"""command-r-plus-104b — dense GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    use_bias=False,
    qk_norm=True,              # command-r-plus uses q/k layernorm
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    norm_eps=1e-5,
    subquadratic_decode=False,  # pure global attention -> long_500k skipped
))
