"""gemma3-4b — 5:1 local:global attention, 128k context. [hf:google/gemma-3-1b-pt]

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256,
window 1024 on 5 of every 6 layers, qk-norm, global rope theta 1M.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    sliding_window=1024,
    local_global_period=6,       # 5 local : 1 global
    qk_norm=True,
    rope_theta=1_000_000.0,
    final_logit_softcap=0.0,     # gemma3 dropped softcap in favour of qk-norm
    tie_embeddings=True,
    subquadratic_decode=True,
))
