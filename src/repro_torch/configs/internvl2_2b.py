"""internvl2-2b — InternViT vision frontend (STUB) + InternLM2 LM.
[arXiv:2404.16821]

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The ViT + pixel-shuffle
projector is a stub: ``input_specs`` provides patch embeddings
(d_frontend=1024, 256 patches/image) consumed via a learned projector.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", d_frontend=1024, num_tokens=256),
    norm_eps=1e-5,
    subquadratic_decode=False,
))
