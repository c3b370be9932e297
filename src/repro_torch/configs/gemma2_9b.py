"""gemma2-9b — local/global alternating attention + logit softcaps.
[arXiv:2408.00118]

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256,
sliding window 4096 on alternating (even) layers, attn softcap 50, final 30.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    sliding_window=4096,
    local_global_period=2,       # local, global, local, global, ...
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    subquadratic_decode=True,    # SW local layers; global layers fall back to
                                 # windowed cache at 500k (DESIGN.md §4)
))
