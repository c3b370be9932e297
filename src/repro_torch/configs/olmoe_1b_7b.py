"""olmoe-1b-7b — 64-expert top-8 MoE. [arXiv:2409.02060]

16L d_model=2048 16H (kv=16) expert d_ff=1024 vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import BLOCK_MOE, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,                   # per-expert hidden dim
    vocab=50304,
    qk_norm=True,
    block_kind=BLOCK_MOE,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024,
                  capacity_factor=1.25, router_aux_weight=0.01),
    norm_eps=1e-5,
    subquadratic_decode=False,
))
