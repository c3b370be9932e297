"""hymba-1.5b — hybrid-head: parallel attention + Mamba heads per layer,
meta tokens, mostly-sliding-window attention. [arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16,
128 learnable meta tokens, SW 1024 except every 8th layer global. Same
config as ``repro.configs.hymba_1p5b``.
"""
from repro_torch.configs.base import (BLOCK_HYBRID, ModelConfig, SSMConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    sliding_window=1024,
    local_global_period=8,       # 7 local : 1 global
    block_kind=BLOCK_HYBRID,
    ssm=SSMConfig(d_state=16, d_head=64, expand=2, d_conv=4, chunk=128),
    n_meta_tokens=128,
    norm_eps=1e-5,
    subquadratic_decode=True,    # SSM branch + SW attention
))
