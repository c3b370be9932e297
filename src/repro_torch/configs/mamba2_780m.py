"""mamba2-780m — SSD (state-space duality), attention-free. [arXiv:2405.21060]

48L d_model=1536, d_state=128, headdim=64 (=> 48 SSD heads at expand=2),
vocab=50280. No MLP between blocks (d_ff=0) — pure Mamba2 stack.
"""
from repro_torch.configs.base import (BLOCK_SSM, ModelConfig, SSMConfig, register)

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    n_heads=48,            # SSD heads = d_inner / d_head = 3072/64
    n_kv_heads=48,
    d_ff=0,                # attn-free, no interleaved MLP
    vocab=50280,
    block_kind=BLOCK_SSM,
    ssm=SSMConfig(d_state=128, d_head=64, expand=2, d_conv=4, chunk=128),
    tie_embeddings=True,
    norm_eps=1e-5,
    subquadratic_decode=True,   # O(1)-state recurrent decode
))
