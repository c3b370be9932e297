"""minicpm3-4b — multi-head latent attention (MLA). [hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H (kv=40 via shared latent) d_ff=6400 vocab=73448.
MLA: q LoRA rank 768, kv LoRA rank 256, qk nope 64 + rope 32, v head 64.
"""
from repro_torch.configs.base import ATTN_MLA, MLAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm3-4b",
    family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attn_kind=ATTN_MLA,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                  qk_rope_dim=32, v_head_dim=64),
    tie_embeddings=True,
    norm_eps=1e-5,
    subquadratic_decode=False,   # full attention (latent cache is compressed
                                 # but attention is still over all positions)
))
