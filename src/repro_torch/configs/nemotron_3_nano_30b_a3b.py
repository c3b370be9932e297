"""nemotron-3-nano-30b-a3b — Mamba2, MoE and attention layers in one stack.
[https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16]

52 layers by ``hybrid_override_pattern``: 23 Mamba2 (M), 23 MoE (E) and 6
GQA attention (*), each ``x + mixer(RMSNorm(x))``; d_model 2688, vocab
131,072, untied. M: 64 heads of 64 (d_inner 4096), 8 B/C groups of state
128, conv 4, chunk 128. E: a sigmoid router over 128 experts whose score
bias picks the top 6 and does not weigh them, the picked scores
normalised and scaled by 2.5; relu² experts 2688 -> 1856 -> 2688 and one
shared relu² expert of 3712; dropless. *: 32 query heads over 2 KV heads
of 128, no rotary (the ``nemotron_h`` modeling code applies none); the
token embeddings enter unscaled. 31.6B
parameters, 3.2B active a token. The port's own configuration: the JAX
package has no such model.
"""
from repro_torch.configs.base import (BLOCK_PATTERN, ModelConfig, MoEConfig,
                                      SSMConfig, register)

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = register(ModelConfig(
    name="nemotron-3-nano-30b-a3b",
    family="hybrid-moe",
    source="https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16",
    n_layers=52,
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=1856,                   # per-expert hidden dim
    vocab=131072,
    sliding_window=None,         # the source's null: global attention
    block_kind=BLOCK_PATTERN,
    moe=MoEConfig(num_experts=128, top_k=6, d_expert=1856,
                  router="sigmoid", score_bias=True, routed_scale=2.5,
                  d_shared=3712, activation="relu2", dropless=True),
    ssm=SSMConfig(d_state=128, d_head=64, expand=2, d_conv=4, chunk=128),
    norm_eps=1e-5,
    layer_pattern=PATTERN,
    rotary=False,
    scale_embeddings=False,
    ssm_groups=8,
    ssm_heads=64,
))
