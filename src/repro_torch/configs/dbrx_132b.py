"""dbrx-132b — fine-grained 16-expert top-4 MoE. [hf:databricks/dbrx-base]

40L d_model=6144 48H (GQA kv=8) expert d_ff=10752 vocab=100352, 16e top-4.
"""
from repro_torch.configs.base import BLOCK_MOE, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,                  # per-expert hidden dim
    vocab=100352,
    rope_theta=500_000.0,
    block_kind=BLOCK_MOE,
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752,
                  capacity_factor=1.25, router_aux_weight=0.05),
    norm_eps=1e-5,
    subquadratic_decode=False,
))
