"""fedforecast-100m — the paper's own scenario model (FederatedForecasts).

A ~100M decoder-only forecaster over a quantized time-series vocabulary
(energy readings binned to 4096 symbols). Same config as
``repro.configs.fedforecast_100m``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="fedforecast-100m",
    family="dense",
    source="FL-APU §I (FederatedForecasts scenario)",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=4096,
    tie_embeddings=True,
    subquadratic_decode=False,
))
