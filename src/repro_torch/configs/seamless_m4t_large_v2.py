"""seamless-m4t-large-v2 — multimodal enc-dec text/speech backbone.
[arXiv:2308.11596]

24L decoder (+24L encoder) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
The speech frontend (mel + conformer feature extractor) is a STUB per spec:
``input_specs`` provides precomputed frame embeddings (d_frontend=160 mel-ish
frames projected by a learned linear into d_model).
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=24,               # decoder layers
    n_encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    use_bias=True,             # fairseq2 lineage uses biased projections
    frontend=FrontendConfig(kind="audio", d_frontend=160, num_tokens=0),
    norm_eps=1e-5,
    subquadratic_decode=False,
))
