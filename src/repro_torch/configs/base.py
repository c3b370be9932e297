"""Model configuration schema + registry (copy of ``repro.configs.base``).

The port keeps its own copy so that it imports nothing of the JAX
package. The schema is the same frozen dataclass, so a config built here
and one built there describe the same model; ``reduced()`` gives the same
CPU smoke-test variant.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

ATTN_GQA = "gqa"          # grouped-query attention (covers MHA when kv==heads)
ATTN_MLA = "mla"          # multi-head latent attention

BLOCK_ATTN = "attn"       # attention + MLP
BLOCK_SSM = "ssm"         # Mamba2 SSD block
BLOCK_HYBRID = "hybrid"   # parallel attention + SSM heads (Hymba)
BLOCK_MOE = "moe"         # attention + MoE MLP
BLOCK_PATTERN = "pattern" # one mixer a layer, by ``layer_pattern``

# the kinds of a ``layer_pattern`` (Nemotron-H's ``hybrid_override_pattern``)
LAYER_SSM = "M"           # pre-norm Mamba2 mixer
LAYER_MOE = "E"           # pre-norm MoE MLP
LAYER_ATTN = "*"          # pre-norm GQA attention
LAYER_KINDS = {LAYER_SSM: "mamba", LAYER_MOE: "moe", LAYER_ATTN: "attention"}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # the port's own options; the defaults are the reference's MoE
    router: str = "softmax"       # softmax | sigmoid (scores, not probs)
    score_bias: bool = False      # a bias on the scores that picks, not weighs
    routed_scale: float = 1.0     # the picked weights' scale after the norm
    d_shared: int = 0             # one always-on expert of this width
    activation: str = "swiglu"    # swiglu | relu2 (non-gated relu squared)
    dropless: bool = False        # every pick computed: no capacity


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_head: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class FrontendConfig:
    kind: str                     # "audio" | "vision"
    d_frontend: int
    num_tokens: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    source: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    attn_kind: str = ATTN_GQA
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = 0   # 0 or None -> global attention
    local_global_period: int = 0
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False
    use_bias: bool = False
    block_kind: str = BLOCK_ATTN
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: Optional[FrontendConfig] = None
    n_meta_tokens: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    subquadratic_decode: bool = False
    # the port's own options, None in every configuration of the reference
    layer_pattern: Optional[str] = None   # one kind a layer (LAYER_KINDS)
    rotary: Optional[bool] = None         # False: no position rotation
    scale_embeddings: Optional[bool] = None  # False: no sqrt(d_model)
    ssm_groups: Optional[int] = None      # B/C groups (None: 1)
    ssm_heads: Optional[int] = None       # SSM heads (None: d_inner/d_head)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a 256-multiple; tokens and
        labels never reach the padded ids."""
        return (self.vocab + 255) // 256 * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner_ssm(self) -> int:
        if self.ssm is None:
            raise ValueError(f"{self.name} has no SSM")
        if self.ssm_heads:
            return self.ssm_heads * self.ssm.d_head
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm.d_head

    @property
    def n_ssm_groups(self) -> int:
        return self.ssm_groups or 1

    @property
    def has_rotary(self) -> bool:
        return self.rotary is not False

    def layer_kinds(self) -> Tuple[str, ...]:
        """Each layer's kind (a ``LAYER_KINDS`` key) where the config has
        a ``layer_pattern``; empty otherwise."""
        if not self.layer_pattern:
            return ()
        if len(self.layer_pattern) != self.n_layers or \
                set(self.layer_pattern) - set(LAYER_KINDS):
            raise ValueError(f"{self.name}: layer_pattern "
                             f"{self.layer_pattern!r} is not {self.n_layers} "
                             f"of {sorted(LAYER_KINDS)}")
        return tuple(self.layer_pattern)

    def layer_is_local(self, i: int) -> bool:
        """True if layer ``i`` uses sliding-window (local) attention."""
        if (self.sliding_window or 0) <= 0:
            return False
        if self.local_global_period <= 0:
            return True
        return (i % self.local_global_period) != self.local_global_period - 1

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if self.n_kv_heads < self.n_heads:
            n_kv = max(1, n_heads // max(1, self.n_heads // self.n_kv_heads))
        changes = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=64 if self.head_dim else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            local_global_period=min(self.local_global_period, 2)
            if self.local_global_period else 0,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            n_meta_tokens=min(self.n_meta_tokens, 8),
            dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2,
                d_expert=min(self.moe.d_expert, 128), capacity_factor=100.0,
                d_shared=min(self.moe.d_shared, 256))
        if self.layer_pattern:
            # one layer of each kind, in the order they first appear
            kinds = "".join(dict.fromkeys(self.layer_pattern))
            changes.update(n_layers=len(kinds), layer_pattern=kinds)
        if self.ssm_groups:
            changes["ssm_groups"] = min(self.ssm_groups, 2)
        if self.ssm_heads:
            changes["ssm_heads"] = min(self.ssm_heads, 8)
        if self.ssm is not None:
            changes["ssm"] = SSMConfig(
                d_state=min(self.ssm.d_state, 16), d_head=32,
                expand=self.ssm.expand, d_conv=self.ssm.d_conv, chunk=16)
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                qk_rope_dim=16, v_head_dim=32)
        if self.frontend is not None:
            changes["frontend"] = FrontendConfig(
                kind=self.frontend.kind, d_frontend=64, num_tokens=16)
        return dataclasses.replace(self, **changes)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _c  # noqa: F401  (registers)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    from repro_torch import configs as _c  # noqa: F401  (registers)
    return tuple(sorted(_REGISTRY))
