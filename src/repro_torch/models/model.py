"""Model API for the decoder-only families (port of
``repro.models.model``: dense, SSM and hybrid, meta tokens included).

``Model`` wraps a ``ModelConfig``, an attention/scan ``impl`` and a
device, and exposes:
  * ``init(generator)``          — parameter tree (fp32 master), on device
  * ``cast(params)``             — fp32 master -> the config's compute dtype
  * ``loss_fn(params, batch)``   — mean next-token CE + aux losses
  * ``prefill(params, batch, cache_len)`` — logits for the last position
    and the decode cache
  * ``decode_step(params, cache, tok, pos)`` — one-token decode; updates
    the cache in place and returns it
  * ``init_cache(batch, cache_len)``, ``cache_len_for(seq_len)``

``impl="xla"`` runs the plain attention and scan; ``impl="kernel"`` runs
K6 flash attention and K7 the SSD scan over full sequences (prefill);
decode always takes the plain paths, as in the reference. Batch layout:
``{"tokens": (B, S) int}`` (a tensor or an array). Meta tokens (hymba)
lead the stream, so positions count them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import transformer
from repro_torch.models.attention import IMPLS
from repro_torch.models.layers import (chunked_softmax_xent, dense_init,
                                       embed_init, rms_norm, softcap)

# longer decode caches take a ring buffer of the sliding window in the
# reference (DESIGN.md section 4); not ported yet
MAX_FULL_CACHE = 32_768


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model:
    def __init__(self, cfg: ModelConfig, *, impl: str = "xla",
                 device=DEFAULT_DEVICE):
        if cfg.is_encoder_decoder or cfg.frontend is not None:
            raise NotImplementedError(
                "encoder-decoder and frontend models are not ported yet "
                "(ROADMAP queue A item 13)")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        transformer._check_supported(cfg)
        self.cfg = cfg
        self.impl = impl
        self.device = resolve(device)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def init(self, generator: torch.Generator) -> dict:
        """fp32 master params, drawn from ``generator`` (on this model's
        device): the reference's distributions, not its numbers."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(
                f"generator on {generator.device}, model on {self.device}")
        cfg = self.cfg
        params = {
            "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model)),
            "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32,
                                      device=self.device),
            "stack": transformer.stack_init(generator, cfg, cfg.n_layers),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(generator,
                                           (cfg.d_model, cfg.padded_vocab))
        if cfg.n_meta_tokens:
            params["meta_tokens"] = embed_init(
                generator, (cfg.n_meta_tokens, cfg.d_model))
        return params

    def cast(self, params: dict) -> dict:
        dt = _dtype(self.cfg.dtype)
        return _tree.tree_map(
            lambda a: a.to(dt) if a.dtype == torch.float32 else a, params)

    def _embed_tokens(self, params, tokens):
        dt = _dtype(self.cfg.dtype)
        # F.embedding, not ``embed[tokens]``: the backward of advanced
        # indexing accumulates in a run-dependent order on the CPU, and
        # then equal rounds give unequal model digests
        x = F.embedding(tokens, params["embed"].to(dt))
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=dt)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(self.device, torch.int64)

    def _assemble_stream(self, params, batch):
        """Returns (embeds (B,S,D), positions (B,S), labels (B,S), mask);
        the meta tokens, if any, lead the stream."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        B, T = tokens.shape
        x = self._embed_tokens(params, tokens)
        n_prefix = cfg.n_meta_tokens
        if n_prefix:
            meta = params["meta_tokens"].to(x.dtype)[None].expand(
                B, n_prefix, cfg.d_model)
            x = torch.cat([meta, x], dim=1)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        # stream position n_prefix + t - 1 predicts tokens[t]
        labels = torch.zeros((B, S), dtype=torch.int64, device=self.device)
        labels[:, n_prefix:n_prefix + T - 1] = tokens[:, 1:]
        mask = torch.zeros((B, S), dtype=torch.float32, device=self.device)
        mask[:, n_prefix:n_prefix + T - 1] = 1.0
        return x, positions, labels, mask

    def _unembed_matrix(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["unembed"]

    def loss_fn(self, params: dict, batch: dict):
        cfg = self.cfg
        params = self.cast(params)
        x, positions, labels, mask = self._assemble_stream(params, batch)
        hidden, aux = transformer.stack_apply(
            cfg, params["stack"], x, positions,
            transformer.layer_windows(cfg), impl=self.impl)
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        ce = chunked_softmax_xent(hidden, self._unembed_matrix(params),
                                  labels, mask,
                                  final_softcap=cfg.final_logit_softcap)
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    # Serving: prefill + decode
    # ------------------------------------------------------------------
    def cache_len_for(self, seq_len: int) -> int:
        """Cache slots for a stream of ``seq_len`` positions (meta tokens
        included). Longer than ``MAX_FULL_CACHE`` the reference keeps a
        ring of the sliding window; the port does not yet."""
        if seq_len > MAX_FULL_CACHE:
            raise NotImplementedError(
                f"a {seq_len}-position stream needs the windowed ring cache "
                "above MAX_FULL_CACHE, not ported yet (ROADMAP queue A "
                "item 13)")
        return seq_len

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Returns (logits (B,1,V) of the last position, stacked cache)."""
        cfg = self.cfg
        params = self.cast(params)
        x, positions, _, _ = self._assemble_stream(params, batch)
        hidden, caches = transformer.stack_prefill(
            cfg, params["stack"], x, positions,
            transformer.layer_windows(cfg), cache_len, impl=self.impl)
        hidden = rms_norm(hidden[:, -1:], params["final_norm"], cfg.norm_eps)
        return self._logits(params, hidden), caches

    def init_cache(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        return transformer.stack_cache_init(cfg, batch, cache_len,
                                            _dtype(cfg.dtype), cfg.n_layers,
                                            self.device)

    def _logits(self, params, hidden_last):
        logits = hidden_last @ self._unembed_matrix(params).to(
            hidden_last.dtype)
        logits = logits[..., :self.cfg.vocab]     # drop padded vocab ids
        if self.cfg.final_logit_softcap > 0:
            logits = softcap(logits.to(torch.float32),
                             self.cfg.final_logit_softcap)
        return logits

    def _decode_cast(self, params, cache, token, pos):
        cfg = self.cfg
        x = self._embed_tokens(params, self._tokens(token))
        pos = torch.as_tensor(pos).to(self.device, torch.int32)
        hidden, cache = transformer.stack_decode(
            cfg, params["stack"], x, cache, pos,
            transformer.layer_windows(cfg))
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        return self._logits(params, hidden), cache

    def decode_step(self, params: dict, cache: dict, token, pos):
        """token: (B,1) int; pos: (B,1) absolute stream position (meta
        tokens counted). Returns (logits (B,1,V), cache); the cache is
        updated in place."""
        params = self.cast(params)
        return self._decode_cast(params, cache, token, pos)


def build_model(name_or_cfg, *, impl: str = "xla",
                device=DEFAULT_DEVICE) -> Model:
    if isinstance(name_or_cfg, str):
        from repro_torch.configs import get_config
        name_or_cfg = get_config(name_or_cfg)
    return Model(name_or_cfg, impl=impl, device=device)
