"""Model API over every architecture family (port of
``repro.models.model``: dense, MoE, MLA, SSM, hybrid with meta tokens,
the vision-frontend stub and the encoder-decoder).

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
K6 flash attention and K7 the SSD scan over full sequences (prefill, the
encoder); decode, cross-attention and MLA always take the plain paths, as
in the reference. Batch layouts, each array a tensor or a numpy array:
  text (dense/moe/ssm/hybrid): ``{"tokens": (B,S) int}``
  vlm:   ``{"patches": (B,P,d_frontend), "tokens": (B,S-P) int}``
  audio: ``{"frames": (B,S,d_frontend), "tokens": (B,S) int}`` (enc-dec)
Meta tokens (hymba), then the projected patches, lead the stream, so
positions count them. An enc-dec prefill encodes the frames and decodes a
bos token at decoder position 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree as _tree
from repro_torch.configs.base import BLOCK_SSM, ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import encdec, transformer
from repro_torch.models.attention import IMPLS
from repro_torch.models.layers import (chunked_softmax_xent, dense_init,
                                       embed_init, rms_norm, softcap)

# decode caches longer than this take a ring buffer of the sliding window
# (or, for SSM-only models, one unused slot), as in the reference: the
# global layers then see only the ring too
MAX_FULL_CACHE = 32_768


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model:
    def __init__(self, cfg: ModelConfig, *, impl: str = "xla",
                 device=DEFAULT_DEVICE):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
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
        gen = generator
        params = {
            "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model)),
            "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32,
                                      device=self.device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen,
                                           (cfg.d_model, cfg.padded_vocab))
        if cfg.is_encoder_decoder:
            params["enc_stack"] = _tree.stack_trees(
                lambda: encdec.enc_block_init(gen, cfg), cfg.n_encoder_layers)
            params["enc_norm"] = torch.zeros(cfg.d_model, dtype=torch.float32,
                                             device=self.device)
            params["dec_stack"] = _tree.stack_trees(
                lambda: encdec.dec_block_init(gen, cfg), cfg.n_layers)
        else:
            params["stack"] = transformer.stack_init(gen, cfg, cfg.n_layers)
        if cfg.frontend is not None:
            params["frontend_proj"] = dense_init(
                gen, (cfg.frontend.d_frontend, cfg.d_model))
        if cfg.n_meta_tokens:
            params["meta_tokens"] = embed_init(
                gen, (cfg.n_meta_tokens, cfg.d_model))
        return params

    def cast(self, params: dict) -> dict:
        dt = _dtype(self.cfg.dtype)
        return _tree.tree_map(
            lambda a: a.to(dt) if a.dtype == torch.float32 else a, params)

    # ------------------------------------------------------------------
    # Embedding / stream assembly
    # ------------------------------------------------------------------
    def _embed_tokens(self, params, tokens):
        dt = _dtype(self.cfg.dtype)
        # F.embedding, not ``embed[tokens]``: the backward of advanced
        # indexing accumulates in a run-dependent order on the CPU, and
        # then equal rounds give unequal model digests
        x = F.embedding(tokens, params["embed"].to(dt))
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=dt)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(self.device, torch.int64)

    def _features(self, a) -> torch.Tensor:
        """Frontend features (patches or frames) in the compute dtype."""
        return torch.as_tensor(a).to(self.device, _dtype(self.cfg.dtype))

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32,
                            device=self.device).expand(B, S)

    def _assemble_stream(self, params, batch):
        """Returns (embeds (B,S,D), positions (B,S), labels (B,S), mask);
        the meta tokens, then the projected patches, lead the stream."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        B, T = tokens.shape
        x = self._embed_tokens(params, tokens)
        parts = []
        if cfg.n_meta_tokens:
            parts.append(params["meta_tokens"].to(x.dtype)[None].expand(
                B, cfg.n_meta_tokens, cfg.d_model))
        if cfg.frontend is not None:
            parts.append(self._features(batch["patches"])
                         @ params["frontend_proj"].to(x.dtype))
        n_prefix = sum(p.shape[1] for p in parts)
        if parts:
            x = torch.cat(parts + [x], dim=1)
        S = x.shape[1]
        # stream position n_prefix + t - 1 predicts tokens[t]
        labels = torch.zeros((B, S), dtype=torch.int64, device=self.device)
        labels[:, n_prefix:n_prefix + T - 1] = tokens[:, 1:]
        mask = torch.zeros((B, S), dtype=torch.float32, device=self.device)
        mask[:, n_prefix:n_prefix + T - 1] = 1.0
        return x, self._positions(B, S), labels, mask

    def _unembed_matrix(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["unembed"]

    def loss_fn(self, params: dict, batch: dict):
        cfg = self.cfg
        params = self.cast(params)
        if cfg.is_encoder_decoder:
            hidden, labels, mask = self._encdec_forward(params, batch)
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
        else:
            x, positions, labels, mask = self._assemble_stream(params, batch)
            hidden, aux = transformer.stack_apply(
                cfg, params["stack"], x, positions,
                transformer.layer_windows(cfg), impl=self.impl)
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        ce = chunked_softmax_xent(hidden, self._unembed_matrix(params),
                                  labels, mask,
                                  final_softcap=cfg.final_logit_softcap)
        return ce + aux, {"ce": ce, "aux": aux}

    def _encode(self, params, frames):
        """The encoder over the projected frames, final-normed."""
        cfg = self.cfg
        x = self._features(frames)
        B, Se = x.shape[:2]
        x = x @ params["frontend_proj"].to(x.dtype)
        x = encdec.encoder_apply(cfg, params["enc_stack"], x,
                                 self._positions(B, Se), impl=self.impl)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _encdec_forward(self, params, batch):
        cfg = self.cfg
        enc_out = self._encode(params, batch["frames"])
        tokens = self._tokens(batch["tokens"])
        B, Sd = tokens.shape
        enc_valid = torch.ones(enc_out.shape[:2], dtype=torch.bool,
                               device=self.device)
        hidden = encdec.decoder_apply(
            cfg, params["dec_stack"], self._embed_tokens(params, tokens),
            self._positions(B, Sd), enc_out, enc_valid, impl=self.impl)
        labels = F.pad(tokens[:, 1:], (0, 1))
        mask = F.pad(torch.ones((B, Sd - 1), dtype=torch.float32,
                                device=self.device), (0, 1))
        return hidden, labels, mask

    # ------------------------------------------------------------------
    # Serving: prefill + decode
    # ------------------------------------------------------------------
    def cache_len_for(self, seq_len: int) -> int:
        """Cache slots for a stream of ``seq_len`` positions (meta tokens
        and patches included). Longer than ``MAX_FULL_CACHE``: a ring of
        the sliding window, or 1 slot for an SSM-only model (it carries
        state), as in the reference."""
        cfg = self.cfg
        if seq_len > MAX_FULL_CACHE and cfg.sliding_window > 0:
            return cfg.sliding_window
        if seq_len > MAX_FULL_CACHE and cfg.block_kind == BLOCK_SSM:
            return 1
        return seq_len

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Returns (logits (B,1,V) of the last position, stacked cache)."""
        cfg = self.cfg
        params = self.cast(params)
        if cfg.is_encoder_decoder:
            return self._encdec_prefill(params, batch, cache_len)
        x, positions, _, _ = self._assemble_stream(params, batch)
        hidden, caches = transformer.stack_prefill(
            cfg, params["stack"], x, positions,
            transformer.layer_windows(cfg), cache_len, impl=self.impl)
        hidden = rms_norm(hidden[:, -1:], params["final_norm"], cfg.norm_eps)
        return self._logits(params, hidden), caches

    def _encdec_prefill(self, params, batch, cache_len):
        """Encode the frames, fill every layer's cross K/V, and decode a
        bos token (id 0) at decoder position 0."""
        enc_out = self._encode(params, batch["frames"])
        B, Se = enc_out.shape[:2]
        caches = self._encdec_cache(B, cache_len, Se)
        caches = encdec.decoder_fill_cross(self.cfg, params["dec_stack"],
                                           caches, enc_out)
        zeros = torch.zeros((B, 1), dtype=torch.int64, device=self.device)
        return self._decode_cast(params, caches, zeros, zeros)

    def _encdec_cache(self, batch: int, cache_len: int, enc_len: int):
        one = encdec.decoder_cache_init(self.cfg, batch, cache_len, enc_len,
                                        _dtype(self.cfg.dtype), self.device)
        return _tree.tree_map(
            lambda a: a[None].expand((self.cfg.n_layers,) + a.shape).clone(),
            one)

    def init_cache(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        if cfg.is_encoder_decoder:          # the reference's enc_len
            return self._encdec_cache(batch, cache_len, cache_len)
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
        if cfg.is_encoder_decoder:
            B, Se = x.shape[0], cache["cross_k"].shape[2]
            enc_valid = torch.ones((B, Se), dtype=torch.bool,
                                   device=self.device)
            hidden, cache = encdec.decoder_decode(
                cfg, params["dec_stack"], x, cache, pos, enc_valid)
        else:
            hidden, cache = transformer.stack_decode(
                cfg, params["stack"], x, cache, pos,
                transformer.layer_windows(cfg))
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        return self._logits(params, hidden), cache

    def decode_step(self, params: dict, cache: dict, token, pos):
        """token: (B,1) int; pos: (B,1) absolute stream position (meta
        tokens and patches counted; the decoder's own for an enc-dec).
        Returns (logits (B,1,V), cache); the cache is updated in place."""
        params = self.cast(params)
        return self._decode_cast(params, cache, token, pos)


def build_model(name_or_cfg, *, impl: str = "xla",
                device=DEFAULT_DEVICE) -> Model:
    if isinstance(name_or_cfg, str):
        from repro_torch.configs import get_config
        name_or_cfg = get_config(name_or_cfg)
    return Model(name_or_cfg, impl=impl, device=device)
