"""Model API over every architecture family (port of
``repro.models.model``: dense, MoE, MLA, SSM, hybrid with meta tokens,
the vision-frontend stub and the encoder-decoder).

``Model`` wraps a ``ModelConfig``, an attention/scan ``impl``, ``remat``
and a device, and exposes:
  * ``init(generator, dtype=None)`` — parameter tree (fp32 master, or
    drawn straight into ``dtype``), on device
  * ``cast(params)``             — fp32 master -> the config's compute dtype
  * ``loss_fn(params, batch)``   — mean next-token CE + aux losses
  * ``prefill(params, batch, cache_len)`` — logits for the last position
    and the decode cache
  * ``decode_step(params, cache, tok, pos)`` — one-token decode; updates
    the cache in place and returns it; on CUDA a CUDA graph of the step
    replays, and each cache is one buffer (``models/decode_graph.py``)
  * ``init_cache(batch, cache_len)``, ``cache_len_for(seq_len)``
  * ``abstract_params()``, ``abstract_cache(batch, cache_len)`` and
    ``input_specs(shape)`` — the same trees as tensors on the ``meta``
    device (torch's ``ShapeDtypeStruct``): shapes and dtypes, no storage

A training forward (while autograd records) checkpoints each chunk of
the CE and each q chunk of the plain attention (``torch.utils.checkpoint``),
as the reference does at either ``remat``; ``remat=True`` (the default,
as the reference's) checkpoints each layer body too. The backward then
runs the layers' forward once more and keeps one layer's activations at
a time; the values are bitwise those of ``remat=False``.

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

import copy
import math

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._device import _device_constructors

from repro_torch import tree as _tree
from repro_torch.configs.base import BLOCK_SSM, ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import encdec, transformer
from repro_torch.models.attention import IMPLS
from repro_torch.models.decode_graph import DecodeGraphs
from repro_torch.models.layers import (chunked_softmax_xent, dense_init,
                                       embed_init, rms_norm, softcap)
from repro_torch.sharding.specs import replicated_call

# decode caches longer than this take a ring buffer of the sliding window
# (or, for SSM-only models, one unused slot), as in the reference: the
# global layers then see only the ring too
MAX_FULL_CACHE = 32_768


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


_META = torch.device("meta")


class _OnMeta(TorchFunctionMode):
    """Every tensor factory allocates on the ``meta`` device and every
    generator is dropped: ``init`` and ``init_cache`` run as they are and
    build their trees of shapes and dtypes without storage (the role of
    the reference's ``jax.eval_shape``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _device_constructors():
            kwargs["device"] = _META
        kwargs.pop("generator", None)
        return func(*args, **kwargs)



def _stream_labels(tokens: torch.Tensor, n_prefix: int, S: int):
    """(B, S) labels: stream position n_prefix + t - 1 predicts tokens[t],
    the rest 0. Written in place, so over ranks it runs on whole tokens
    (``replicated_call``)."""
    B, T = tokens.shape
    labels = torch.zeros((B, S), dtype=torch.int64, device=tokens.device)
    labels[:, n_prefix:n_prefix + T - 1] = tokens[:, 1:]
    return labels


class Model:
    def __init__(self, cfg: ModelConfig, *, impl: str = "xla",
                 remat: bool = True, device=DEFAULT_DEVICE):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.cfg = cfg
        self.impl = impl
        self.remat = bool(remat)
        self.device = resolve(device)
        self._graphs = DecodeGraphs()

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def init(self, generator: torch.Generator, dtype=None) -> dict:
        """fp32 master params, drawn from ``generator`` (on this model's
        device): the reference's distributions, not its numbers. With
        ``dtype`` every f32 leaf comes out in it, the same values as
        ``init`` then a cast; a pattern config's layers are drawn one at a
        time into it (a model too large for f32 masters is served so)."""
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
            params["stack"] = transformer.stack_init(gen, cfg, cfg.n_layers,
                                                     dtype)
        if cfg.frontend is not None:
            params["frontend_proj"] = dense_init(
                gen, (cfg.frontend.d_frontend, cfg.d_model))
        if cfg.n_meta_tokens:
            params["meta_tokens"] = embed_init(
                gen, (cfg.n_meta_tokens, cfg.d_model))
        if dtype is None:
            return params
        return _tree.tree_map(
            lambda a: a.to(dtype) if a.dtype == torch.float32 else a, params)

    def _on_cpu(self) -> "Model":
        """This model with its device set to the CPU (for the meta
        builds, which must not need the card)."""
        m = copy.copy(self)
        m.device = torch.device("cpu")
        return m

    def abstract_params(self) -> dict:
        """``init``'s tree as meta tensors: the fp32 masters' shapes."""
        with _OnMeta():
            return self._on_cpu().init(torch.Generator())

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
        if self.cfg.scale_embeddings is False:
            return x
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
        labels = replicated_call(_stream_labels, tokens, n_prefix, S)
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
                transformer.layer_windows(cfg), impl=self.impl,
                remat=self.remat)
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        ce = chunked_softmax_xent(hidden, self._unembed_matrix(params),
                                  labels, mask,
                                  final_softcap=cfg.final_logit_softcap)
        return ce + aux, {"ce": ce, "aux": aux}

    def _encode(self, params, frames, *, serve: bool = False):
        """The encoder over the projected frames, final-normed; ``serve``:
        a prefill's (``encdec.encoder_apply``)."""
        cfg = self.cfg
        x = self._features(frames)
        B, Se = x.shape[:2]
        x = x @ params["frontend_proj"].to(x.dtype)
        x = encdec.encoder_apply(cfg, params["enc_stack"], x,
                                 self._positions(B, Se), impl=self.impl,
                                 remat=self.remat, serve=serve)
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
            self._positions(B, Sd), enc_out, enc_valid, impl=self.impl,
            remat=self.remat)
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
        if seq_len > MAX_FULL_CACHE and (cfg.sliding_window or 0) > 0:
            return cfg.sliding_window
        if seq_len > MAX_FULL_CACHE and cfg.block_kind == BLOCK_SSM:
            return 1
        return seq_len

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Returns (logits (B,1,V) of the last position, stacked cache).
        Span ``serve.prefill``."""
        # repro_torch.core imports this module: import its telemetry late
        from repro_torch.core.telemetry import current
        with current().span("serve.prefill", cat="serve",
                            device=self.device):
            cfg = self.cfg
            # the cache before the activations: on the decode graphs' path
            # it then takes the block a freed cache left, and the graphs'
            # keys recur (models/decode_graph.py)
            if cfg.is_encoder_decoder:
                B, Se = batch["frames"].shape[:2]
                caches = self._encdec_cache(B, cache_len, Se)
                return self._encdec_prefill(self.cast(params), batch, caches)
            into = (self.init_cache(batch["tokens"].shape[0], cache_len)
                    if self._graphs.on_path(self.device, params) else None)
            params = self.cast(params)
            x, positions, _, _ = self._assemble_stream(params, batch)
            hidden, caches = transformer.stack_prefill(
                cfg, params["stack"], x, positions,
                transformer.layer_windows(cfg), cache_len, impl=self.impl,
                stack=lambda trees, kind=None: self._graphs.stack(
                    self.device, trees,
                    into if into is None or kind is None else into[kind]))
            hidden = rms_norm(hidden[:, -1:], params["final_norm"],
                              cfg.norm_eps)
            return self._logits(params, hidden), caches

    def _encdec_prefill(self, params, batch, caches):
        """Encode the frames, fill every layer's cross K/V of ``caches``,
        and decode a bos token (id 0) at decoder position 0."""
        enc_out = self._encode(params, batch["frames"], serve=True)
        B = enc_out.shape[0]
        caches = encdec.decoder_fill_cross(self.cfg, params["dec_stack"],
                                           caches, enc_out)
        zeros = torch.zeros((B, 1), dtype=torch.int64, device=self.device)
        return self._decode_cast(params, caches, zeros, zeros)

    def _stack(self, trees: list) -> dict:
        """The layers' caches stacked into one cache (on the decode graphs'
        path one buffer: ``DecodeGraphs.stack``)."""
        return self._graphs.stack(self.device, trees)

    def _encdec_cache(self, batch: int, cache_len: int, enc_len: int):
        one = encdec.decoder_cache_init(self.cfg, batch, cache_len, enc_len,
                                        _dtype(self.cfg.dtype), self.device)
        return self._stack([one] * self.cfg.n_layers)

    def init_cache(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        if cfg.is_encoder_decoder:          # the reference's enc_len
            return self._encdec_cache(batch, cache_len, cache_len)
        return transformer.stack_cache_init(cfg, batch, cache_len,
                                            _dtype(cfg.dtype), cfg.n_layers,
                                            self.device, stack=self._stack)

    def abstract_cache(self, batch: int, cache_len: int) -> dict:
        """``init_cache``'s tree as meta tensors."""
        with _OnMeta():
            return self._on_cpu().init_cache(batch, cache_len)

    def _logits(self, params, hidden_last):
        """Span ``serve.logits``."""
        # repro_torch.core imports this module: import its telemetry late
        from repro_torch.core.telemetry import current
        with current().span("serve.logits", cat="serve",
                            device=hidden_last.device):
            logits = hidden_last @ self._unembed_matrix(params).to(
                hidden_last.dtype)
            logits = logits[..., :self.cfg.vocab]  # drop padded vocab ids
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

    def _decode(self, params, cache, token, pos):
        return self._decode_cast(self.cast(params), cache, token, pos)

    def decode_step(self, params: dict, cache: dict, token, pos):
        """token: (B,1) int; pos: (B,1) absolute stream position (meta
        tokens and patches counted; the decoder's own for an enc-dec).
        Returns (logits (B,1,V), cache); the cache is updated in place.
        On CUDA with autograd off the step replays as one CUDA graph
        (``models/decode_graph.py``). Span ``serve.decode_step``."""
        # repro_torch.core imports this module: import its telemetry late
        from repro_torch.core.telemetry import current
        with current().span("serve.decode_step", cat="serve",
                            device=self.device):
            return self._graphs(self._decode, self.device, params, cache,
                                token, pos)

    # ------------------------------------------------------------------
    # Dry-run input specs (no allocation)
    # ------------------------------------------------------------------
    def input_specs(self, shape: InputShape) -> dict:
        """The batch of ``shape`` as meta tensors, in the reference's
        layouts and dtypes (int32 tokens, frontend features in the compute
        dtype); a decode shape gives ``{"cache", "token", "pos"}``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32, dt = torch.int32, _dtype(cfg.dtype)

        def sds(shp, dtype):
            return torch.empty(shp, dtype=dtype, device=_META)
        if shape.mode in ("train", "prefill"):
            if cfg.is_encoder_decoder:
                return {"frames": sds((B, S, cfg.frontend.d_frontend), dt),
                        "tokens": sds((B, S), i32)}
            if cfg.frontend is not None:
                P = cfg.frontend.num_tokens
                return {"patches": sds((B, P, cfg.frontend.d_frontend), dt),
                        "tokens": sds((B, S - P), i32)}
            return {"tokens": sds((B, S), i32)}
        # decode: (cache, token, pos)
        cache = self.abstract_cache(B, self.cache_len_for(S))
        return {"cache": cache, "token": sds((B, 1), i32),
                "pos": sds((B, 1), i32)}


def build_model(name_or_cfg, *, impl: str = "xla", remat: bool = True,
                device=DEFAULT_DEVICE) -> Model:
    if isinstance(name_or_cfg, str):
        from repro_torch.configs import get_config
        name_or_cfg = get_config(name_or_cfg)
    return Model(name_or_cfg, impl=impl, remat=remat, device=device)
