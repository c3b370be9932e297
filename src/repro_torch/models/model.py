"""Model API for the dense decoder (port of ``repro.models.model``).

``Model`` wraps a ``ModelConfig`` and a device and exposes:
  * ``init(generator)``          — parameter tree (fp32 master), on device
  * ``cast(params)``             — fp32 master -> the config's compute dtype
  * ``loss_fn(params, batch)``   — mean next-token CE + aux losses

Batch layout: ``{"tokens": (B, S) int}`` (a tensor or an array). Prefill
and decode come with the control-plane slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import transformer
from repro_torch.models.layers import (chunked_softmax_xent, dense_init,
                                       embed_init, rms_norm)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model:
    def __init__(self, cfg: ModelConfig, *, device=DEFAULT_DEVICE):
        if (cfg.is_encoder_decoder or cfg.frontend is not None
                or cfg.n_meta_tokens):
            raise NotImplementedError(
                "encoder-decoder, frontend and meta-token models are not "
                "ported yet (ROADMAP queue A item 13)")
        transformer._check_supported(cfg)
        self.cfg = cfg
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

    def _assemble_stream(self, params, batch):
        """Returns (embeds (B,S,D), positions (B,S), labels (B,S), mask)."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device,
                                                     torch.int64)
        B, S = tokens.shape
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        # stream position t - 1 predicts tokens[t]; the last has no label
        labels = torch.zeros((B, S), dtype=torch.int64, device=self.device)
        labels[:, :S - 1] = tokens[:, 1:]
        mask = torch.zeros((B, S), dtype=torch.float32, device=self.device)
        mask[:, :S - 1] = 1.0
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
            transformer.layer_windows(cfg))
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        ce = chunked_softmax_xent(hidden, self._unembed_matrix(params),
                                  labels, mask,
                                  final_softcap=cfg.final_logit_softcap)
        return ce + aux, {"ce": ce, "aux": aux}


def build_model(name_or_cfg, *, device=DEFAULT_DEVICE) -> Model:
    if isinstance(name_or_cfg, str):
        from repro_torch.configs import get_config
        name_or_cfg = get_config(name_or_cfg)
    return Model(name_or_cfg, device=device)
