"""Negotiated lossy update compression: the compressed and the
masked-quantized (composable-privacy) data planes.

A copy of ``repro.core.compression``. The coding side is numpy, as in
the reference, so the wire dicts are bitwise equal to the reference's for
the same inputs and seeds: the stochastic rounding and the DP noise draw
from numpy ``default_rng`` streams, and the int8 stream rides zlib.

``topk``  — keep the ``ratio`` fraction of largest-|x| coordinates as
    sorted (int32 index, f32 value) pairs.
``int8``  — one symmetric f32 scale per ``CHUNK`` (1024) values (or a
    fixed ``grid``), stochastic rounding floor(x/s + u), zlib level 6.
``masked_int8`` — the fixed cohort grid, optional integer-domain DP
    noise, then this client's pairwise residues mod 2**mbits
    (``secure_agg.int_mask_offset``, computed on ``device``); the wire is
    the raw uint16/uint32 residue stream.

Error feedback keeps ``residual = target - decompress(compress(target))``
per client, so compression delays mass and never drops it.

The server side reduces through the streaming sinks
(``core/streaming.py``): int8 cohorts through K3 (``QuantSink``), masked
cohorts through the modular fold and K4 (``ModularSink``), top-k by a
scatter-add on the device. The reduces return tensors on ``device``.
"""
from __future__ import annotations

import hashlib
import math
import zlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.secure_agg import int_mask_offset, mask_modulus_bits
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.kernels.compressed_agg.ref import CHUNK

SCHEMES = ("none", "topk", "int8")

# cohort-common fixed quantization grid half-range for masked int8 rounds
DEFAULT_QUANT_RANGE = 0.02


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def _host_f32(buf) -> np.ndarray:
    """A packed buffer (array or tensor on any device) as a flat host f32
    array: the coding below is numpy."""
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().to("cpu", torch.float32).numpy()
    return np.asarray(buf, np.float32).reshape(-1)


def compress(buf, scheme: str, *, ratio: float = 0.1, bits: int = 8,
             rng: Optional[np.random.Generator] = None,
             grid: float = 0.0) -> Dict:
    """Compress a packed (T,) fp32 buffer into a wire dict. ``grid > 0``
    pins the int8 path to a fixed quantization step (the masked plane's
    plain twin)."""
    x = _host_f32(buf)
    t = x.size
    if scheme == "topk":
        k = max(1, int(round(ratio * t)))
        idx = np.argpartition(np.abs(x), t - k)[t - k:]
        idx = np.sort(idx).astype(np.int32)
        return {"scheme": "topk", "size": t, "idx": idx,
                "val": x[idx].astype(np.float32)}
    if scheme == "int8":
        qmax = _qmax(int(bits))
        pad = (-t) % CHUNK
        xp = np.pad(x, (0, pad)).reshape(-1, CHUNK)
        if grid and grid > 0:
            scales = np.full(xp.shape[0], np.float32(grid), np.float32)
        else:
            scales = (np.abs(xp).max(axis=1) / qmax
                      + 1e-12).astype(np.float32)
        y = xp / scales[:, None]
        u = (rng.random(y.shape, np.float32) if rng is not None
             else np.full_like(y, 0.5))          # no rng: round-to-nearest
        q = np.clip(np.floor(y + u), -qmax, qmax).astype(np.int8)
        return {"scheme": "int8", "size": t, "bits": int(bits),
                "qz": zlib.compress(q.reshape(-1)[:t].tobytes(), 6),
                "scales": scales}
    raise KeyError(f"unknown compression scheme {scheme!r}; "
                   f"known: {SCHEMES[1:]}")


def masked_compress(buf, *, bits: int = 8, grid: float,
                    client_id: str, cohort: Sequence[str],
                    pair_secret: bytes,
                    rng: Optional[np.random.Generator] = None,
                    dp_sigma: float = 0.0,
                    dp_rng: Optional[np.random.Generator] = None,
                    device=DEFAULT_DEVICE):
    """Masked-quantized wire coding: fixed-grid quantize, optional
    integer-domain DP noise, widen, add this client's pairwise residues
    mod 2**mbits. Returns ``(msg, deq)``, ``deq`` the (T,) f32
    dequantization of the clean (pre-noise, pre-mask) stream. The mask
    offset is computed on ``device``; the rest is numpy."""
    x = _host_f32(buf)
    t = x.size
    qmax = _qmax(int(bits))
    pad = (-t) % CHUNK
    xp = np.pad(x, (0, pad))
    y = xp / np.float32(grid)
    u = (rng.random(y.shape, np.float32) if rng is not None
         else np.full_like(y, 0.5))
    q = np.clip(np.floor(y + u), -qmax, qmax).astype(np.int32)
    deq = (q[:t].astype(np.float32)) * np.float32(grid)
    if dp_sigma and dp_sigma > 0:
        if dp_rng is None:
            raise ValueError("dp_sigma > 0 needs a dp_rng")
        noise = np.rint(dp_rng.normal(0.0, float(dp_sigma) / float(grid),
                                      q.shape)).astype(np.int64)
        q = np.clip(q.astype(np.int64) + noise,
                    -2 * qmax, 2 * qmax).astype(np.int32)
    mbits = mask_modulus_bits(len(cohort), bits)
    offset = int_mask_offset(q.size, client_id, cohort, pair_secret, mbits,
                             device=device)
    offset = offset.view(torch.int32).cpu().numpy().view(np.uint32)
    maskval = np.uint32((1 << mbits) - 1)
    z = (q.astype(np.uint32) + offset) & maskval   # int32 wrap = mod 2**32
    wire_dtype = np.uint16 if mbits <= 16 else np.uint32
    msg = {"scheme": "masked_int8", "size": t, "bits": int(bits),
           "mbits": int(mbits), "grid": float(grid),
           "z": z.astype(wire_dtype)}
    return msg, deq


def quantized_values(msg: Dict) -> np.ndarray:
    """Entropy-decode an int8 wire dict's quantized stream -> (T,) int8."""
    return np.frombuffer(zlib.decompress(msg["qz"]), np.int8)


def decompress(msg: Dict) -> np.ndarray:
    """Invert ``compress`` up to the lossy step: wire dict -> (T,) f32."""
    t = int(msg["size"])
    if msg["scheme"] == "masked_int8":
        raise ValueError(
            "a masked_int8 wire dict cannot be decompressed on its own: "
            "individual streams carry uncancelled pairwise masks; decode a "
            "full cohort via reduce_masked")
    if msg["scheme"] == "topk":
        out = np.zeros(t, np.float32)
        out[np.asarray(msg["idx"], np.int64)] = np.asarray(msg["val"],
                                                           np.float32)
        return out
    if msg["scheme"] == "int8":
        pad = (-t) % CHUNK
        qp = np.pad(quantized_values(msg),
                    (0, pad)).astype(np.float32).reshape(-1, CHUNK)
        return (qp * np.asarray(msg["scales"],
                                np.float32)[:, None]).reshape(-1)[:t]
    raise KeyError(f"unknown compression scheme {msg['scheme']!r}")


def wire_bytes(msg: Dict) -> int:
    """Nominal payload bytes of a wire dict (array bytes only)."""
    if msg["scheme"] == "topk":
        return msg["idx"].nbytes + msg["val"].nbytes
    if msg["scheme"] == "masked_int8":
        return msg["z"].nbytes        # uniform residues: no entropy coding
    return len(msg["qz"]) + msg["scales"].nbytes


def update_norm(msg: Dict) -> float:
    """l2 norm of one wire dict's decompressed delta."""
    if msg["scheme"] == "topk":
        return float(np.linalg.norm(np.asarray(msg["val"], np.float64)))
    if msg["scheme"] == "masked_int8":
        raise ValueError(
            "masked_int8 wire dicts carry no recoverable per-client "
            "norm: the stream is pairwise-masked")
    return float(np.linalg.norm(decompress(msg).astype(np.float64)))


def reduce_compressed(msgs: Sequence[Dict], weights: Sequence[float], *,
                      return_norms: bool = False, device=DEFAULT_DEVICE):
    """``sum_i weights_i * decompress(msg_i)`` as a (T,) f32 tensor on
    ``device``, streamed through ``QuantSink`` (K3) or ``TopkSink``.
    Weights are used as given. ``return_norms=True`` also returns each
    client's l2 delta norm."""
    from repro_torch.core import streaming
    return streaming.stream_reduce_compressed(
        msgs, weights, return_norms=return_norms, device=device)


def reduce_masked(msgs: Sequence[Dict], *,
                  corrections: Optional[Sequence] = None,
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """Decode a masked cohort's wire messages -> dense (T,) f32 *sum* on
    ``device``, through ``ModularSink`` (modular fold, then K4). Bit-exact
    under any arrival order. ``corrections``: per-survivor integer repair
    streams aligned with ``msgs``, subtracted mod M."""
    from repro_torch.core import streaming
    return streaming.stream_reduce_masked(msgs, corrections=corrections,
                                          device=device)


def dp_sigma_total(epsilon: float, delta: float, clip: float) -> float:
    """Gaussian-mechanism noise std for one round's cohort sum:
    ``clip * sqrt(2 ln(1.25/delta)) / epsilon``."""
    if epsilon <= 0:
        raise ValueError("dp_epsilon must be > 0")
    if not 0 < delta < 1:
        raise ValueError("dp_delta must be in (0, 1)")
    return float(clip) * math.sqrt(2.0 * math.log(1.25 / float(delta))) \
        / float(epsilon)


class ErrorFeedback:
    """Client-side error-feedback compressor state (one per run).

    ``step(delta)`` compresses ``delta + residual`` and keeps the new
    residual; ``step_masked`` is its masked twin (pre-scale by the FedAvg
    weight, optional DP clip, fixed-grid quantize, optional DP noise,
    mask), whose residual absorbs clip and quantization error only, never
    the DP noise. ``device`` is where ``step_masked`` computes the mask
    offsets.
    """

    def __init__(self, scheme: str, *, ratio: float = 0.1, bits: int = 8,
                 seed: int = 0, quant_range: float = 0.0,
                 dp: Optional[Dict] = None, dp_seed: int = 0,
                 device=DEFAULT_DEVICE):
        if scheme not in SCHEMES or scheme == "none":
            raise ValueError(f"ErrorFeedback needs a lossy scheme, "
                             f"got {scheme!r}")
        self.scheme = scheme
        self.ratio = float(ratio)
        self.bits = int(bits)
        self.quant_range = float(quant_range)
        self.dp = dict(dp) if dp else None
        self.rng = np.random.default_rng(seed)
        self.dp_rng = np.random.default_rng(dp_seed)
        self.residual: Optional[np.ndarray] = None
        self.device = device

    @property
    def grid(self) -> float:
        qr = self.quant_range or DEFAULT_QUANT_RANGE
        return qr / _qmax(self.bits)

    def reset(self):
        self.residual = None

    def step(self, delta) -> Dict:
        target = _host_f32(delta)
        if self.residual is not None:
            target = target + self.residual
        msg = compress(target, self.scheme, ratio=self.ratio,
                       bits=self.bits, rng=self.rng,
                       grid=(self.grid if self.scheme == "int8"
                             and self.quant_range > 0 else 0.0))
        self.residual = target - decompress(msg)
        return msg

    def step_masked(self, delta, *, weight: float, client_id: str,
                    cohort: Sequence[str], pair_secret: bytes) -> Dict:
        target = _host_f32(delta)
        if self.residual is not None:
            target = target + self.residual
        w = float(weight) or 1.0
        buf = w * target
        dp_sigma = 0.0
        if self.dp is not None:
            nrm = float(np.linalg.norm(buf.astype(np.float64)))
            clip = float(self.dp["clip"])
            if nrm > clip:
                buf = buf * np.float32(clip / nrm)
            dp_sigma = float(self.dp["sigma_total"]) \
                / math.sqrt(max(1, len(cohort)))
        msg, deq = masked_compress(
            buf, bits=self.bits, grid=self.grid, client_id=client_id,
            cohort=cohort, pair_secret=pair_secret, rng=self.rng,
            dp_sigma=dp_sigma, dp_rng=self.dp_rng, device=self.device)
        self.residual = target - deq / np.float32(w)
        return msg


def make_error_feedback(job, noise_id: str, *,
                        device=DEFAULT_DEVICE) -> ErrorFeedback:
    """EF compressor for a job's negotiated scheme, seeded per silo from
    its stable identity ``noise_id``. ``job`` is duck-typed: it needs
    ``compression``, ``compression_ratio`` and ``quant_bits``, and may
    carry ``quant_range`` and ``dp_epsilon`` (with ``dp_delta``,
    ``dp_clip``, ``dp_seed``)."""
    seed = int.from_bytes(
        hashlib.sha256(noise_id.encode()).digest()[:8], "little")
    dp = None
    dp_seed = 0
    if getattr(job, "dp_epsilon", 0.0) > 0:
        dp = {"epsilon": job.dp_epsilon, "delta": job.dp_delta,
              "clip": job.dp_clip,
              "sigma_total": dp_sigma_total(job.dp_epsilon, job.dp_delta,
                                            job.dp_clip)}
        dp_seed = int.from_bytes(
            hashlib.sha256(f"{job.dp_seed}/{noise_id}".encode()
                           ).digest()[:8], "little")
    return ErrorFeedback(job.compression, ratio=job.compression_ratio,
                         bits=job.quant_bits, seed=seed,
                         quant_range=getattr(job, "quant_range", 0.0),
                         dp=dp, dp_seed=dp_seed, device=device)
