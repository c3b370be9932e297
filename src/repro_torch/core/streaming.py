"""Streaming, O(T) server-side aggregation of the fp32 secure plane.

Port of ``repro.core.streaming``'s ``MaskedF32Sink`` and
``stream_masked_packed``. The sink holds one (T,) fp32 accumulator on its
device; every ``batch`` staged buffers are stacked into one contiguous
(B, T) slab, reduced through K1 (``masked_sum``) and added into the
accumulator, so steady-state memory is O(T + B*T) whatever the cohort
size. Repair corrections fold as negative-weight rows.

Not ported yet: the mesh (T split across devices, ``sharding/agg.py``)
and the telemetry spans, which come with the control plane. The sink
keeps ``fold_batches`` and ``peak_bytes``.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.packing import as_f32
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels.secure_agg.ops import masked_sum

DEFAULT_STREAM_BATCH = 8


class _SinkBase:
    """Shared staging/flush bookkeeping of the streaming sinks."""

    plane = "?"

    def __init__(self, t: int, *, batch: int = DEFAULT_STREAM_BATCH,
                 device=DEFAULT_DEVICE):
        if t <= 0:
            raise ValueError("sink needs a positive buffer size")
        self.t = int(t)
        self.batch = max(1, int(batch))
        self.device = resolve(device)
        self.n_folded = 0            # net clients folded (unfolds subtract)
        self.fold_batches = 0
        self.peak_bytes = 0
        self._staging: list = []
        self._finalized = False

    @property
    def accumulator_bytes(self) -> int:
        raise NotImplementedError

    def _stage(self, item):
        if self._finalized:
            raise RuntimeError("sink already finalized")
        self._staging.append(item)
        if len(self._staging) >= self.batch:
            self._flush()

    def _flush(self):
        if not self._staging:
            return
        staged, self._staging = self._staging, []
        staged_bytes = sum(self._row_bytes(s) for s in staged)
        self._reduce(staged)
        self.fold_batches += 1
        self.peak_bytes = max(self.peak_bytes,
                              self.accumulator_bytes + staged_bytes)

    def _row_bytes(self, item) -> int:
        raise NotImplementedError

    def _reduce(self, staged):
        raise NotImplementedError

    def finalize(self):
        raise NotImplementedError


class MaskedF32Sink(_SinkBase):
    """Streaming twin of ``secure_agg.aggregate_masked_packed``: folds (T,)
    fp32 masked buffers (weight +1) and repair corrections (weight -1)
    into one (T,) f32 accumulator. ``finalize()`` returns the cohort
    *sum*; the caller divides by the survivors' total pre-scaled weight."""

    plane = "masked_f32"

    def __init__(self, t: int, **kw):
        super().__init__(t, **kw)
        self._acc: Optional[torch.Tensor] = None   # allocated by 1st flush

    @property
    def accumulator_bytes(self) -> int:
        return 4 * self.t

    def fold(self, buf, weight: float = 1.0):
        """Stage one (T,) buffer (array or tensor, moved to the sink's
        device) with its weight."""
        buf = as_f32(buf, self.device).reshape(-1)
        if buf.shape[0] != self.t:
            raise ValueError(
                f"buffer size {buf.shape[0]} != sink size {self.t}")
        self._stage((buf, float(weight)))
        self.n_folded += 1 if weight > 0 else -1

    def unfold(self, buf, weight: float = 1.0):
        """Back a folded client out (mid-repair dropout)."""
        self.fold(buf, -weight)

    def fold_correction(self, buf, weight: float = 1.0):
        """sum_i w_i*(x_i - c_i) == sum_i w_i*x_i - sum_i w_i*c_i: the
        repair subtraction as a negative-weight fold."""
        n = self.n_folded
        self.fold(buf, -weight)
        self.n_folded = n            # corrections are not cohort members

    def unfold_correction(self, buf, weight: float = 1.0):
        """Back out a correction that became stale."""
        self.fold_correction(buf, -weight)

    def _row_bytes(self, item) -> int:
        return item[0].numel() * 4

    def _reduce(self, staged):
        x = torch.stack([b for b, _ in staged])      # contiguous (B, T)
        ws = torch.tensor([w for _, w in staged], dtype=torch.float32,
                          device=self.device)
        s = masked_sum(x, ws)
        if self._acc is None:
            self._acc = s
        else:
            # in place: the reference's donated ``jax.jit`` add
            # (``acc + s`` with ``donate_argnums=0``) reuses the
            # accumulator buffer; ``add_`` is the same thing eagerly
            self._acc.add_(s)

    def finalize(self) -> torch.Tensor:
        """Flush what is staged; the (T,) fp32 sum on the sink's device."""
        self._flush()
        self._finalized = True
        if self._acc is None:
            return torch.zeros(self.t, dtype=torch.float32,
                               device=self.device)
        return self._acc


def stream_masked_packed(buffers: Iterable, weights: Optional[Sequence]
                         = None, *, corrections=None,
                         batch: int = DEFAULT_STREAM_BATCH,
                         device=DEFAULT_DEVICE) -> torch.Tensor:
    """Streaming ``secure_agg.aggregate_masked_packed``: same defaults
    (uniform mean when ``weights`` is None, else the weights as given),
    corrections fold as negative-weight rows."""
    bufs = buffers
    if weights is None:
        bufs = list(bufs)            # the uniform mean needs the count
        if not bufs:
            raise ValueError("no masked buffers to reduce")
        weights = np.full((len(bufs),), 1.0 / len(bufs), np.float32)
    w = np.asarray(weights, np.float32)
    corr_iter = iter(corrections) if corrections is not None else None
    sink = None
    for i, b in enumerate(bufs):
        if sink is None:
            sink = MaskedF32Sink(int(np.prod(b.shape)), batch=batch,
                                 device=device)
        sink.fold(b, w[i])
        if corr_iter is not None:
            sink.fold_correction(next(corr_iter), w[i])
    if sink is None:
        raise ValueError("no masked buffers to reduce")
    return sink.finalize()
