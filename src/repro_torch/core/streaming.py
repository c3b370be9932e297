"""Streaming, O(T) server-side aggregation sinks.

Port of ``repro.core.streaming``. Each sink holds its accumulator on its
device and folds staged updates in bounded batches, so steady-state
memory is O(T + B*T) whatever the cohort size:

* ``MaskedF32Sink`` — the fp32 secure plane: every ``batch`` staged
  buffers are stacked into one contiguous (B, T) slab, reduced through K1
  (``masked_sum``) and added into a (T,) f32 accumulator. Repair
  corrections fold as negative-weight rows.
* ``ModularSink`` — the masked-quantized integer plane. The accumulator
  is an int64 tensor holding the uint32 wrap-around sum of the residue
  streams: each staged row (kept as its 32-bit pattern in int32) is
  widened to int64, added or subtracted, and the sum is masked back to
  32 bits after each row, which is exactly uint32 arithmetic. The fold is
  plain PyTorch (the reference's is outside Pallas too) and bit-exact
  under any arrival order. ``finalize`` hands K4 the (1, T') 32-bit
  pattern of the accumulator. It costs 8 bytes a column where the
  reference's uint32 accumulator costs 4.
* ``QuantSink`` — the plain int8 plane: batches fold through K3
  (``dequant_reduce``) weighted by raw example counts; per-client norms
  come from the int8 rows on the host in f64, as in the reference.
* ``TopkSink`` — sparse (index, value) adds into a (T,) f32 accumulator.

The protocol-facing wrappers come with them: ``StreamedUpdates`` (the
fold-on-arrival cohort the collect phase hands the aggregator),
``LazyCohort`` and ``LazyView`` (decrypt-on-access board views) and the
``CORRECTIONS_FOLDED`` sentinel of the streamed repair.

Telemetry: a sink records into its ``telemetry`` bundle, or without one
into the bundle in scope (``telemetry.current()``). Each fold runs under
a ``sink.fold`` span whose ``bytes`` are the host bytes it moved onto
the card (also the always-live ``sink.h2d_bytes`` counter, by plane),
each ``finalize`` under ``sink.finalize``, and each flush and each
decode under a ``kernel_span`` (``kernel:<kernel>_stream``): device
spans, timed on the card by CUDA events, so nothing waits for the card
inside them; ``kernel.seconds`` gets each reduction's device time. Each
flush bumps ``agg.stream_fold_batches`` and folds its working-set
high-water mark into the ``agg.accumulator_peak_bytes`` gauge.

Mesh: the fp32, int8 and masked-integer sinks take the reference's
``mesh`` argument, a 1-D ``("shard",)`` aggregation mesh over a device
list in one process (``repro_torch.sharding.agg``; one controller over
several devices, no collective). ``"auto"`` (the default) is
``agg_mesh()``: the visible CUDA devices, ``None`` below two, so on one
card the sinks run the unsplit kernels exactly as before. With a mesh,
``MaskedF32Sink`` and ``QuantSink`` keep their accumulator padded to the
split's width as one slab a shard, each on its device, and each flush
launches K1 / K3 once a slab; ``ModularSink``'s wrap-around fold stays
whole and its decode launches K4 once a slab, as the reference's. The
slabs are gathered on the mesh's first device at ``finalize`` and cut
back to T; every column is reduced by the same kernel as unsplit, so the
result is bitwise the unsplit sink's.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import telemetry as _telemetry
from repro_torch.core.packing import as_f32
from repro_torch.core.secure_agg import u32_bits, u32_from_i64, u32_to_i64
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels.compressed_agg.ops import (CHUNK, dequant_reduce,
                                                    masked_dequant_reduce)
from repro_torch.kernels.secure_agg.ops import masked_sum
from repro_torch.sharding import agg as _shard

_M32 = 0xFFFFFFFF

DEFAULT_STREAM_BATCH = 8

GAUGE_PEAK_BYTES = "agg.accumulator_peak_bytes"
COUNTER_FOLD_BATCHES = "agg.stream_fold_batches"
COUNTER_H2D_BYTES = "sink.h2d_bytes"


def _host_nbytes(x) -> int:
    """Bytes of ``x`` if it lies in host memory (an array or a CPU
    tensor), else 0."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size() if x.device.type == "cpu" else 0
    return int(np.asarray(x).nbytes)


def _note_moved(bundle, span, device, plane: str, nbytes: int) -> None:
    """A fold moved ``nbytes`` of host memory onto ``device`` (none off
    CUDA): the span's ``bytes`` and the ``sink.h2d_bytes`` counter."""
    if device.type != "cuda":
        nbytes = 0
    span.set(bytes=nbytes)
    bundle.metrics.counter(COUNTER_H2D_BYTES, plane=plane).inc(nbytes)


class _CorrectionsFolded:
    """Sentinel: the repair phase already streamed the corrections into
    the pending sink (fold-on-arrival), so the aggregate step must not
    fold them again — but the round still commits as repaired."""

    def __repr__(self):
        return "<corrections already folded>"


CORRECTIONS_FOLDED = _CorrectionsFolded()


def default_mesh():
    """The aggregation mesh of ``mesh="auto"``: the visible CUDA devices,
    or ``None`` with fewer than two."""
    return _shard.agg_mesh()


def _resolve_mesh(mesh):
    return default_mesh() if mesh == "auto" else mesh


def _add_slabs(acc: Optional[list], slabs: list) -> list:
    """The per-shard accumulator plus this flush's per-shard sums (in
    place from the second flush on)."""
    if acc is None:
        return slabs
    for a, s in zip(acc, slabs):
        a.add_(s)
    return acc


class _SinkBase:
    """Shared staging/flush bookkeeping of the streaming sinks."""

    plane = "?"

    def __init__(self, t: int, *, batch: int = DEFAULT_STREAM_BATCH,
                 device=DEFAULT_DEVICE, telemetry=None,
                 run_id: Optional[str] = None, mesh="auto"):
        if t <= 0:
            raise ValueError("sink needs a positive buffer size")
        self.t = int(t)
        self.batch = max(1, int(batch))
        self.device = resolve(device)
        self.mesh = _resolve_mesh(mesh)
        self.telemetry = telemetry
        self.run_id = run_id
        self.n_folded = 0            # net clients folded (unfolds subtract)
        self.fold_batches = 0
        self.peak_bytes = 0
        self._staging: list = []
        self._finalized = False

    # -- telemetry ------------------------------------------------------
    def _bundle(self):
        """The sink's telemetry bundle, else the one in scope."""
        if self.telemetry is not None:
            return self.telemetry
        return _telemetry.current()

    def _span(self, kernel: str):
        """The reduction under ``kernel_span(<kernel>_stream)``, timed on
        the sink's device without waiting for it."""
        return self._bundle().kernel_span(
            f"{kernel}_stream", run_id=self.run_id, device=self.device,
            plane=self.plane, cohort=str(self.n_folded))

    def _note_flush(self, staged_bytes: int):
        self.fold_batches += 1
        self.peak_bytes = max(self.peak_bytes,
                              self.accumulator_bytes + staged_bytes)
        if self.telemetry is not None:
            m = self.telemetry.metrics
            m.counter(COUNTER_FOLD_BATCHES, plane=self.plane).inc()
            g = m.gauge(GAUGE_PEAK_BYTES, plane=self.plane)
            g.set(max(g.read(), self.peak_bytes))

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
        self._note_flush(staged_bytes)

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
        # with a mesh the accumulator is padded to the split's width and
        # kept as one slab a shard for its whole life
        self.tp = t if self.mesh is None else t + _shard._t_pad(
            t, self.mesh.size, _shard.LANE)
        self._acc = None             # allocated by the first flush

    @property
    def accumulator_bytes(self) -> int:
        return 4 * self.tp

    def fold(self, buf, weight: float = 1.0):
        """Stage one (T,) buffer (array or tensor, moved to the sink's
        device) with its weight."""
        bundle = self._bundle()
        with bundle.span("sink.fold", cat="sink",
                         device=self.device) as sp:
            host = _host_nbytes(buf) > 0
            buf = as_f32(buf, self.device).reshape(-1)
            if buf.shape[0] != self.t:
                raise ValueError(
                    f"buffer size {buf.shape[0]} != sink size {self.t}")
            self._stage((buf, float(weight)))
            self.n_folded += 1 if weight > 0 else -1
            _note_moved(bundle, sp, self.device, self.plane,
                        4 * buf.numel() if host else 0)

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
        with self._span("masked_sum"):
            if self.mesh is not None:
                self._acc = _add_slabs(self._acc, _shard.masked_sum_slabs(
                    x, ws, mesh=self.mesh))
                return
            s = masked_sum(x, ws)
            if self._acc is None:
                self._acc = s
            else:
                # in place: the reference's donated ``jax.jit`` add
                # (``acc + s`` with ``donate_argnums=0``) reuses the
                # accumulator buffer; ``add_`` is the same thing eagerly
                self._acc.add_(s)

    def finalize(self) -> torch.Tensor:
        """Flush what is staged; the (T,) fp32 sum on the sink's device
        (with a mesh, on its first device)."""
        with self._bundle().span("sink.finalize", cat="sink",
                                  device=self.device):
            self._flush()
            self._finalized = True
            if self._acc is None:
                return torch.zeros(self.t, dtype=torch.float32,
                                   device=self.device)
            if self.mesh is not None:
                return _shard.gather(self._acc, self.t)
            return self._acc


class ModularSink(_SinkBase):
    """Streaming twin of ``compression.reduce_masked``: folds residue
    streams mod M = 2**mbits with wrap-around adds (bit-exact under any
    fold order), subtracts integer repair corrections mod M, and decodes
    once through K4 (``masked_dequant_reduce``) at finalize."""

    plane = "masked_int"

    def __init__(self, t: int, *, mbits: int, grid: float, **kw):
        super().__init__(t, **kw)
        self.mbits = int(mbits)
        self.grid = float(grid)
        self.tp = t + (-t) % CHUNK   # decode needs CHUNK-aligned columns
        self._acc = torch.zeros(self.tp, dtype=torch.int64,
                                device=self.device)

    @property
    def accumulator_bytes(self) -> int:
        return 8 * self.tp

    def _pad(self, z) -> torch.Tensor:
        """A wire stream (length t or the CHUNK-padded tp, uint16 or
        uint32) as a (tp,) int32 bit-pattern tensor on the sink's
        device."""
        z = u32_bits(z, self.device).reshape(-1)
        if z.shape[0] not in (self.t, self.tp):
            raise ValueError(
                f"residue stream size {z.shape[0]} != sink size {self.t}")
        if z.shape[0] != self.tp:
            z = torch.nn.functional.pad(z, (0, self.tp - z.shape[0]))
        return z

    def fold(self, z):
        self._fold_row(z, False, 1)

    def unfold(self, z):
        self._fold_row(z, True, -1)

    def fold_correction(self, z):
        """Modular subtraction of a survivor's integer repair stream."""
        self._fold_row(z, True, 0)

    def unfold_correction(self, z):
        """Modular re-add of a correction that became stale."""
        self._fold_row(z, False, 0)

    def _fold_row(self, z, subtract: bool, members: int):
        """Stage ``z`` to be added (or subtracted) mod 2**32; ``members``
        is its change to the cohort count."""
        bundle = self._bundle()
        with bundle.span("sink.fold", cat="sink",
                         device=self.device) as sp:
            moved = _host_nbytes(z)
            self._stage((self._pad(z), subtract))
            self.n_folded += members
            _note_moved(bundle, sp, self.device, self.plane, moved)

    def _row_bytes(self, item) -> int:
        return item[0].numel() * 4

    def _reduce(self, staged):
        with self._span("modular_sum"):
            for z, subtract in staged:
                row = u32_to_i64(z)
                if subtract:
                    self._acc.sub_(row)
                else:
                    self._acc.add_(row)
                self._acc.bitwise_and_(_M32)

    def finalize(self) -> torch.Tensor:
        """Flush; the (t,) f32 decoded cohort sum on the sink's device."""
        with self._bundle().span("sink.finalize", cat="sink",
                                  device=self.device):
            self._flush()
            self._finalized = True
            scales = torch.full((self.tp // CHUNK,), self.grid,
                                dtype=torch.float32, device=self.device)
            z = u32_from_i64(self._acc).reshape(1, self.tp)
            with self._span("masked_dequant_reduce"):
                if self.mesh is not None:
                    out = _shard.sharded_masked_dequant_reduce(
                        z, scales, modulus_bits=self.mbits, mesh=self.mesh)
                else:
                    out = masked_dequant_reduce(z, scales,
                                                modulus_bits=self.mbits)
            return out[:self.t]


class QuantSink(_SinkBase):
    """Streaming twin of the int8 branch of ``compression.
    reduce_compressed``: folds (q, scales) wire pairs weighted by raw
    example counts through K3; ``finalize()`` returns the weighted *sum*
    (divide by ``total_weight`` for the mean), ``norms`` the per-client
    l2 norms."""

    plane = "compressed_int8"

    def __init__(self, t: int, **kw):
        super().__init__(t, **kw)
        self.tp = t + (-t) % CHUNK
        self._acc: Optional[torch.Tensor] = None
        self.total_weight = 0.0
        self.norms: Dict[str, float] = {}

    @property
    def accumulator_bytes(self) -> int:
        return 4 * self.tp

    def fold(self, cid: str, q, scales, weight: float):
        """Stage one client's decoded int8 wire stream with its per-chunk
        scales and weight; both go to the sink's device."""
        bundle = self._bundle()
        with bundle.span("sink.fold", cat="sink",
                         device=self.device) as sp:
            q = np.asarray(q, np.int8).reshape(-1)
            if q.shape[0] != self.t:
                raise ValueError(f"quantized stream size {q.shape[0]} != "
                                 f"sink size {self.t}")
            if self.tp != self.t:
                q = np.pad(q, (0, self.tp - self.t))
            scales = np.asarray(scales, np.float32).reshape(-1)
            # ||deq||^2 from per-chunk energies of the int8 row, on the
            # host in f64 as the reference computes it (f32 squares are
            # exact: |q| <= 127 keeps a chunk's squared sum < 2**24)
            qsq = (q.astype(np.float32) ** 2).reshape(-1, CHUNK).sum(
                -1, dtype=np.float64)
            self.norms[cid] = float(
                np.sqrt((qsq * scales.astype(np.float64) ** 2).sum()))
            self._stage((torch.from_numpy(np.require(q, requirements="W"))
                         .to(self.device),
                         torch.from_numpy(np.require(scales,
                                                     requirements="W"))
                         .to(self.device),
                         float(weight)))
            self.total_weight += float(weight)
            self.n_folded += 1 if weight > 0 else -1
            _note_moved(bundle, sp, self.device, self.plane,
                        q.nbytes + scales.nbytes)

    def unfold(self, cid: str, q, scales, weight: float):
        self.fold(cid, q, scales, -weight)
        self.norms.pop(cid, None)

    def _row_bytes(self, item) -> int:
        return item[0].numel() + item[1].numel() * 4

    def _reduce(self, staged):
        q = torch.stack([s[0] for s in staged])          # (B, tp) int8
        scales = torch.stack([s[1] for s in staged])
        ws = torch.tensor([s[2] for s in staged], dtype=torch.float32,
                          device=self.device)
        with self._span("dequant_reduce"):
            if self.mesh is not None:
                self._acc = _add_slabs(self._acc, _shard.dequant_reduce_slabs(
                    q, scales, ws, mesh=self.mesh))
                return
            s = dequant_reduce(q, scales, ws)
            if self._acc is None:
                self._acc = s
            else:
                self._acc.add_(s)

    def finalize(self) -> torch.Tensor:
        with self._bundle().span("sink.finalize", cat="sink",
                                  device=self.device):
            self._flush()
            self._finalized = True
            if self._acc is None:
                return torch.zeros(self.t, dtype=torch.float32,
                                   device=self.device)
            if self.mesh is not None:
                return _shard.gather(self._acc, self.t)
            return self._acc[:self.t]


class TopkSink:
    """Sparse top-k accumulator: weighted (index, value) adds into a (T,)
    f32 tensor on ``device`` (a message's indices are unique)."""

    plane = "compressed_topk"

    def __init__(self, t: int, *, device=DEFAULT_DEVICE, **_kw):
        self.t = int(t)
        self.device = resolve(device)
        self._acc = torch.zeros(self.t, dtype=torch.float32,
                                device=self.device)
        self.total_weight = 0.0
        self.norms: Dict[str, float] = {}
        self.n_folded = 0
        self.fold_batches = 0
        self.peak_bytes = 4 * self.t

    @property
    def accumulator_bytes(self) -> int:
        return 4 * self.t

    def fold(self, cid: str, idx, val, weight: float):
        bundle = _telemetry.current()
        with bundle.span("sink.fold", cat="sink",
                         device=self.device) as sp:
            val = np.require(val, np.float32, "W")
            idx = np.require(idx, requirements="W")
            moved = val.nbytes + idx.nbytes
            val = torch.from_numpy(val).to(self.device)
            idx = torch.from_numpy(idx).to(self.device, torch.int64)
            self._acc[idx] += torch.tensor(weight, dtype=torch.float32) * val
            self.norms[cid] = float(torch.linalg.vector_norm(
                val.to(torch.float64)))
            self.total_weight += float(weight)
            self.n_folded += 1
            self.fold_batches += 1
            _note_moved(bundle, sp, self.device, self.plane, moved)

    def unfold(self, cid: str, idx, val, weight: float):
        self.fold(cid, idx, val, -weight)
        self.norms.pop(cid, None)
        self.n_folded -= 2           # the fold() above counted +1; net -1

    def finalize(self) -> torch.Tensor:
        with _telemetry.current().span("sink.finalize", cat="sink",
                                       device=self.device):
            return self._acc


def _masked_contract(m: dict, expect: Optional[tuple]) -> tuple:
    got = (int(m["size"]), int(m["mbits"]), float(m["grid"]))
    if m.get("scheme") != "masked_int8":
        raise ValueError("reduce_masked needs masked_int8 wire dicts")
    if expect is not None and got != expect:
        raise ValueError(
            "masked updates disagree on the shared coding contract "
            "(size / mask modulus / quantization grid)")
    return got


def stream_reduce_masked(msgs: Iterable[dict], *, corrections=None,
                         batch: int = DEFAULT_STREAM_BATCH,
                         device=DEFAULT_DEVICE, telemetry=None,
                         run_id: Optional[str] = None,
                         mesh="auto") -> torch.Tensor:
    """Streaming ``compression.reduce_masked``: contract checks, then the
    (T,) f32 decoded sum, bit-exact whatever the order. ``corrections``
    is an iterable aligned with ``msgs`` (or None)."""
    dev = resolve(device)
    sink = None
    contract = None
    corr_iter = iter(corrections) if corrections is not None else None
    n = 0
    for m in msgs:
        contract = _masked_contract(m, contract)
        if sink is None:
            t, mbits, grid = contract
            sink = ModularSink(t, mbits=mbits, grid=grid, batch=batch,
                               device=dev, telemetry=telemetry,
                               run_id=run_id, mesh=mesh)
        sink.fold(m["z"])
        if corr_iter is not None:
            try:
                sink.fold_correction(next(corr_iter))
            except StopIteration:
                raise ValueError(
                    "repair corrections do not match the masked stream "
                    "count") from None
        n += 1
    if sink is None:
        raise ValueError("no masked updates to reduce")
    if corr_iter is not None:
        leftover = sum(1 for _ in corr_iter)
        if leftover:
            raise ValueError(
                f"{leftover} repair corrections do not match the masked "
                f"stream count {n}")
    return sink.finalize()


def stream_reduce_compressed(msgs: Iterable[dict], weights, *,
                             return_norms: bool = False,
                             batch: int = DEFAULT_STREAM_BATCH,
                             device=DEFAULT_DEVICE, telemetry=None,
                             run_id: Optional[str] = None, mesh="auto"):
    """Streaming ``compression.reduce_compressed``: weights are used as
    given, norms ride along per fold; ``weights`` is indexable and
    aligned with the iteration order of ``msgs``."""
    from repro_torch.core.compression import quantized_values
    dev = resolve(device)
    sink = None
    w = np.asarray(weights, np.float32)
    t = None
    scheme = None
    i = 0
    for m in msgs:
        if scheme is None:
            scheme, t = m["scheme"], int(m["size"])
        if m["scheme"] != scheme:
            raise ValueError(
                f"mixed compression schemes in one cohort: "
                f"{sorted({scheme, m['scheme']})}")
        if int(m["size"]) != t:
            raise ValueError("compressed updates disagree on buffer size")
        if scheme == "topk":
            if sink is None:
                sink = TopkSink(t, device=dev)
            sink.fold(str(i), m["idx"], m["val"], w[i])
        else:
            if sink is None:
                sink = QuantSink(t, batch=batch, device=dev,
                                 telemetry=telemetry, run_id=run_id,
                                 mesh=mesh)
            sink.fold(str(i), quantized_values(m), m["scales"], w[i])
        i += 1
    if sink is None:
        raise ValueError("no compressed updates to reduce")
    out = sink.finalize()
    if not return_norms:
        return out
    return out, [sink.norms[str(j)] for j in range(i)]


def stream_masked_packed(buffers: Iterable, weights: Optional[Sequence]
                         = None, *, corrections=None,
                         batch: int = DEFAULT_STREAM_BATCH,
                         device=DEFAULT_DEVICE, telemetry=None,
                         run_id: Optional[str] = None,
                         mesh="auto") -> torch.Tensor:
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
                                 device=device, telemetry=telemetry,
                                 run_id=run_id, mesh=mesh)
        sink.fold(b, w[i])
        if corr_iter is not None:
            sink.fold_correction(next(corr_iter), w[i])
    if sink is None:
        raise ValueError("no masked buffers to reduce")
    return sink.finalize()


# ---------------------------------------------------------------------------
# protocol-facing wrappers: fold-on-arrival cohorts and lazy board views
# (copies of the reference's)
# ---------------------------------------------------------------------------
class LazyView:
    """Read-through view over a lazily-decrypted cohort mapping: each
    ``view[cid]`` decrypts that client's payload *now* and extracts one
    key — nothing is cached, so a batched fold loop holds at most one
    decrypted payload per staged row."""

    def __init__(self, msgs, key: str):
        self._msgs = msgs
        self._key = key

    def __getitem__(self, cid):
        return self._msgs[cid][self._key]

    def __iter__(self):
        return iter(self._msgs)

    def __len__(self):
        return len(self._msgs)

    def __contains__(self, cid):
        return cid in self._msgs

    def keys(self):
        return self._msgs.keys()


class StreamedUpdates:
    """The ``updates`` mapping ``_aggregate_and_advance`` receives when
    the collect phase folded the cohort on arrival: cids map to the
    opaque sink (the buffers themselves are gone — that is the point).
    Supports the mapping surface the server/protocol layer touches
    (membership, iteration, len) and ``restrict_to`` for mid-repair
    dropouts."""

    def __init__(self, sink, plane: str):
        self.sink = sink
        self.plane = plane
        self._cids: Dict[str, bool] = {}

    def note_folded(self, cid: str):
        self._cids[cid] = True

    def __iter__(self):
        return iter(self._cids)

    def __len__(self):
        return len(self._cids)

    def __contains__(self, cid):
        return cid in self._cids

    def keys(self):
        return self._cids.keys()

    def __getitem__(self, cid):
        if cid not in self._cids:
            raise KeyError(cid)
        return self.sink                 # opaque handle; already folded

    def restrict_to(self, cohort, refetch: Callable[[str], object]):
        """Unfold members that dropped after being folded: ``refetch``
        returns the client's original heavy payload from the board (still
        posted — round GC runs at commit), and the sink backs it out."""
        for cid in [c for c in self._cids if c not in set(cohort)]:
            payload = refetch(cid)
            if self.plane == "masked_int":
                self.sink.unfold(payload["z"])
            else:
                self.sink.unfold(payload)
            del self._cids[cid]


class LazyCohort:
    """Decrypt-on-access cohort mapping: ``mapping[cid]`` runs
    ``comm.collect`` *at access time* instead of eagerly materializing
    every decrypted payload. ``_poll_cohort(..., lazy=True)`` returns
    this so the repair fold can stream corrections one batch at a time —
    the O(N x T) dict of decrypted correction buffers never exists."""

    def __init__(self, comm, paths: Dict[str, str]):
        self._comm = comm
        self._paths = dict(paths)

    def __getitem__(self, cid):
        msg = self._comm.collect(self._paths[cid], cid)
        if msg is None:
            raise KeyError(cid)
        return msg

    def __iter__(self):
        return iter(self._paths)

    def __len__(self):
        return len(self._paths)

    def __contains__(self, cid):
        return cid in self._paths

    def keys(self):
        return self._paths.keys()
