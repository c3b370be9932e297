"""Federation flight recorder: tracing, metrics, trace export (§VII).

The paper's production claim is *"traceability of governance decisions
and tracking of training processes"* — and Kuo et al. argue that what
real cross-silo deployments lack is exactly this operational tooling.
The repo had five disconnected ``stats`` dicts (MessageBoard, Transport,
ClientCommunicator, FederationScheduler, WanModel) and a provenance
chain, but no way to answer *"where did round 7 of run X spend its time,
and on which silo's link?"*. This module is that instrument panel
(DESIGN.md §Observability), three pieces behind one ``Telemetry`` bundle:

* **Span tracer** — nested spans opened by the scheduler (pass / admit /
  preempt), the server's protocol phases (one span per phase *visit*,
  opened on enter and closed on the transition out, however many ticks
  that takes), client agents (fetch / train / compress / post) and the
  board's per-RPC transport calls. Every span is stamped with BOTH the
  wall clock and — when a :class:`~repro_torch.core.transport.WanModel` is
  attached — the acting actor's *simulated* clock, so a trace of a
  simulated-WAN bench explains where the simulated seconds went, not
  just the host seconds.
* **Metrics registry** — one ``Counter`` / ``Gauge`` / ``Histogram`` API
  with labeled series (per-run, per-silo, per-scheme). The components'
  legacy ``stats`` dicts are now *views* assembled from registry
  counters (``MessageBoard.stats``, ``FederationScheduler.stats``), so
  a snapshot really is a snapshot — nothing the caller holds mutates
  under it. ``snapshot()``/``diff()`` support windowed readings;
  ``kernel_span`` feeds the ``kernel.seconds`` histogram around the
  CUDA secure_agg / compressed_agg reductions.
* **Flight recorder** — a bounded ring of recent spans per run, dumped
  into ``incidents`` on failure/pause, and exportable as Chrome-trace /
  Perfetto JSON (``export_trace``). ``anchor_trace`` records the
  canonical trace digest (never the payload) on the MetadataStore
  provenance chain, so an exported timeline is tamper-evident like
  every other governance artifact.

Device time. A span opened with ``device=`` a CUDA device records a
pair of timing events (``torch.cuda.Event``, from a pool) on that
device's current stream at enter and at exit, and never waits for the
card inside the span: ``Span.device_s`` resolves the pair when it is
read, waiting for the end event then. Off CUDA it is the host duration.
The host stamps stay on ``time.perf_counter``.

The hot path. The data plane and the models (the train step, pack and
mask, the sinks, the outer step, prefill and decode) record into
``current()``: the bundle a caller put in scope with ``scope(tel)`` (an
``FLClientNode`` scopes its board's), else the process-wide
``process()`` bundle, disabled by default. A bundle records spans while
``recording``: when it is enabled, or while a ``torch.profiler``
session is on, so a profile of the program carries its layers.

``Telemetry(enabled=False)`` is the default everywhere and is measurably
near-free: ``span()`` short-circuits to a shared no-op context manager
(no allocation) after two attribute reads, the registry counters are
plain attribute adds the components already paid as dict updates, and
nothing is recorded. ``benchmarks/check_regression.py`` gates the
disabled-path overhead at <5% of the multi-job smoke bench.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Span", "Telemetry"]


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------
class Counter:
    """Monotonic counter. ``inc`` is a plain attribute add — the hot
    paths (board posts, scheduler passes) pay what the old ad-hoc
    ``stats[key] += 1`` dict updates paid."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def read(self):
        return self.value


class Gauge:
    """Last-written value (queue depths, clocks, cache sizes)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = v

    def read(self):
        return self.value


class Histogram:
    """Streaming summary: count / total / min / max / last.

    Deliberately bucket-free — the consumers (kernel timing, RPC sizes)
    want means and extrema per labeled series, and a fixed bucket layout
    would have to be renegotiated per metric. ``read()`` returns a plain
    dict so snapshots are JSON-able."""

    __slots__ = ("count", "total", "vmin", "vmax", "last")
    kind = "histogram"

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.last = 0.0

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self.last = v

    def read(self):
        if not self.count:
            return {"count": 0, "total": 0.0, "mean": 0.0,
                    "min": 0.0, "max": 0.0}
        return {"count": self.count, "total": self.total,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Labeled metric series under one namespace.

    ``counter("board.posts")`` returns the same object every call;
    ``counter("board.bytes_posted_by", actor="siloA")`` is one series of
    the labeled family ``board.bytes_posted_by``. A name is pinned to
    its kind at first use — re-registering it as another kind raises
    (two components silently sharing a name as different types is how
    ad-hoc stats dicts drift).

    ``register_collector(fn)`` adds a callback run at every
    ``snapshot()``: components whose counters live elsewhere (a
    transport's ``round_trips``, the WanModel's per-actor clocks) push
    their current readings into gauges there, so the snapshot covers
    the whole federation without the hot paths double-writing.
    """

    def __init__(self):
        self._series: Dict[Tuple[str, Tuple], object] = {}
        self._kind_of: Dict[str, str] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    def _get(self, kind: str, name: str, labels: dict):
        known = self._kind_of.get(name)
        if known is None:
            self._kind_of[name] = kind
        elif known != kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{known}, not {kind}")
        key = (name, tuple(sorted(labels.items())))
        metric = self._series.get(key)
        if metric is None:
            metric = self._series[key] = _KINDS[kind]()
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def register_collector(self, fn: Callable[["MetricsRegistry"], None]):
        self._collectors.append(fn)

    # --- views ----------------------------------------------------------
    def labeled(self, name: str, label: str) -> Dict[str, object]:
        """``{label value: reading}`` across one labeled family — the
        shape the legacy ``*_by`` stats maps had."""
        out = {}
        for (n, labels), metric in self._series.items():
            if n == name:
                d = dict(labels)
                if label in d:
                    out[d[label]] = metric.read()
        return out

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time reading of every series: ``{name: value}`` for
        unlabeled series, ``{name: {"k=v,...": value}}`` for labeled
        ones. Plain data, fully detached — mutating it cannot touch the
        live metrics, and a later snapshot cannot mutate it."""
        for fn in self._collectors:
            fn(self)
        out: Dict[str, object] = {}
        for (name, labels), metric in self._series.items():
            if not labels:
                out[name] = metric.read()
            else:
                key = ",".join(f"{k}={v}" for k, v in labels)
                out.setdefault(name, {})[key] = metric.read()
        return out

    @staticmethod
    def diff(before: dict, after: dict) -> dict:
        """What moved between two snapshots. Counters/gauges subtract;
        histogram summaries subtract count/total (min/max are windowless
        and omitted); series absent from ``before`` count from zero."""
        def sub(b, a):
            if isinstance(a, dict) and "count" in a:      # histogram
                bc = b if isinstance(b, dict) else {}
                return {"count": a["count"] - bc.get("count", 0),
                        "total": a["total"] - bc.get("total", 0.0)}
            if isinstance(a, dict):                        # labeled family
                bb = b if isinstance(b, dict) else {}
                return {k: sub(bb.get(k), v) for k, v in a.items()}
            return a - (b if isinstance(b, (int, float)) else 0)
        return {name: sub(before.get(name), val)
                for name, val in after.items()}


# ---------------------------------------------------------------------------
# Device timing events
# ---------------------------------------------------------------------------
_EVENTS: Dict[int, list] = {}         # CUDA index -> free timing events


def _cuda_index(device) -> Optional[int]:
    """The CUDA index of ``device`` (a ``torch.device`` or its name), or
    ``None`` for any other device."""
    if device is None:
        return None
    if isinstance(device, str):
        device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _record(index: int, stream):
    """A timing event of device ``index`` from the pool, recorded on
    ``stream``; nothing waits for it."""
    free = _EVENTS.get(index)
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------
class Span:
    """One timed operation, stamped on both clocks.

    ``t0``/``t1`` are wall-clock (``perf_counter``); ``sim0``/``sim1``
    are the acting actor's WanModel simulated clock when one is attached
    (``None`` otherwise). ``t1 is None`` marks a still-open span (a
    phase the run is currently in) — export treats it as running up to
    the export instant. ``device`` is the type of the device the span
    was opened with (``None``: a host span); ``device_s`` its time on
    that device."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "actor", "run_id",
                 "t0", "t1", "sim0", "sim1", "attrs", "device", "_ev",
                 "_device_s", "_telemetry")

    def __init__(self, span_id, parent_id, name, cat, actor, run_id,
                 t0, sim0, attrs):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.actor = actor
        self.run_id = run_id
        self.t0 = t0
        self.t1 = None
        self.sim0 = sim0
        self.sim1 = None
        self.attrs = attrs
        self.device = None
        self._ev = None
        self._device_s = None

    def set(self, **attrs):
        """Attach attributes mid-span (a train span learns its loss)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def _start(self, device) -> None:
        """Time the span on ``device``: on CUDA, record its start event on
        the device's current stream, where its end event goes too."""
        if isinstance(device, str):
            device = torch.device(device)
        self.device = device.type
        index = _cuda_index(device)
        if index is not None:
            stream = torch.cuda.current_stream(index)
            self._ev = [_record(index, stream), None, index, stream]

    def _finish(self, t1: float) -> None:
        self.t1 = t1
        ev = self._ev
        if ev is not None:
            ev[1] = _record(ev[2], ev[3])

    @property
    def device_s(self) -> Optional[float]:
        """Seconds between the span's two events on its CUDA device,
        resolved at the first read (which waits for the end event) and
        kept; the host duration for a span off CUDA; ``None`` while the
        span is open."""
        if self.t1 is None:
            return None
        if self._device_s is None:
            if self._ev is None:
                return self.t1 - self.t0
            start, end, index, _ = self._ev
            end.synchronize()
            self._device_s = start.elapsed_time(end) / 1e3
            self._ev = None
            _EVENTS.setdefault(index, []).extend((start, end))
        return self._device_s

    def to_dict(self) -> dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "cat": self.cat, "actor": self.actor,
                "run_id": self.run_id, "t0": self.t0, "t1": self.t1,
                "sim0": self.sim0, "sim1": self.sim1,
                "attrs": self.attrs or {}}

    # context-manager protocol: closed by the owning Telemetry
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self._telemetry._close(self, error=exc is not None)
        return False


class _KernelSpan(Span):
    """A span around one reduction (``Telemetry.kernel_span``): its
    device time feeds ``kernel.seconds`` whether or not it is recorded
    as a trace span (``span_id`` 0: not recorded)."""

    __slots__ = ("kernel",)

    def __exit__(self, exc_type, exc, tb):
        tel = self._telemetry
        if self.span_id:
            tel._close(self, error=exc is not None)
        else:
            self._finish(tel.clock())
        tel._kernel_done(self)
        return False


class _NullSpan:
    """Shared no-op for the disabled path: no allocation, no recording.
    Supports the same surface (``with``, ``set``) so call sites never
    branch on whether telemetry is on."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()

_FLEET = "<fleet>"                    # ring key for spans with no run


class Telemetry:
    """The federation's shared observability bundle.

    One instance per federation, anchored on the MessageBoard (every
    component — scheduler, servers, client agents, communicators —
    already holds the board, so they all reach the same instance).
    ``recording`` gates the *tracer* (``enabled``, or a
    ``torch.profiler`` session on); the metrics registry is always live
    because the components' ``stats`` views are assembled from it.
    """

    def __init__(self, enabled: bool = False, *, recorder_cap: int = 4096,
                 max_incidents: int = 16,
                 clock: Optional[Callable[[], float]] = None):
        self.enabled = bool(enabled)
        self.metrics = MetricsRegistry()
        self.recorder_cap = int(recorder_cap)
        self.max_incidents = int(max_incidents)
        self.clock = clock or time.perf_counter
        self.wan = None               # set via attach_wan
        self._rings: Dict[str, deque] = {}
        self._open: Dict[int, Span] = {}
        self._stack: List[Span] = []
        self._next_id = 1
        self.incidents: List[dict] = []
        self._kernels: List[_KernelSpan] = []   # not yet in kernel.seconds
        self.metrics.register_collector(self._collect_kernels)

    @property
    def recording(self) -> bool:
        """Spans record: the bundle is enabled, or a ``torch.profiler``
        session is on (its plain Python flag, no call into C++)."""
        return self.enabled or _profiler._is_profiler_enabled

    # --- wiring ---------------------------------------------------------
    def attach_wan(self, wan) -> None:
        """Adopt a WanModel: spans gain the sim-clock lane, and the
        model's clocks/charges surface in metric snapshots."""
        self.wan = wan

        def collect(reg: MetricsRegistry):
            reg.gauge("wan.sim_elapsed_s").set(wan.elapsed())
            reg.gauge("wan.charges").set(wan.charges)
            for actor, t in wan.clocks.items():
                reg.gauge("wan.clock_s", actor=actor).set(t)
        self.metrics.register_collector(collect)

    def attach_transport(self, transport) -> None:
        """Surface a transport backend's own counters in snapshots."""
        def collect(reg: MetricsRegistry):
            for attr in ("round_trips", "list_index_hits",
                         "list_full_scans"):
                if hasattr(transport, attr):
                    reg.gauge(f"transport.{attr}").set(
                        getattr(transport, attr))
        self.metrics.register_collector(collect)

    def _sim_now(self, actor: str) -> Optional[float]:
        if self.wan is None:
            return None
        return self.wan.clocks.get(actor, 0.0)

    # --- span lifecycle -------------------------------------------------
    def span(self, name: str, *, cat: str = "span",
             actor: Optional[str] = None, run_id: Optional[str] = None,
             attrs: Optional[dict] = None, device=None):
        """Open a span as a context manager. Not recording: returns the
        shared no-op immediately — build expensive ``attrs`` only behind
        an ``if telemetry.recording`` guard. ``actor`` and ``run_id``
        default to the enclosing span's (``actor`` to ``"server"`` at the
        top). With ``device`` the span also keeps its time on that
        device (``Span.device_s``)."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _NULL_SPAN
        sp = self._open_span(name, cat, actor, run_id, attrs, device)
        sp._telemetry = self
        self._stack.append(sp)
        return sp

    def open_span(self, name: str, *, cat: str = "span",
                  actor: Optional[str] = None, run_id: Optional[str] = None,
                  attrs: Optional[dict] = None) -> int:
        """Open a long-lived span that crosses call boundaries (a
        protocol phase spanning many ticks). Returns a span id for
        ``close_span``; 0 when not recording."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return 0
        sp = self._open_span(name, cat, actor, run_id, attrs)
        return sp.span_id

    def _open_span(self, name, cat, actor, run_id, attrs, device=None,
                   cls=Span) -> Span:
        parent = self._stack[-1] if self._stack else None
        if actor is None:
            actor = parent.actor if parent is not None else "server"
        if run_id is None and parent is not None:
            run_id = parent.run_id
        sid = self._next_id
        self._next_id += 1
        sp = cls(sid, parent.span_id if parent is not None else None, name,
                 cat, actor, run_id, self.clock(), self._sim_now(actor),
                 attrs)
        self._open[sid] = sp
        if device is not None:
            sp._start(device)
        return sp

    def close_span(self, span_id: int, **attrs) -> None:
        sp = self._open.get(span_id)
        if sp is None:
            return
        if attrs:
            sp.set(**attrs)
        self._close(sp)

    def _close(self, sp: Span, error: bool = False) -> None:
        self._open.pop(sp.span_id, None)
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        sp._finish(self.clock())
        sp.sim1 = self._sim_now(sp.actor)
        if error:
            sp.set(error=True)
        self._ring(sp.run_id).append(sp)

    def _ring(self, run_id: Optional[str]) -> deque:
        key = run_id or _FLEET
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = deque(maxlen=self.recorder_cap)
        return ring

    # --- kernel timing --------------------------------------------------
    def kernel_span(self, kernel: str, *, run_id: Optional[str] = None,
                    device=None, **labels):
        """A device span (``kernel:<kernel>``) around a CUDA reduction.
        Always feeds the ``kernel.seconds`` histogram: its time on
        ``device`` (two timing events on CUDA, the host duration off it),
        resolved by a registry collector at ``snapshot()``, so nothing
        waits for the card here. Recorded as a trace span only while
        recording."""
        if self.enabled or _profiler._is_profiler_enabled:
            sp = self._open_span(f"kernel:{kernel}", "kernel", None, run_id,
                                 dict(labels) or None, device, _KernelSpan)
            self._stack.append(sp)
        else:
            sp = _KernelSpan(0, None, f"kernel:{kernel}", "kernel",
                             "server", run_id, self.clock(), None, None)
            if device is not None:
                sp._start(device)
        sp._telemetry = self
        sp.kernel = kernel
        return sp

    def _kernel_done(self, sp: _KernelSpan) -> None:
        self._kernels.append(sp)
        if len(self._kernels) > KERNEL_BACKLOG:
            # nobody snapshots: fold the older half, long since finished
            self._collect_kernels(self.metrics, KERNEL_BACKLOG // 2)

    def _collect_kernels(self, reg: MetricsRegistry,
                         n: Optional[int] = None) -> None:
        done = self._kernels[:n]
        del self._kernels[:len(done)]
        for sp in done:
            reg.histogram("kernel.seconds",
                          kernel=sp.kernel).observe(sp.device_s)

    # --- flight recorder ------------------------------------------------
    def spans(self, run_id: Optional[str] = None,
              include_open: bool = True) -> List[Span]:
        """Recorded spans for one run (plus its open ones), oldest first."""
        out = list(self._rings.get(run_id or _FLEET, ()))
        if include_open:
            out.extend(sp for sp in self._open.values()
                       if (sp.run_id or _FLEET) == (run_id or _FLEET))
        out.sort(key=lambda s: s.t0)
        return out

    def record_incident(self, run_id: str, reason: str) -> dict:
        """Dump the run's recent spans on failure/pause. Bounded — a
        flapping run cannot grow the incident log without limit."""
        dump = {"run_id": run_id, "reason": reason,
                "wall": self.clock(),
                "sim": self.wan.elapsed() if self.wan else None,
                "spans": [s.to_dict() for s in self.spans(run_id)]}
        self.incidents.append(dump)
        del self.incidents[:-self.max_incidents]
        self.metrics.counter("telemetry.incidents").inc()
        return dump

    # --- Chrome-trace export --------------------------------------------
    def export_trace(self, run_id: str, *, include_fleet: bool = True
                     ) -> dict:
        """The run's flight-recorder ring as Chrome-trace JSON (load in
        ``chrome://tracing`` or https://ui.perfetto.dev).

        Two process lanes: pid 1 plots every span on the wall clock,
        pid 2 re-plots the same spans on the WanModel simulated clock
        (present only when a WAN model is attached) — side by side they
        show where host time and simulated WAN time diverge. Threads
        are actors (scheduler, server, each silo). Fleet-level spans
        (scheduler passes) ride along so the run is shown in context.
        """
        spans = self.spans(run_id)
        if include_fleet:
            spans = sorted(spans + self.spans(None),
                           key=lambda s: s.t0)
        now = self.clock()
        t_base = min((s.t0 for s in spans), default=0.0)
        actors = sorted({s.actor for s in spans})
        tid_of = {a: i + 1 for i, a in enumerate(actors)}
        events = []
        lanes = [(1, "wall-clock")]
        if self.wan is not None:
            lanes.append((2, "sim-clock (WAN model)"))
        for pid, label in lanes:
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": label}})
            for a in actors:
                events.append({"ph": "M", "pid": pid, "tid": tid_of[a],
                               "name": "thread_name",
                               "args": {"name": a}})
        for s in spans:
            t1 = s.t1 if s.t1 is not None else now
            args = dict(s.attrs or {})
            if s.run_id:
                args["run_id"] = s.run_id
            if s.t1 is None:
                args["open"] = True
            elif s.device is not None:
                args["device_ms"] = s.device_s * 1e3
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X", "pid": 1,
                "tid": tid_of[s.actor],
                "ts": round((s.t0 - t_base) * 1e6, 3),
                "dur": round(max(t1 - s.t0, 0.0) * 1e6, 3),
                "args": args})
            if self.wan is not None and s.sim0 is not None:
                sim1 = (s.sim1 if s.sim1 is not None
                        else self._sim_now(s.actor) or s.sim0)
                events.append({
                    "name": s.name, "cat": s.cat, "ph": "X", "pid": 2,
                    "tid": tid_of[s.actor],
                    "ts": round(s.sim0 * 1e6, 3),
                    "dur": round(max(sim1 - s.sim0, 0.0) * 1e6, 3),
                    "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"run_id": run_id,
                              "spans": len(spans),
                              "sim_clock": self.wan is not None}}

    def anchor_trace(self, metadata, run_id: str) -> Tuple[dict, str]:
        """Export the run's trace and anchor its digest — not the
        payload — on the provenance chain, so a timeline shipped to an
        auditor can be checked against what the coordinator recorded
        (tamper-evident, like every governance artifact). Returns
        ``(trace, digest)``."""
        trace = self.export_trace(run_id)
        payload = json.dumps(trace, sort_keys=True, default=float)
        digest = hashlib.sha256(payload.encode()).hexdigest()
        metadata.record_provenance(
            actor="telemetry", operation="trace_export", subject=run_id,
            outcome="anchored",
            details={"digest": digest,
                     "events": len(trace["traceEvents"]),
                     "spans": trace["otherData"]["spans"],
                     "sim_clock": trace["otherData"]["sim_clock"]})
        return trace, digest

    @staticmethod
    def trace_digest(trace: dict) -> str:
        """Digest of an exported trace — recompute it on the artifact an
        auditor received and compare against the anchored record."""
        payload = json.dumps(trace, sort_keys=True, default=float)
        return hashlib.sha256(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# The bundle in scope
# ---------------------------------------------------------------------------
PROCESS_RING = 8192           # spans the process-wide bundle's ring keeps
KERNEL_BACKLOG = 256          # kernel spans kept for the next snapshot

_PROCESS = Telemetry(recorder_cap=PROCESS_RING)
_SCOPE: contextvars.ContextVar = contextvars.ContextVar("telemetry")


def process() -> Telemetry:
    """The process-wide bundle: what ``current()`` returns with none in
    scope. Disabled by default; it records while a profiler is on."""
    return _PROCESS


def current() -> Telemetry:
    """The bundle in scope (``scope``), else ``process()``."""
    return _SCOPE.get(_PROCESS)


@contextlib.contextmanager
def scope(tel: Telemetry):
    """Put ``tel`` in scope: the data plane and the models record into
    it inside the block."""
    token = _SCOPE.set(tel)
    try:
        yield tel
    finally:
        _SCOPE.reset(token)
