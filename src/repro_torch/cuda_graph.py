"""Steps replayed as CUDA graphs, key by key.

A step that launches thousands of small kernels (4,323 for a hymba-1.5b
decode step, about 3,800 for a fedforecast-100m train step) keeps the
card waiting while Python issues them one by one. ``Graphs`` runs a kind
of step through one captured graph a key, and each kind says only what
its key is, what it copies into the graph's input buffers before a
replay and what it hands back after: the served decode step
(``models/decode_graph.py``) and the silo train step
(``training/train_graph.py``).

The policy. A key's first step runs eagerly (it loads the lazily loaded
kernels and the cuBLAS handles); its second step captures the graph and
replays it, and every later step replays. Nothing is captured while the
telemetry in scope records (a ``torch.profiler`` session on, or an
enabled bundle): a capture would take its timing events into the graph.
A new key then runs eagerly, and a captured one still replays. The keys
live in a ``Keys`` store of bounded size, the least recently used going
first with its graph, its buffers and its memory: a runner owns its
store, or shares one with the other runners of its kind. The graphs of
one store share one memory pool: they replay one at a time on one
stream, and each step hands its outputs back before the next replays.
Each step counts its path in the process bundle's counter
``<counter>{path=replay|capture|eager}``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import torch


class CudaGraph:
    """One step captured on a side stream of ``device`` into a
    ``torch.cuda.CUDAGraph`` and replayed on the current stream; its
    memory pool is ``share``'s (another ``CudaGraph``), or a new one.
    Holds no reference to what the step read."""

    device_type = "cuda"

    def __init__(self, device: torch.device, share=None):
        self.device = device
        self.pool = (share.pool if share is not None
                     else torch.cuda.graph_pool_handle())
        self._graph = torch.cuda.CUDAGraph()

    def capture(self, fn):
        """Capture ``fn()``: nothing runs on the card. Returns its
        outputs, which each replay refills."""
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._graph.capture_begin(pool=self.pool,
                                          capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    self._graph.capture_end()
            main.wait_stream(side)
        return out

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self._graph.replay()


class Captured(NamedTuple):
    """A key's graph, the input buffers a replay reads and the outputs
    it refills."""
    graph: object
    inputs: object
    outputs: object


class Keys(OrderedDict):
    """Key -> its ``Captured``, or None for a key seen once; at most
    ``capacity`` keys, the least recently used going first."""

    def __init__(self, capacity: int):
        super().__init__()
        self.capacity = capacity

    def seen(self, key) -> None:
        self[key] = None
        if len(self) > self.capacity:
            self.popitem(last=False)

    def share(self):
        """A kept graph, whose pool a new one shares, or None."""
        return next((e.graph for e in self.values() if e is not None), None)


class Graphs:
    """Steps replayed through graphs of class ``graph`` (``CudaGraph``, or
    a stand-in with its ``device_type``, ``(device, share)`` constructor,
    ``capture(fn)`` and ``replay()``), their keys in ``keys``, their paths
    counted under ``counter`` (module docstring)."""

    def __init__(self, counter: str, keys: Keys, graph=CudaGraph):
        self._counter, self._keys, self._graph = counter, keys, graph

    def _count(self, path: str) -> None:
        # repro_torch.core imports the models and the training steps:
        # import its telemetry late
        from repro_torch.core.telemetry import process
        process().metrics.counter(self._counter, path=path).inc()

    def _run(self, key, device, eager, capture, refill, hand_back):
        """One step of ``key`` on ``device`` (``key`` None: the step
        stays eager). An eager step returns ``eager()``. Otherwise the
        key's ``Captured`` is made by ``capture(graph)`` over a new graph,
        or refilled by ``refill(entry)``; its graph replays, and the step
        returns ``hand_back(entry)``."""
        keys = self._keys
        if key is None or key not in keys:
            if key is not None:
                keys.seen(key)
            self._count("eager")
            return eager()
        keys.move_to_end(key)
        entry = keys[key]
        if entry is None:
            # repro_torch.core imports the models and the training steps:
            # import its telemetry late
            from repro_torch.core.telemetry import current
            if current().recording:
                self._count("eager")
                return eager()
            graph = self._graph(device, keys.share())
            entry = keys[key] = capture(graph)
            self._count("capture")
        else:
            refill(entry)
            self._count("replay")
        entry.graph.replay()
        return hand_back(entry)
