"""The decode step replayed as one CUDA graph.

A served decode step launches thousands of small kernels (4,323 for
hymba-1.5b), and issuing them one by one from Python takes the host
longer than the card takes to run them. ``DecodeGraphs`` captures the
whole step, from the embedding to the logits, and replays it with one
launch. ``Model.decode_step`` goes through it.

When it engages: the model's device is the one its graph class serves
(CUDA), autograd is off, and no leaf of the params or the cache is a
``DTensor`` (programs over ranks stay eager). Everywhere else the step
runs eagerly, as it always did.

A graph belongs to one key: the ``(data_ptr, shape, stride, dtype)`` of
every leaf of the params and of the cache, and the token's and position's
shapes. The graph reads the params and reads and writes the caller's own
cache tensors at their addresses, so the cache is still updated in place,
nothing is copied in or out, and two caches interleaved never alias. The
token and the position are copied into the graph's own input buffers.

A new key runs one eager step (it loads the lazily loaded kernels and
the cuBLAS handles); its second step captures the graph and replays it,
and every later step replays. At most ``CAPACITY`` keys are kept, the
least recently used going first: each request's prefill makes a fresh
cache, so a serving loop keeps meeting new keys, and memory must not grow
with their number. Nothing is captured while the telemetry in scope
records (a ``torch.profiler`` session on, or an enabled bundle): a
capture would take its timing events into the graph. A new key then
runs eagerly, and a captured one still replays.

Under the same conditions each cache is one buffer (``DecodeGraphs.stack``),
and a prefill allocates its cache before its activations: a serving loop
frees a cache after the next request's prefill, so the block it leaves is
free, and the best fit, when the prefill after that one asks for a cache
of that size. So the keys of a serving loop alternate between two (with
both freed, the lower block is taken), and from the third request on every
step replays. A cache allocated at the end of a prefill, or as one
tensor a leaf, lands somewhere new each request: the activations take
the blocks, and the leaves of two freed caches mix.

The logits handed back are a copy of the graph's output: a caller that
keeps each step's logits must not see a later replay overwrite them.
The graphs of one runner share one memory pool: they replay one at a
time on one stream and keep nothing from one replay to the next. Each
step counts its path in the process bundle's counter
``serve.decode_graph{path=replay|capture|eager}``.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as _tree

CAPACITY = 4                # keys (graphs, or keys seen once) kept
ALIGN = 512                 # bytes: where each leaf of a cache's buffer starts


def stack_in_one(trees: list, device) -> dict:
    """``trees`` (one structure) stacked leaf by leaf on a new leading
    axis into views of one new buffer on ``device``, each view starting at
    a multiple of ``ALIGN`` bytes."""
    flat = [_tree.leaves(t) for t in trees]
    first, treedef = _tree.flatten(trees[0])
    shapes = [(len(trees),) + tuple(a.shape) for a in first]
    sizes = [math.prod(s) * a.element_size() for s, a in zip(shapes, first)]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // ALIGN) * ALIGN)
    buf = torch.empty(starts[-1], dtype=torch.uint8, device=device)
    out = []
    for j, (shape, a) in enumerate(zip(shapes, first)):
        view = buf[starts[j]:starts[j] + sizes[j]].view(a.dtype).view(shape)
        torch.stack([leaves[j] for leaves in flat], out=view)
        out.append(view)
    return _tree.unflatten(treedef, out)


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


class _Captured:
    """A key's graph and its input buffers and output."""

    __slots__ = ("graph", "token", "pos", "logits")

    def __init__(self, graph, token, pos, logits):
        self.graph, self.token, self.pos, self.logits = (graph, token, pos,
                                                         logits)


class DecodeGraphs:
    """The decode steps of one model, each key's replayed as a graph
    (module docstring). ``graph`` is the graph class: ``CudaGraph``, or a
    stand-in with its ``device_type``, ``(device, share)`` constructor,
    ``capture(fn)`` and ``replay()``."""

    def __init__(self, *, graph=CudaGraph):
        self._graph = graph
        self._keys: OrderedDict = OrderedDict()   # key -> _Captured or None

    def _engages(self, device) -> bool:
        return (device.type == self._graph.device_type
                and not torch.is_grad_enabled())

    def on_path(self, device, tree) -> bool:
        """Whether steps over ``tree`` on ``device`` go through graphs: the
        graph class's device, autograd off, no ``DTensor`` leaf."""
        return self._engages(device) and not any(
            isinstance(a, DTensor) for a in _tree.leaves(tree))

    def stack(self, device, trees: list, into=None):
        """``trees`` (one structure) stacked leaf by leaf on a new leading
        axis. On the graphs' path into ``into``'s leaves (a cache made
        before the prefill's activations; module docstring) where their
        shapes and dtypes match, else into views of one new buffer;
        otherwise each stack is a tensor of its own."""
        if not self.on_path(device, trees[0]):
            return _tree.tree_map(lambda *xs: torch.stack(xs), *trees)
        if into is not None and [(a.shape, a.dtype) for a in
                                 _tree.leaves(into)] == [
                ((len(trees),) + a.shape, a.dtype)
                for a in _tree.leaves(trees[0])]:
            for dst, *xs in zip(_tree.leaves(into),
                                *[_tree.leaves(t) for t in trees]):
                torch.stack(xs, out=dst)
            return into
        return stack_in_one(trees, device)

    def _key(self, params, cache, token, pos):
        """The step's key, or ``None`` where a leaf is a ``DTensor``."""
        sig = []
        for a in _tree.leaves(params) + _tree.leaves(cache):
            if isinstance(a, DTensor):
                return None
            sig.append((a.data_ptr(), a.shape, a.stride(), a.dtype))
        return tuple(sig), token.shape, pos.shape

    @staticmethod
    def _path(path: str) -> None:
        # repro_torch.core imports the models: import its telemetry late
        from repro_torch.core.telemetry import process
        process().metrics.counter("serve.decode_graph", path=path).inc()

    def __call__(self, step, device, params, cache, token, pos):
        """``step(params, cache, token, pos) -> (logits, cache)`` on
        ``device``, eagerly or through this key's graph. Returns (logits,
        cache)."""
        key = None
        if self._engages(device):
            token, pos = torch.as_tensor(token), torch.as_tensor(pos)
            key = self._key(params, cache, token, pos)
        if key is None or key not in self._keys:
            if key is not None:
                self._keys[key] = None
                if len(self._keys) > CAPACITY:
                    self._keys.popitem(last=False)
            self._path("eager")
            return step(params, cache, token, pos)
        self._keys.move_to_end(key)
        entry = self._keys[key]
        if entry is None:
            # repro_torch.core imports the models: import its telemetry late
            from repro_torch.core.telemetry import current
            if current().recording:
                self._path("eager")
                return step(params, cache, token, pos)
            entry = self._keys[key] = self._capture(step, device, params,
                                                    cache, token, pos)
            self._path("capture")
        else:
            entry.token.copy_(token)
            entry.pos.copy_(pos)
            self._path("replay")
        entry.graph.replay()
        return entry.logits.clone(), cache

    def _capture(self, step, device, params, cache, token, pos) -> _Captured:
        """Capture ``step`` over this key's tensors and new input buffers
        holding ``token`` and ``pos``."""
        tok = torch.empty(token.shape, dtype=torch.int64, device=device)
        at = torch.empty(pos.shape, dtype=torch.int32, device=device)
        tok.copy_(token)
        at.copy_(pos)
        share = next((e.graph for e in self._keys.values()
                      if e is not None), None)
        graph = self._graph(device, share)
        logits, out = graph.capture(lambda: step(params, cache, tok, at))
        if any(a is not b for a, b in zip(_tree.leaves(out),
                                          _tree.leaves(cache))):
            raise RuntimeError("the decode step replaced a cache leaf: a "
                               "graph of it would write the old one")
        return _Captured(graph, tok, at, logits)
