"""The decode step replayed as one CUDA graph.

A served decode step launches thousands of small kernels (4,323 for
hymba-1.5b), and issuing them one by one from Python takes the host
longer than the card takes to run them. ``DecodeGraphs`` replays the
whole step, from the embedding to the logits, as one graph a key, by the
policy of ``repro_torch.cuda_graph``. ``Model.decode_step`` goes through
it.

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
Each runner keeps at most ``CAPACITY`` keys: each request's prefill makes
a fresh cache, so a serving loop keeps meeting new keys, and memory must
not grow with their number.

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
Each step counts its path in the process bundle's counter
``serve.decode_graph{path=replay|capture|eager}``.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as _tree
from repro_torch.cuda_graph import Captured, CudaGraph, Graphs, Keys

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


class DecodeGraphs(Graphs):
    """The decode steps of one model, each key's replayed as a graph
    (module docstring) of class ``graph`` (``repro_torch.cuda_graph``)."""

    def __init__(self, *, graph=CudaGraph):
        super().__init__("serve.decode_graph", Keys(CAPACITY), graph)

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

    def __call__(self, step, device, params, cache, token, pos):
        """``step(params, cache, token, pos) -> (logits, cache)`` on
        ``device``, eagerly or through this key's graph. Returns (logits,
        cache)."""
        key = None
        if self._engages(device):
            token, pos = torch.as_tensor(token), torch.as_tensor(pos)
            key = self._key(params, cache, token, pos)

        def capture(graph) -> Captured:
            """``step`` over this key's tensors and new input buffers
            holding ``token`` and ``pos``."""
            tok = torch.empty(token.shape, dtype=torch.int64, device=device)
            at = torch.empty(pos.shape, dtype=torch.int32, device=device)
            tok.copy_(token)
            at.copy_(pos)
            logits, out = graph.capture(lambda: step(params, cache, tok, at))
            if any(a is not b for a, b in zip(_tree.leaves(out),
                                              _tree.leaves(cache))):
                raise RuntimeError("the decode step replaced a cache leaf: "
                                   "a graph of it would write the old one")
            return Captured(graph, (tok, at), logits)

        def refill(entry) -> None:
            entry.inputs[0].copy_(token)
            entry.inputs[1].copy_(pos)

        return self._run(key, device, lambda: step(params, cache, token, pos),
                         capture, refill,
                         lambda entry: (entry.outputs.clone(), cache))
