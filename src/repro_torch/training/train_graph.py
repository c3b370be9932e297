"""The silo train step replayed as one CUDA graph.

A train step of the main path's model (fedforecast-100m, 8 x 256, remat)
launches thousands of small kernels, and issuing them one by one from
Python takes the host four times longer than the card takes to run them.
``TrainGraphs`` captures the whole step: the forward, the backward, the
clipping, the optimizer's update and the apply, and replays it with one
launch. ``make_train_step`` goes through it.

When it engages: every tensor of the params, the optimizer state and the
batch is on the device its graph class serves (CUDA), none is a
``DTensor`` (programs over ranks stay eager), and no
``TorchDispatchMode`` is on (a replay would hide the step's operations
from it: the dry run's counters). Everywhere else (the CPU, meta
tensors, a batch still in numpy) the step runs eagerly, as it always did.
The optimizer's state is a host ``count`` beside trees of tensors, and
its per-step host values are ``Optimizer.scalars(count)``.

A graph belongs to one key: the shape, stride and dtype of every leaf of
the params, of the optimizer state's tensors and of the batch, and the
trees' structure. Not the addresses: the step is functional, and its
inputs are new tensors each step. Before each replay the caller's
params, moments and batch are copied into the graph's own input buffers,
and the host values of this step (the learning rate, AdamW's bias
corrections) are written into its 0-d input tensors; the graph never
writes the caller's tensors. The new params, the new state's tensors and
the metrics are handed back as copies of the graph's outputs, so what a
caller keeps of one step (a silo's trained params) no later replay
overwrites. The state's ``count`` stays a host int, advanced here.

The policy is ``repro_torch.cuda_graph``'s: a new key runs one eager step
(it also starts the autograd engine's device thread), its second step
captures, and every later step replays; no capture while the telemetry
in scope records, so the step's inner spans (``train.forward``,
``train.backward``, ``train.optimizer``) open only on an eager step.
A graph keeps its input buffers (the params and both moments: about
1.4 GB at fedforecast-100m) and its pool's memory for as long as it is
kept, so the graphs of every ``make_train_step`` in the process share one
store of ``CAPACITY`` keys: a new key evicts the least recently used
one, whoever's it was, and the train steps a process has cached (one a
job and learning rate, ``core/client.py``) never hold more than
``CAPACITY`` graphs on the card. Each step counts its path in the
process bundle's counter ``train.step_graph{path=replay|capture|eager}``.
"""
from __future__ import annotations

import itertools

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from repro_torch import tree as _tree
from repro_torch.cuda_graph import Captured, CudaGraph, Graphs, Keys
from repro_torch.optim.adamw import on_device

CAPACITY = 2                # keys (graphs, or keys seen once) kept, in all
KEYS = Keys(CAPACITY)       # the store every runner of the process shares
_RUNNERS = itertools.count()


def _frozen(treedef):
    """A treedef (a nested dict skeleton) as a hashable nested tuple."""
    if isinstance(treedef, dict):
        return tuple((k, _frozen(v)) for k, v in treedef.items())
    return None


def _tensors(opt_state) -> dict:
    """The optimizer state's trees of tensors: all but its host count."""
    return {k: v for k, v in opt_state.items() if k != "count"}


def _inputs(params, opt_state, batch) -> list:
    """The step's input tensors in the key's order."""
    return (_tree.leaves(params) + _tree.leaves(_tensors(opt_state))
            + _tree.leaves(batch))


class TrainGraphs(Graphs):
    """The train steps of one ``make_train_step``, each key's replayed as
    a graph (module docstring) of class ``graph``
    (``repro_torch.cuda_graph``); the keys are kept in ``KEYS``, beside
    every other runner's."""

    def __init__(self, *, graph=CudaGraph):
        super().__init__("train.step_graph", KEYS, graph)
        self._id = next(_RUNNERS)

    def _key(self, params, opt_state, batch):
        """The step's key, or ``None`` where the step stays eager."""
        if is_in_torch_dispatch_mode():
            return None
        sig = [self._id]
        device = None
        for tree in (params, _tensors(opt_state), batch):
            leaves, treedef = _tree.flatten(tree)
            sig.append(_frozen(treedef))
            for a in leaves:
                if not isinstance(a, torch.Tensor) or isinstance(a, DTensor):
                    return None
                device = a.device if device is None else device
                if a.device != device:
                    return None
                sig.append((a.shape, a.stride(), a.dtype))
        if device is None or device.type != self._graph.device_type:
            return None
        return tuple(sig)

    def __call__(self, step, opt, params, opt_state, batch):
        """``step(params, opt_state, batch, scalars)`` (``scalars``: the
        optimizer's per-step values as 0-d tensors, or None for the
        update to make them), eagerly or through this key's graph.
        Returns (params, opt_state, metrics)."""
        key = self._key(params, opt_state, batch)
        count = opt_state["count"] + 1
        device = _tree.leaves(params)[0].device

        def capture(graph) -> Captured:
            """``step`` over new input buffers holding this step's params,
            state, batch and host values."""
            def buffer(a):
                out = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                          device=a.device)
                return out.copy_(a)
            p_in = _tree.tree_map(buffer, params)
            s_in = {**_tree.tree_map(buffer, _tensors(opt_state)),
                    "count": opt_state["count"]}
            b_in = _tree.tree_map(buffer, batch)
            scalars = on_device(opt.scalars(count), _tree.leaves(params)[0])
            new_params, new_state, metrics = graph.capture(
                lambda: step(p_in, s_in, b_in, scalars))
            outputs, out_def = _tree.flatten({
                "params": new_params, "metrics": metrics,
                "state": _tensors(new_state)})
            if not all(isinstance(a, torch.Tensor) for a in outputs):
                raise RuntimeError("the train step returned a host value: a "
                                   "graph of it would freeze it")
            return Captured(graph, (_inputs(p_in, s_in, b_in), scalars),
                            (outputs, out_def))

        def refill(entry) -> None:
            buffers, scalars = entry.inputs
            torch._foreach_copy_(buffers, _inputs(params, opt_state, batch))
            for k, v in opt.scalars(count).items():
                scalars[k].fill_(v)

        def hand_back(entry):
            outputs, out_def = entry.outputs
            fresh = [torch.empty_like(a) for a in outputs]
            torch._foreach_copy_(fresh, outputs)
            out = _tree.unflatten(out_def, fresh)
            return (out["params"], {**out["state"], "count": count},
                    out["metrics"])

        return self._run(key, device,
                         lambda: step(params, opt_state, batch, None),
                         capture, refill, hand_back)
