"""Training and aggregation steps, one silo and silo-stacked (port of
``repro.training.steps``).

``make_train_step``: the reference's ``jax.value_and_grad`` becomes
``torch.autograd.grad`` of ``model.loss_fn`` with respect to the fp32
master leaves; the optimizer update follows under ``no_grad``. Like the
reference the step is functional: it returns new params and optimizer
state.

Multi-pod FL: every leaf gains a leading ``(n_pods,)`` silo dim. The
reference ``vmap``s the one-silo step over it; here the step runs once
per silo on that silo's slice and the results are stacked again
(``torch.func.vmap`` does not compose with ``torch.autograd.grad`` on
leaves), so silo i's result is bitwise the one-silo step on silo i. The
FedAvg over the silo dim (the paper's Model Aggregator) is plain PyTorch,
as the reference computes it outside any kernel.

Over a mesh of ranks (``sharding/mesh.py``) the leaves are ``DTensor``s
whose silo dim is ``Shard(0)`` over ``"pod"``. Each rank's pod group then
trains only its own silos: their local slices become ``DTensor``s of the
``(data, model)`` sub-mesh and ``make_train_step`` runs on them, so the
per-silo step issues no cross-pod collective (silos are independent in
FL), as the reference's ``vmap(spmd_axis_name="pod")`` keeps it
pod-local. The FedAvg is then the collective over the pod group: an
all-reduce of each pod's partial sum and the divide; its int8 form
all-reduces the silo's max over ``(data, model)`` and all-gathers the
int8 values and scales over ``"pod"``, as the reference's ``_build_fedavg``
(``launch/variants.py``) does.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import tree as _tree
from repro_torch.optim.adamw import apply_updates
from repro_torch.sharding.mesh import Mesh, mesh_scope, sharded_program
from repro_torch.sharding.specs import NamedSharding, contiguous_stride
from repro_torch.training.train_graph import TrainGraphs


def make_train_step(model, opt):
    """(params, opt_state, batch) -> (params, opt_state, metrics), on the
    model's device (``build_model`` chose it). Spans ``train.step`` and,
    on an eager step, its ``train.forward``, ``train.backward``,
    ``train.optimizer``. On CUDA each shape's step is replayed as one
    graph from its second call on (``train_graph.TrainGraphs``, the
    returned function's ``graphs``)."""
    # repro_torch.core imports this module: import its telemetry late
    from repro_torch.core.telemetry import current

    def step(params, opt_state, batch, scalars):
        flat, treedef = _tree.flatten(params)
        tel, dev = current(), flat[0].device
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with sharded_program(flat):
            with tel.span("train.forward", cat="train", device=dev):
                loss, metrics = model.loss_fn(
                    _tree.unflatten(treedef, leaves), batch)
                # over ranks the loss may come back partial (a sum
                # pending over the mesh): reduce it, so the backward
                # starts from one replicated seed
                loss = _replicated(loss)
            with tel.span("train.backward", cat="train", device=dev):
                grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad(), sharded_program(flat), tel.span(
                "train.optimizer", cat="train", device=dev):
            params = _tree.unflatten(treedef, [p.detach() for p in leaves])
            grads = _tree.unflatten(treedef, list(grads))
            updates, opt_state, opt_info = opt.update(grads, opt_state,
                                                      params, scalars)
            params = apply_updates(params, updates)
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   **opt_info, "loss": loss.detach()}
        return params, opt_state, metrics

    def train_step(params, opt_state, batch):
        dev = _tree.leaves(params)[0].device
        with current().span("train.step", cat="train", device=dev):
            return train_step.graphs(step, opt, params, opt_state, batch)

    train_step.graphs = TrainGraphs()
    return train_step


def _replicated(x):
    """A ``DTensor`` redistributed to ``Replicate()`` on its mesh; a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def silo(tree, i: int):
    """Silo ``i`` of a silo-stacked tree: each tensor leaf's slice ``i``
    as a fresh contiguous tensor; other leaves (the optimizer's step
    count, which every silo shares) as they are."""
    return _tree.tree_map(
        lambda a: a[i].clone() if isinstance(a, torch.Tensor) else a, tree)


def stack_silos(trees):
    """Same-structure trees stacked leaf by leaf on a new silo dim; a
    non-tensor leaf (a count or rate) must agree across silos and stays
    as it is."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        if any(x != xs[0] for x in xs[1:]):
            raise ValueError(f"silos disagree on a shared leaf: {xs}")
        return xs[0]
    return _tree.tree_map(stack, *trees)


def _pod_dim(x: DTensor) -> int:
    names = x.device_mesh.mesh_dim_names or ()
    if "pod" not in names or x.placements[names.index("pod")] != Shard(0):
        raise ValueError("a silo-stacked DTensor has its silo dim Shard(0) "
                         f"over 'pod', not {x.placements} over {names}")
    return names.index("pod")


def _inner(placements, pod: int) -> list:
    """A stacked leaf's placements on the pod's sub-mesh, one dim down."""
    out = []
    for i, p in enumerate(placements):
        if i == pod:
            continue
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError(f"the silo dim is sharded off 'pod': "
                                 f"{placements}")
            p = Shard(p.dim - 1)
        elif not isinstance(p, Replicate):
            raise ValueError(f"a stacked leaf must not be {p}")
        out.append(p)
    return out


class _PodLocal:
    """The local silos of silo-stacked trees of ``DTensor``s over a
    ``(pod, ...)`` mesh, each as a tree of ``DTensor``s of the pod's
    sub-mesh, and the way back. Every leaf's silo dim is ``Shard(0)``
    over ``"pod"``; nothing here issues a collective."""

    def __init__(self, trees):
        x = next(a for t in trees for a in _tree.leaves(t)
                 if isinstance(a, DTensor))
        self.dm = x.device_mesh
        self.pod = _pod_dim(x)
        self.inner_names = tuple(n for n in self.dm.mesh_dim_names
                                 if n != "pod")
        self.sub_dm = self.dm[self.inner_names]
        self.sub_mesh = Mesh.over_ranks(self.sub_dm)
        self.n_local = x.to_local().shape[0]

    def silo(self, tree, j: int):
        """Local silo ``j`` of ``tree``; non-tensor leaves as they are."""
        def one(a):
            if not isinstance(a, DTensor):
                return a
            return DTensor.from_local(
                a.to_local()[j], self.sub_dm,
                _inner(a.placements, _pod_dim(a)), run_check=False,
                shape=a.shape[1:], stride=contiguous_stride(a.shape[1:]))
        return _tree.tree_map(one, tree)

    def stack(self, trees, like=None):
        """Per-silo trees of sub-mesh ``DTensor``s stacked back over
        ``"pod"``: each leaf placed as ``like``'s silos when given, else as
        the first silo's (a plain tensor is replicated)."""
        n_in = len(self.inner_names)

        def one(ref, *xs):
            if not isinstance(xs[0], torch.Tensor):
                if any(x != xs[0] for x in xs[1:]):
                    raise ValueError(f"silos disagree on a shared leaf: {xs}")
                return xs[0]
            xs = [x if isinstance(x, DTensor) else DTensor.from_local(
                x, self.sub_dm, [Replicate()] * n_in, run_check=False)
                for x in xs]
            inner = _inner(ref.placements, self.pod) \
                if isinstance(ref, DTensor) else list(xs[0].placements)
            locs = [x.redistribute(self.sub_dm, inner).to_local()
                    for x in xs]
            pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
                  for p in inner]
            pl.insert(self.pod, Shard(0))
            shape = (self.dm.size(self.pod) * len(xs),) + tuple(xs[0].shape)
            return DTensor.from_local(torch.stack(locs), self.dm, pl,
                                      run_check=False, shape=shape,
                                      stride=contiguous_stride(shape))
        if like is None:
            return _tree.tree_map(lambda *xs: one(None, *xs), *trees)
        return _tree.tree_map(one, like, *trees)


def pod_map(fn, like=None):
    """The reference's ``vmap(fn, spmd_axis_name="pod")`` over silo-stacked
    ``DTensor`` arguments: each rank runs ``fn`` once for each of its
    pod's silos, on ``DTensor``s of the ``(data, model)`` sub-mesh inside
    ``mesh_scope`` of it, and stacks the results back over ``"pod"`` (a
    tuple result position by position, each placed as the tree at its
    position of ``like`` when that is given and not None). No collective
    crosses pods."""
    def mapped(*args):
        pods = _PodLocal(args)
        outs = []
        with mesh_scope(pods.sub_mesh):
            for j in range(pods.n_local):
                outs.append(fn(*[pods.silo(a, j) for a in args]))
        if not isinstance(outs[0], tuple):
            return pods.stack(outs, like)
        refs = like if like is not None else (None,) * len(outs[0])
        return tuple(pods.stack([o[k] for o in outs], refs[k])
                     for k in range(len(outs[0])))
    return mapped


def make_multipod_train_step(model, opt, n_pods: int):
    """The one-silo step over the leading silo dim of params, optimizer
    state and batch; metrics come back as (n_pods,) tensors. Over a mesh
    of ranks each rank runs its pod's silos on the ``(data, model)``
    sub-mesh (``pod_map``), params and moments placed as they came."""
    step = make_train_step(model, opt)

    def multipod_step(params, opt_state, batch):
        if any(isinstance(a, DTensor) for a in _tree.leaves(params)):
            return pod_map(step, like=(params, opt_state, None))(
                params, opt_state, batch)
        outs = [step(silo(params, i), silo(opt_state, i), silo(batch, i))
                for i in range(n_pods)]
        return tuple(stack_silos([o[k] for o in outs]) for k in range(3))

    return multipod_step


def _local_silo_rows(x: DTensor, pod: int) -> slice:
    """The global silo indices of this rank's local silos."""
    n_local = x.to_local().shape[0]
    first = x.device_mesh.get_local_rank(pod) * n_local
    return slice(first, first + n_local)


def _pod_mean(leaf: DTensor, weights=None) -> DTensor:
    """``fedavg_pod_params`` of one pod-stacked leaf: each pod's partial
    (weighted) sum of its local silos, all-reduced over the pod group
    (``Partial`` -> ``Replicate`` over ``"pod"``), then the divide, and
    the mean re-installed in every local silo."""
    pod = _pod_dim(leaf)
    local = leaf.to_local().to(torch.float32)
    if weights is None:
        part = torch.sum(local, dim=0, keepdim=True)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=local.device)
        w = (w / torch.sum(w))[_local_silo_rows(leaf, pod)]
        part = torch.tensordot(w, local, dims=([0], [0]))[None]
    pl = list(leaf.placements)
    pl[pod] = Partial()
    shape = (1,) + tuple(leaf.shape[1:])
    total = DTensor.from_local(part, leaf.device_mesh, pl, run_check=False,
                               shape=shape, stride=contiguous_stride(shape))
    pl[pod] = Replicate()
    m = total.redistribute(leaf.device_mesh, pl).to_local()
    if weights is None:
        m = m / leaf.shape[0]
    out = m.expand(local.shape).to(leaf.dtype).contiguous()
    return DTensor.from_local(out, leaf.device_mesh, leaf.placements,
                              run_check=False, shape=leaf.shape,
                              stride=leaf.stride())


def fedavg_pod_params(stacked_params, weights=None):
    """Model Aggregator data plane: the f32 mean over the silo dim (or
    the normalised ``weights``' tensordot), broadcast back to every silo
    so training continues from the aggregate. A pod-sharded ``DTensor``
    leaf takes the collective over the pod group (``_pod_mean``)."""
    def agg(leaf):
        if isinstance(leaf, DTensor):
            return _pod_mean(leaf, weights)
        lf = leaf.to(torch.float32)
        if weights is None:
            m = torch.mean(lf, dim=0, keepdim=True)
        else:
            w = torch.as_tensor(weights, dtype=torch.float32,
                                device=leaf.device)
            w = w / torch.sum(w)
            m = torch.tensordot(w, lf, dims=([0], [0]))[None]
        return m.expand(leaf.shape).to(leaf.dtype).contiguous()

    return _tree.tree_map(agg, stacked_params)


def _quantize(lf: torch.Tensor, amax: torch.Tensor):
    """Symmetric int8 with one scale ``max|x|/127 + 1e-12`` a silo (round
    half to even, clipped to +-127); true divisions by tensors on the
    leaf's device: a division by a host scalar may run as a multiply by
    its reciprocal."""
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(lf / scale), -127, 127).to(torch.int8)
    return q, scale


def _pod_q8_mean(leaf: DTensor) -> DTensor:
    """The int8 FedAvg of one pod-stacked leaf: the silo's max over the
    whole leaf all-reduced (MAX) over ``(data, model)``, the int8 values
    and the scales all-gathered over ``"pod"``, the dequantised mean after
    the gather."""
    pod = _pod_dim(leaf)
    dm = leaf.device_mesh
    local = leaf.to_local().to(torch.float32)
    dims = tuple(range(1, local.dim()))
    amax_l = torch.amax(torch.abs(local), dim=dims, keepdim=True) \
        if dims else torch.abs(local)
    rest = [Partial("max")] * dm.ndim
    rest[pod] = Shard(0)
    ashape = (leaf.shape[0],) + (1,) * len(dims)
    amax = DTensor.from_local(amax_l, dm, rest, run_check=False,
                              shape=ashape, stride=contiguous_stride(ashape))
    rest = [Replicate()] * dm.ndim
    rest[pod] = Shard(0)
    amax = amax.redistribute(dm, rest).to_local()
    q, scale = _quantize(local, amax)
    gathered = list(leaf.placements)
    gathered[pod] = Replicate()
    q = DTensor.from_local(q, dm, leaf.placements, run_check=False,
                           shape=leaf.shape, stride=leaf.stride())
    q = q.redistribute(dm, gathered).to_local()
    scale = DTensor.from_local(scale, dm, rest, run_check=False,
                               shape=ashape, stride=contiguous_stride(ashape))
    scale = scale.redistribute(dm, [Replicate()] * dm.ndim).to_local()
    m = torch.mean(q.to(torch.float32) * scale, dim=0, keepdim=True)
    out = m.expand(local.shape).to(leaf.dtype).contiguous()
    return DTensor.from_local(out, dm, leaf.placements, run_check=False,
                              shape=leaf.shape, stride=leaf.stride())


def make_fedavg_pod_step(quantize: bool = False, pspecs=None):
    """The cross-silo aggregation step. ``quantize=True`` is the
    reference's int8 variant: each silo's leaf quantized to symmetric int8
    with one scale ``max|x|/127 + 1e-12`` (round half to even, clipped to
    +-127), dequantized, then the f32 mean. ``pspecs``, the pod-stacked
    parameter specs, place each ``DTensor`` leaf before the exchange, so
    only the pod axis is gathered and the intra-pod shards stay (the
    reference's constraint; a plain leaf, with no mesh, ignores them)."""
    if not quantize:
        return fedavg_pod_params

    def quantized_fedavg(stacked_params, weights=None):
        def agg(leaf, spec=None):
            if isinstance(leaf, DTensor):
                if spec is not None:
                    leaf = NamedSharding(Mesh.over_ranks(leaf.device_mesh),
                                         spec).constrain(leaf)
                return _pod_q8_mean(leaf)
            lf = leaf.to(torch.float32)
            dims = tuple(range(1, lf.dim()))
            amax = torch.amax(torch.abs(lf), dim=dims, keepdim=True) \
                if dims else torch.abs(lf)
            q, scale = _quantize(lf, amax)
            deq = q.to(torch.float32) * scale
            m = torch.mean(deq, dim=0, keepdim=True)
            return m.expand(leaf.shape).to(leaf.dtype).contiguous()

        if pspecs is None:
            return _tree.tree_map(agg, stacked_params)
        return _tree.tree_map(agg, stacked_params, pspecs)

    return quantized_fedavg
