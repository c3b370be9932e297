"""Model Aggregator strategies of the PyTorch port against the JAX package.

Pytree plane (``fedavg``, ``trimmed_mean``, ``coordinate_median``,
``aggregate``) and packed plane (``aggregate_packed``, FedAvg through
K1's plain version on the CPU) on identical numpy inputs, atol 1e-6: the
sums run in another order. Even cohorts check that the median is the
midpoint of the two middle values, as ``jnp.median`` takes it.
"""
import numpy as np
import pytest
import torch

import jax

from repro.core import aggregation as jagg
from repro.core.packing import pack_pytree as jpack
from repro_torch.core import aggregation as tagg
from repro_torch.core.packing import PackedLayout
from repro_torch.kernels.secure_agg import ops

ATOL = 1e-6


def _trees(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(5, 3)).astype(np.float32),
             "b": rng.normal(size=(7,)).astype(np.float32),
             "blk": {"k": rng.normal(size=(2, 2, 2)).astype(np.float32)}}
            for _ in range(n)]


def _torch_tree(t):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in t.items()}


def _assert_trees_close(ttree, jtree):
    jl = jax.tree.leaves(jtree)
    tl = jax.tree.leaves({k: v for k, v in _np_tree(ttree).items()})
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL)


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in t.items()}


@pytest.mark.parametrize("n", [3, 4, 5])
@pytest.mark.parametrize("name", ["fedavg", "trimmed_mean", "median"])
def test_aggregate_matches_jax(name, n):
    trees = _trees(n, n)
    weights = list(np.arange(1, n + 1, dtype=np.float32))
    kw = {"trim": 1} if name == "trimmed_mean" else {}
    jout = jagg.aggregate(name, trees, weights, **kw)
    tout = tagg.aggregate(name, [_torch_tree(t) for t in trees], weights,
                          device="cpu", **kw)
    _assert_trees_close(tout, jout)


def test_fedavg_uniform_and_robust_edges():
    trees = _trees(4, 0)
    _assert_trees_close(tagg.fedavg(trees, device="cpu"),
                        jagg.fedavg(trees))
    _assert_trees_close(tagg.coordinate_median(trees, device="cpu"),
                        jagg.coordinate_median(trees))
    with pytest.raises(ValueError):
        tagg.trimmed_mean(trees, trim=2, device="cpu")


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("name", ["fedavg", "trimmed_mean", "median"])
def test_aggregate_packed_matches_jax(name, n):
    trees = _trees(n, 10 + n)
    bufs = [np.asarray(jpack(t)[0]) for t in trees]
    weights = [float(i + 1) for i in range(n)]
    before = dict(ops.LAUNCHES)
    tout = tagg.aggregate_packed(name, bufs, weights, device="cpu")
    assert ops.LAUNCHES == before
    jout = np.asarray(jagg.aggregate_packed(name, np.stack(bufs), weights))
    assert isinstance(tout, torch.Tensor) and tout.shape == jout.shape
    np.testing.assert_allclose(tout.numpy(), jout, atol=ATOL)
    # with a layout the result comes back as the tree
    layout = PackedLayout.for_tree(_torch_tree(trees[0]))
    ttree = tagg.aggregate_packed(name, np.stack(bufs), weights,
                                  layout=layout, device="cpu")
    _assert_trees_close(ttree, jagg.aggregate_packed(
        name, np.stack(bufs), weights,
        layout=jpack(trees[0])[1]))


def test_aggregate_packed_default_weights_and_errors():
    bufs = [np.asarray(jpack(t)[0]) for t in _trees(3, 1)]
    np.testing.assert_allclose(
        tagg.aggregate_packed("fedavg", bufs, device="cpu").numpy(),
        np.mean(bufs, axis=0), atol=ATOL)
    with pytest.raises(KeyError):
        tagg.aggregate_packed("krum", bufs, device="cpu")
    with pytest.raises(ValueError):
        tagg.aggregate_packed("trimmed_mean", bufs, trim=2, device="cpu")
