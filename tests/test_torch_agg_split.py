"""The T-split server aggregation (``repro_torch.sharding.agg``) against
the unsplit ops of both packages and against the streaming sinks.

The five checks of ``tests/test_streaming_shard.py`` §1 run on the port
over CPU device lists of 2, 3 and 4 (``agg_mesh(["cpu"] * n)``), at sizes
that no mesh divides, so the zero padding must be an exact identity: K1,
K2 and K3 within 1e-5 of the port's unsplit op and of the reference's
(its interpret-mode path), K4 bitwise, and chunk-unaligned T rejected.
(The reference's own versions need several JAX devices and skip in a
one-device run.) The split of the rows an unsplit sink folds equals
what that sink finalizes, bitwise (the sinks over a mesh are
``tests/test_torch_mesh_sinks.py``'s): each column
sums its rows in the same order split or not, and the modular decode is
integer.
"""
import numpy as np
import pytest
import torch

from repro.kernels.compressed_agg.ops import \
    dequant_reduce as jdequant_reduce
from repro.kernels.compressed_agg.ops import \
    masked_dequant_reduce as jmasked_dequant_reduce
from repro.kernels.secure_agg.ops import masked_sum as jmasked_sum
from repro.kernels.secure_agg.ops import \
    masked_sum_corrected as jmasked_sum_corrected
from repro_torch.core.streaming import MaskedF32Sink, ModularSink, QuantSink
from repro_torch.kernels.compressed_agg.ops import (CHUNK, dequant_reduce,
                                                    masked_dequant_reduce)
from repro_torch.kernels.secure_agg.ops import (masked_sum,
                                                masked_sum_corrected)
from repro_torch.sharding import agg as shard

SHARDS = [2, 3, 4]
ATOL = 1e-5


def _mesh(n):
    return shard.agg_mesh(["cpu"] * n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, port_ref, jax_ref, atol=ATOL):
    assert got.shape == port_ref.shape
    np.testing.assert_allclose(got.numpy(), port_ref.numpy(), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref), atol=atol,
                               rtol=0)


def test_agg_mesh_rules():
    assert shard.agg_mesh() is None            # no CUDA device here
    assert shard.agg_mesh(["cpu"]) is None
    m = shard.agg_mesh(["cpu"] * 3)
    assert m.axis_names == ("shard",) and m.shape == {"shard": 3}
    assert shard._t_pad(3001, 4, shard.LANE) == 71
    assert shard._t_pad(3 * CHUNK, 2, CHUNK) == CHUNK


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_masked_sum_matches_single_device(n):
    rng = _rng(0)
    x = rng.normal(size=(5, 3001)).astype(np.float32)  # T % shards != 0
    w = rng.uniform(0.5, 2.0, size=(5,)).astype(np.float32)
    got = shard.sharded_masked_sum(x, w, mesh=_mesh(n))
    _close(got, masked_sum(_t(x), _t(w)), jmasked_sum(x, w))


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_masked_sum_corrected_matches_single_device(n):
    rng = _rng(1)
    x = rng.normal(size=(5, 3001)).astype(np.float32)
    corr = rng.normal(size=(5, 3001)).astype(np.float32)
    w = np.full((5,), 0.2, np.float32)
    got = shard.sharded_masked_sum_corrected(x, corr, w, mesh=_mesh(n))
    _close(got, masked_sum_corrected(_t(x), _t(corr), _t(w)),
           jmasked_sum_corrected(x, corr, w))


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_dequant_reduce_matches_single_device(n):
    rng = _rng(2)
    t = 3 * CHUNK                    # CHUNK-aligned but not shards*CHUNK
    q = rng.integers(-127, 128, size=(5, t)).astype(np.int8)
    scales = rng.uniform(1e-3, 1e-2,
                         size=(5, t // CHUNK)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(5,)).astype(np.float32)
    got = shard.sharded_dequant_reduce(q, scales, w, mesh=_mesh(n))
    _close(got, dequant_reduce(_t(q), _t(scales), _t(w)),
           jdequant_reduce(q, scales, w))


@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_masked_dequant_reduce_bit_exact(n, with_corr):
    rng = _rng(3)
    t, mbits = 3 * CHUNK, 18
    z = rng.integers(0, 1 << mbits, size=(5, t)).astype(np.uint32)
    corr = (rng.integers(0, 1 << mbits, size=(5, t)).astype(np.uint32)
            if with_corr else None)
    scales = np.full((t // CHUNK,), 1e-2, np.float32)
    got = shard.sharded_masked_dequant_reduce(
        z, scales, modulus_bits=mbits, corr=corr, mesh=_mesh(n))
    port = masked_dequant_reduce(
        _t(z.view(np.int32)), _t(scales), modulus_bits=mbits,
        corr=None if corr is None else _t(corr.view(np.int32)))
    ref = np.asarray(jmasked_dequant_reduce(z, scales, modulus_bits=mbits,
                                            corr=corr))
    assert np.array_equal(got.numpy(), port.numpy())
    assert np.array_equal(got.numpy(), ref)      # integer decode: exact


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_rejects_unaligned_chunk_sizes(n):
    q = np.zeros((2, CHUNK + 1), np.int8)
    with pytest.raises(ValueError, match="multiple of CHUNK"):
        shard.sharded_dequant_reduce(q, np.ones((2, 2), np.float32),
                                     np.ones(2, np.float32), mesh=_mesh(n))
    with pytest.raises(ValueError, match="multiple of CHUNK"):
        shard.sharded_masked_dequant_reduce(
            np.zeros((1, CHUNK + 1), np.uint32), np.ones(2, np.float32),
            modulus_bits=16, mesh=_mesh(n))


@pytest.mark.parametrize("n", SHARDS)
def test_split_matches_masked_f32_sink(n):
    rng = _rng(4)
    bufs = rng.normal(size=(3, 3001)).astype(np.float32)
    corrs = rng.normal(size=(3, 3001)).astype(np.float32)
    sink = MaskedF32Sink(3001, batch=6, device="cpu")     # one flush
    for b, c in zip(bufs, corrs):
        sink.fold(b)
        sink.fold_correction(c, 0.5)
    # the sink's rows in fold order: corrections at weight -0.5
    x = np.stack([r for pair in zip(bufs, corrs) for r in pair])
    w = np.tile(np.float32([1.0, -0.5]), 3)
    got = shard.sharded_masked_sum(x, w, mesh=_mesh(n))
    assert got.shape == (3001,)
    assert torch.equal(got, sink.finalize())


@pytest.mark.parametrize("n", SHARDS)
def test_split_matches_modular_sink(n):
    rng = _rng(5)
    t, mbits, grid = 3 * CHUNK, 16, 0.01
    zs = rng.integers(0, 1 << mbits, size=(5, t)).astype(np.uint32)
    sink = ModularSink(t, mbits=mbits, grid=grid, batch=3, device="cpu")
    for z in zs[:3]:
        sink.fold(z)
    for z in zs[3:]:
        sink.fold_correction(z)
    got = shard.sharded_masked_dequant_reduce(
        zs[:3], np.full(t // CHUNK, grid, np.float32), modulus_bits=mbits,
        corr=zs[3:], mesh=_mesh(n))
    assert torch.equal(got, sink.finalize())


@pytest.mark.parametrize("n", SHARDS)
def test_split_matches_quant_sink(n):
    rng = _rng(7)
    t = 3 * CHUNK
    q = rng.integers(-127, 128, size=(3, t)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, size=(3, t // CHUNK)).astype(np.float32)
    w = np.float32([1.0, 2.0, 3.0])
    sink = QuantSink(t, batch=3, device="cpu")            # one flush
    for i in range(3):
        sink.fold(f"c{i}", q[i], s[i], float(w[i]))
    got = shard.sharded_dequant_reduce(q, s, w, mesh=_mesh(n))
    assert torch.equal(got, sink.finalize())


def test_launch_puts_the_callers_device_back(monkeypatch):
    """Each shard launches on its own card: the launch runs with that
    card current and the caller's current device comes back after it,
    also when the launch fails."""
    from repro_torch.kernels.secure_agg import kernel
    events = []

    class Current:                      # stands in for torch.cuda.device
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            events.append(("enter", self.dev))

        def __exit__(self, *exc):
            events.append(("exit", self.dev))

    monkeypatch.setattr(torch.cuda, "device", Current)
    monkeypatch.setattr(kernel, "_stream", lambda dev: 77)

    def launch(*args):
        events.append(("launch", args))
        return 0

    dev = torch.device("cuda", 3)
    kernel._call(launch, "k", dev, "x", 5)
    assert events == [("enter", dev), ("launch", ("x", 5, 3, 77)),
                      ("exit", dev)]
    with pytest.raises(RuntimeError, match="k launch failed: cudaError 9"):
        kernel._call(lambda *a: 9, "k", dev)
    assert events[-1] == ("exit", dev)
