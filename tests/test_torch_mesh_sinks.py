"""The streaming sinks of the PyTorch port over a device mesh (the
reference's ``mesh=`` of ``repro.core.streaming``).

The reference's ``multi_device`` cases (``tests/test_streaming_shard.py``)
skip below two JAX devices; here the mesh is ``agg_mesh([cpu] * n)``, a
device list in one process, which is how the port's T split runs on one
host. With a mesh ``MaskedF32Sink`` and ``QuantSink`` keep one
accumulator slab a shard and ``ModularSink`` decodes once a slab; every
column is reduced by the same op as unsplit, so each result is bitwise
the unsplit sink's, whatever the fold order, batch, unfolds and
corrections. T is not a multiple of the shards' width, so the padding
runs. The integer plane is also held bitwise against the reference's
unsplit sink.
"""
import numpy as np
import pytest
import torch

from repro.core import streaming as jstream
from repro_torch.core import compression
from repro_torch.core import streaming as tstream
from repro_torch.sharding import agg

T = 3001
TQ = 5000                      # int8 / residue rows: Tp = 5120
SHARDS = (2, 3)


def _mesh(n):
    return agg.agg_mesh(["cpu"] * n)


def _f32_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=T) * 0.05).astype(np.float32) for _ in range(n)]


def _drive_f32(sink, bufs, corr):
    for i, b in enumerate(bufs):
        sink.fold(b, 0.25 * (i + 1))
    sink.unfold(bufs[1], 0.5)
    sink.fold_correction(corr[0])
    sink.fold_correction(corr[1], 0.5)
    sink.unfold_correction(corr[1], 0.5)
    return sink.finalize()


def test_auto_is_no_mesh_without_two_cuda_devices():
    assert tstream.default_mesh() is None      # this host has no card
    assert tstream.MaskedF32Sink(8, device="cpu").mesh is None
    assert tstream.QuantSink(8, device="cpu", mesh=None).mesh is None
    mesh = _mesh(2)
    assert tstream.ModularSink(8, mbits=16, grid=1.0, device="cpu",
                               mesh=mesh).mesh is mesh


@pytest.mark.parametrize("n", SHARDS)
def test_masked_f32_sink_over_a_mesh_is_bitwise(n):
    bufs, corr = _f32_rows(5, 0), _f32_rows(2, 1)
    plain = tstream.MaskedF32Sink(T, batch=2, device="cpu", mesh=None)
    split = tstream.MaskedF32Sink(T, batch=2, device="cpu", mesh=_mesh(n))
    a, b = _drive_f32(plain, bufs, corr), _drive_f32(split, bufs, corr)
    assert b.shape == (T,) and torch.equal(a, b)
    assert split.tp % (n * agg.LANE) == 0 and split.tp >= T
    assert split.accumulator_bytes == 4 * split.tp
    assert split.fold_batches == plain.fold_batches > 1


@pytest.mark.parametrize("n", SHARDS)
def test_masked_f32_sink_over_a_mesh_matches_the_reference(n):
    """Against the reference's sink (one device, its default mesh on a
    one-device host) within the streaming twins' 1e-6."""
    bufs, corr = _f32_rows(5, 2), _f32_rows(2, 3)
    ref = _drive_f32(jstream.MaskedF32Sink(T, batch=2, mesh=None), bufs,
                     corr)
    got = _drive_f32(tstream.MaskedF32Sink(T, batch=2, device="cpu",
                                           mesh=_mesh(n)), bufs, corr)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def _int8_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(-127, 128, TQ).astype(np.int8),
             rng.uniform(1e-4, 1e-2, -(-TQ // 1024)).astype(np.float32),
             float(rng.integers(1, 50))) for _ in range(n)]


def _drive_q8(sink, rows):
    for i, (q, s, w) in enumerate(rows):
        sink.fold(str(i), q, s, w)
    sink.unfold("1", *rows[1])
    return sink.finalize()


@pytest.mark.parametrize("n", SHARDS)
def test_quant_sink_over_a_mesh_is_bitwise(n):
    rows = _int8_rows(5, 4)
    plain = tstream.QuantSink(TQ, batch=2, device="cpu", mesh=None)
    split = tstream.QuantSink(TQ, batch=2, device="cpu", mesh=_mesh(n))
    a, b = _drive_q8(plain, rows), _drive_q8(split, rows)
    assert b.shape == (TQ,) and torch.equal(a, b)
    assert split.norms == plain.norms
    assert split.total_weight == plain.total_weight


def _residues(n, seed, mbits=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << mbits, TQ).astype(np.uint32)
            for _ in range(n)]


def _drive_mod(sink, z, corr):
    for r in z:
        sink.fold(r)
    sink.unfold(z[2])
    sink.fold_correction(corr[0])
    sink.fold_correction(corr[1])
    sink.unfold_correction(corr[1])
    return sink.finalize()


@pytest.mark.parametrize("n", SHARDS)
def test_modular_sink_over_a_mesh_is_bitwise_and_the_reference(n):
    z, corr = _residues(5, 5), _residues(2, 6)
    kw = dict(mbits=16, grid=1e-3, batch=2)
    plain = _drive_mod(tstream.ModularSink(TQ, device="cpu", mesh=None,
                                           **kw), z, corr)
    split = _drive_mod(tstream.ModularSink(TQ, device="cpu", mesh=_mesh(n),
                                           **kw), z, corr)
    ref = _drive_mod(jstream.ModularSink(TQ, mesh=None, **kw), z, corr)
    assert split.shape == (TQ,) and torch.equal(plain, split)
    np.testing.assert_array_equal(split.numpy(), ref)


@pytest.mark.parametrize("n", SHARDS)
def test_stream_functions_take_the_mesh(n):
    bufs, corr = _f32_rows(4, 7), _f32_rows(4, 8)
    w = np.full(4, 0.25, np.float32)
    a = tstream.stream_masked_packed(bufs, w, corrections=corr, batch=3,
                                     device="cpu", mesh=None)
    b = tstream.stream_masked_packed(bufs, w, corrections=corr, batch=3,
                                     device="cpu", mesh=_mesh(n))
    assert torch.equal(a, b)
    msgs = [{"scheme": "masked_int8", "size": TQ, "mbits": 16,
             "grid": 1e-3, "z": r} for r in _residues(3, 9)]
    a = tstream.stream_reduce_masked(msgs, batch=2, device="cpu", mesh=None)
    b = tstream.stream_reduce_masked(msgs, batch=2, device="cpu",
                                     mesh=_mesh(n))
    assert torch.equal(a, b)
    rng = np.random.default_rng(10)
    msgs = [compression.compress(rng.normal(size=TQ).astype(np.float32),
                                 "int8") for _ in range(3)]
    ws = [3.0, 1.0, 2.0]
    a, na = tstream.stream_reduce_compressed(msgs, ws, batch=2, device="cpu",
                                             mesh=None, return_norms=True)
    b, nb = tstream.stream_reduce_compressed(msgs, ws, batch=2, device="cpu",
                                             mesh=_mesh(n), return_norms=True)
    assert torch.equal(a, b) and na == nb
