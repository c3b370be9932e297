"""Streaming fp32 sink of the PyTorch port against the JAX package.

Batch 2 over 5 buffers flushes several times; unfold and fold_correction
run in between. The reference runs with ``mesh=None`` (one device).
atol 1e-6: folds are fp32 sums of the same rows in batch order, so the
two sides differ at most at rounding level.
"""
import numpy as np
import pytest
import torch

from repro.core import secure_agg as jsa
from repro.core import streaming as jstream
from repro_torch.core import secure_agg as tsa
from repro_torch.core import streaming as tstream

T = 3001
ATOL = 1e-6


def _bufs(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=T) * 0.05).astype(np.float32) for _ in range(n)]


def _drive(sink, bufs, corr):
    for b in bufs:
        sink.fold(b)
    sink.unfold(bufs[1])
    sink.fold_correction(corr[0])
    sink.fold_correction(corr[1], 0.5)
    sink.unfold_correction(corr[1], 0.5)
    return sink.finalize()


def test_masked_sink_matches_jax():
    bufs, corr = _bufs(5, 0), _bufs(2, 1)
    jsink = jstream.MaskedF32Sink(T, batch=2, mesh=None)
    tsink = tstream.MaskedF32Sink(T, batch=2, device="cpu")
    jout = _drive(jsink, bufs, corr)
    tout = _drive(tsink, [torch.from_numpy(b) for b in bufs], corr)
    assert isinstance(tout, torch.Tensor) and tout.shape == (T,)
    np.testing.assert_allclose(tout.numpy(), jout, atol=ATOL)
    expect = (np.sum(bufs, axis=0) - bufs[1] - corr[0])
    np.testing.assert_allclose(tout.numpy(), expect, atol=ATOL)
    assert tsink.n_folded == jsink.n_folded == 4
    assert tsink.fold_batches == jsink.fold_batches == 5
    assert tsink.peak_bytes == jsink.peak_bytes


def test_sink_edges():
    sink = tstream.MaskedF32Sink(T, device="cpu")
    assert float(sink.finalize().abs().sum()) == 0.0
    with pytest.raises(RuntimeError):
        sink.fold(np.zeros(T, np.float32))
    with pytest.raises(ValueError):
        tstream.MaskedF32Sink(T, device="cpu").fold(np.zeros(T + 1))
    with pytest.raises(ValueError):
        tstream.MaskedF32Sink(0, device="cpu")


@pytest.mark.parametrize("batch", [1, 8])
def test_stream_masked_packed_matches_stacked_repair(batch):
    cohort = ["gridpower", "solarx", "windco"]
    secret = b"s"
    plain = dict(zip(cohort, _bufs(3, 2)))
    survivors = ["gridpower", "windco"]
    masked = [np.asarray(jsa.mask_packed(plain[c], c, cohort, secret))
              for c in survivors]
    corr = [np.asarray(jsa.repair_correction(T, c, ["solarx"], secret))
            for c in survivors]
    ones = np.ones(2, np.float32)
    jstacked = np.asarray(jsa.aggregate_masked_packed(masked, ones,
                                                      corrections=corr))
    tstreamed = tstream.stream_masked_packed(masked, ones, corrections=corr,
                                             batch=batch, device="cpu")
    tstacked = tsa.aggregate_masked_packed(masked, ones, corrections=corr,
                                           device="cpu")
    np.testing.assert_allclose(tstreamed.numpy(), jstacked, atol=ATOL)
    np.testing.assert_allclose(tstacked.numpy(), jstacked, atol=ATOL)
    np.testing.assert_allclose(tstreamed.numpy(),
                               plain["gridpower"] + plain["windco"],
                               atol=ATOL)
    # uniform-mean default, no corrections
    jmean = jstream.stream_masked_packed(masked, mesh=None)
    np.testing.assert_allclose(
        tstream.stream_masked_packed(masked, device="cpu").numpy(), jmean,
        atol=ATOL)


# ---------------------------------------------------------------------------
# ModularSink, QuantSink and TopkSink against the reference sinks
# ---------------------------------------------------------------------------
TQ = 3000                     # not a CHUNK multiple: padding counts
TP = 3072


def _residues(rng, n, size, hi):
    return [rng.integers(0, hi, size=size, dtype=np.uint64).astype(np.uint32)
            for _ in range(n)]


def _drive_modular(sink, rows, corr, order, as_tensor):
    def wrap(z):
        return torch.from_numpy(z) if as_tensor else z
    for i in order:
        sink.fold(wrap(rows[i]))
    sink.unfold(wrap(rows[3]))
    sink.fold_correction(wrap(corr[0]))
    sink.fold_correction(wrap(corr[1]))
    sink.unfold_correction(wrap(corr[1]))
    return sink.finalize()


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("mbits", [16, 32])
def test_modular_sink_bitwise_any_order(mbits, batch):
    rng = np.random.default_rng(mbits + batch)
    hi = 2 ** mbits
    # arrival lengths: logical t and the CHUNK-padded tp, mixed
    rows = _residues(rng, 2, TQ, hi) + _residues(rng, 3, TP, hi)
    corr = _residues(rng, 2, TP, hi)
    grid = 0.02 / 127
    jsink = jstream.ModularSink(TQ, mbits=mbits, grid=grid, batch=batch,
                                mesh=None)
    jout = _drive_modular(jsink, rows, corr, range(5), False)
    for k, order in enumerate([range(5), rng.permutation(5),
                               rng.permutation(5)]):
        tsink = tstream.ModularSink(TQ, mbits=mbits, grid=grid, batch=batch,
                                    device="cpu")
        tout = _drive_modular(tsink, rows, corr, list(order), k == 1)
        assert tout.dtype == torch.float32 and tout.shape == (TQ,)
        np.testing.assert_array_equal(tout.numpy().view(np.uint32),
                                      jout.view(np.uint32))
        assert tsink.n_folded == jsink.n_folded == 4
        assert tsink.fold_batches == jsink.fold_batches


def test_modular_sink_wraps_uint32_and_takes_the_wire_uint16():
    """Row sums past 2**32 wrap exactly; uint16 wire streams widen."""
    z = np.full(TP, 2 ** 32 - 1, np.uint32)
    sink = tstream.ModularSink(TQ, mbits=32, grid=1.0, device="cpu")
    for _ in range(5):
        sink.fold(z)
    np.testing.assert_array_equal(sink.finalize().numpy(), -5.0)
    wire = np.random.default_rng(0).integers(0, 2 ** 16, TQ).astype(
        np.uint16)
    jsink = jstream.ModularSink(TQ, mbits=16, grid=0.5, mesh=None)
    tsink = tstream.ModularSink(TQ, mbits=16, grid=0.5, device="cpu")
    for s in (jsink, tsink):
        s.fold(wire)
        s.fold(wire)
    np.testing.assert_array_equal(tsink.finalize().numpy(), jsink.finalize())
    with pytest.raises(ValueError):
        tstream.ModularSink(TQ, mbits=16, grid=1.0, device="cpu").fold(
            np.zeros(TQ + 1, np.uint32))


def _quant_msgs(n, seed):
    from repro.core.compression import compress
    rng = np.random.default_rng(seed)
    return [compress((rng.normal(size=TQ) * 0.01).astype(np.float32), "int8",
                     rng=np.random.default_rng(seed + i)) for i in range(n)]


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_quant_sink_matches_jax(batch):
    from repro.core.compression import quantized_values
    msgs = _quant_msgs(5, batch)
    w = [3.0, 5.0, 1.0, 8.0, 2.0]
    jsink = jstream.QuantSink(TQ, batch=batch, mesh=None)
    tsink = tstream.QuantSink(TQ, batch=batch, device="cpu")
    for s in (jsink, tsink):
        for i, m in enumerate(msgs):
            s.fold(f"c{i}", quantized_values(m), m["scales"], w[i])
        s.unfold("c1", quantized_values(msgs[1]), msgs[1]["scales"], w[1])
    jout, tout = jsink.finalize(), tsink.finalize()
    assert isinstance(tout, torch.Tensor) and tout.shape == (TQ,)
    np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5)
    assert tsink.total_weight == jsink.total_weight
    assert sorted(tsink.norms) == sorted(jsink.norms)
    for k in jsink.norms:
        np.testing.assert_allclose(tsink.norms[k], jsink.norms[k], rtol=1e-6)
    assert tsink.n_folded == jsink.n_folded
    assert tsink.fold_batches == jsink.fold_batches
    assert tsink.peak_bytes == jsink.peak_bytes
    with pytest.raises(ValueError):
        tstream.QuantSink(TQ, device="cpu").fold(
            "x", np.zeros(TQ + 1, np.int8), msgs[0]["scales"], 1.0)


def test_topk_sink_matches_jax():
    from repro.core.compression import compress
    rng = np.random.default_rng(9)
    msgs = [compress(rng.normal(size=TQ).astype(np.float32), "topk",
                     ratio=0.2) for _ in range(4)]
    w = [0.5, 1.5, 2.0, 0.25]
    jsink = jstream.TopkSink(TQ)
    tsink = tstream.TopkSink(TQ, device="cpu")
    for s in (jsink, tsink):
        for i, m in enumerate(msgs):
            s.fold(f"c{i}", m["idx"], m["val"], w[i])
        s.unfold("c2", msgs[2]["idx"], msgs[2]["val"], w[2])
    np.testing.assert_allclose(tsink.finalize().numpy(), jsink.finalize(),
                               atol=1e-6)
    for k in jsink.norms:
        np.testing.assert_allclose(tsink.norms[k], jsink.norms[k], rtol=1e-6)
    assert sorted(tsink.norms) == sorted(jsink.norms)
    assert tsink.n_folded == jsink.n_folded == 3
    assert tsink.total_weight == jsink.total_weight
    assert tsink.peak_bytes == jsink.peak_bytes


def test_stream_reducers_match_jax():
    from repro.core.compression import masked_compress
    cohort = ["gridpower", "solarx", "windco"]
    msgs = []
    for i, cid in enumerate(cohort):
        buf = (np.random.default_rng(i).normal(size=TQ) * 0.004).astype(
            np.float32)
        msgs.append(masked_compress(buf, grid=0.02 / 127, client_id=cid,
                                    cohort=cohort, pair_secret=b"s",
                                    rng=np.random.default_rng(i))[0])
    jout = jstream.stream_reduce_masked(iter(msgs), batch=2, mesh=None)
    tout = tstream.stream_reduce_masked(iter(msgs), batch=2, device="cpu")
    np.testing.assert_array_equal(tout.numpy().view(np.uint32),
                                  jout.view(np.uint32))
    with pytest.raises(ValueError):
        tstream.stream_reduce_masked([], device="cpu")
    qmsgs = _quant_msgs(3, 4)
    w = np.array([1.0, 2.0, 3.0], np.float32)
    jq, jn = jstream.stream_reduce_compressed(qmsgs, w, return_norms=True,
                                              batch=2, mesh=None)
    tq, tn = tstream.stream_reduce_compressed(qmsgs, w, return_norms=True,
                                              batch=2, device="cpu")
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
