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
