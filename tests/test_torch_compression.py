"""The port's copy of ``core/compression.py`` against the JAX package.

Same inputs, same seeds: the wire dicts of ``compress`` (topk; int8 at 8
and 4 bits, adaptive and fixed grid) and ``masked_compress`` (with and
without DP) are bitwise equal to the reference's, and so are three
rounds of ``ErrorFeedback.step`` / ``step_masked`` with their residuals.
``reduce_masked`` decodes bitwise equal; ``reduce_compressed`` agrees
within 1e-5 (the K3 row sums run in another order) with the same norms
(rel 1e-6).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.core import secure_agg as jsa
from repro_torch.core import compression as tc
from repro_torch.core import secure_agg as tsa

T = 3000                     # not a CHUNK multiple: the padded tail counts
COHORT = ["gridpower", "solarx", "windco"]
SECRET = b"compression-secret"


def _buf(seed, scale=0.004, t=T):
    return (np.random.default_rng(seed).normal(size=t) * scale).astype(
        np.float32)


def assert_wire_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray):
            assert isinstance(vb, np.ndarray), k
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            assert va.tobytes() == vb.tobytes(), k
        else:
            assert type(va) is type(vb) and va == vb, k


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_compress_topk_wire_equal(ratio):
    x = _buf(1)
    assert_wire_equal(tc.compress(x, "topk", ratio=ratio),
                      jc.compress(x, "topk", ratio=ratio))


@pytest.mark.parametrize("grid", [0.0, 0.02 / 127], ids=["adaptive", "grid"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", [None, 3])
def test_compress_int8_wire_equal(bits, grid, seed):
    x = _buf(2)
    rng = (lambda: None) if seed is None else (
        lambda: np.random.default_rng(seed))
    tmsg = tc.compress(torch.from_numpy(x), "int8", bits=bits, grid=grid,
                       rng=rng())
    jmsg = jc.compress(x, "int8", bits=bits, grid=grid, rng=rng())
    assert_wire_equal(tmsg, jmsg)
    np.testing.assert_array_equal(tc.decompress(tmsg), jc.decompress(jmsg))
    np.testing.assert_array_equal(tc.quantized_values(tmsg),
                                  jc.quantized_values(jmsg))
    assert tc.wire_bytes(tmsg) == jc.wire_bytes(jmsg)
    assert tc.update_norm(tmsg) == jc.update_norm(jmsg)


def test_compress_rejects_unknown_scheme():
    with pytest.raises(KeyError):
        tc.compress(_buf(0), "fp8")


# 16-bit quantization widens a 3-silo cohort's modulus to 32 bits
@pytest.mark.parametrize("dp_sigma", [0.0, 0.003], ids=["no_dp", "dp"])
@pytest.mark.parametrize("bits", [8, 16], ids=["mbits16", "mbits32"])
def test_masked_compress_wire_equal(bits, dp_sigma):
    grid = jc.DEFAULT_QUANT_RANGE / 127
    for i, cid in enumerate(COHORT):
        x = _buf(10 + i)

        def kw():
            return dict(bits=bits, grid=grid, client_id=cid, cohort=COHORT,
                        pair_secret=SECRET,
                        rng=np.random.default_rng(i),
                        dp_sigma=dp_sigma,
                        dp_rng=np.random.default_rng(99 + i))
        tmsg, tdeq = tc.masked_compress(x, device="cpu", **kw())
        jmsg, jdeq = jc.masked_compress(x, **kw())
        assert_wire_equal(tmsg, jmsg)
        np.testing.assert_array_equal(tdeq, jdeq)
        assert tc.wire_bytes(tmsg) == jc.wire_bytes(jmsg)
    assert tmsg["mbits"] == {8: 16, 16: 32}[bits]


def test_masked_compress_dp_needs_rng():
    with pytest.raises(ValueError):
        tc.masked_compress(_buf(0), grid=0.001, client_id="a",
                           cohort=["a", "b"], pair_secret=SECRET,
                           dp_sigma=0.1, device="cpu")


@pytest.mark.parametrize("scheme,kw", [
    ("int8", {}), ("int8", {"quant_range": 0.02}), ("int8", {"bits": 4}),
    ("topk", {"ratio": 0.2})], ids=["int8", "int8_grid", "int4", "topk"])
def test_error_feedback_step_three_rounds(scheme, kw):
    tef = tc.ErrorFeedback(scheme, seed=7, **kw)
    jef = jc.ErrorFeedback(scheme, seed=7, **kw)
    for r in range(3):
        delta = _buf(20 + r)
        assert_wire_equal(tef.step(delta), jef.step(delta))
        np.testing.assert_array_equal(tef.residual, jef.residual)


@pytest.mark.parametrize("dp", [None, {"clip": 0.05, "sigma_total": 0.01}],
                         ids=["no_dp", "dp"])
def test_error_feedback_step_masked_three_rounds(dp):
    for i, cid in enumerate(COHORT):
        tef = tc.ErrorFeedback("int8", seed=i, dp=dp, dp_seed=40 + i,
                               device="cpu")
        jef = jc.ErrorFeedback("int8", seed=i, dp=dp, dp_seed=40 + i)
        for r in range(3):
            delta = _buf(30 + 3 * i + r)
            kw = dict(weight=0.5 + i, client_id=cid, cohort=COHORT,
                      pair_secret=SECRET)
            assert_wire_equal(tef.step_masked(torch.from_numpy(delta), **kw),
                              jef.step_masked(delta, **kw))
            np.testing.assert_array_equal(tef.residual, jef.residual)
        tef.reset()
        assert tef.residual is None


def test_make_error_feedback_seeds_like_reference():
    job = SimpleNamespace(compression="int8", compression_ratio=0.1,
                          quant_bits=8, quant_range=0.0, dp_epsilon=2.0,
                          dp_delta=1e-5, dp_clip=0.1, dp_seed=3)
    tef = tc.make_error_feedback(job, "windco", device="cpu")
    jef = jc.make_error_feedback(job, "windco")
    assert tef.dp == jef.dp
    delta = _buf(50)
    kw = dict(weight=1.0, client_id="windco", cohort=COHORT,
              pair_secret=SECRET)
    assert_wire_equal(tef.step_masked(delta, **kw),
                      jef.step_masked(delta, **kw))
    with pytest.raises(ValueError):
        tc.ErrorFeedback("none")


@pytest.mark.parametrize("eps,delta,clip", [(1.0, 1e-5, 0.1), (8.0, 1e-3, 2)])
def test_dp_sigma_total_equal(eps, delta, clip):
    assert tc.dp_sigma_total(eps, delta, clip) == jc.dp_sigma_total(
        eps, delta, clip)
    with pytest.raises(ValueError):
        tc.dp_sigma_total(0.0, delta, clip)
    with pytest.raises(ValueError):
        tc.dp_sigma_total(eps, 1.0, clip)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_reduce_compressed_matches_jax(scheme):
    msgs = [jc.compress(_buf(60 + i, scale=1.0), scheme, ratio=0.2,
                        rng=np.random.default_rng(i)) for i in range(4)]
    w = np.random.default_rng(7).uniform(0.1, 1.0, 4).astype(np.float32)
    jout, jnorms = jc.reduce_compressed(msgs, w, return_norms=True)
    tout, tnorms = tc.reduce_compressed(msgs, w, return_norms=True,
                                        device="cpu")
    assert isinstance(tout, torch.Tensor) and tout.shape == (T,)
    np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5)
    np.testing.assert_allclose(tnorms, jnorms, rtol=1e-6)
    dense = np.sum([wi * jc.decompress(m).astype(np.float64)
                    for wi, m in zip(w, msgs)], axis=0)
    np.testing.assert_allclose(tc.reduce_compressed(msgs, w, device="cpu")
                               .numpy(), dense, atol=1e-5)


def test_reduce_compressed_refuses_mixed_cohorts():
    a = jc.compress(_buf(1), "topk")
    b = jc.compress(_buf(2), "int8")
    with pytest.raises(ValueError):
        tc.reduce_compressed([a, b], [1.0, 1.0], device="cpu")
    with pytest.raises(ValueError):
        tc.reduce_compressed([a, jc.compress(_buf(1, t=10), "topk")],
                             [1.0, 1.0], device="cpu")
    with pytest.raises(ValueError):
        tc.reduce_compressed([], [], device="cpu")


def _masked_msgs(cohort, seed=0, bits=8):
    grid = jc.DEFAULT_QUANT_RANGE / 127
    out = []
    for i, cid in enumerate(cohort):
        msg, _ = jc.masked_compress(_buf(seed + i), bits=bits, grid=grid,
                                    client_id=cid, cohort=cohort,
                                    pair_secret=SECRET,
                                    rng=np.random.default_rng(seed + i))
        out.append(msg)
    return out


@pytest.mark.parametrize("bits", [8, 16], ids=["mbits16", "mbits32"])
def test_reduce_masked_bitwise(bits):
    msgs = _masked_msgs(COHORT, seed=5, bits=bits)
    assert msgs[0]["mbits"] == {8: 16, 16: 32}[bits]
    rng = np.random.default_rng(bits)
    jout = jc.reduce_masked(msgs)
    for order in (rng.permutation(3), rng.permutation(3)):
        tout = tc.reduce_masked([msgs[i] for i in order], device="cpu")
        np.testing.assert_array_equal(tout.numpy().view(np.uint32),
                                      jout.view(np.uint32))
    tout = tc.reduce_masked(msgs, device="cpu")
    assert tout.dtype == torch.float32 and tout.shape == (T,)
    np.testing.assert_array_equal(tout.numpy().view(np.uint32),
                                  jout.view(np.uint32))


def test_reduce_masked_repair_bitwise():
    msgs = dict(zip(COHORT, _masked_msgs(COHORT, seed=8)))
    survivors = ["gridpower", "windco"]
    mbits = msgs["windco"]["mbits"]
    tp = T + (-T) % 1024
    jcorr = [np.asarray(jsa.int_repair_correction(tp, c, ["solarx"], SECRET,
                                                  mbits)) for c in survivors]
    tcorr = [tsa.int_repair_correction(tp, c, ["solarx"], SECRET, mbits,
                                       device="cpu") for c in survivors]
    jout = jc.reduce_masked([msgs[c] for c in survivors], corrections=jcorr)
    tout = tc.reduce_masked([msgs[c] for c in survivors], corrections=tcorr,
                            device="cpu")
    np.testing.assert_array_equal(tout.numpy().view(np.uint32),
                                  jout.view(np.uint32))
    with pytest.raises(ValueError):
        tc.reduce_masked([msgs[c] for c in survivors], corrections=tcorr[:1],
                         device="cpu")
    with pytest.raises(ValueError):
        tc.reduce_masked([msgs["windco"]], corrections=tcorr, device="cpu")


def test_masked_wire_cannot_be_decoded_alone():
    msg = _masked_msgs(COHORT)[0]
    with pytest.raises(ValueError):
        tc.decompress(msg)
    with pytest.raises(ValueError):
        tc.update_norm(msg)
    with pytest.raises(ValueError):
        tc.reduce_masked([msg, dict(msg, grid=1.0)], device="cpu")
