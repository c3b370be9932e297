"""Pairwise-mask PRG of the PyTorch port against the JAX package.

Everything here is bit-exact: the pair keys, the lowbias32 bit stream
(with key words >= 2**31), the uniform draw, the masked buffers and the
repair corrections. The port evaluates each pair's multiply-add as the
single rounding FMA that XLA compiles the reference's expression into
(``repro_torch.core.secure_agg._apply_masks``), so masks agree to the
bit, not merely to an ulp.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import secure_agg as jsa
from repro_torch.core import secure_agg as tsa

COHORT = ["gridpower", "solarx", "windco"]
COHORT8 = [f"silo-{i}" for i in range(8)]
SECRET = b"pair-secret"


@pytest.mark.parametrize("cohort", [COHORT, COHORT8])
def test_pair_keys_equal(cohort):
    for cid in cohort:
        jk, js = jsa.pair_keys(cid, cohort, SECRET)
        tk, ts = tsa.pair_keys(cid, cohort, SECRET)
        np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                      tk.numpy())
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_prg_bit_stream_bit_exact():
    n = 100_000
    rng = np.random.default_rng(7)
    keys = [(0, 0), (0, 0xFFFFFFFF), (0x80000000, 0x7FFFFFFF)]
    keys += [tuple(int(v) for v in rng.integers(0, 2 ** 32, 2))
             for _ in range(3)]
    idx_u32 = jnp.arange(n, dtype=jnp.uint32)
    idx_i64 = torch.arange(n, dtype=torch.int64)
    high_words = 0
    for k0, k1 in keys:
        jbits = np.asarray(jsa._mix32(jsa._mix32(idx_u32 ^ jnp.uint32(k0))
                                      + jnp.uint32(k1)))
        tbits = tsa._pair_bits(idx_i64, k0, k1).numpy()
        assert tbits.min() >= 0 and tbits.max() < 2 ** 32
        np.testing.assert_array_equal(jbits.astype(np.int64), tbits)
        high_words += int((jbits >= 2 ** 31).sum())
        ju = np.asarray(jsa._uniform_from_bits(jnp.asarray(jbits)))
        tu = tsa._uniform_from_bits(torch.from_numpy(tbits)).numpy()
        np.testing.assert_array_equal(ju.view(np.uint32), tu.view(np.uint32))
    assert high_words > n          # the stream did cover words >= 2**31


@pytest.mark.parametrize("cohort", [COHORT, COHORT8])
def test_mask_packed_bit_exact(cohort):
    buf = (np.random.default_rng(3).normal(size=5003) * 0.05).astype(
        np.float32)
    for cid in cohort:
        jm = np.asarray(jsa.mask_packed(jnp.asarray(buf), cid, cohort,
                                        SECRET))
        tm = tsa.mask_packed(buf, cid, cohort, SECRET, device="cpu")
        assert tm.dtype == torch.float32 and tm.device.type == "cpu"
        np.testing.assert_array_equal(jm.view(np.uint32),
                                      tm.numpy().view(np.uint32))


def test_masked_cohort_cancels_to_plain_sum():
    rng = np.random.default_rng(4)
    bufs = [(rng.normal(size=4096) * 0.05).astype(np.float32)
            for _ in COHORT]
    masked = [tsa.mask_packed(b, cid, COHORT, SECRET, device="cpu")
              for b, cid in zip(bufs, COHORT)]
    assert all(float((m - torch.from_numpy(b)).abs().max()) > 1e-3
               for m, b in zip(masked, bufs))      # each post is masked
    total = tsa.aggregate_masked_packed(masked, np.ones(3), device="cpu")
    np.testing.assert_allclose(total.numpy(), np.sum(bufs, axis=0),
                               atol=1e-6)


def test_repair_correction_bit_exact_and_repairs():
    t = 3001
    for cid in ("gridpower", "windco"):
        jc = np.asarray(jsa.repair_correction(t, cid, ["solarx"], SECRET))
        tc = tsa.repair_correction(t, cid, ["solarx"], SECRET, device="cpu")
        np.testing.assert_array_equal(jc.view(np.uint32),
                                      tc.numpy().view(np.uint32))
    rng = np.random.default_rng(5)
    bufs = {c: (rng.normal(size=t) * 0.05).astype(np.float32)
            for c in COHORT}
    survivors = ["gridpower", "windco"]
    masked = [tsa.mask_packed(bufs[c], c, COHORT, SECRET, device="cpu")
              for c in survivors]
    corr = [tsa.repair_correction(t, c, ["solarx"], SECRET, device="cpu")
            for c in survivors]
    total = tsa.aggregate_masked_packed(masked, np.ones(2), corrections=corr,
                                        device="cpu")
    np.testing.assert_allclose(total.numpy(),
                               bufs["gridpower"] + bufs["windco"], atol=1e-6)
