"""The threefry mask stream (``prg="threefry"``) of the PyTorch port
against the JAX package.

Bitwise: the bits against ``jax.random.bits(key, (T,), uint32)`` (jax's
partitionable threefry, its default) for pair keys of the reference's
form ``[0, seed]`` and raw keys with both words set, at sizes that are
not powers of two; the masked buffers of ``mask_packed`` and the repair
corrections of ``repair_correction`` against the reference's, whose
``lax.scan`` body XLA contracts into one FMA a pair as it does the fast
path's unrolled loop. Then the cohort cancels, as
``tests/test_secure_packed.py`` asserts of the reference.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import secure_agg as jsa
from repro_torch.core import secure_agg as tsa

COHORT = ["gridpower", "solarx", "windco"]
COHORT8 = [f"silo-{i}" for i in range(8)]
SECRET = b"pair-secret"
KEYS = [(0, 0), (0, 12345), (0, 0xFFFFFFFF), (0, 0x80000007),
        (0x9E3779B9, 0x7F4A7C15), (0xFFFFFFFF, 1)]
SIZES = [1, 3, 5003, 100_003, (1 << 17) + 11]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]:x}-{k[1]:x}")
def test_threefry_bits_equal_jax_random_bits(key, size):
    jkey = jnp.asarray(key, dtype=jnp.uint32)
    jbits = np.asarray(jax.random.bits(jkey, (size,), jnp.uint32))
    tbits = tsa.threefry_bits(torch.arange(size, dtype=torch.int64), *key)
    assert tbits.dtype == torch.int64
    assert int(tbits.min()) >= 0 and int(tbits.max()) < 2 ** 32
    np.testing.assert_array_equal(jbits.astype(np.int64), tbits.numpy())


def test_pair_keys_are_threefry_keys():
    """The reference draws each pair's stream from ``PRNGKey(seed)``; the
    port's pair-key words give the same bits."""
    for other in COHORT[1:]:
        seed = tsa._pair_seed(SECRET, COHORT[0], other)
        jbits = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (777,),
                                           jnp.uint32))
        keys, _ = tsa.pair_keys(COHORT[0], [COHORT[0], other], SECRET)
        tbits = tsa.threefry_bits(torch.arange(777), *keys[0].tolist())
        np.testing.assert_array_equal(jbits.astype(np.int64), tbits.numpy())


@pytest.mark.parametrize("cohort", [COHORT, COHORT8])
def test_mask_packed_threefry_bit_exact(cohort):
    buf = (np.random.default_rng(3).normal(size=5003) * 0.05).astype(
        np.float32)
    for cid in cohort:
        jm = np.asarray(jsa.mask_packed(jnp.asarray(buf), cid, cohort,
                                        SECRET, prg="threefry"))
        tm = tsa.mask_packed(buf, cid, cohort, SECRET, prg="threefry",
                             device="cpu")
        np.testing.assert_array_equal(jm.view(np.uint32),
                                      tm.numpy().view(np.uint32))


@pytest.mark.parametrize("scale", [tsa.DEFAULT_SCALE, 2.0])
def test_repair_correction_threefry_bit_exact(scale):
    for cid in ("gridpower", "windco"):
        jc = np.asarray(jsa.repair_correction(3001, cid, ["solarx"], SECRET,
                                              scale, "threefry"))
        tc = tsa.repair_correction(3001, cid, ["solarx"], SECRET, scale,
                                   "threefry", device="cpu")
        np.testing.assert_array_equal(jc.view(np.uint32),
                                      tc.numpy().view(np.uint32))


def test_threefry_masked_cohort_cancels_and_repairs():
    """As ``tests/test_secure_packed.py::test_threefry_prg_also_telescopes``
    for the reference: every post is masked, the cohort sum is the plain
    sum; after a dropout the corrections repair the survivors' sum."""
    cohort = ["a", "b", "c"]
    bufs = [np.full((50,), float(i), np.float32) for i in range(3)]
    masked = [tsa.mask_packed(b, cid, cohort, b"s", 2.0, "threefry",
                              device="cpu")
              for b, cid in zip(bufs, cohort)]
    assert float((masked[0] - torch.from_numpy(bufs[0])).abs().max()) > 0.01
    agg = tsa.aggregate_masked_packed(masked, device="cpu")
    np.testing.assert_allclose(agg.numpy(), 1.0, atol=1e-5)
    corr = [tsa.repair_correction(50, cid, ["c"], b"s", 2.0, "threefry",
                                  device="cpu") for cid in ("a", "b")]
    total = tsa.aggregate_masked_packed(masked[:2], np.ones(2),
                                        corrections=corr, device="cpu")
    np.testing.assert_allclose(total.numpy(), bufs[0] + bufs[1], atol=1e-5)


def test_threefry_stream_differs_from_fast():
    buf = np.zeros(64, np.float32)
    fast = tsa.mask_packed(buf, "a", ["a", "b"], SECRET, device="cpu")
    tf = tsa.mask_packed(buf, "a", ["a", "b"], SECRET, prg="threefry",
                         device="cpu")
    assert not torch.equal(fast, tf)


def test_unknown_prg_raises():
    with pytest.raises(ValueError, match="unknown prg"):
        tsa.mask_packed(np.zeros(8, np.float32), "a", ["a", "b"], SECRET,
                        prg="philox", device="cpu")


def test_reference_scan_body_is_one_fma():
    """XLA contracts the reference's threefry ``lax.scan`` body into one
    FMA a pair, as it does the fast path's loop: the port's FMA form is
    bitwise the reference's, the form with two roundings is not."""
    buf = (np.random.default_rng(9).normal(size=4099) * 0.05).astype(
        np.float32)
    jm = np.asarray(jsa.mask_packed(jnp.asarray(buf), "solarx", COHORT,
                                    SECRET, prg="threefry"))
    keys, signs = tsa.pair_keys("solarx", COHORT, SECRET)
    idx = torch.arange(buf.size, dtype=torch.int64)
    two_roundings = torch.from_numpy(buf.copy())
    for (k0, k1), sign in zip(keys.tolist(), signs):
        u = tsa._uniform_from_bits(tsa.threefry_bits(idx, k0, k1))
        two_roundings = two_roundings + (
            sign * torch.tensor(tsa.DEFAULT_SCALE, dtype=torch.float32)) * u
    fma = tsa.mask_packed(buf, "solarx", COHORT, SECRET, prg="threefry",
                          device="cpu")
    np.testing.assert_array_equal(jm.view(np.uint32),
                                  fma.numpy().view(np.uint32))
    assert not np.array_equal(jm.view(np.uint32),
                              two_roundings.numpy().view(np.uint32))
