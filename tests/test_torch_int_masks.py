"""Integer-domain pairwise masks of the PyTorch port against the JAX package.

``int_mask_offset`` and ``int_repair_correction`` are bitwise equal to
the reference's for every cohort member, at both mask moduli; the
offsets of a full cohort sum to 0 mod 2**mbits; the modulus width
follows the reference's for every cohort size.
"""
import numpy as np
import pytest
import torch

from repro.core import secure_agg as jsa
from repro_torch.core import secure_agg as tsa

SECRET = b"int-mask-secret"
SIZE = 3001


def _cohort(n):
    return [f"silo-{i}" for i in range(n)]


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_mask_modulus_bits_matches_jax(bits):
    for n in list(range(0, 140)) + [255, 256, 257, 1000]:
        assert tsa.mask_modulus_bits(n, bits) == jsa.mask_modulus_bits(
            n, bits)


@pytest.mark.parametrize("mbits", [16, 32])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_int_mask_offset_bit_exact(n, mbits):
    cohort = _cohort(n)
    for cid in cohort:
        j = np.asarray(jsa.int_mask_offset(SIZE, cid, cohort, SECRET, mbits))
        t = tsa.int_mask_offset(SIZE, cid, cohort, SECRET, mbits,
                                device="cpu")
        assert t.dtype == torch.uint32 and t.shape == (SIZE,)
        assert j.dtype == np.uint32
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("mbits", [16, 32])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_int_repair_correction_bit_exact(n, mbits):
    cohort = _cohort(n)
    dropped = cohort[1:2]
    for cid in cohort:
        if cid in dropped:
            continue
        j = np.asarray(jsa.int_repair_correction(SIZE, cid, dropped, SECRET,
                                                 mbits))
        t = tsa.int_repair_correction(SIZE, cid, dropped, SECRET, mbits,
                                      device="cpu")
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("mbits", [16, 32])
@pytest.mark.parametrize("n", [2, 3, 7])
def test_offsets_cancel_mod_modulus(n, mbits):
    cohort = _cohort(n)
    acc = np.zeros(SIZE, np.uint32)
    for cid in cohort:
        off = tsa.int_mask_offset(SIZE, cid, cohort, SECRET, mbits,
                                  device="cpu").numpy()
        acc = acc + off                         # uint32 wraps mod 2**32
        assert off.any()                        # each offset is a mask
    np.testing.assert_array_equal(acc & np.uint32((1 << mbits) - 1), 0)


def test_single_member_cohort_has_zero_offset():
    off = tsa.int_mask_offset(64, "only", ["only"], SECRET, 16,
                              device="cpu")
    assert off.dtype == torch.uint32
    assert not off.numpy().any()


def test_u32_helpers_round_trip():
    vals = np.array([0, 1, 2 ** 15, 2 ** 16 - 1, 2 ** 31, 2 ** 32 - 1],
                    np.int64)
    u = tsa.u32_from_i64(torch.from_numpy(vals))
    assert u.dtype == torch.uint32
    np.testing.assert_array_equal(u.numpy().astype(np.int64), vals)
    np.testing.assert_array_equal(tsa.u32_to_i64(u).numpy(), vals)
    for arr in (vals.astype(np.uint32), u, u.view(torch.int32)):
        bits = tsa.u32_bits(arr)
        assert bits.dtype == torch.int32
        np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                      vals.astype(np.uint32))
    small = np.array([0, 1, 40000, 65535], np.uint16)
    np.testing.assert_array_equal(tsa.u32_bits(small).numpy(),
                                  small.astype(np.int32))
    for bad in (torch.zeros(3), torch.from_numpy(vals)):
        with pytest.raises(TypeError):
            tsa.u32_bits(bad)
