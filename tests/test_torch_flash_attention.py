"""K6 flash attention of the PyTorch port against the JAX package.

On the CPU ``ops.flash_attention`` runs its plain version
(``ref.attention_ref``, f32 scores and probabilities). It is held against
the JAX oracle ``repro.kernels.flash_attention.ref.attention_ref`` on
every ``FLASH_CASES`` shape of ``tests/test_kernels.py`` in f32 and bf16,
on identical numpy inputs, at that file's tolerances: 2e-5 in f32 (the
two frameworks sum in other orders) and 2e-2 in bf16 (one bf16 rounding
of the output). The JAX Pallas kernel itself does not run on the
installed jax (no ``pl.load``), so the oracle is the reference. No CPU
call may count as a kernel launch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import ops, ref
from test_kernels import FLASH_CASES

RAGGED_CASES = [
    # B, S, H, Hkv, D, causal, window, softcap: S not a tile multiple
    (2, 200, 6, 2, 64, True, 64, 0.0),
    (1, 77, 4, 1, 32, False, 0, 30.0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, seed=0):
    B, S, H, Hkv, D = case[:5]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def _compare(case, dtype):
    B, S, H, Hkv, D, causal, window, cap = case
    q, k, v = _inputs(case)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window, logit_softcap=cap)
    assert ops.LAUNCHES == before
    assert out.shape == (B, S, H, D) and out.dtype == tdt
    want = jref(*(jnp.asarray(a, jdt).swapaxes(1, 2) for a in (q, k, v)),
                scale=D ** -0.5, causal=causal, window=window,
                softcap=cap).swapaxes(1, 2)
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_attention_matches_jax(case, dtype):
    _compare(case, dtype)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_plain_flash_attention_ragged(case):
    _compare(case, "float32")


@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES)
def test_plain_bf16_rounds_to_nearest(case):
    """The bf16 output is the f32 attention of the widened bf16 inputs
    rounded to nearest: within half a bf16 ulp (2^-8 of the value) plus
    twice the f32 tolerance of the JAX oracle in f32. A truncating store
    is off by up to a whole ulp. ``chip_smoke.py`` holds K6 to this rule
    on the card."""
    B, S, H, Hkv, D, causal, window, cap = case
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(case)]
    out = ops.flash_attention(*bf, causal=causal, window=window,
                              logit_softcap=cap)
    want = np.asarray(jref(
        *(jnp.asarray(t.float().numpy()).swapaxes(1, 2) for t in bf),
        scale=D ** -0.5, causal=causal, window=window,
        softcap=cap).swapaxes(1, 2), np.float32)
    t32 = 2 * TOL["float32"]
    limit = 2.0 ** -8 * np.abs(want) + t32 + t32 * np.abs(want)
    assert (np.abs(out.float().numpy() - want) <= limit).all()


def test_window_and_causal_mask_positions():
    """Row i sees exactly keys (i - window, i]: one-hot values read back
    which keys got weight."""
    S, W = 12, 4
    q = torch.zeros(1, S, 1, 32)
    k = torch.zeros(1, S, 1, 32)
    v = torch.eye(S, 32)[None, :, None, :]
    out = ops.flash_attention(q, k, v, causal=True, window=W)[0, :, 0, :S]
    for i in range(S):
        seen = {j for j in range(S) if float(out[i, j]) > 0}
        assert seen == set(range(max(0, i - W + 1), i + 1))


def _cuda_like(*shapes, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype) for s in shapes]


@pytest.mark.parametrize("bad,match", [
    ((2, 8, 4, 48), "head dim"),
    ((2, 8, 3, 64), "group"),
])
def test_kernel_checks_raise(bad, match):
    q = torch.zeros(bad)
    k, v = _cuda_like((2, 8, 2, bad[-1]), (2, 8, 2, bad[-1]))
    with pytest.raises(ValueError, match=match):
        ops.check_flash_attention(q, k, v, 0)


def test_kernel_checks_dtype_layout_and_grad():
    q, k, v = _cuda_like((1, 8, 2, 64), (1, 8, 1, 64), (1, 8, 1, 64))
    ops.check_flash_attention(q, k, v, 16)
    with pytest.raises(ValueError, match="q is"):
        ops.check_flash_attention(q, k.to(torch.bfloat16), v, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.check_flash_attention(q.half(), k.half(), v.half(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.check_flash_attention(
            torch.zeros(1, 8, 64, 2).transpose(2, 3), k, v, 0)
    with pytest.raises(ValueError, match="window"):
        ops.check_flash_attention(q, k, v, -1)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.check_flash_attention(q.requires_grad_(True), k, v, 0)


def test_plain_version_is_ref_in_bhsd():
    case = FLASH_CASES[0]
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, seed=3))
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), scale=q.shape[-1] ** -0.5,
                             causal=True, window=0, softcap=0.0)
    assert torch.equal(out, want.transpose(1, 2))
