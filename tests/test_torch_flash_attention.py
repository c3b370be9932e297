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

The card's bf16 kernel rounds at other points than the plain version:
``_emulate_tensor_core`` repeats them in plain torch (bf16 q and k into
f32 scores, an online softmax over 128-key tiles with f32 m and l, P
split into bf16 hi + lo into an f32 PV, the l clamp, a round-to-nearest
bf16 store) and is held against the JAX oracle and against the half-ulp
limit that ``chip_smoke.py`` holds the kernel to.
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
LOG2E = 1.4426950408889634
HALF_ULP = 2.0 ** -8            # chip_smoke.py's BF16_HALF_ULP


def _emulate_tensor_core(q, k, v, *, causal, window, cap, split=True,
                         tile=128):
    """The rounding points of K6's bf16 tensor-core kernel, in plain torch:
    q, k, v (B,S,H,D) / (B,S,Hkv,D) bf16 -> (B,S,H,D) bf16. ``split=False``
    rounds P to bf16 once instead of hi + lo."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (a.float().repeat_interleave(G, 2).transpose(1, 2)
              for a in (k, v))
    scale = D ** -0.5
    m = torch.full((B, H, S), float("-inf"))
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    i = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        j = torch.arange(k0, min(k0 + tile, S))[None, :]
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)    # f32 scores
        if cap > 0:
            x = cap * torch.tanh(s * scale / cap) * LOG2E
        else:
            x = s * (scale * LOG2E)
        vis = torch.ones((S, j.shape[1]), dtype=torch.bool)
        if causal:
            vis &= j <= i
        if window > 0:
            vis &= j > i - window
        x = torch.where(vis, x, float("-inf"))
        mn = torch.maximum(m, x.amax(-1))
        mu = torch.where(mn == float("-inf"), 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(x - mu[..., None])
        l = l * alpha + p.sum(-1)
        vt = vf[:, :, k0:k0 + tile]
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha[..., None] + pv
        m = mn
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.bfloat16().transpose(1, 2)


def _half_ulp_used(out, want):
    """Share of chip_smoke.py's limit for a bf16 output against the f32
    attention of the widened inputs: half a bf16 ulp plus twice the f32
    tolerance."""
    t32 = 2 * TOL["float32"]
    return float((np.abs(out.float().numpy() - want)
                  / (HALF_ULP * np.abs(want) + t32 + t32 * np.abs(want)))
                 .max())


def _jax_f32(bf, case):
    """The JAX oracle in f32 on the widened bf16 inputs, (B,S,H,D)."""
    D, causal, window, cap = case[4:]
    return np.asarray(jref(
        *(jnp.asarray(t.float().numpy()).swapaxes(1, 2) for t in bf),
        scale=D ** -0.5, causal=causal, window=window,
        softcap=cap).swapaxes(1, 2), np.float32)


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
    assert _half_ulp_used(out, _jax_f32(bf, case)) <= 1.0


@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES[:1])
def test_tensor_core_rounding_matches_jax(case):
    """The bf16 kernel's rounding points, emulated on the CPU, stay within
    the bf16 tolerance of the JAX oracle in bf16."""
    B, S, H, Hkv, D, causal, window, cap = case
    q, k, v = _inputs(case)
    out = _emulate_tensor_core(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=causal, window=window, cap=cap)
    want = jref(*(jnp.asarray(a, jnp.bfloat16).swapaxes(1, 2)
                  for a in (q, k, v)),
                scale=D ** -0.5, causal=causal, window=window,
                softcap=cap).swapaxes(1, 2)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES)
def test_tensor_core_rounding_within_half_ulp(case):
    """With P split into bf16 hi + lo the emulated kernel holds the same
    half-ulp limit as the plain version: P keeps about 16 bits."""
    B, S, H, Hkv, D, causal, window, cap = case
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(case)]
    out = _emulate_tensor_core(*bf, causal=causal, window=window, cap=cap)
    assert _half_ulp_used(out, _jax_f32(bf, case)) <= 1.0


def test_single_bf16_rounding_of_p_breaks_the_limit():
    """Why the kernel splits P: rounded to bf16 once, P alone takes the
    output past half a bf16 ulp of the f32 result."""
    case = (1, 1024, 2, 1, 64, True, 0, 0.0)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(case)]
    want = _jax_f32(bf, case)
    kw = dict(causal=True, window=0, cap=0.0)
    assert _half_ulp_used(_emulate_tensor_core(*bf, **kw), want) <= 1.0
    assert _half_ulp_used(_emulate_tensor_core(*bf, split=False, **kw),
                          want) > 2.0


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


def test_kernel_checks_tma_alignment_and_dispatch():
    """bf16 goes to the tensor-core kernel, whose TMA maps need 16-byte
    bases and (b, s, h) strides; f32 to the CUDA-core kernel, which does
    not. A dim of size 1 is never stepped over, so its stride is free."""
    from repro_torch.kernels.flash_attention import kernel
    assert ops.VARIANT == {torch.bfloat16: "flash_attention",
                           torch.float32: "flash_attention_f32"}
    assert set(ops.LAUNCHES) == set(ops.VARIANT.values())
    assert kernel.ENTRY[torch.bfloat16] == "flash_attention_bf16_fwd"
    assert kernel.ENTRY[torch.float32] == "flash_attention_f32_fwd"
    bf = torch.bfloat16
    q, k, v = _cuda_like((2, 8, 4, 64), (2, 8, 2, 64), (2, 8, 2, 64),
                         dtype=bf)
    ops.check_flash_attention(q, k, v, 0)
    # a fused (B, S, (H + 2 Hkv) D) buffer, as the models slice it
    qkv = torch.zeros(2, 8, 8 * 64, dtype=bf)
    ops.check_flash_attention(qkv[..., :256].view(2, 8, 4, 64),
                              qkv[..., 256:384].view(2, 8, 2, 64),
                              qkv[..., 384:].view(2, 8, 2, 64), 0)
    # MQA: one kv head, whatever its stride
    mqa = torch.zeros(2, 8, 64, 1, dtype=bf).transpose(2, 3)
    assert mqa.stride(2) == 1
    ops.check_flash_attention(q, mqa, mqa, 0)
    shifted = torch.zeros(2 * 8 * 4 * 64 + 1, dtype=bf)[1:].view(2, 8, 4, 64)
    with pytest.raises(ValueError, match="base is not 16-byte"):
        ops.check_flash_attention(shifted, k, v, 0)
    ragged = torch.zeros(2, 8, 2, 68, dtype=bf)[..., :64]
    with pytest.raises(ValueError, match="h stride 68 is not a 16-byte"):
        ops.check_flash_attention(q, ragged, v, 0)
    ops.check_flash_attention(*(a.float() for a in (shifted, k)),
                              ragged.float(), 0)
