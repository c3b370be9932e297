"""K7 SSD scan of the PyTorch port against the JAX package.

On the CPU ``ops.ssd_scan`` runs the plain chunked form
(``ref.ssd_chunked``). It and the port's sequential oracle
(``ref.ssd_ref``) are held against the JAX oracle ``ssd_ref``, the JAX
Pallas kernel in interpret mode (``repro.kernels.ssd_scan.ops.ssd_scan``)
and the JAX ``models.ssm.ssd_chunked`` on every ``SSD_CASES`` shape of
``tests/test_kernels.py``, on identical numpy inputs, at that file's
2e-4: all are f32, summed in other orders and over other chunk splits.
No CPU call may count as a kernel launch.

The card's kernel runs the chunk-parallel decomposition (per-chunk C B^T
and states, state passing, output); ``ref.ssd_three_pass`` is that
decomposition in plain torch and is held against the same oracles.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd_scan.ops import ssd_scan as jpallas
from repro.kernels.ssd_scan.ref import ssd_ref as jref
from repro.models.ssm import ssd_chunked as jchunked
from repro_torch.kernels.ssd_scan import kernel, ops, ref
from test_kernels import SSD_CASES

TOL = 2e-4


def _softplus(a):
    return np.log1p(np.exp(-np.abs(a))) + np.maximum(a, 0)


def _inputs(b, S, H, P, N, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, H, P)).astype(np.float32)
    dt = (_softplus(rng.normal(size=(b, S, H))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    B = rng.normal(size=(b, S, N)).astype(np.float32)
    C = rng.normal(size=(b, S, N)).astype(np.float32)
    return x, dt, A, B, C


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_scan_matches_jax(case):
    b, S, H, P, N, chunk = case
    arrs = _inputs(b, S, H, P, N)
    before = dict(ops.LAUNCHES)
    y, h = ops.ssd_scan(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    assert ops.LAUNCHES == before
    assert y.shape == (b, S, H, P) and h.shape == (b, H, P, N)
    assert y.dtype == h.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrs]
    y_ref, h_ref = jref(*j)
    y_k, h_k = jpallas(*j, chunk=chunk)
    y_c, h_c = jchunked(*j, chunk=chunk)
    for want_y, want_h in ((y_ref, h_ref), (y_k, h_k), (y_c, h_c)):
        _close(y.numpy(), want_y)
        _close(h.numpy(), want_h)


@pytest.mark.parametrize("case", SSD_CASES)
def test_sequential_oracle_matches_jax(case):
    b, S, H, P, N, _ = case
    arrs = _inputs(b, S, H, P, N, seed=2)
    y, h = ref.ssd_ref(*(torch.from_numpy(a) for a in arrs))
    y_ref, h_ref = jref(*(jnp.asarray(a) for a in arrs))
    _close(y.numpy(), y_ref)
    _close(h.numpy(), h_ref)


def test_bf16_inputs_are_widened():
    """x, B, C in bf16 (the serve path's types): the port widens to f32
    as the reference does, so both see the same rounded inputs."""
    b, S, H, P, N, chunk = 2, 48, 3, 8, 16, 16
    x, dt, A, B, C = _inputs(b, S, H, P, N, seed=4)
    tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    y, h = ops.ssd_scan(tx, torch.from_numpy(dt), torch.from_numpy(A), tB,
                        tC, chunk=chunk)
    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, B, C))
    y_ref, h_ref = jref(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC)
    _close(y.numpy(), y_ref)
    _close(h.numpy(), h_ref)


def test_state_continuation():
    """The final state of a prefill continues the recurrence exactly."""
    b, S, H, P, N = 1, 64, 2, 8, 8
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _inputs(b, S, H, P, N, seed=3))
    _, h_full = ref.ssd_ref(x, dt, A, B, C)
    _, h = ops.ssd_scan(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32],
                        chunk=16)
    for t in range(32, S):
        dA = torch.exp(dt[:, t] * A)
        h = (h * dA[..., None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t]))
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_chunking_does_not_change_the_answer():
    """Chunk 8, 16, 48 and a whole-sequence chunk agree (padding with
    dt = 0 is a no-op)."""
    arrs = [torch.from_numpy(a) for a in _inputs(2, 40, 3, 8, 4, seed=5)]
    y0, h0 = ops.ssd_scan(*arrs, chunk=40)
    for chunk in (8, 16, 48):
        y, h = ops.ssd_scan(*arrs, chunk=chunk)
        _close(y.numpy(), y0.numpy())
        _close(h.numpy(), h0.numpy())


def test_kernel_checks_raise():
    x, dt, A, B, C = (torch.from_numpy(a) for a in _inputs(1, 32, 2, 8, 4))
    ops.check_ssd_scan(x, dt, A, B, C, 16)
    with pytest.raises(TypeError, match="share"):
        ops.check_ssd_scan(x, dt, A, B.to(torch.bfloat16), C, 16)
    with pytest.raises(TypeError, match="float32"):
        ops.check_ssd_scan(x, dt.double(), A, B, C, 16)
    with pytest.raises(ValueError, match="dt"):
        ops.check_ssd_scan(x, dt[:, :, :1], A, B, C, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.check_ssd_scan(x, dt, A, B.transpose(1, 2).contiguous()
                           .transpose(1, 2), C, 16)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 512, 2, 128)
        ops.check_ssd_scan(big, torch.zeros(1, 512, 2), A,
                           torch.zeros(1, 512, 128), torch.zeros(1, 512, 128),
                           512)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.check_ssd_scan(x.requires_grad_(True), dt, A, B, C, 16)


@pytest.mark.parametrize("case", SSD_CASES + [(2, 77, 3, 8, 4, 32),
                                              (1, 45, 2, 8, 4, 20)])
def test_three_pass_matches_jax(case):
    """The kernel's decomposition against the JAX oracle, the Pallas kernel
    in interpret mode and the JAX chunked form; ragged S included."""
    b, S, H, P, N, chunk = case
    arrs = _inputs(b, S, H, P, N, seed=6)
    y, h = ref.ssd_three_pass(*(torch.from_numpy(a) for a in arrs),
                              chunk=chunk)
    assert y.shape == (b, S, H, P) and h.shape == (b, H, P, N)
    j = [jnp.asarray(a) for a in arrs]
    for want_y, want_h in (jref(*j), jpallas(*j, chunk=chunk),
                           jchunked(*j, chunk=chunk)):
        _close(y.numpy(), want_y)
        _close(h.numpy(), want_h)


def test_three_pass_bf16_inputs():
    b, S, H, P, N, chunk = 2, 48, 3, 8, 16, 16
    x, dt, A, B, C = _inputs(b, S, H, P, N, seed=7)
    tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    y, h = ref.ssd_three_pass(tx, torch.from_numpy(dt), torch.from_numpy(A),
                              tB, tC, chunk=chunk)
    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, B, C))
    y_ref, h_ref = jref(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC)
    _close(y.numpy(), y_ref)
    _close(h.numpy(), h_ref)


def test_three_pass_state_continuation():
    """The three-pass final state continues the recurrence."""
    b, S, H, P, N = 1, 64, 2, 8, 8
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _inputs(b, S, H, P, N, seed=8))
    _, h_full = ref.ssd_ref(x, dt, A, B, C)
    _, h = ref.ssd_three_pass(x[:, :40], dt[:, :40], A, B[:, :40],
                              C[:, :40], chunk=16)
    for t in range(40, S):
        dA = torch.exp(dt[:, t] * A)
        h = (h * dA[..., None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t]))
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_kernel_scratch_and_shared_memory():
    """The wrapper's scratch at the serve shape (hymba-1.5b, b 4): C B^T
    4.2 MB once a (batch, chunk), L, and 13 MB each of chunk states and
    entering states; the output pass fits two CTAs an SM, and mamba2's
    N = 128 fits one."""
    shapes = kernel.scratch_shapes(4, 2048, 50, 64, 16, 128)
    assert shapes == {"cbt": (4, 16, 128, 128), "L": (4, 16, 50, 128),
                      "states": (4, 16, 50, 16, 64),
                      "entering": (4, 16, 50, 16, 64)}
    assert 4 * np.prod(shapes["cbt"]) == 4_194_304
    assert 4 * np.prod(shapes["states"]) == 13_107_200
    assert kernel.padded_chunk(20) == 24 and kernel.padded_chunk(128) == 128
    assert kernel.scratch_shapes(1, 45, 2, 8, 4, 20)["cbt"] == (1, 3, 24, 24)
    assert 2 * (kernel.smem_bytes(128, 64, 16) + 1024) <= 233_472
    assert kernel.smem_bytes(128, 64, 128) <= kernel.MAX_SMEM


def test_kernel_checks_tile_width():
    """P must be a multiple of the kernel's 4-column float4 tiles."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in _inputs(1, 32, 2, 6, 4))
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.check_ssd_scan(x, dt, A, B, C, 16)
