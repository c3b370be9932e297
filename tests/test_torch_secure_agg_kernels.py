"""K1/K2 (secure-agg combines) of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain versions; these are held
against the JAX oracles (``ref.py``) and against the Pallas kernels in
interpret mode on identical numpy inputs, atol 1e-5: the bar of
``tests/test_kernels.py``, because the row order of the sum differs
between the implementations. No CPU call may count as a kernel launch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.secure_agg import kernel as jkernel
from repro.kernels.secure_agg import ref as jref
from repro_torch.kernels.secure_agg import ops, ref

SHAPES = [(4, 1000), (8, 8192), (3, 5000), (2, 127), (1, 4097)]
ATOL = 1e-5


def _inputs(n, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t)).astype(np.float32)
    c = rng.normal(size=(n, t)).astype(np.float32)
    w = rng.normal(size=(n,)).astype(np.float32)
    return x, c, w


@pytest.mark.parametrize("n,t", SHAPES)
def test_masked_sum_matches_jax(n, t):
    x, _, w = _inputs(n, t, 0)
    before = dict(ops.LAUNCHES)
    out = ops.masked_sum(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert ops.LAUNCHES == before
    assert out.shape == (t,) and out.dtype == np.float32
    np.testing.assert_allclose(
        out, np.asarray(jref.masked_sum_ref(jnp.asarray(x), jnp.asarray(w))),
        atol=ATOL)
    pallas = jkernel.masked_sum_flat(jnp.asarray(x), jnp.asarray(w),
                                     interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL)


@pytest.mark.parametrize("n,t", SHAPES)
def test_masked_sum_corrected_matches_jax(n, t):
    x, c, w = _inputs(n, t, 1)
    before = dict(ops.LAUNCHES)
    out = ops.masked_sum_corrected(torch.from_numpy(x), torch.from_numpy(c),
                                   torch.from_numpy(w)).numpy()
    assert ops.LAUNCHES == before
    np.testing.assert_allclose(
        out, np.asarray(jref.masked_sum_corrected_ref(
            jnp.asarray(x), jnp.asarray(c), jnp.asarray(w))), atol=ATOL)
    pallas = jkernel.masked_sum_corrected_flat(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL)


def test_plain_versions_are_the_definitions():
    x, c, w = _inputs(3, 257, 2)
    x64, c64, w64 = (a.astype(np.float64) for a in (x, c, w))
    np.testing.assert_allclose(
        ref.masked_sum_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        w64 @ x64, atol=ATOL)
    np.testing.assert_allclose(
        ref.masked_sum_corrected_ref(torch.from_numpy(x), torch.from_numpy(c),
                                     torch.from_numpy(w)).numpy(),
        w64 @ (x64 - c64), atol=ATOL)


def test_cuda_argument_checks_reject_bad_inputs():
    """The checks the wrapper runs before a launch (exercised here on CPU
    tensors): wrong dtype, shape or layout raises, nothing is copied."""
    x = torch.zeros(3, 16)
    w = torch.ones(3)
    ops._check_cuda(x, w)                                  # accepted
    with pytest.raises(TypeError):
        ops._check_cuda(x.double(), w)
    with pytest.raises(ValueError):
        ops._check_cuda(x.t(), torch.ones(16))             # non-contiguous
    with pytest.raises(ValueError):
        ops._check_cuda(x, torch.ones(4))                  # weights length
    with pytest.raises(ValueError):
        ops._check_rows("corr", torch.zeros(3, 15), (3, 16))  # corr shape
