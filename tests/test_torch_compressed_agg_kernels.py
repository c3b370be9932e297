"""K3, K4 and K5 of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain versions; these are held
against the JAX oracles (``ref.py``) and the Pallas kernels in interpret
mode on identical numpy inputs:

* K3 ``dequant_reduce`` at the shapes of ``tests/test_compression.py``,
  atol 1e-5 (the row sums run in another order);
* K4 ``masked_dequant_reduce`` at mbits {16, 32} x corr {no, yes},
  bitwise: the integer part is exact and one f32 multiply follows;
* K5 ``secure_agg_combine`` at the shapes of ``tests/test_kernels.py``,
  atol 1e-5, and ``combine_pytrees`` against the reference's.

No CPU call may count as a kernel launch. The argument checks that the
wrappers run before a CUDA launch reject a bad dtype, shape, layout or
alignment.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.compressed_agg import kernel as jck
from repro.kernels.compressed_agg import ref as jcref
from repro.kernels.secure_agg import ops as jsops
from repro.kernels.secure_agg import ref as jsref
from repro_torch.kernels.compressed_agg import ops as cops
from repro_torch.kernels.compressed_agg import ref as cref
from repro_torch.kernels.secure_agg import ops as sops

CHUNK = 1024
ATOL = 1e-5


def _quant_inputs(n, c, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(n, c * CHUNK)).astype(np.int8)
    scales = rng.uniform(1e-6, 1e-2, size=(n, c)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    return q, scales, w


@pytest.mark.parametrize("n,c", [(1, 1), (3, 2), (4, 8), (7, 13), (8, 5)])
def test_dequant_reduce_matches_jax(n, c):
    q, scales, w = _quant_inputs(n, c, 6)
    before = dict(cops.LAUNCHES)
    out = cops.dequant_reduce(torch.from_numpy(q), torch.from_numpy(scales),
                              torch.from_numpy(w))
    assert cops.LAUNCHES == before
    assert out.dtype == torch.float32 and out.shape == (c * CHUNK,)
    out = out.numpy()
    jref = np.asarray(jcref.dequant_reduce_ref(q, scales, w))
    np.testing.assert_allclose(out, jref, atol=ATOL, rtol=1e-5)
    pallas = np.asarray(jck.dequant_reduce_flat(q, scales, w, bt=4096,
                                                interpret=True))
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=1e-5)
    dense = (q.astype(np.float64).reshape(n, c, CHUNK)
             * scales.astype(np.float64)[:, :, None]).reshape(n, -1)
    np.testing.assert_allclose(out, w.astype(np.float64) @ dense, atol=ATOL)


def _u32_rows(rng, n, t, mbits):
    hi = 2 ** 32 if mbits == 32 else 2 ** mbits
    return rng.integers(0, hi, size=(n, t), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("with_corr", [False, True], ids=["plain", "corr"])
@pytest.mark.parametrize("mbits", [16, 32])
@pytest.mark.parametrize("n,c", [(1, 1), (2, 3), (3, 2), (8, 4)])
def test_masked_dequant_reduce_bitwise_jax(n, c, mbits, with_corr):
    rng = np.random.default_rng(100 * n + c + mbits)
    t = c * CHUNK
    z = _u32_rows(rng, n, t, mbits)
    corr = _u32_rows(rng, n, t, mbits) if with_corr else None
    scales = rng.uniform(1e-6, 1e-2, size=c).astype(np.float32)
    before = dict(cops.LAUNCHES)
    tz = torch.from_numpy(z.view(np.int32))
    tc = None if corr is None else torch.from_numpy(corr)   # uint32 too
    out = cops.masked_dequant_reduce(tz, torch.from_numpy(scales),
                                     modulus_bits=mbits, corr=tc).numpy()
    assert cops.LAUNCHES == before
    jz, js = jnp.asarray(z), jnp.asarray(scales)
    jc = None if corr is None else jnp.asarray(corr)
    jref = np.asarray(jcref.masked_dequant_reduce_ref(jz, js, mbits,
                                                      corr=jc))
    np.testing.assert_array_equal(out.view(np.uint32), jref.view(np.uint32))
    pallas = np.asarray(jck.masked_dequant_reduce_flat(
        jz, js, modulus_bits=mbits, corr=jc, interpret=True))
    np.testing.assert_array_equal(out.view(np.uint32),
                                  pallas.view(np.uint32))


def test_masked_dequant_reduce_wraps_and_centers():
    """Columns whose row sum passes 2**32, and residues either side of
    the centering threshold, decode to the exact signed value."""
    t = CHUNK
    z = np.zeros((3, t), np.uint32)
    z[:, 0] = 2 ** 32 - 1                 # sum = -3 mod 2**32
    z[0, 1], z[1, 1] = 2 ** 31, 2 ** 31   # sum = 0 mod 2**32
    z[0, 2] = 2 ** 15                     # -2**15 at mbits 16
    z[0, 3] = 2 ** 15 - 1
    scales = np.ones(1, np.float32)
    tz = torch.from_numpy(z)
    out16 = cref.masked_dequant_reduce_ref(tz, torch.from_numpy(scales), 16)
    assert out16[:4].tolist() == [-3.0, 0.0, -32768.0, 32767.0]
    out32 = cref.masked_dequant_reduce_ref(tz, torch.from_numpy(scales), 32)
    assert out32[:4].tolist() == [-3.0, 0.0, 32768.0, 32767.0]


@pytest.mark.parametrize("n,t", [(4, 1000), (8, 8192), (3, 5000), (2, 127),
                                 (1, 4097)])
def test_secure_agg_combine_matches_jax(n, t):
    rng = np.random.default_rng(2)
    q = rng.integers(-127, 128, size=(n, t)).astype(np.int8)
    scales = rng.uniform(1e-4, 1e-2, size=n).astype(np.float32)
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    before = dict(sops.LAUNCHES)
    out = sops.secure_agg_combine(torch.from_numpy(q),
                                  torch.from_numpy(scales),
                                  torch.from_numpy(w)).numpy()
    assert sops.LAUNCHES == before
    assert out.shape == (t,) and out.dtype == np.float32
    pallas = np.asarray(jsops.secure_agg_combine(
        jnp.asarray(q), jnp.asarray(scales), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(out, pallas, atol=ATOL)
    np.testing.assert_allclose(
        out, np.asarray(jsref.secure_agg_ref(jnp.asarray(q),
                                             jnp.asarray(scales),
                                             jnp.asarray(w))), atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_update_matches_jax(seed):
    x = (np.random.default_rng(seed).normal(size=5000) * 0.3).astype(
        np.float32)
    jq, js = jsops.quantize_update(jnp.asarray(x))
    tq, ts = sops.quantize_update(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.float32(ts.item()) == np.float32(js)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_combine_pytrees_matches_jax():
    rng = np.random.default_rng(4)
    trees = [{"b": rng.normal(size=(4, 7)).astype(np.float32),
              "a": rng.normal(size=(33,)).astype(np.float32),
              "c": {"z": rng.normal(size=(5,)).astype(np.float32),
                    "y": rng.normal(size=(2, 3)).astype(np.float32)}}
             for _ in range(4)]
    w = np.full(4, 0.25, np.float32)
    jagg = jsops.combine_pytrees([{k: jnp.asarray(v) if not isinstance(v, dict)
                                   else {kk: jnp.asarray(vv)
                                         for kk, vv in v.items()}
                                   for k, v in t.items()} for t in trees],
                                 jnp.asarray(w))
    ttrees = [{k: torch.from_numpy(v) if not isinstance(v, dict)
               else {kk: torch.from_numpy(vv) for kk, vv in v.items()}
               for k, v in t.items()} for t in trees]
    before = dict(sops.LAUNCHES)
    tagg = sops.combine_pytrees(ttrees, w, device="cpu")
    assert sops.LAUNCHES == before
    max_scale = max(float(np.abs(np.concatenate(
        [np.ravel(v) for v in (t["a"], t["b"], t["c"]["y"], t["c"]["z"])]
    )).max()) / 127.0 for t in trees)
    for key in ("a", "b"):
        assert tuple(tagg[key].shape) == trees[0][key].shape
        np.testing.assert_allclose(tagg[key].numpy(), np.asarray(jagg[key]),
                                   atol=ATOL)
        mean = np.mean([t[key] for t in trees], axis=0)
        assert np.abs(tagg[key].numpy() - mean).max() <= max_scale
    for key in ("y", "z"):
        np.testing.assert_allclose(tagg["c"][key].numpy(),
                                   np.asarray(jagg["c"][key]), atol=ATOL)


def _misaligned(dtype, shape):
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].reshape(shape)


def test_dequant_reduce_checks_reject_bad_inputs():
    q = torch.zeros(2, 2 * CHUNK, dtype=torch.int8)
    s = torch.ones(2, 2)
    w = torch.ones(2)
    cops.check_dequant_reduce(q, s, w)                        # accepted
    with pytest.raises(TypeError):
        cops.check_dequant_reduce(q.to(torch.int16), s, w)
    with pytest.raises(ValueError):
        cops.check_dequant_reduce(q[:, :1000], s, w)          # T % 1024
    with pytest.raises(ValueError):
        cops.check_dequant_reduce(q, torch.ones(2, 3), w)     # scales shape
    with pytest.raises(TypeError):
        cops.check_dequant_reduce(q, s.double(), w)
    with pytest.raises(ValueError):
        cops.check_dequant_reduce(q, s, torch.ones(3))        # weights
    with pytest.raises(ValueError):                           # layout
        cops.check_dequant_reduce(
            torch.zeros(2 * CHUNK, 2, dtype=torch.int8).t(), s, w)
    with pytest.raises(ValueError, match="16-byte"):
        cops.check_dequant_reduce(_misaligned(torch.int8, (2, 2 * CHUNK)),
                                  s, w)


def test_masked_dequant_reduce_checks_reject_bad_inputs():
    z = torch.zeros(2, CHUNK, dtype=torch.int32)
    s = torch.ones(1)
    cops.check_masked_dequant_reduce(z, s, 16, None)          # accepted
    cops.check_masked_dequant_reduce(z.view(torch.uint32), s, 32,
                                     z.view(torch.uint32))
    for bad in (torch.int64, torch.float32, torch.int16):
        with pytest.raises(TypeError):
            cops.check_masked_dequant_reduce(torch.zeros(2, CHUNK,
                                                         dtype=bad),
                                             s, 16, None)
    with pytest.raises(ValueError):
        cops.check_masked_dequant_reduce(z, s, 8, None)       # modulus
    with pytest.raises(ValueError):
        cops.check_masked_dequant_reduce(z, torch.ones(2), 16, None)
    with pytest.raises(ValueError):
        cops.check_masked_dequant_reduce(z, s, 16, z[:1])     # corr shape
    with pytest.raises(TypeError):
        cops.check_masked_dequant_reduce(z, s, 16, z.long())  # corr dtype
    with pytest.raises(ValueError):
        cops.check_masked_dequant_reduce(
            torch.zeros(CHUNK, 2, dtype=torch.int32).t(), s, 16, None)
    with pytest.raises(ValueError, match="16-byte"):
        cops.check_masked_dequant_reduce(
            _misaligned(torch.int32, (2, CHUNK)), s, 16, None)


def test_secure_agg_combine_checks_reject_bad_inputs():
    q = torch.zeros(3, 16, dtype=torch.int8)
    s = w = torch.ones(3)
    sops.check_secure_agg_combine(q, s, w)                    # accepted
    with pytest.raises(TypeError):
        sops.check_secure_agg_combine(q.float(), s, w)
    with pytest.raises(ValueError):
        sops.check_secure_agg_combine(q.t(), torch.ones(16), torch.ones(16))
    with pytest.raises(ValueError):
        sops.check_secure_agg_combine(q, torch.ones(4), w)
    with pytest.raises(ValueError):
        sops.check_secure_agg_combine(q, s, w.double())
