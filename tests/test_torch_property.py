"""The system's hypothesis properties (``tests/test_property.py``) on the
PyTorch port, with the same strategies and settings, each also held
against the JAX package on the same draw:

* crypto: keys equal, and each package decrypts the other's messages;
* secure aggregation's pytree entry points: ``mask_update`` trees bitwise
  the reference's, ``aggregate_masked`` within ``1e-5 * scale`` plus 4
  f32 ulps of the reference's (the weighted sums round in another order)
  and within the reference's own tolerance of the plain mean;
* ``fedavg`` and ``trimmed_mean`` within 1e-5 of the reference's;
* ``cache_write``'s ring holds the same positions (and values).
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import crypto as jcrypto  # noqa: E402
from repro.core import secure_agg as jsa  # noqa: E402
from repro.core.aggregation import fedavg as jfedavg  # noqa: E402
from repro.core.aggregation import trimmed_mean as jtrimmed  # noqa: E402
from repro.models.attention import cache_write as jcache_write  # noqa: E402
from repro_torch.core import crypto, secure_agg  # noqa: E402
from repro_torch.core.aggregation import fedavg, trimmed_mean  # noqa: E402
from repro_torch.models.attention import cache_write  # noqa: E402

F32_ULPS = 4 * float(np.finfo(np.float32).eps)
COHORT_IDS = st.lists(
    st.text(alphabet="abcdef0123456789", min_size=4, max_size=8),
    min_size=2, max_size=5, unique=True)


@settings(max_examples=25, deadline=None)
@given(data=st.binary(min_size=0, max_size=2048),
       purpose=st.text(min_size=1, max_size=16))
def test_crypto_roundtrip(data, purpose):
    key = crypto.derive_key(b"master" * 6, purpose)
    assert key == jcrypto.derive_key(b"master" * 6, purpose)
    for compress in ("auto", False):
        blob = crypto.encrypt(key, data, compress=compress)
        assert crypto.decrypt(key, blob) == data
        assert jcrypto.decrypt(key, blob) == data
        assert crypto.decrypt(key, jcrypto.encrypt(
            key, data, compress=compress)) == data


@settings(max_examples=20, deadline=None)
@given(cohort=COHORT_IDS,
       vals=st.lists(st.floats(-100, 100, allow_nan=False), min_size=1,
                     max_size=4),
       scale=st.floats(0.1, 50.0))
def test_pairwise_masks_always_cancel(cohort, vals, scale):
    """Invariant: mean(masked updates) == mean(plain updates), any cohort."""
    base = np.asarray(vals + [0.0], np.float32)
    updates = [{"w": base + i} for i in range(len(cohort))]
    masked = [secure_agg.mask_update(u, cid, cohort, b"s", scale=scale,
                                     device="cpu")
              for u, cid in zip(updates, cohort)]
    ref_masked = [jsa.mask_update(u, cid, cohort, b"s", scale=scale)
                  for u, cid in zip(updates, cohort)]
    for m, r in zip(masked, ref_masked):
        assert m["w"].dtype == torch.float32
        np.testing.assert_array_equal(m["w"].numpy(), np.asarray(r["w"]))
    agg = secure_agg.aggregate_masked(masked, device="cpu")
    ref_agg = jsa.aggregate_masked(ref_masked)
    # the two weighted sums round in another order: besides 1e-5 * scale,
    # a few f32 ulps of the mean itself (|mean| reaches 100 at scale 0.1)
    np.testing.assert_allclose(agg["w"].numpy(), np.asarray(ref_agg["w"]),
                               rtol=F32_ULPS, atol=1e-5 * scale)
    expected = np.mean([u["w"] for u in updates], axis=0)
    np.testing.assert_allclose(agg["w"].numpy(), expected, atol=1e-3 * scale
                               * len(cohort), rtol=1e-4)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 6), seed=st.integers(0, 10_000))
def test_fedavg_permutation_invariant_and_idempotent(n, seed):
    rng = np.random.default_rng(seed)
    ups = [{"w": rng.normal(size=(4,)).astype(np.float32)} for _ in range(n)]
    w = rng.uniform(0.1, 1.0, n)
    out1 = fedavg(ups, list(w), device="cpu")
    perm = rng.permutation(n)
    out2 = fedavg([ups[i] for i in perm], list(w[perm]), device="cpu")
    np.testing.assert_allclose(out1["w"].numpy(), out2["w"].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out1["w"].numpy(),
                               np.asarray(jfedavg(ups, list(w))["w"]),
                               rtol=0, atol=1e-5)
    # aggregating identical updates is the identity
    same = fedavg([ups[0]] * n, device="cpu")
    np.testing.assert_allclose(same["w"].numpy(), ups[0]["w"], atol=1e-6)


@settings(max_examples=20, deadline=None)
@given(cache_len=st.integers(4, 16), n_writes=st.integers(1, 30),
       seed=st.integers(0, 1000))
def test_ring_cache_keeps_last_positions(cache_len, n_writes, seed):
    """Invariant: after writing positions 0..n-1 one at a time, the cache
    holds exactly the last min(n, cache_len) positions."""
    rng = np.random.default_rng(seed)
    cache = {"k": torch.zeros((1, cache_len, 1, 2)),
             "v": torch.zeros((1, cache_len, 1, 2)),
             "pos": torch.full((1, cache_len), -1, dtype=torch.int32)}
    ref = {"k": jnp.zeros((1, cache_len, 1, 2)),
           "v": jnp.zeros((1, cache_len, 1, 2)),
           "pos": jnp.full((1, cache_len), -1, jnp.int32)}
    for t in range(n_writes):
        k_new = rng.normal(size=(1, 1, 1, 2)).astype(np.float32)
        cache = cache_write(cache, torch.from_numpy(k_new),
                            torch.from_numpy(k_new),
                            torch.full((1, 1), t, dtype=torch.int32))
        ref = jcache_write(ref, jnp.asarray(k_new), jnp.asarray(k_new),
                           jnp.full((1, 1), t, jnp.int32))
    held = sorted(int(p) for p in cache["pos"][0] if p >= 0)
    expect = list(range(max(0, n_writes - cache_len), n_writes))
    assert held == expect
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref["pos"]))
    for key in ("k", "v"):
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(ref[key]))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), trim=st.integers(1, 2))
def test_trimmed_mean_bounded_by_extremes(seed, trim):
    rng = np.random.default_rng(seed)
    n = 2 * trim + 3
    ups = [{"w": rng.normal(size=(5,)).astype(np.float32)}
           for _ in range(n)]
    out = trimmed_mean(ups, trim=trim, device="cpu")["w"].numpy()
    stack = np.stack([u["w"] for u in ups])
    s = np.sort(stack, axis=0)
    assert (out >= s[trim] - 1e-5).all()
    assert (out <= s[-trim - 1] + 1e-5).all()
    np.testing.assert_allclose(out, np.asarray(jtrimmed(ups, trim=trim)["w"]),
                               rtol=0, atol=1e-5)
