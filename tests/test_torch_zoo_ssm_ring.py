"""SSM and ring-cache zoo twins against the JAX package, reduced configs:
mamba2-780m (the pure SSD stack; on the card K7 at N 128), the
decode-consistency cases of the SSM and hybrid stacks, and the windowed
ring above ``MAX_FULL_CACHE``. The ring is reached by setting
``MAX_FULL_CACHE`` low in both packages' model modules (both read the
global when ``cache_len_for`` runs): a stream past it keeps a ring of the
sliding window (32 reduced), or one unused slot for an SSM-only model,
and a prefill longer than the ring leaves each slot holding its last
position. Tolerances: ``torch_zoo_twins`` (1e-4; positions equal)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.model as jmodel
import repro_torch.models.model as tmodel
from repro.models import build_model as jbuild
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build_model as tbuild
from torch_zoo_twins import (one_torch_thread,  # noqa: F401 (autouse)
                             B, TOL, assert_tree_close, cfgs,
                             check_adamw_step, check_decode_consistency,
                             check_decode_step, check_loss_and_grads,
                             check_prefill, perturb_zeros)

ARCH = "mamba2-780m"


def test_loss_and_grads_match():
    check_loss_and_grads(ARCH)


def test_adamw_step_matches():
    check_adamw_step(ARCH)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_prefill_matches(impl):
    check_prefill(ARCH, impl)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_decode_step_matches(impl):
    check_decode_step(ARCH, impl)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_decode_consistency_twin(arch):
    check_decode_consistency(arch)


RING_S, RING_GEN, RING_MAX = 45, 3, 40
# arch: ring slots at the reduced config
RINGS = {"gemma3-4b": 32, "gemma2-9b": 32, "hymba-1.5b": 32,
         "mamba2-780m": 1}


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", sorted(RINGS))
def test_ring_above_max_full_cache(arch, impl, monkeypatch):
    """Prefill a 45-token prompt into the ring, then decode 3 given
    tokens: logits and the whole cache equal the reference's at every
    step."""
    monkeypatch.setattr(jmodel, "MAX_FULL_CACHE", RING_MAX)
    monkeypatch.setattr(tmodel, "MAX_FULL_CACHE", RING_MAX)
    jcfg, tcfg = cfgs(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg, impl=impl, device="cpu")
    n_meta = jcfg.n_meta_tokens
    stream = n_meta + RING_S + RING_GEN
    assert stream > RING_MAX
    cache_len = jm.cache_len_for(stream)
    assert cache_len == tm.cache_len_for(stream) == RINGS[arch]
    assert tm.cache_len_for(RING_MAX) == RING_MAX
    jp = perturb_zeros(jm.init(jax.random.PRNGKey(5)), 5)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (B, RING_S + RING_GEN)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :RING_S])}, cache_len)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": toks[:, :RING_S]}, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert_tree_close(params_to_numpy(tc), jax.tree.map(np.asarray, jc))
    if "attn" in tc:       # the ring holds the prompt's last positions
        want = np.arange(n_meta + RING_S - cache_len, n_meta + RING_S)
        assert sorted(tc["attn"]["pos"][0, 0].tolist()) == want.tolist()
    decode = jax.jit(jm.decode_step)
    for i in range(RING_GEN):
        tok = toks[:, RING_S + i:RING_S + i + 1]
        pos = np.full((B, 1), n_meta + RING_S + i, np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, tok, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        assert_tree_close(params_to_numpy(tc), jax.tree.map(np.asarray, jc))


def test_ring_write_keeps_the_last_positions():
    """``cache_write`` of more positions than the ring holds writes only
    each row's last T (no slot twice)."""
    from repro_torch.models.attention import cache_write
    cache = {"k": torch.zeros(2, 4, 1, 2), "v": torch.zeros(2, 4, 1, 2),
             "pos": torch.full((2, 4), -1, dtype=torch.int32)}
    pos = torch.arange(10).expand(2, 10)
    k = pos[..., None, None].float().expand(2, 10, 1, 2)
    cache_write(cache, k, -k, pos)
    assert cache["pos"].tolist() == [[8, 9, 6, 7]] * 2
    assert cache["k"][..., 0, 0].tolist() == [[8.0, 9.0, 6.0, 7.0]] * 2
    assert cache["v"][..., 0, 0].tolist() == [[-8.0, -9.0, -6.0, -7.0]] * 2
