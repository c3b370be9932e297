"""Shared harness of the model-zoo twins (``tests/test_torch_zoo_*.py``):
the port against the JAX package on the reference's params converted
through numpy and the same inputs, drawn with numpy from a seed. The
reference's zero-initialised leaves (norm weights, biases) are drawn
anew with numpy, so that both sides add and scale by them.

Every architecture runs ``reduced()`` (2 layers, d_model <= 256, f32 on
the CPU). Tolerances, the repo's twin rule (both sides f32, sums in other
orders): loss 1e-5, grads 1e-4, params after one AdamW step 1e-5 (where
the gradient is not rounding noise; ``check_adamw_step``), prefill and
decode logits and every float cache leaf 1e-4; token ids and
cache positions equal. The port's ``kernel`` impl runs K6's and K7's
plain versions here.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.training import make_train_step as jstep
from repro_torch import tree
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.training import make_train_step as tstep

B = 2
S = 24
TOL = 1e-4              # logits, cache leaves, grads
LOSS_TOL = 1e-5         # loss; params after one AdamW step
LR = 3e-4
ADAM_EPS = 1e-8         # adamw's default, both packages


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The twins are small and the suite runs several workers at once:
    torch's intra-op pool on every core of every worker would
    oversubscribe the host (each zoo file imports this fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, changes=()):
    """(reference config, port config), both ``reduced()`` with
    ``changes`` (a tuple of (field, value) pairs) applied."""
    ch = dict(changes)
    return (dataclasses.replace(jget(arch).reduced(), **ch),
            dataclasses.replace(tget(arch).reduced(), **ch))


def np_batch(cfg, n_tokens: int, seed: int, n_frames: int = S) -> dict:
    """The family's batch as numpy: tokens (B, n_tokens) int32, and the
    vision model's patches (B, P, d_frontend) or the enc-dec model's
    frames (B, n_frames, d_frontend), float32 normals."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend is not None:
        n = n_frames if cfg.is_encoder_decoder else cfg.frontend.num_tokens
        key = "frames" if cfg.is_encoder_decoder else "patches"
        out[key] = rng.normal(size=(B, n, cfg.frontend.d_frontend)).astype(
            np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, (B, n_tokens)).astype(
        np.int32)
    return out


def n_prefix(cfg) -> int:
    """Stream positions ahead of the tokens: meta tokens and patches."""
    if cfg.frontend is not None and not cfg.is_encoder_decoder:
        return cfg.n_meta_tokens + cfg.frontend.num_tokens
    return cfg.n_meta_tokens


def perturb_zeros(params, seed: int):
    """The init with every all-zero leaf (norm weights, biases) drawn
    N(0, 0.1) with numpy: zeros would hide where a bias is added or a
    norm weight scales."""
    rng = np.random.default_rng(seed + 1000)
    flat, treedef = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat = [rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
            if a.dtype.kind == "f" and not a.any() else a for a in flat]
    return jax.tree.map(jnp.asarray, jax.tree.unflatten(treedef, flat))


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _head(batch: dict, n: int) -> dict:
    return {k: (v[:, :n] if k == "tokens" else v) for k, v in batch.items()}


def _np(t):
    return jax.tree.map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def reference(arch, changes=(), seed=7):
    """The reference's numbers on ``arch``'s reduced config, as numpy:
    prefill of S tokens (logits, cache), prefill of S + 1 (not for an
    enc-dec, whose prefill decodes a bos), one decode step of token S
    from the first prefill, loss and grads on the S + 1 batch, and one
    AdamW step on it."""
    jcfg, tcfg = cfgs(arch, changes)
    jm = jbuild(jcfg)
    jp = perturb_zeros(jm.init(jax.random.PRNGKey(seed)), seed)
    batch = np_batch(jcfg, S + 1, seed)
    prompt = _head(batch, S)
    if jcfg.is_encoder_decoder:
        pos, cache_len = np.full((B, 1), 1, np.int32), 8
    else:
        pos = np.full((B, 1), n_prefix(jcfg) + S, np.int32)
        cache_len = n_prefix(jcfg) + S + 1
    prefill = jax.jit(jm.prefill, static_argnums=2)
    logits, cache = prefill(jp, _jnp(prompt), cache_len)
    full = None
    if not jcfg.is_encoder_decoder:
        full = np.asarray(prefill(jp, _jnp(batch), cache_len)[0])
    nxt = batch["tokens"][:, S:]
    dec, dcache = jax.jit(jm.decode_step)(jp, cache, jnp.asarray(nxt),
                                          jnp.asarray(pos))
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, _jnp(batch))
    opt = jadamw(LR)
    stepped, _, met = jax.jit(jstep(jm, opt))(jp, opt.init(jp), _jnp(batch))
    return {"cfg": tcfg, "params": _np(jp), "batch": batch,
            "prompt": prompt, "next": nxt, "pos": pos,
            "cache_len": cache_len, "logits": np.asarray(logits),
            "cache": _np(cache), "full": full, "dec": np.asarray(dec),
            "dcache": _np(dcache), "loss": float(loss), "grads": _np(grads),
            "stepped": _np(stepped), "step_loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"])}


def port(arch, impl="xla", changes=()):
    """(reference dict, port model, port params) on the same weights."""
    ref = reference(arch, changes)
    model = tbuild(ref["cfg"], impl=impl, device="cpu")
    return ref, model, params_from_numpy(ref["params"], "cpu")


def assert_tree_close(got: dict, want: dict, tol=TOL, where=""):
    """Same keys; float leaves within ``tol``; integer leaves equal."""
    assert sorted(got) == sorted(want), (where, sorted(got), sorted(want))
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            assert_tree_close(g, w, tol, f"{where}/{key}")
            continue
        assert g.shape == w.shape, (where, key, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{where}/{key}")
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                       err_msg=f"{where}/{key}")


# --- the checks each family file parametrizes over its architectures ---
def check_loss_and_grads(arch, changes=()):
    ref, model, params = port(arch, changes=changes)
    leaves, treedef = tree.flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    loss, metrics = model.loss_fn(tree.unflatten(treedef, leaves),
                                  ref["batch"])
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - ref["loss"]) <= LOSS_TOL
    assert np.isfinite(float(metrics["aux"]))
    for want, got in zip(jax.tree.leaves(ref["grads"]), grads):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def check_adamw_step(arch, changes=()):
    ref, model, params = port(arch, changes=changes)
    opt = tadamw(LR)
    params, state, met = tstep(model, opt)(params, opt.init(params),
                                           ref["batch"])
    assert abs(float(met["loss"]) - ref["step_loss"]) <= LOSS_TOL
    assert abs(float(met["grad_norm"]) - ref["grad_norm"]) <= TOL
    assert state["count"] == 1
    # Adam's first step moves a coordinate by lr g / (|g| + eps): where the
    # clipped gradient is within a hundred eps of 0, that ratio is one of
    # rounding noise (sums in another order), and either side may move it
    # by up to lr the other way: there the bound is 2 lr. Elsewhere (an
    # exact 0 included) the step holds LOSS_TOL.
    scale = min(1.0, 1.0 / ref["grad_norm"])
    for g, w, grad in zip(jax.tree.leaves(params_to_numpy(params)),
                          jax.tree.leaves(ref["stepped"]),
                          jax.tree.leaves(ref["grads"])):
        sure = (np.abs(grad) * scale > 100 * ADAM_EPS) | (grad == 0)
        np.testing.assert_allclose(g[sure], w[sure], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        assert float(np.abs(g - w).max()) <= 2 * LR + LOSS_TOL


def check_prefill(arch, impl, changes=()):
    ref, model, params = port(arch, impl, changes)
    with torch.no_grad():
        logits, cache = model.prefill(params, ref["prompt"],
                                      ref["cache_len"])
    assert logits.shape == (B, 1, ref["cfg"].vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=TOL,
                               rtol=TOL)
    assert_tree_close(params_to_numpy(cache), ref["cache"])


def check_decode_step(arch, impl, changes=()):
    ref, model, params = port(arch, impl, changes)
    with torch.no_grad():
        _, cache = model.prefill(params, ref["prompt"], ref["cache_len"])
        dec, cache2 = model.decode_step(params, cache, ref["next"],
                                        ref["pos"])
    assert cache2 is cache                       # updated in place
    np.testing.assert_allclose(dec.numpy(), ref["dec"], atol=TOL, rtol=TOL)
    assert_tree_close(params_to_numpy(cache), ref["dcache"])


def check_decode_consistency(arch, changes=()):
    """``tests/test_decode_consistency.py`` as a twin: prefill(S) +
    decode_step of token S against prefill(S + 1), on the port (kernel
    impl) and on the reference; the port's decode within 1e-4 of the
    reference's, and the port meets the reference test's own bar (2e-2,
    top-1 >= 0.99) and the twin rule (1e-4) against its own prefill."""
    ref, model, params = port(arch, "kernel", changes)
    with torch.no_grad():
        full, _ = model.prefill(params, ref["batch"], ref["cache_len"])
        _, cache = model.prefill(params, ref["prompt"], ref["cache_len"])
        dec, _ = model.decode_step(params, cache, ref["next"], ref["pos"])
    dec, full = dec.numpy()[:, 0], full.numpy()[:, 0]
    np.testing.assert_allclose(dec, ref["dec"][:, 0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(full, ref["full"][:, 0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dec, full, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ref["dec"][:, 0], ref["full"][:, 0],
                               atol=2e-2, rtol=2e-2)
    assert (dec.argmax(-1) == full.argmax(-1)).mean() >= 0.99
