"""Serving path of the PyTorch port (prefill, ring-cache decode, the
serve loop) against the JAX package, on the reference's params converted
through numpy and the same tokens.

Reduced ``hymba-1.5b`` (hybrid attention + SSM heads, 8 meta tokens,
window 32 on layer 0, SSD chunk 16) and reduced ``fedforecast-100m``
(dense, tied embeddings), both f32 on the CPU. Prompts of 24 and 45
tokens: with hymba's meta tokens the streams are 32 (at the window) and
53 positions (past the window, and not a multiple of the chunk).

Tolerance 1e-4 for logits and every float cache leaf, the repo's twin
rule: both sides are f32 and differ only in summation order; the
``kernel`` impl runs K6's and K7's plain versions here (``attention_ref``
and the chunked scan), whose sums are ordered differently again. Cache
positions must be equal.
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
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import build_model as tbuild

ARCHS = ["hymba-1.5b", "fedforecast-100m"]
PROMPTS = [24, 45]
IMPLS = ["xla", "kernel"]
B = 2
TOL = 1e-4


def _cfgs(arch, **changes):
    return (dataclasses.replace(jget(arch).reduced(), **changes),
            dataclasses.replace(tget(arch).reduced(), **changes))


@functools.lru_cache(maxsize=None)
def _reference(arch, S, block_kind=None):
    """The reference's prefill(S) and prefill(S + 1), and one decode step
    from prefill(S), all with impl="xla", as numpy."""
    changes = {"block_kind": block_kind} if block_kind else {}
    jcfg, tcfg = _cfgs(arch, **changes)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(7))
    toks = np.random.default_rng(S).integers(0, jcfg.vocab,
                                             (B, S + 1)).astype(np.int32)
    n_meta = jcfg.n_meta_tokens
    cache_len = n_meta + S + 1
    prefill = jax.jit(jm.prefill, static_argnums=2)
    logits, cache = prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                            cache_len)
    full, _ = prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len)
    pos = np.full((B, 1), n_meta + S, np.int32)
    dec, dcache = jax.jit(jm.decode_step)(jp, cache, jnp.asarray(toks[:, S:]),
                                          jnp.asarray(pos))
    as_np = functools.partial(jax.tree.map, np.asarray)
    return {"cfg": tcfg, "params": as_np(jp), "toks": toks, "pos": pos,
            "cache_len": cache_len, "logits": np.asarray(logits),
            "cache": as_np(cache), "full": np.asarray(full),
            "dec": np.asarray(dec), "dcache": as_np(dcache)}


def _assert_tree_close(got: dict, want: dict, where=""):
    assert sorted(got) == sorted(want), (where, sorted(got), sorted(want))
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            _assert_tree_close(g, w, f"{where}/{key}")
            continue
        assert g.shape == w.shape, (where, key, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{where}/{key}")
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"{where}/{key}")


def _port(arch, S, impl, block_kind=None):
    ref = _reference(arch, S, block_kind)
    model = tbuild(ref["cfg"], impl=impl, device="cpu")
    return ref, model, params_from_numpy(ref["params"], "cpu")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, S, impl):
    ref, model, params = _port(arch, S, impl)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": ref["toks"][:, :S]},
                                      ref["cache_len"])
    assert logits.shape == (B, 1, ref["cfg"].vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=TOL,
                               rtol=TOL)
    _assert_tree_close(params_to_numpy(cache), ref["cache"])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, S, impl):
    ref, model, params = _port(arch, S, impl)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": ref["toks"][:, :S]},
                                 ref["cache_len"])
        dec, cache2 = model.decode_step(params, cache, ref["toks"][:, S:],
                                        ref["pos"])
    assert cache2 is cache                       # updated in place
    np.testing.assert_allclose(dec.numpy(), ref["dec"], atol=TOL, rtol=TOL)
    _assert_tree_close(params_to_numpy(cache), ref["dcache"])


@pytest.mark.parametrize("S", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_its_prefill(arch, S):
    """The port's own decode consistency: prefill(S) + decode_step of
    token S equals prefill(S + 1), with the kernel impl, and both equal
    the reference's prefill(S + 1)."""
    ref, model, params = _port(arch, S, "kernel")
    toks = ref["toks"]
    with torch.no_grad():
        full, _ = model.prefill(params, {"tokens": toks}, ref["cache_len"])
        _, cache = model.prefill(params, {"tokens": toks[:, :S]},
                                 ref["cache_len"])
        dec, _ = model.decode_step(params, cache, toks[:, S:], ref["pos"])
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(full.numpy(), ref["full"], atol=TOL, rtol=TOL)


def test_ssm_block_matches_jax():
    """The pure SSM block (mamba2-style) on hymba's reduced widths."""
    ref, model, params = _port("hymba-1.5b", 45, "kernel", block_kind="ssm")
    assert "attn" not in params["stack"]
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": ref["toks"][:, :45]},
                                      ref["cache_len"])
        dec, _ = model.decode_step(params, cache, ref["toks"][:, 45:],
                                   ref["pos"])
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(dec.numpy(), ref["dec"], atol=TOL, rtol=TOL)
    _assert_tree_close(params_to_numpy(cache), ref["dcache"])


def test_hybrid_loss_matches_jax():
    """Train-path forward with meta tokens (labels offset by n_prefix)."""
    ref, model, params = _port("hymba-1.5b", 45, "xla")
    jm = jbuild(_cfgs("hymba-1.5b")[0])
    jp = jax.tree.map(jnp.asarray, ref["params"])
    jl, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(ref["toks"])})
    with torch.no_grad():
        tl, _ = model.loss_fn(params, {"tokens": ref["toks"]})
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_serve_positions_count_meta_tokens():
    """The serve loop decodes at n_meta + S + i: its last step's logits
    equal a prefill over the prompt and the tokens it generated. Decoding
    at S + i (the reference serve loop's positions) does not."""
    model, params, batch = serve.setup("hymba-1.5b", batch=B, prompt_len=20,
                                       seed=3, impl="kernel", device="cpu")
    tokens = batch["tokens"]
    n_meta = model.cfg.n_meta_tokens
    assert n_meta == 8
    with torch.no_grad():
        res = serve.generate(model, params, batch, 4)
        out = res["tokens"]
        assert out.shape == (B, 4)
        stream = torch.cat([tokens, out[:, :3]], 1)
        full, _ = model.prefill(params, {"tokens": stream},
                                model.cache_len_for(n_meta + 23))
        np.testing.assert_allclose(res["last_logits"].numpy(), full.numpy(),
                                   atol=TOL, rtol=TOL)
        # the reference serve loop's accounting, for one step
        cache_len = n_meta + 21
        _, cache = model.prefill(params, {"tokens": tokens}, cache_len)
        one, _ = model.prefill(params, {"tokens": stream[:, :21]}, cache_len)
        wrong, _ = model.decode_step(params, cache, stream[:, 20:21],
                                     torch.full((B, 1), 20))
    assert float((wrong - one).abs().max()) > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "20", "--gen", "3"])
    printed = capsys.readouterr().out
    assert f"arch={arch} impl=kernel device=cpu" in printed
    assert "prefill:" in printed and "sample continuation:" in printed
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["last_logits"]).all()
    xla = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "20", "--gen", "3", "--impl", "xla"])
    np.testing.assert_allclose(xla["last_logits"].numpy(),
                               res["last_logits"].numpy(), atol=TOL,
                               rtol=TOL)


def test_cache_init_matches_jax_tree():
    jcfg, tcfg = _cfgs("hymba-1.5b")
    jc = jbuild(jcfg).init_cache(2, 40)
    tc = params_to_numpy(tbuild(tcfg, device="cpu").init_cache(2, 40))
    _assert_tree_close(tc, jax.tree.map(np.asarray, jc))


def test_client_predict_matches_reference_on_hymba():
    """``FLClientNode.predict`` follows the reference's positions (S + i,
    the meta tokens left out; ROADMAP queue C), not the serve loop's: on
    reduced ``hymba-1.5b`` and the reference's params it gives the
    reference's tokens."""
    from types import SimpleNamespace

    from repro.core.client import FLClientNode as JNode
    from repro.core.telemetry import Telemetry as JTelemetry
    from repro_torch.core.client import FLClientNode as TNode
    from repro_torch.core.telemetry import Telemetry as TTelemetry

    jcfg, tcfg = _cfgs("hymba-1.5b")
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(11)))
    nodes = []
    for node_cls, tel, model, params, kw in (
            (JNode, JTelemetry, jbuild(jcfg), jp, {}),
            (TNode, TTelemetry, tbuild(tcfg, device="cpu"),
             params_from_numpy(jp, "cpu"), {"device": "cpu"})):
        comm = SimpleNamespace(board=SimpleNamespace(telemetry=tel()))
        node = node_cls("silo", comm, None, "run", ["silo"], b"s", **kw)
        node.model, node.deployed_params = model, params
        nodes.append(node)
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab, (B, 20)).astype(
        np.int32)
    want = nodes[0].predict(prompt, n_steps=6)
    got = nodes[1].predict(prompt, n_steps=6)
    assert got.shape == (B, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
