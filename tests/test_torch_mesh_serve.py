"""Serve programs over ranks whose heads do not divide "model", against
the same programs in one process.

A gloo world of 3 ranks, (data 1, model 3). The reduced configs have 4
attention heads (spans of 2, 2 and 0 over the three ranks: one rank
attends with no head at all) and 16 SSM heads (6, 6, 4), and their GQA
configs 1 or 2 kv heads, so every q span meets kv heads that another
rank's span shares. For one reduced config of each family (MHA, GQA with
a frontend, qk-norm GQA, MLA, the hybrid SSM with meta tokens and
windows, the pure SSM, the encoder-decoder), from one seed on every
rank: a prefill and two decode steps on TP-placed serving weights,
logits within 1e-4 and the caches within 1e-5 of the one-process run,
and a spy sees the head-parallel serve paths (``sharding/serve.py``) run:
``_gqa_over_ranks`` / ``_mla_over_ranks`` in every prefill layer,
``_ssm_prefill_over_ranks`` / ``_ssm_decode_over_ranks`` in every SSM
layer.
"""
import pytest

from test_torch_mesh_world import run_world

ARCHS = ["fedforecast-100m", "internvl2-2b", "command-r-plus-104b",
         "minicpm3-4b", "hymba-1.5b", "mamba2-780m", "seamless-m4t-large-v2"]
B, S = 4, 24
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
SPIED = {"attention": ["_gqa_over_ranks", "_mla_over_ranks"],
         "ssm": ["_ssm_prefill_over_ranks", "_ssm_decode_over_ranks"]}


def _batch(cfg, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"frames": torch.from_numpy(rng.normal(
                    size=(B, S, cfg.frontend.d_frontend)).astype(np.float32)),
                "tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab, (B, S)).astype(np.int64))}
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int64))}
    if cfg.frontend is not None:
        out["patches"] = torch.from_numpy(rng.normal(size=(
            B, cfg.frontend.num_tokens, cfg.frontend.d_frontend)).astype(
                np.float32))
    return out


def _max_err(a, b):
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as _tree
    err = 0.0
    for x, y in zip(_tree.leaves(a), _tree.leaves(b)):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        err = max(err, float((x.double() - y.double()).abs().max()))
    return err


def _spy(calls):
    """Count each serve path's calls into ``calls``."""
    import importlib
    for mod, names in SPIED.items():
        m = importlib.import_module(f"repro_torch.models.{mod}")
        for name in names:
            fn = getattr(m, name)

            def spied(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            setattr(m, name, spied)


def _arch_checks(arch, calls):
    import torch
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import cache_pspecs, param_pspecs
    from repro_torch.sharding.mesh import mesh_scope, sharded_program
    from repro_torch.sharding.specs import NamedSharding, P, place

    mesh = make_host_mesh(1, 3)
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    batch = _batch(cfg, 1)
    cache_len = S + 4
    out = {}
    calls.clear()
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, cache_len)
        d_serve = place(params, _tree.tree_map(
            lambda s: NamedSharding(mesh, s),
            param_pspecs(params, mesh, "serve")))
        d_batch = {k: NamedSharding(mesh, P("data", *([None] * (v.dim() - 1)))
                                    ).place(v) for k, v in batch.items()}
        with mesh_scope(mesh), sharded_program(_tree.leaves(d_serve)):
            d_logits, d_cache = model.prefill(d_serve, d_batch, cache_len)
            specs = cache_pspecs(d_cache, mesh, batch=B)
            d_cache = _tree.tree_map(
                lambda c, s: NamedSharding(mesh, s).constrain(c), d_cache,
                specs)
        out["prefill"] = _max_err(d_logits, logits)
        pos = torch.full((B, 1), 1 if cfg.is_encoder_decoder else S,
                         dtype=torch.int32)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        errs = []
        for i in range(2):
            logits, cache = model.decode_step(params, cache, tok, pos + i)
            with mesh_scope(mesh), sharded_program(_tree.leaves(d_serve)):
                d_logits, d_cache = model.decode_step(
                    d_serve, d_cache, NamedSharding(mesh, P("data", None))
                    .place(tok), NamedSharding(mesh, P("data", None)).place(
                        pos + i))
            errs.append(_max_err(d_logits, logits))
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out["decode"] = max(errs)
        out["cache"] = _max_err(d_cache, cache)
    out["calls"] = dict(calls)
    return out


def _rank_checks(rank, world):
    calls = {}
    _spy(calls)
    return {arch: _arch_checks(arch, calls) for arch in ARCHS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(_rank_checks, 3, tmp_path_factory.mktemp("serve"))


def _expected_calls(arch):
    """Each prefill layer's attention and SSM, each decode step's SSM."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN_MLA, BLOCK_SSM
    cfg = get_config(arch).reduced()
    L = cfg.n_layers
    if cfg.is_encoder_decoder:
        return {"_gqa_over_ranks": cfg.n_encoder_layers}
    out = {}
    if cfg.block_kind != BLOCK_SSM:
        out["_mla_over_ranks" if cfg.attn_kind == ATTN_MLA
            else "_gqa_over_ranks"] = L
    if cfg.ssm is not None:
        out["_ssm_prefill_over_ranks"] = L
        out["_ssm_decode_over_ranks"] = 2 * L
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_over_uneven_heads_matches_one_process(world, arch):
    for r in world:
        got = r[arch]
        assert got["prefill"] <= LOGIT_TOL and got["decode"] <= LOGIT_TOL, got
        assert got["cache"] <= CACHE_TOL, got


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_over_ranks_runs_head_parallel(world, arch):
    for r in world:
        assert r[arch]["calls"] == _expected_calls(arch), r[arch]["calls"]
