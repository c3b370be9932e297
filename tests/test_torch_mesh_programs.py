"""The model zoo's programs over a mesh of ranks against the same
programs in one process.

A gloo world of 4 ranks, (data 2, model 2): for one reduced config of
each family (dense, MoE, MLA, hybrid SSM with meta tokens, qk-norm with
windows, the encoder-decoder), from one seed on every rank:

* a train step (``make_train_step``, AdamW) on ``DTensor`` params placed
  FSDP x TP by ``param_pspecs`` and a batch over "data": the loss within
  1e-5 and every updated leaf within 1e-4 of the one-process step (the
  twin rule at lr 3e-4; the sums run in another order);
* a prefill and two decode steps on TP-placed serving weights: logits
  within 1e-4, and the caches it writes in place over the ranks (the
  ring write, the SSM state, the enc-dec cross cache) equal to the
  one-process caches within 1e-5.

This is what the dry run over the production meshes runs, on real
tensors: the sharding rules, the redistributions DTensor inserts, the
MoE dispatch and ring writes that run on whole tensors
(``replicated_call``) and the views gathered where a dim splits unevenly
(``sharded_program``).
"""
import pytest

from test_torch_mesh_world import run_world

ARCHS = ["fedforecast-100m", "olmoe-1b-7b", "minicpm3-4b", "hymba-1.5b",
         "gemma3-4b", "seamless-m4t-large-v2"]
B, S = 4, 24
LOSS_TOL, PARAM_TOL, LOGIT_TOL, CACHE_TOL = 1e-5, 1e-4, 1e-4, 1e-5


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


def _arch_checks(arch):
    import torch
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import cache_pspecs, param_pspecs
    from repro_torch.sharding.mesh import mesh_scope, sharded_program
    from repro_torch.sharding.specs import NamedSharding, P, place
    from repro_torch.training import make_train_step

    mesh = make_host_mesh(2, 2)
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    batch = _batch(cfg, 1)
    opt = adamw(3e-4)
    step = make_train_step(model, opt)
    out = {}

    def on(tree, specs):
        return place(tree, _tree.tree_map(lambda s: NamedSharding(mesh, s),
                                          specs))

    def batch_on(b):
        return {k: NamedSharding(mesh, P("data", *([None] * (v.dim() - 1)))
                                 ).place(v) for k, v in b.items()}

    ref = step(params, opt.init(params), batch)
    d_params = on(params, param_pspecs(params, mesh))
    with mesh_scope(mesh):
        got = step(d_params, opt.init(d_params), batch_on(batch))
    out["loss"] = abs(float(got[2]["loss"].full_tensor() - ref[2]["loss"]))
    out["params"] = _max_err(got[0], ref[0])
    out["moments"] = _max_err(got[1]["m"], ref[1]["m"])

    cache_len = S + 4
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, cache_len)
        d_serve = on(params, param_pspecs(params, mesh, "serve"))
        with mesh_scope(mesh), sharded_program(_tree.leaves(d_serve)):
            d_logits, d_cache = model.prefill(d_serve, batch_on(batch),
                                              cache_len)
            specs = cache_pspecs(d_cache, mesh, batch=B)
            d_cache = _tree.tree_map(
                lambda c, s: NamedSharding(mesh, s).constrain(c)
                if hasattr(c, "placements") else c, d_cache, specs)
        out["prefill"] = _max_err(d_logits, logits)
        pos = torch.full((B, 1), S, dtype=torch.int32)
        if cfg.is_encoder_decoder:
            pos = torch.full((B, 1), 1, dtype=torch.int32)
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
    return out


def _rank_checks(rank, world):
    return {arch: _arch_checks(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(_rank_checks, 4, tmp_path_factory.mktemp("programs"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_over_ranks_matches_one_process(world, arch):
    for r in world:
        got = r[arch]
        assert got["loss"] <= LOSS_TOL, got
        assert got["params"] <= PARAM_TOL and got["moments"] <= PARAM_TOL, got


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_over_ranks_match_one_process(world, arch):
    for r in world:
        got = r[arch]
        assert got["prefill"] <= LOGIT_TOL and got["decode"] <= LOGIT_TOL, got
        assert got["cache"] <= CACHE_TOL, got
