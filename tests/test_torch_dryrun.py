"""The port's dry run (``repro_torch.launch.dryrun`` and what it reads)
against the JAX package's.

* ``roofline_model.traffic_bytes`` equal to the reference's, float for
  float, for all eleven configs x the four shapes at full size, on one
  device and on the reference's 16 x 16 mesh (meta trees only: fast).
* ``hlo_analysis.roofline_terms`` equal to the reference's under a
  hardware stub with the TPU v5e figures; ``model_flops_estimate`` equal
  for every config and shape.
* ``FlopCounterMode``'s counts of the reduced dense attention configs,
  at three batch x sequence shapes, equal the hand count of 2·M·N·K over
  their matmuls worked out from the config: 3 forwards for the train
  step, the forward with the last token's unembed for the prefill, one
  token against the whole cache for a decode step.
* For every reduced config, the meta count and the live-bytes tracker's
  peak equal those of the same step on real CPU tensors.
* The artifact's keys equal the reference's (read from its source);
  ``benchmarks/roofline.py`` renders it; ``--multi-pod``, a mesh over
  more than one card and the mesh-only variants run over fake ranks
  (``tests/test_torch_mesh_dryrun.py`` holds the mesh runs in full);
  rank 0's FLOPs count its local ops; ``moe_grouped``, ``fedavg_sync``
  and ``fedavg_q8`` run.
"""
import ast
import functools
import importlib.util
import json
import os
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

import jax

from repro.configs import SHAPES as JSHAPES
from repro.configs import InputShape as JInputShape
from repro.configs import get_config as jget
from repro.configs import list_configs
from repro.launch.hlo_analysis import roofline_terms as jroofline_terms
from repro.launch.mesh import V5E
from repro.launch.roofline_model import traffic_bytes as jtraffic_bytes
from repro.models import build_model as jbuild
from repro_torch import tree as _tree
from repro_torch.configs import InputShape
from repro_torch.configs import get_config as tget
from repro_torch.launch import dryrun, variants
from repro_torch.launch.hlo_analysis import no_collectives, roofline_terms
from repro_torch.launch.mesh import H100, Mesh
from repro_torch.launch.roofline_model import traffic_bytes
from repro_torch.models import build_model as tbuild
from repro_torch.optim import adamw
from repro_torch.training import make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(list_configs())
SHAPE_NAMES = [s.name for s in JSHAPES]
# one device, and the reference's production 16 x 16 (data x model) mesh
MESHES = [(1, 1, 1), (256, 16, 16)]


@functools.lru_cache(maxsize=None)
def _models(arch):
    return jbuild(jget(arch)), tbuild(tget(arch), device="meta")


@functools.lru_cache(maxsize=None)
def _ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512
    host devices: the backend is up before it (so the flag is inert) and
    the variable is restored after."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


@pytest.mark.parametrize("n_dev,dp,tp", MESHES, ids=["1dev", "16x16"])
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_traffic_bytes_equal_reference(arch, shape_name, n_dev, dp, tp):
    jm, tm = _models(arch)
    shape = next(s for s in JSHAPES if s.name == shape_name)
    want = jtraffic_bytes(jm, shape, n_devices=n_dev, dp=dp, tp=tp)
    got = traffic_bytes(tm, shape, n_devices=n_dev, dp=dp, tp=tp)
    assert got == want


V5E_STUB = SimpleNamespace(peak_flops_bf16=V5E.peak_flops_bf16,
                           hbm_bw=V5E.hbm_bw, nvlink_bw=V5E.ici_bw,
                           network_bw=V5E.dcn_bw)


@pytest.mark.parametrize("flops,hbm,ici,dcn", [
    (1.5e15, 2e10, 0.0, 0.0),          # compute-bound
    (1e12, 4.1e11, 1e9, 0.0),          # memory-bound
    (1e12, 1e9, 3e10, 2e9),            # collective-bound
    (0.0, 0.0, 0.0, 0.0),
])
def test_roofline_terms_equal_reference(flops, hbm, ici, dcn):
    coll = {**no_collectives(), "ici_bytes": ici, "dcn_bytes": dcn}
    want = jroofline_terms(flops, hbm, coll, V5E, n_chips=256)
    got = roofline_terms(flops, hbm, coll, V5E_STUB, n_chips=256)
    assert got == want


def test_one_card_terms_use_the_h100():
    t = roofline_terms(989e12, 3.35e12, no_collectives(), H100, n_chips=1)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 1.0
    assert t["collective_s"] == 0.0
    assert H100.network_bw == 50e9


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_estimate_equal_reference(arch):
    ref = _ref_dryrun()
    for shape in JSHAPES:
        want = ref.model_flops_estimate(jget(arch), shape)
        got = dryrun.model_flops_estimate(tget(arch), shape)
        assert got == want and type(got[1]) is type(want[1]) is int


def hand_count(cfg, mode, B, S, remat=True):
    """2·M·N·K over the matmuls of one step of a dense GQA config with a
    gated MLP (``impl="xla"``: the scores over every cached key), as the
    dry run builds it: a train step is a forward and a backward of twice
    its FLOPs with the unembed over every position, and the recompute of
    what is checkpointed: at ``remat`` the layers and CE chunks, a forward
    less each layer's ``w_down`` product (no backward needs its output,
    and the recompute stops before it), else the CE chunks' unembed
    alone (``S`` is under one q chunk); a prefill takes the unembed of
    the last position only; a decode step is one token against an
    ``S``-slot cache."""
    D, H, kv, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                         cfg.vocab, cfg.n_layers)
    hd = cfg.head_dim or D // H
    Sq = 1 if mode == "decode" else S
    proj = D * (H + 2 * kv) * hd + H * hd * D + 3 * D * F  # qkv, o, MLP
    scores = 2 * H * Sq * S * hd                          # q·k and p·v
    fwd = L * 2 * B * (Sq * proj + scores) \
        + 2 * (B * S if mode == "train" else B) * D * V
    if mode != "train":
        return fwd
    return 3 * fwd + (fwd - L * 2 * B * S * F * D if remat
                      else 2 * B * S * D * V)


# the reduced configs whose every matmul ``hand_count`` spells out (MHA,
# GQA, one kv head; windows, softcaps and qk-norm add no matmul)
HAND_ARCHS = ["fedforecast-100m", "command-r-plus-104b", "gemma2-9b",
              "gemma3-4b"]


@pytest.mark.parametrize("batch,seq", [(8, 64), (2, 48), (3, 96)])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", HAND_ARCHS)
def test_flop_count_equals_hand_count(arch, mode, batch, seq):
    cfg = tget(arch).reduced()
    rec = dryrun.measure(cfg, InputShape(mode, seq, batch, mode))
    assert rec["per_device"]["flops"] == hand_count(cfg, mode, batch, seq)


@pytest.mark.parametrize("mode", ["decode", "prefill", "train"])
def test_fedforecast_reduced_flop_counts(mode):
    """Reduced fedforecast-100m at 8 x 64 through ``measure``: the hand
    count, and for the train step at ``remat=False`` exactly three
    forwards of ``loss_fn`` and the CE chunk's unembed, which its
    checkpoint recomputes (at ``remat=True`` the hand count adds the
    layers' recompute)."""
    cfg = tget("fedforecast-100m").reduced()
    shape = InputShape(mode, 64, 8, mode)
    rec = dryrun.measure(cfg, shape)
    assert rec["per_device"]["flops"] == hand_count(cfg, mode, 8, 64)
    if mode == "train":            # a forward, and twice its FLOPs back
        model = tbuild(cfg, device="meta")
        fwd = dryrun.count(model.loss_fn, (model.abstract_params(),
                                           model.input_specs(shape)))
        plain = dryrun.measure(cfg, shape, remat=False)
        unembed = 2 * 8 * 64 * cfg.d_model * cfg.vocab
        assert plain["per_device"]["flops"] == 3 * fwd["flops"] + unembed
        assert plain["per_device"]["flops"] == hand_count(
            cfg, mode, 8, 64, remat=False)


def _ref_cost_flops(monkeypatch, cfg, shape):
    """XLA's ``cost_analysis()["flops"]`` of the reference's
    ``build_dryrun`` program in cost mode on a one-device mesh."""
    ref = _ref_dryrun()
    monkeypatch.setattr(ref, "make_production_mesh", lambda multi_pod=False:
                        jax.make_mesh((1, 1), ("data", "model"),
                                      axis_types=(jax.sharding.AxisType.Auto,)
                                      * 2))
    monkeypatch.setattr(ref, "get_shape", lambda name: shape)
    monkeypatch.setenv("REPRO_COST_MODE", "1")
    mesh, fn, args = ref.build_dryrun(cfg, shape.name, multi_pod=False)
    with mesh:
        return fn.lower(*args).compile().cost_analysis()["flops"]


def test_reference_cost_mode_caveats(monkeypatch):
    """Reference caveats, against the hand count (reduced
    fedforecast-100m, 8 x 64): XLA's decode count falls below the matmuls
    alone, and two more layers add under half of their matmuls to it;
    its train count holds a second forward of the layers (every layer is
    remat'd), so it is the port's at ``remat=True`` (4 forwards against
    4), not at ``remat=False`` (3 and the CE's unembed against 4); its
    prefill and train counts are the matmuls plus the elementwise ops,
    within 2 % of them (XLA counts those, ``FlopCounterMode`` does
    not)."""
    import dataclasses
    jcfg = jget("fedforecast-100m").reduced()
    tcfg = tget("fedforecast-100m").reduced()
    xla = {(L, m): _ref_cost_flops(
        monkeypatch, dataclasses.replace(jcfg, n_layers=L),
        JInputShape(m, 64, 8, m))
        for L, m in ((2, "decode"), (4, "decode"), (2, "train"),
                     (2, "prefill"))}
    hand = {(L, m): hand_count(dataclasses.replace(tcfg, n_layers=L), m,
                               8, 64)
            for L, m in xla}
    assert xla[2, "decode"] < hand[2, "decode"]
    assert (xla[4, "decode"] - xla[2, "decode"]
            < (hand[4, "decode"] - hand[2, "decode"]) / 2)
    assert 0.98 < hand[2, "train"] / xla[2, "train"] < 1.0
    plain = hand_count(dataclasses.replace(tcfg, n_layers=2), "train", 8, 64,
                       remat=False)
    assert 0.70 < plain / xla[2, "train"] < 0.80
    assert 0.98 < hand[2, "prefill"] / xla[2, "prefill"] < 1.0


def _count(cfg, shape):
    _, fn, args = dryrun.build_dryrun(cfg, shape)
    return dryrun.count(fn, args)


def _real(tree, vocab, gen):
    """Real CPU tensors of a meta tree's shapes: ids below ``vocab``,
    small normals elsewhere."""
    def one(a):
        if a.dtype.is_floating_point:
            return (torch.randn(a.shape, generator=gen) * 0.02).to(a.dtype)
        return torch.randint(0, vocab, a.shape, generator=gen,
                             dtype=a.dtype)
    return _tree.tree_map(one, tree)


def _cpu_twin(cfg, shape):
    """The dry run's step of ``shape`` built anew on a CPU model, with real
    tensors: ``(fn, args)``."""
    model = tbuild(cfg, impl="xla", device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(model.generator(0))
    if shape.mode == "train":
        opt = adamw(1e-4)
        batch = _real(model.input_specs(shape), cfg.vocab, gen)
        return make_train_step(model, opt), (params, opt.init(params), batch)
    bf16 = _tree.tree_map(
        lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a,
        params)
    if shape.mode == "prefill":
        batch = _real(model.input_specs(shape), cfg.vocab, gen)
        return (lambda p, b: model.prefill(
            p, b, model.cache_len_for(shape.seq_len))), (bf16, batch)
    B, S = shape.global_batch, shape.seq_len
    cache = model.init_cache(B, model.cache_len_for(S))
    token = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                          dtype=torch.int32)
    pos = torch.full((B, 1), S - 1, dtype=torch.int32)
    return model.decode_step, (bf16, cache, token, pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_counts_equal_real_tensor_counts(arch):
    cfg = tget(arch).reduced()
    for mode in ("train", "prefill", "decode"):
        shape = InputShape(mode, 48, 2, mode)
        meta = _count(cfg, shape)
        fn, args = _cpu_twin(cfg, shape)
        real = dryrun.count(fn, args)
        assert meta["flops"] > 0
        assert meta == real, (mode, meta, real)


def test_live_bytes_follow_frees():
    x = torch.ones(1000, requires_grad=True)
    with dryrun.LiveBytes() as live:
        y = (x * 2).sin()                  # x * 2 is saved for the backward
        y.sum().backward()
        del y
    assert live.live == 4000               # x.grad is all that stays
    assert live.peak >= 3 * 4000           # x * 2, sin, the grad together


def _ref_record_keys():
    """The reference ``run_one``'s record keys, nested dict literals
    included, for the ``ok`` and the ``skipped`` records."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_one")

    def keys(d):
        return {k.value: (keys(v) if isinstance(v, ast.Dict) else None)
                for k, v in zip(d.keys, d.values)}
    recs = [keys(n.value) for n in ast.walk(fn)
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
            and any(isinstance(t, ast.Name) and t.id == "rec"
                    for t in n.targets)]
    return {("ok" if "per_device" in r else "skipped"): r for r in recs}


def _assert_keys(rec, want):
    """``rec`` has ``want``'s keys, level by level where ``want`` spells
    out a nested dict."""
    assert set(rec) == set(want)
    for k, w in want.items():
        if w is not None:
            _assert_keys(rec[k], w)


def test_artifact_keys_equal_reference(tmp_path):
    want = _ref_record_keys()
    ok = dryrun.run_one("fedforecast-100m", "decode_32k",
                        out_dir=str(tmp_path), verbose=False)
    skipped = dryrun.run_one("fedforecast-100m", "long_500k",
                             out_dir=str(tmp_path), verbose=False)
    assert skipped["status"] == "skipped"
    _assert_keys(ok, want["ok"])
    _assert_keys(skipped, want["skipped"])
    on_disk = json.loads(
        (tmp_path / "fedforecast-100m__decode_32k__h100x1.json").read_text())
    assert on_disk["mesh"] == "h100x1" and on_disk["n_devices"] == 1
    assert on_disk["cost_compile_s"] is None
    assert on_disk["per_device"]["xla_bytes_accessed_rolled"] is None
    assert on_disk["collectives"]["rolled_count"] is None
    assert on_disk["collectives"]["count"] == 0
    assert set(on_disk["roofline"]) == {"compute_s", "memory_s",
                                        "collective_s", "dominant",
                                        "step_time_lower_bound_s"}

    spec = importlib.util.spec_from_file_location(
        "bench_roofline", ROOT / "benchmarks" / "roofline.py")
    roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline)
    table = roofline.roofline_table(roofline.load_records(str(tmp_path)),
                                    mesh="h100x1")
    rows = table.splitlines()[2:]
    assert len(rows) == 2 and "| skipped |" in rows[1]
    assert rows[0].startswith("| fedforecast-100m | decode_32k |")


def test_main_writes_and_skips_existing(tmp_path, capsys):
    argv = ["--arch", "fedforecast-100m", "--shape", "decode_32k", "--out",
            str(tmp_path)]
    dryrun.main(argv)
    assert [p.name for p in tmp_path.iterdir()] == [
        "fedforecast-100m__decode_32k__h100x1.json"]
    dryrun.main(argv + ["--skip-existing"])
    assert "[skip-existing]" in capsys.readouterr().out


def _main_multi_pod(tmp):
    dryrun.main(["--arch", "fedforecast-100m", "--shape", "decode_32k",
                 "--multi-pod", "--out", str(tmp)])
    return json.loads((tmp / "fedforecast-100m__decode_32k__h100x2x16x16"
                       ".json").read_text())


def _on_fake_mesh(sizes, names, build):
    """``build(mesh)``'s ``(mesh, fn, args)`` counted in a fake world of
    the mesh's size: the record's keys as ``count`` gives them."""
    with dryrun.fake_world(int(torch.tensor(sizes).prod())):
        mesh, fn, args = build(Mesh(sizes, names))
        assert mesh.device_mesh is not None and mesh.size > 1
        return dryrun.count(fn, args)


def _small(arch, mode):
    return tget(arch).reduced(), InputShape(mode, 64, 8, mode)


@pytest.mark.parametrize("call", [
    _main_multi_pod,
    lambda tmp: dryrun.run_one("fedforecast-100m", "train_4k",
                               multi_pod=True, out_dir=str(tmp),
                               verbose=False),
    lambda tmp: _on_fake_mesh((2, 1), ("data", "model"),
                              lambda m: dryrun.build_dryrun(
                                  "fedforecast-100m", "train_4k", mesh=m)),
    lambda tmp: _on_fake_mesh((2, 4), ("data", "model"),
                              lambda m: variants.build_variant(
                                  *_small("gemma2-9b", "train"), "seqpar",
                                  mesh=m)),
    lambda tmp: _on_fake_mesh((2, 4), ("data", "model"),
                              lambda m: variants.build_variant(
                                  *_small("gemma2-9b", "decode"),
                                  "tree_decode", mesh=m)),
    lambda tmp: _on_fake_mesh((2, 4), ("data", "model"),
                              lambda m: variants.build_variant(
                                  *_small("mamba2-780m", "prefill"),
                                  "ssm_shard", mesh=m)),
], ids=["main-multi-pod", "run_one-multi-pod", "two-card-mesh", "seqpar",
        "tree_decode", "ssm_shard"])
def test_more_than_one_card_raises(call, tmp_path):
    """These raised ``NotImplementedError`` while the dry run covered one
    card; each now runs over a mesh of fake ranks (meta tensors) and
    records its collectives. The multi-pod ones are the production
    (2, 16, 16) mesh at full size: a decode serves B requests a pod, a
    train step stacks the silos over "pod" and crosses no pod."""
    rec = call(tmp_path)
    coll = rec["collectives"]
    assert coll["count"] > 0 and coll["ici_bytes"] > 0
    if "status" in rec:
        assert rec["status"] == "ok" and rec["mesh"] == "h100x2x16x16"
        assert rec["n_devices"] == 512 and coll["dcn_bytes"] == 0
        assert rec["roofline"]["collective_s"] > 0
    assert not dist.is_initialized()


def test_local_flops_count_rank_zero_share():
    """``FlopCounterMode`` around a DTensor matmul counts the global op;
    the dry run's ``LocalFlops`` counts rank 0's local product. On the
    (16, 16) fake mesh, a (64, 4096) batch over "data" times a (4096,
    8192) weight over "model": rank 0 multiplies (4, 4096) by (4096, 512),
    2 * 4 * 4096 * 512 FLOPs, 1/256 of the global 2 * 64 * 4096 * 8192."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.specs import NamedSharding, P
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        a = NamedSharding(mesh, P("data", None)).place(
            torch.empty(64, 4096, device="meta"))
        b = NamedSharding(mesh, P(None, "model")).place(
            torch.empty(4096, 8192, device="meta"))
        with FlopCounterMode(display=False) as whole:
            a @ b
        counts = dryrun.count(lambda x, y: x @ y, (a, b))
    assert whole.get_total_flops() == 2 * 64 * 4096 * 8192 == 4294967296
    assert counts["flops"] == 2 * 4 * 4096 * 512 == 16777216
    assert counts["argument_bytes"] == 4 * (4 * 4096 + 4096 * 512)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        variants.build_variant("fedforecast-100m", "train_4k", "moe_a2a")


def test_moe_grouped_variant_runs_grouped():
    flag = variants._EnvCall(lambda: os.environ.get("REPRO_MOE_GROUPED"),
                             "REPRO_MOE_GROUPED", "16")
    assert flag() == "16" and "REPRO_MOE_GROUPED" not in os.environ
    cfg = tget("olmoe-1b-7b").reduced()
    shape = InputShape("train", 64, 8, "train")
    # at remat=False the layers' dispatch buffers are live at the peak
    # (at remat=True the peak is set outside the layers)
    _, fn, args = variants.build_variant(
        cfg, shape, "moe_grouped", model=dryrun._meta_model(cfg, remat=False))
    grouped = dryrun.count(fn, args)
    assert "REPRO_MOE_GROUPED" not in os.environ
    _, fn, args = dryrun.build_dryrun(cfg, shape, remat=False)
    base = dryrun.count(fn, args)
    assert grouped["flops"] == base["flops"]
    assert grouped["temp_bytes"] != base["temp_bytes"]   # another dispatch
    rec = dryrun.measure(cfg, shape, variant="moe_grouped")
    assert rec["variant"] == "moe_grouped" and rec["status"] == "ok"


@pytest.mark.parametrize("variant", ["fedavg_sync", "fedavg_q8"])
def test_fedavg_variants_run_on_two_stacked_replicas(variant):
    cfg = tget("fedforecast-100m").reduced()
    mesh, fn, (stacked,) = variants.build_variant(cfg, "train_4k", variant)
    assert mesh.size == 1
    n = sum(a.numel() for a in _tree.leaves(
        tbuild(cfg, device="meta").abstract_params()))
    leaves = _tree.leaves(stacked)
    assert all(a.device.type == "meta" and a.shape[0] == variants.N_PODS
               for a in leaves)
    assert sum(a.numel() for a in leaves) == variants.N_PODS * n
    c = dryrun.count(fn, (stacked,))
    assert c["output_bytes"] == variants.N_PODS * 4 * n
    rec = dryrun.measure(cfg, "train_4k", variant=variant)
    assert rec["variant"] == variant and rec["per_device"]["flops"] == 0.0
    # the real aggregator on CPU tensors: both replicas equal the mean
    real = _tree.tree_map(
        lambda a: torch.randn(a.shape, dtype=a.dtype), stacked)
    out = fn(real)
    for a, r in zip(_tree.leaves(out), _tree.leaves(real)):
        assert torch.equal(a[0], a[1])
        tol = 0 if variant == "fedavg_sync" else float(r.abs().max()) / 127
        assert float((a[0] - r.mean(0)).abs().max()) <= tol + 1e-6
