"""The port's dry run over meshes of ranks (the ``fake`` process group,
meta tensors) against the JAX package's small-mesh dry run.

* The counterpart of ``tests/test_dryrun_small.py``'s six combinations:
  reduced ``fedforecast-100m`` and ``olmoe-1b-7b`` at 8 x 64, a train
  step on the (data 2, model 4) mesh and on the (pod 2, data 2, model 2)
  mesh (the multi-pod program) and a decode step on (2, 4); each runs
  and writes an ``ok`` artifact, the train steps with collectives, the
  multi-pod one with none across pods (the per-silo step is pod-local;
  only the FedAvg crosses). Rank 0's FLOPs are the global count over the
  ranks that split the work: an eighth of one card's for the train step.
* Each mesh-only variant (``seqpar``, ``tree_decode``, ``ssm_shard``)
  builds on the (2, 4) fake mesh, sets its flag only around the call,
  and writes an artifact with the reference's keys (read from its
  source, as ``tests/test_torch_dryrun.py`` does); the FedAvg variants
  on the pod mesh exchange across pods, the int8 one about 4x fewer
  bytes.
* The MoE dispatch refuses tokens and expert weights of which some are
  ``DTensor``s and some plain.
* ``record_collectives``: explicit ``torch.distributed`` calls and
  DTensor's redistributions, each kind's ring traffic as the
  reference's ``analyze_collectives`` computes it from the same result
  bytes and group size, and the cross-pod split by ``rank // pod_size``.
* ``main --mesh`` writes artifacts named after the mesh, which
  ``benchmarks/roofline.py`` renders.
"""
import importlib.util
import json
import os
import re
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_analysis import analyze_collectives
from repro_torch.configs import InputShape
from repro_torch.configs import get_config as tget
from repro_torch.launch import dryrun, variants
from repro_torch.launch.hlo_analysis import record_collectives, ring_traffic
from repro_torch.launch.mesh import mesh_name, rank_mesh
from test_torch_dryrun import _assert_keys, _ref_record_keys

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"train_4k": InputShape("train_4k", 64, 8, "train"),
         "decode_32k": InputShape("decode_32k", 64, 8, "decode")}
ONE_POD, TWO_PODS = ((2, 4), ("data", "model")), \
    ((2, 2, 2), ("pod", "data", "model"))


@pytest.fixture(scope="module")
def world():
    """Rank 0 of a fake group of 8 ranks for the module, both meshes."""
    with dryrun.fake_world(8):
        yield {"one": rank_mesh(*ONE_POD), "two": rank_mesh(*TWO_PODS)}


@pytest.mark.parametrize("arch", ["fedforecast-100m", "olmoe-1b-7b"])
@pytest.mark.parametrize("shape,pods", [("train_4k", "one"),
                                        ("train_4k", "two"),
                                        ("decode_32k", "one")])
def test_small_mesh_dryrun_all_paths(world, arch, shape, pods, tmp_path,
                                     monkeypatch):
    monkeypatch.setattr(dryrun, "get_shape", lambda name: SMALL[name])
    monkeypatch.setattr(dryrun, "get_config", lambda a: tget(a).reduced())
    mesh = world[pods]
    rec = dryrun.run_one(arch, shape, mesh=mesh, out_dir=str(tmp_path),
                         verbose=False)
    name = "h100x2x4" if pods == "one" else "h100x2x2x2"
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__{name}.json")
                         .read_text())
    assert rec["status"] == on_disk["status"] == "ok"
    assert on_disk["mesh"] == name and on_disk["n_devices"] == 8
    coll = rec["collectives"]
    if shape == "train_4k":
        assert coll["count"] > 0 and coll["ici_bytes"] > 0
        assert rec["roofline"]["collective_s"] > 0
    assert coll["dcn_bytes"] == 0          # no FedAvg inside the step


def test_train_flops_are_an_eighth_of_one_card(world):
    cfg = tget("fedforecast-100m").reduced()
    one = dryrun.measure(cfg, SMALL["train_4k"])
    for mesh in world.values():
        rec = dryrun.measure(cfg, SMALL["train_4k"], mesh=mesh)
        assert rec["per_device"]["flops"] * 8 == one["per_device"]["flops"]
        assert rec["n_devices"] == 8


@pytest.mark.parametrize("arch,mode,variant,flag", [
    ("gemma2-9b", "train", "seqpar", "REPRO_SEQ_SHARD"),
    ("fedforecast-100m", "decode", "tree_decode", "REPRO_TREE_DECODE"),
    ("mamba2-780m", "train", "ssm_shard", "REPRO_SSM_SHARD")])
def test_mesh_only_variants_build_on_a_fake_mesh(world, arch, mode, variant,
                                                 flag, tmp_path,
                                                 monkeypatch):
    cfg = tget(arch).reduced()
    shape = InputShape(mode, 64, 8, mode)
    mesh, fn, args = variants.build_variant(cfg, shape, variant,
                                            mesh=world["one"])
    assert mesh is world["one"] and flag not in os.environ
    seen = []
    import repro_torch.models.transformer as tr
    monkeypatch.setattr(tr, "layer_windows", _spy(tr.layer_windows, flag,
                                                  seen))
    counts = dryrun.count(fn, args)
    assert seen and all(v == "1" for v in seen) and flag not in os.environ
    assert counts["flops"] > 0 and counts["collectives"]["count"] > 0
    monkeypatch.setattr(dryrun, "get_config", lambda a: tget(a).reduced())
    monkeypatch.setattr(dryrun, "get_shape", lambda name: shape)
    dryrun.run_one(arch, mode, mesh=world["one"], variant=variant,
                   out_dir=str(tmp_path), verbose=False)
    rec = json.loads((tmp_path / f"{arch}__{mode}__h100x2x4__{variant}"
                      ".json").read_text())
    assert rec["variant"] == variant and rec["status"] == "ok"
    _assert_keys(rec, _ref_record_keys()["ok"])


def _spy(fn, flag, seen):
    def wrapped(*a, **kw):
        seen.append(os.environ.get(flag))
        return fn(*a, **kw)
    return wrapped


def test_fedavg_variants_cross_pods(world):
    cfg = tget("fedforecast-100m").reduced()
    recs = {v: dryrun.measure(cfg, SMALL["train_4k"], variant=v,
                              mesh=world["two"])
            for v in ("fedavg_sync", "fedavg_q8")}
    sync, q8 = (recs[v]["collectives"] for v in ("fedavg_sync",
                                                  "fedavg_q8"))
    assert sync["dcn_bytes"] > 0 and q8["dcn_bytes"] > 0
    assert 3.5 < sync["dcn_bytes"] / q8["dcn_bytes"] <= 4.0
    with pytest.raises(ValueError, match="'pod' axis"):
        variants.build_variant(cfg, SMALL["train_4k"], "fedavg_sync",
                               mesh=world["one"])


@pytest.mark.parametrize("placed", ["tokens", "experts"])
def test_moe_dispatch_refuses_mixed_placements(world, placed):
    """Tokens and expert weights are all ``DTensor``s (the sharded
    dispatch) or all plain tensors; a mix would gather whole buffers, so
    it raises."""
    from repro_torch.models import moe
    from repro_torch.sharding.specs import NamedSharding, P
    cfg = tget("olmoe-1b-7b").reduced()
    p = {k: v.to("meta") for k, v in moe.moe_init(
        torch.Generator().manual_seed(0), cfg).items()}
    x = torch.empty((2, 8, cfg.d_model), device="meta")
    rep = NamedSharding(world["one"], P())
    if placed == "tokens":
        x = rep.place(x)
    else:
        p = {k: rep.place(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="all DTensors or all plain"):
        moe.moe_apply(p, cfg, x)


def test_record_collectives_sees_explicit_calls_and_pod_crossings(world):
    from repro_torch.sharding.specs import NamedSharding, P
    mesh = world["two"]
    t = torch.empty(4, 8, device="meta")
    with record_collectives(pod_size=4) as rec:
        dist.all_reduce(t)                             # the whole world
        dist.all_reduce(t, group=mesh.device_mesh.get_group("data"))
        x = NamedSharding(mesh, P("pod", "data", None)).place(
            torch.empty(8, 16, 4, device="meta"))
        x.redistribute(mesh.device_mesh, [x.placements[0]] + [
            type(x.placements[2])()] * 2)              # gather over data
        x.full_tensor()                                # and over pod
    ops = rec.summary()["ops"]
    kinds = [(o["kind"], o["group_size"], o["cross_pod"]) for o in ops]
    assert kinds[:2] == [("all-reduce", 8, True), ("all-reduce", 2, False)]
    assert ("all-gather", 2, True) in kinds[2:]
    assert ("all-gather", 2, False) in kinds[2:]
    assert ops[0]["bytes"] == 4 * 8 * 4
    summ = rec.summary()
    assert summ["count"] == len(ops)
    assert summ["dcn_bytes"] == sum(o["traffic"] for o in ops
                                    if o["cross_pod"])


HLO = """
  %ar = f32[{n}]{{0}} all-reduce(f32[{n}]{{0}} %p), replica_groups=[2,4]<=[8]
  %ag = f32[{n}]{{0}} all-gather(f32[16]{{0}} %p), replica_groups=[2,4]<=[8]
  %rs = f32[{n}]{{0}} reduce-scatter(f32[256]{{0}} %p), replica_groups=[2,4]<=[8]
  %aa = f32[{n}]{{0}} all-to-all(f32[{n}]{{0}} %p), replica_groups=[2,4]<=[8]
  %cp = f32[{n}]{{0}} collective-permute(f32[{n}]{{0}} %p), source_target_pairs={{{{0,1}}}}
"""


@pytest.mark.parametrize("n", [64, 1000])
def test_ring_traffic_is_the_reference_formula(n):
    ref = analyze_collectives(HLO.format(n=n), n_devices=8, pod_size=None)
    got = [(op["kind"], op["traffic"]) for op in ref["ops"]]
    for kind, traffic in got:
        gsize = 8 if kind == "collective-permute" else 4
        assert ring_traffic(kind, 4 * n, gsize) == traffic, kind
    assert len(got) == 5


def test_main_writes_mesh_artifacts_the_table_reads(world, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(dryrun, "get_shape", lambda name: SMALL[name])
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: tget(a).reduced())
    dryrun.main(["--arch", "fedforecast-100m", "--shape", "train_4k",
                 "--mesh", "2,2,2", "--out", str(tmp_path)])
    path = tmp_path / "fedforecast-100m__train_4k__h100x2x2x2.json"
    assert json.loads(path.read_text())["status"] == "ok"
    spec = importlib.util.spec_from_file_location(
        "bench_roofline", ROOT / "benchmarks" / "roofline.py")
    roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline)
    table = roofline.roofline_table(roofline.load_records(str(tmp_path)),
                                    mesh="h100x2x2x2")
    row = table.splitlines()[2]
    assert row.startswith("| fedforecast-100m | train_4k |")
    assert not re.search(r"\| 0\.00 \|\s*$", row)


def test_mesh_names_and_parse():
    assert dryrun.parse_mesh("card") is None
    assert dryrun.parse_mesh("card", multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))
    assert dryrun.parse_mesh("production") == ((16, 16), ("data", "model"))
    assert dryrun.parse_mesh("2,4") == ((2, 4), ("data", "model"))
    from repro_torch.launch.mesh import Mesh, make_card_mesh
    assert mesh_name(make_card_mesh()) == "h100x1"
    assert mesh_name(Mesh((16, 16), ("data", "model"))) == "h100x16x16"
    assert mesh_name(Mesh((2, 16, 16), ("pod", "data", "model"))) == \
        "h100x2x16x16"
    with pytest.raises(ValueError):
        dryrun.parse_mesh("2,4", multi_pod=True)
