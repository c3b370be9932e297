"""The port's placement over meshes of ranks against the JAX package's.

One world of 8 gloo ranks (``test_torch_mesh_world.run_world``) holds
both of the reference's host meshes, (data 2, model 4) and (pod 2, data
2, model 2). On each, every leaf of every reduced config, in train and
serve mode (and silo-stacked ``P("pod", ...)`` on the pod mesh), is
placed from meta tensors by ``param_pspecs``: its local shard shape must
be the reference's ``NamedSharding(mesh, spec).shard_shape``, computed
in a subprocess with 8 forced host devices (as
``tests/test_dryrun_small.py`` runs the reference's meshes). Then, on
real tensors: ``shard_batch`` puts the batch ``P(("pod", "data"))``, so
rank (p, d, m) holds rows ``(2p + d) * B/4`` on; ``to_shardings`` /
``place`` of a whole leaf gives each rank its own slab and gathers back
bitwise, as does ``NamedSharding.from_local`` of each rank's own slab; ``constrain`` inside ``mesh_scope`` redistributes a ``DTensor``
and is the identity with no mesh in scope.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from test_torch_mesh_world import run_world

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, list_configs
    from repro.models import build_model
    from repro.sharding.specs import param_pspecs
    meshes = {"2x4": ((2, 4), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
    out = {}
    for tag, (shape, names) in meshes.items():
        mesh = jax.make_mesh(shape, names)
        for arch in sorted(list_configs()):
            params = build_model(get_config(arch).reduced()).abstract_params()
            for mode in ("train", "serve"):
                specs = param_pspecs(params, mesh, mode)
                leaves = jax.tree.leaves(params)
                sl = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
                out[f"{tag}|{arch}|{mode}"] = [
                    list(NamedSharding(mesh, s).shard_shape(a.shape))
                    for a, s in zip(leaves, sl)]
                if "pod" in names and mode == "train":
                    out[f"{tag}|{arch}|pod"] = [
                        list(NamedSharding(mesh, P("pod", *s)).shard_shape(
                            (2,) + a.shape)) for a, s in zip(leaves, sl)]
    print("RESULT" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_shapes():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[0][len("RESULT"):])


def _rank_checks(rank, world):
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config, list_configs
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import param_pspecs, to_shardings
    from repro_torch.sharding.mesh import mesh_scope
    from repro_torch.sharding.specs import NamedSharding, P, constrain, place

    meshes = {"2x4": make_host_mesh(2, 4),
              "2x2x2": make_host_mesh(2, 2, pod=2)}
    shapes = {}
    for tag, mesh in meshes.items():
        for arch in sorted(list_configs()):
            params = build_model(get_config(arch).reduced(),
                                 device="meta").abstract_params()
            for mode in ("train", "serve"):
                specs = param_pspecs(params, mesh, mode)
                placed = place(params, to_shardings(specs, mesh))
                shapes[f"{tag}|{arch}|{mode}"] = [
                    list(a.to_local().shape) for a in _tree.leaves(placed)]
                if "pod" in mesh.axis_names and mode == "train":
                    stacked = _tree.tree_map(
                        lambda a: torch.empty((2,) + tuple(a.shape),
                                              device="meta"), params)
                    pod = _tree.tree_map(lambda s: P("pod", *s), specs)
                    placed = place(stacked, to_shardings(pod, mesh))
                    shapes[f"{tag}|{arch}|pod"] = [
                        list(a.to_local().shape)
                        for a in _tree.leaves(placed)]

    pod_mesh = meshes["2x2x2"]
    coords = tuple(pod_mesh.device_mesh.get_local_rank(n) for n in pod_mesh.axis_names)
    tokens = torch.arange(8 * 3, dtype=torch.int32).reshape(8, 3)
    batch = shard_batch(pod_mesh, {"tokens": tokens.numpy()})["tokens"]
    w = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    mesh = meshes["2x4"]
    leaf = place({"w": w}, to_shardings({"w": P("data", "model")},
                                        mesh))["w"]
    d, m = (mesh.device_mesh.get_local_rank(n) for n in mesh.axis_names)
    own = NamedSharding(mesh, P("data", "model")).from_local(
        w[4 * d:4 * d + 4, 2 * m:2 * m + 2].clone(), w.shape)
    with mesh_scope(mesh):
        moved = constrain(leaf, P(None, "model"))
        plain = constrain(w, P("data", None))
    outside = constrain(leaf, P(None, None))
    return {
        "shapes": shapes, "coords": coords,
        "batch_local": batch.to_local().tolist(),
        "batch_placements": tuple(batch.placements) == (
            Shard(0), Shard(0), Replicate()),
        "w_local": leaf.to_local().tolist(),
        "w_whole": torch.equal(leaf.full_tensor(), w),
        "own_whole": torch.equal(own.full_tensor(), w)
        and tuple(own.placements) == tuple(leaf.placements),
        "moved": tuple(moved.placements) == (Replicate(), Shard(1))
        and torch.equal(moved.full_tensor(), w),
        "plain_kept": plain is w and not isinstance(plain, DTensor),
        "outside_identity": outside is leaf,
        "rank_coords": tuple(mesh.device_mesh.get_local_rank(n) for n in mesh.axis_names),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(_rank_checks, 8, tmp_path_factory.mktemp("placement"))


@pytest.mark.parametrize("mesh,mode", [
    ("2x4", "train"), ("2x4", "serve"), ("2x2x2", "train"),
    ("2x2x2", "serve"), ("2x2x2", "pod")])
def test_local_shards_are_the_reference_shard_shapes(world,
                                                     reference_shapes, mesh,
                                                     mode):
    keys = [k for k in reference_shapes if k.startswith(mesh + "|")
            and k.endswith("|" + mode)]
    assert len(keys) == 11
    for r in world:
        for k in keys:
            assert r["shapes"][k] == reference_shapes[k], (r["coords"], k)


def test_shard_batch_puts_rows_over_pod_then_data(world):
    import numpy as np
    rows = np.arange(8 * 3).reshape(8, 3)
    for r in world:
        p, d, _ = r["coords"]
        assert r["batch_placements"]
        assert r["batch_local"] == rows[(2 * p + d) * 2:
                                        (2 * p + d + 1) * 2].tolist()


def test_place_slabs_gather_back_and_constrain(world):
    import numpy as np
    w = np.arange(8 * 8, dtype=np.float32).reshape(8, 8)
    for r in world:
        d, m = r["rank_coords"]
        assert np.array_equal(r["w_local"],
                              w[4 * d:4 * d + 4, 2 * m:2 * m + 2])
        assert r["w_whole"] and r["own_whole"] and r["moved"]
        assert r["plain_kept"] and r["outside_identity"]
