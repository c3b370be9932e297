"""The port's input shapes, abstract trees and placement rules against
the JAX package's.

* ``configs.shapes``: the shape table, ``get_shape`` and
  ``shape_applicable`` for every config and shape.
* ``Model.abstract_params``, ``abstract_cache`` and ``input_specs`` at
  full size for all eleven configs: the same leaf paths in the same
  order, shapes and dtypes exactly (the port's trees are meta tensors,
  which allocate nothing).
* ``sharding.specs.param_pspecs`` (train and serve), ``cache_pspecs`` and
  ``data.pipeline.batch_pspec`` equal to the reference's on
  ``jax.sharding.AbstractMesh`` meshes of (2, 4), (2, 2, 2), (16, 16) and
  (2, 16, 16), with the port's abstract ``Mesh`` of the same axes.
* the placement on a one-device mesh, the ``ValueError`` of a device
  list over more than one card in one process, and the same axes over a
  gloo world of ranks.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import get_shape as jget_shape
from repro.configs import list_configs
from repro.configs import shape_applicable as japplicable
from repro.data.pipeline import batch_pspec as jbatch_pspec
from repro.models import build_model as jbuild
from repro.sharding.specs import cache_pspecs as jcache_pspecs
from repro.sharding.specs import param_pspecs as jparam_pspecs
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as tget
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import shape_applicable as tapplicable
from repro_torch.data.pipeline import batch_pspec, shard_batch
from repro_torch.launch.mesh import (H100, Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model as tbuild
from repro_torch.sharding import cache_pspecs, param_pspecs, to_shardings
from repro_torch.sharding.specs import P, constrain, place

ARCHS = sorted(list_configs())
SHAPE_NAMES = [s.name for s in JSHAPES]
MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_BATCH, CACHE_LEN = 8, 64


def test_arch_lists_match():
    """The reference's eleven, and the port's own config by name."""
    from repro_torch.configs import PORT_ONLY_ARCHS
    from repro_torch.configs import list_configs as tlist
    assert PORT_ONLY_ARCHS == ("nemotron-3-nano-30b-a3b",)
    assert sorted(tlist()) == sorted(ARCHS + list(PORT_ONLY_ARCHS))
    assert len(ARCHS) == 11


def test_shape_table_matches():
    assert [tuple(vars(s).values()) for s in TSHAPES] == \
        [tuple(vars(s).values()) for s in JSHAPES]
    for name in SHAPE_NAMES:
        assert vars(tget_shape(name)) == vars(jget_shape(name))
    with pytest.raises(KeyError):
        tget_shape("no_such_shape")


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_matches(arch):
    for js, ts in zip(JSHAPES, TSHAPES):
        assert tapplicable(tget(arch), ts) == japplicable(jget(arch), js)


def _jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in flat]


def _tleaves(node, path=""):
    if isinstance(node, dict):
        return [x for k in sorted(node)
                for x in _tleaves(node[k], f"{path}['{k}']")]
    assert node.device.type == "meta", path
    return [(path, tuple(node.shape), str(node.dtype).replace("torch.", ""))]


def _models(arch):
    return jbuild(jget(arch)), tbuild(tget(arch), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match(arch):
    jm, tm = _models(arch)
    got = _tleaves(tm.abstract_params())
    assert got == _jleaves(jm.abstract_params())
    assert all(dt == "float32" for _, _, dt in got)   # fp32 masters


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches(arch):
    jm, tm = _models(arch)
    assert _tleaves(tm.abstract_cache(CACHE_BATCH, CACHE_LEN)) == \
        _jleaves(jm.abstract_cache(CACHE_BATCH, CACHE_LEN))


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match(arch, shape):
    jm, tm = _models(arch)
    assert _tleaves(tm.input_specs(tget_shape(shape))) == \
        _jleaves(jm.input_specs(jget_shape(shape)))


def _jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _tspecs(tree):
    from repro_torch import tree as _tree
    out = _tree.leaves(tree)
    assert all(isinstance(s, P) for s in out)
    return [tuple(s) for s in out]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_rules_match(arch, mesh):
    sizes, names = mesh
    jmesh, tmesh = AbstractMesh(sizes, names), Mesh(sizes, names)
    jm, tm = _models(arch)
    jp, tp = jm.abstract_params(), tm.abstract_params()
    for mode in ("train", "serve"):
        assert _tspecs(param_pspecs(tp, tmesh, mode)) == \
            _jspecs(jparam_pspecs(jp, jmesh, mode)), mode
    # batch 8 divides data = 2 (the batch dim splits); 1 never does, and
    # 16 > 8 splits the ring's time dim instead
    for batch in (CACHE_BATCH, 1):
        assert _tspecs(cache_pspecs(tm.abstract_cache(batch, CACHE_LEN),
                                    tmesh, batch=batch)) == \
            _jspecs(jcache_pspecs(jm.abstract_cache(batch, CACHE_LEN),
                                  jmesh, batch=batch)), batch
    for shape in SHAPE_NAMES[:2]:               # train and prefill batches
        assert _tspecs(batch_pspec(tmesh, tm.input_specs(tget_shape(shape)))
                       ) == _jspecs(jbatch_pspec(
                           jmesh, jm.input_specs(jget_shape(shape)))), shape


def test_production_meshes_are_abstract():
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        assert m.is_abstract and m.size == (512 if multi else 256)
        with pytest.raises(ValueError, match="abstract"):
            to_shardings({"w": P(None)}, m)
    assert make_host_mesh(2, 4).axis_names == ("data", "model")
    assert make_host_mesh(2, 2, pod=2).shape == {"pod": 2, "data": 2,
                                                 "model": 2}
    with pytest.raises(ValueError, match="devices for a mesh"):
        make_host_mesh(2, 2, devices=["cpu"])


def test_h100_hardware_model():
    assert H100.peak_flops_bf16 == 989e12 and H100.hbm_bw == 3.35e12
    assert H100.hbm_per_chip == 80e9 and H100.nvlink_bw == 900e9


def test_one_device_mesh_places_and_constrain_degrades():
    tm = tbuild(tget("fedforecast-100m").reduced(), device="cpu")
    params = tm.init(tm.generator(0))
    mesh = make_host_mesh(1, 1, pod=1, devices=["cpu"])
    specs = param_pspecs(params, mesh)
    placed = place(params, to_shardings(specs, mesh))
    from repro_torch import tree as _tree
    for a, b in zip(_tree.leaves(params), _tree.leaves(placed)):
        assert b.device.type == "cpu" and torch.equal(a, b)
    x = torch.ones(4, 3)
    assert constrain(x, P("data", None)) is x          # no mesh: identity
    assert torch.equal(constrain(x, P(None, None), mesh), x)
    with pytest.raises(ValueError, match="not in"):
        constrain(x, P("shard", None), mesh)
    batch = shard_batch(mesh, {"tokens": np.zeros((2, 5), np.int32)})
    assert batch["tokens"].dtype == torch.int32
    assert batch_pspec(mesh, batch) == {"tokens": P(("pod", "data"), None)}


def _two_rank_placement(rank, world):
    from repro_torch.sharding.specs import NamedSharding
    mesh = make_host_mesh(2, 1)                    # over the group's ranks
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    sh = to_shardings({"w": P("data", None)}, mesh)["w"]
    assert isinstance(sh, NamedSharding)
    leaf = place({"w": w}, {"w": sh})["w"]
    return {"local": leaf.to_local().tolist(),
            "whole": torch.equal(leaf.full_tensor(), w),
            "over_ranks": mesh.device_mesh is not None}


def test_a_mesh_over_several_cards_raises(tmp_path):
    """A device list over several cards in one process cannot hold a
    leaf (``ValueError``: that needs ranks); the same axes over a gloo
    world of two ranks place it, each rank its half."""
    from test_torch_mesh_world import run_world
    mesh = make_host_mesh(2, 1, devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="mesh over ranks"):
        to_shardings({"w": P("data", None)}, mesh)
    # the same device twice is one card
    mesh = make_host_mesh(2, 1, devices=["cpu", "cpu"])
    assert to_shardings({"w": P("data", None)}, mesh)["w"].mesh is mesh
    assert place({"w": torch.ones(2)}, to_shardings(
        {"w": P("data")}, mesh))["w"].device.type == "cpu"
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    for rank, r in enumerate(run_world(_two_rank_placement, 2, tmp_path)):
        assert r["over_ranks"] and r["whole"]
        assert r["local"] == w[2 * rank:2 * rank + 2].tolist()
