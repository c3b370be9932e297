"""The port's model zoo against the JAX package's: the registry, every
config field by field, and for every architecture at ``reduced()`` the
init tree (keys, leaf order, shapes, f32) and the packed buffer and model
digest of equal params (bitwise)."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.checkpoint import pytree_digest as jdigest
from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.core.packing import pack_pytree as jpack
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.checkpoint import pytree_digest as tdigest
from repro_torch.configs import ASSIGNED_ARCHS as T_ASSIGNED
from repro_torch.configs import PORT_ONLY_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs as tlist
from repro_torch.convert import params_from_numpy
from repro_torch.core.packing import pack_pytree as tpack
from repro_torch.models import build_model as tbuild

ARCHS = sorted(jlist())
PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


# the port's own config fields, at these values in every config of the
# reference
PORT_FIELDS = {"layer_pattern": None, "rotary": None,
               "scale_embeddings": None, "ssm_groups": None,
               "ssm_heads": None}
PORT_MOE_FIELDS = {"router": "softmax", "score_bias": False,
                   "routed_scale": 1.0, "d_shared": 0,
                   "activation": "swiglu", "dropless": False}


def _reference_fields(cfg) -> dict:
    """``asdict(cfg)`` without the port's own fields, each checked at the
    value it has in every config of the reference."""
    d = dataclasses.asdict(cfg)
    for k, v in PORT_FIELDS.items():
        assert d.pop(k) == v, k
    if d["moe"] is not None:
        for k, v in PORT_MOE_FIELDS.items():
            assert d["moe"].pop(k) == v, k
    return d


def test_registry_matches_reference():
    assert PORT_ONLY_ARCHS == ("nemotron-3-nano-30b-a3b",)
    assert tuple(a for a in tlist() if a not in PORT_ONLY_ARCHS) == jlist()
    assert set(PORT_ONLY_ARCHS) <= set(tlist()) and len(tlist()) == 12
    assert len(jlist()) == 11
    assert T_ASSIGNED == J_ASSIGNED


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for j, t in ((jget(arch), tget(arch)),
                 (jget(arch).reduced(), tget(arch).reduced())):
        assert _reference_fields(t) == dataclasses.asdict(j)
        assert (t.padded_vocab, t.resolved_head_dim) == (
            j.padded_vocab, j.resolved_head_dim)
        assert [t.layer_is_local(i) for i in range(t.n_layers)] == [
            j.layer_is_local(i) for i in range(j.n_layers)]


def _paths(node, prefix=()):
    """(key path, shape) of each leaf of a nested dict, in JAX's order."""
    if isinstance(node, dict):
        return [p for k in sorted(node) for p in _paths(node[k],
                                                        prefix + (k,))]
    return [(prefix, tuple(node.shape))]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    cfg = tget(arch).reduced()
    model = tbuild(cfg, device="cpu")
    tp = model.init(model.generator(0))
    jabs = jbuild(jget(arch).reduced()).abstract_params()
    want = [(tuple(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jabs)[0]]
    assert _paths(tp) == want
    assert all(leaf.dtype == torch.float32 for leaf in tree.leaves(tp))
    assert all(str(leaf.dtype) == "float32" for leaf in jax.tree.leaves(jabs))
    again = model.init(model.generator(0))
    for a, b in zip(tree.leaves(tp), tree.leaves(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_and_digest_bitwise(arch):
    jp = jbuild(jget(arch).reduced()).init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jbuf, jlayout = jpack(jp)
    tbuf, tlayout = tpack(tp)
    np.testing.assert_array_equal(np.asarray(jbuf).view(np.uint32),
                                  tbuf.numpy().view(np.uint32))
    assert tlayout.to_dict() == jlayout.to_dict()
    assert tdigest(tp) == jdigest(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_builds_every_arch(arch):
    """Every full-width config builds on the CPU (no init: the largest are
    208 and 264 GB in bf16) and so does its reduced twin, for both
    impls."""
    for impl in ("xla", "kernel"):
        model = tbuild(arch, impl=impl, device="cpu")
        assert model.cfg == tget(arch) and model.device.type == "cpu"
        assert tbuild(tget(arch).reduced(), impl=impl,
                      device="cpu").cfg.n_layers == 2


def test_no_unported_raise_is_left_in_the_models():
    for path in sorted((PKG / "models").glob("*.py")):
        assert "NotImplementedError" not in path.read_text(), path
