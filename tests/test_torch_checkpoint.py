"""The port's checkpoint store against the JAX package's, on the CPU.

Both packages write the same two files for the same tree: ``.npz`` (the
leaves in JAX's flatten order) and ``.manifest`` (msgpack: format, leaf
count, treedef, dtypes, shapes, digest, time, metadata). With
``time.time`` fixed the files are byte-equal, for f32 trees and for bf16
trees (the reference writes a bf16 leaf as ml_dtypes' ``<V2``). An f32
checkpoint written by either package loads bitwise in the other.

The one difference is pinned: the reference restores a bf16 leaf as a
``|V2`` array, so its own digest check rejects every bf16 tree; the port
gives each leaf its manifest's dtype and round-trips it.

Trees: a small seeded one (f32, a 0-d leaf, an int32 leaf) and the
reduced ``fedforecast-100m`` params (the reference's init, then
``convert.params_from_numpy``); each in bf16 as well, the port's bits
viewed as ml_dtypes' bfloat16 on the reference's side.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.checkpoint import (load_checkpoint, pytree_digest,
                                    save_checkpoint)
from repro_torch.convert import params_from_numpy

FIXED_TIME = 1_760_000_000.125
META = {"round": 3, "run_id": "run-0", "contract_id": "contract-0"}


def _small():
    rng = np.random.default_rng(3)
    return {"b": {"c": rng.normal(size=(4, 3)).astype(np.float32),
                  "a": np.float32(rng.normal())},
            "a": rng.normal(size=(5,)).astype(np.float32),
            "n": rng.integers(-9, 9, (2, 2)).astype(np.int32)}


def _bf16(port):
    """A port tree's float leaves in bf16, and the reference's twin: the
    same bits as ml_dtypes' bfloat16."""
    port = tree.tree_map(lambda t: t.to(torch.bfloat16)
                         if t.is_floating_point() else t, port)
    ref = tree.tree_map(
        lambda t: (t.view(torch.int16).numpy().view(jnp.bfloat16)
                   if t.dtype == torch.bfloat16 else t.numpy()), port)
    return ref, port


@pytest.fixture(scope="module")
def trees():
    cfg = jget("fedforecast-100m").reduced()
    ff = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(5)))
    out = {}
    for name, ref in (("small", _small()), ("fedforecast", ff)):
        port = params_from_numpy(ref, "cpu")
        out[name] = (ref, port)
        out[name + "-bf16"] = _bf16(port)
    return out


@pytest.fixture
def fixed_time(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: FIXED_TIME)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_bitwise(got, want):
    g, w = tree.leaves(got), tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def _read(path):
    return {ext: open(path + ext, "rb").read()
            for ext in (".npz", ".manifest")}


@pytest.mark.parametrize("name", ["small", "fedforecast", "small-bf16",
                                  "fedforecast-bf16"])
def test_files_byte_equal_to_the_reference(trees, name, tmp_path,
                                           fixed_time):
    ref, port = trees[name]
    jm = jckpt.save_checkpoint(str(tmp_path / "ref" / "ckpt"), ref,
                               metadata=META)
    tm = save_checkpoint(str(tmp_path / "port" / "ckpt"), port,
                         metadata=META)
    assert tm == jm
    assert tm["saved_at"] == FIXED_TIME and tm["metadata"] == META
    assert tm["digest"] == pytree_digest(port)
    assert tm["treedef"] == str(jax.tree_util.tree_structure(ref))
    assert _read(str(tmp_path / "port" / "ckpt")) == _read(
        str(tmp_path / "ref" / "ckpt"))


@pytest.mark.parametrize("tree_", [{}, {"x": {}}, {"w": np.float32(2.0)}],
                         ids=["empty", "empty-node", "scalar"])
def test_edge_trees_byte_equal(tree_, tmp_path, fixed_time):
    port = tree.tree_map(lambda a: torch.tensor(a), tree_)
    jckpt.save_checkpoint(str(tmp_path / "ref"), tree_)
    save_checkpoint(str(tmp_path / "port"), port)
    assert _read(str(tmp_path / "port")) == _read(str(tmp_path / "ref"))
    back, manifest = load_checkpoint(str(tmp_path / "ref"), port,
                                     device="cpu")
    _assert_bitwise(back, port)


@pytest.mark.parametrize("name", ["small", "fedforecast"])
def test_reference_checkpoint_loads_in_the_port(trees, name, tmp_path):
    ref, port = trees[name]
    path = str(tmp_path / "ckpt")
    jm = jckpt.save_checkpoint(path, ref, metadata=META)
    back, manifest = load_checkpoint(path, port, device="cpu")
    assert manifest == jm
    assert pytree_digest(back) == jckpt.pytree_digest(ref) == jm["digest"]
    _assert_bitwise(back, port)
    assert all(t.device.type == "cpu" for t in tree.leaves(back))


@pytest.mark.parametrize("name", ["small", "fedforecast"])
def test_port_checkpoint_loads_in_the_reference(trees, name, tmp_path):
    ref, port = trees[name]
    path = str(tmp_path / "ckpt")
    tm = save_checkpoint(path, port, metadata=META)
    back, manifest = jckpt.load_checkpoint(path, ref)
    assert manifest == tm
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["small-bf16", "fedforecast-bf16"])
def test_bf16_round_trips_in_the_port_only(trees, name, tmp_path):
    """Pinned difference: the reference's loader restores a bf16 leaf as
    ``|V2`` and rejects its own checkpoint; the port restores bf16."""
    ref, port = trees[name]
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, port)
    back, manifest = load_checkpoint(path, port, device="cpu")
    _assert_bitwise(back, port)
    assert "bfloat16" in manifest["dtypes"]
    with pytest.raises(ValueError, match="checkpoint digest mismatch"):
        jckpt.load_checkpoint(path, ref)
    jckpt.save_checkpoint(path, ref)
    with pytest.raises(ValueError, match="checkpoint digest mismatch"):
        jckpt.load_checkpoint(path, ref)
    _assert_bitwise(load_checkpoint(path, port, device="cpu")[0], port)


@pytest.mark.parametrize("name", ["small", "fedforecast"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_tampered_npz_raises_in_both(trees, name, writer, tmp_path):
    ref, port = trees[name]
    path = str(tmp_path / "ckpt")
    if writer == "ref":
        jckpt.save_checkpoint(path, ref)
    else:
        save_checkpoint(path, port)
    with np.load(path + ".npz") as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    arrays["leaf_0"].reshape(-1)[0] += 1.0
    np.savez(path + ".npz", **arrays)
    with pytest.raises(ValueError, match="checkpoint digest mismatch"):
        jckpt.load_checkpoint(path, ref)
    with pytest.raises(ValueError, match="checkpoint digest mismatch"):
        load_checkpoint(path, port, device="cpu")


@pytest.mark.parametrize("name", ["small", "fedforecast"])
@pytest.mark.parametrize("change", ["fewer", "more"])
def test_wrong_leaf_count_raises_in_both(trees, name, change, tmp_path):
    ref, port = trees[name]
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, port)
    if change == "fewer":
        last = sorted(ref)[-1]
        ref_like = {k: v for k, v in ref.items() if k != last}
        port_like = {k: v for k, v in port.items() if k != last}
    else:
        ref_like = {**ref, "z": np.zeros(1, np.float32)}
        port_like = {**port, "z": torch.zeros(1)}
    with pytest.raises(ValueError):
        jckpt.load_checkpoint(path, ref_like)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, port_like, device="cpu")

