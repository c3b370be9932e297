"""Pytree checkpointing: flat .npz payload + msgpack manifest.

Port of ``repro.checkpoint.ckpt``. The manifest carries the tree
structure, dtypes, a content digest, and caller-supplied metadata (round,
silo, governance contract id) — the hooks the FL-APU Metadata Manager
needs to track model provenance (paper §VII).

The files are the reference's, byte for byte: the archive ``np.savez``
writes of ``leaf_{i}`` in JAX's flatten order (its members carry a fixed
zip time, so it is deterministic) and ``msgpack.packb`` of the manifest
with the reference's keys in its order, ``treedef`` spelled as JAX's
``str(treedef)``. The digest's byte stream is the reference's too: per
leaf in JAX order, the NumPy dtype name, ``str`` of the shape tuple, then
the leaf's C-order bytes. Equal params therefore give equal digests on
both sides.

A ``bfloat16`` leaf is stored as what the reference's ``np.asarray`` of
one writes: its bits under the ``.npy`` descr ``<V2`` (ml_dtypes'
spelling), which numpy reads back as a ``|V2`` array. The reference's
loader keeps that dtype and so fails its own digest check on any bf16
tree; this loader gives each leaf its manifest's dtype, so bf16 trees
round-trip.
"""
from __future__ import annotations

import hashlib
import os
import time
import zipfile
from typing import Optional

import msgpack
import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.device import DEFAULT_DEVICE, resolve

_FORMAT = "repro-ckpt-v1"
_BF16_DESCR = "<V2"


def _host_array(leaf: torch.Tensor) -> np.ndarray:
    """A host tensor's C-order bytes as a numpy array, without a copy
    where the tensor already is one (numpy has no bfloat16: its bits)."""
    leaf = leaf.detach().contiguous()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.view(torch.int16)
    return leaf.numpy()


def _digest(flat) -> str:
    # imported here: ``repro_torch.core`` imports this module (its server
    # and client digest models)
    from repro_torch.core.packing import dtype_name
    h = hashlib.sha256()
    for leaf in flat:
        h.update(dtype_name(leaf.dtype).encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(_host_array(leaf.cpu()).reshape(-1))
    return h.hexdigest()


def pytree_digest(tree) -> str:
    """SHA256 over all leaf bytes — the model identity used for tracking."""
    return _digest(_tree.leaves(tree))


def _treedef_node(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_node(v)}"
                               for k, v in node.items()) + "}"
    return "*"


def _treedef_str(treedef) -> str:
    """JAX's ``str(treedef)`` of the same tree, from the port's dict
    skeleton: ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    return f"PyTreeDef({_treedef_node(treedef)})"


def _savez(path: str, members) -> None:
    """``np.savez`` of ``(name, array, descr)`` members, ``descr`` None for
    the array's own: the same zip (stored, zip64 forced, numpy's fixed
    member time) and ``.npy`` v1.0 headers. A bf16 leaf needs the given
    descr: no numpy dtype spells ``<V2`` without ml_dtypes."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr, descr in members:
            header = np.lib.format.header_data_from_array_1_0(arr)
            if descr is not None:
                header["descr"] = descr
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(fid, header)
                fid.write(arr.data)


def save_checkpoint(path: str, tree, *,
                    metadata: Optional[dict] = None) -> dict:
    """Write ``path.npz`` and ``path.manifest``; returns the manifest.
    Each leaf is copied to the host once: the archive and the digest read
    the same host copy."""
    from repro_torch.core.packing import dtype_name
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat, treedef = _tree.flatten(tree)
    flat = [leaf.detach().cpu() for leaf in flat]
    _savez(path + ".npz", [
        (f"leaf_{i}", _host_array(leaf),
         _BF16_DESCR if leaf.dtype == torch.bfloat16 else None)
        for i, leaf in enumerate(flat)])
    manifest = {
        "format": _FORMAT,
        "n_leaves": len(flat),
        "treedef": _treedef_str(treedef),
        "dtypes": [dtype_name(leaf.dtype) for leaf in flat],
        "shapes": [list(leaf.shape) for leaf in flat],
        "digest": _digest(flat),
        "saved_at": time.time(),
        "metadata": metadata or {},
    }
    with open(path + ".manifest", "wb") as f:
        f.write(msgpack.packb(manifest))
    return manifest


def _restore(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """An archive member as a host tensor of the manifest's dtype: a
    ``|V2`` member whose manifest says ``bfloat16`` is its bits."""
    if arr.dtype.kind == "V":
        return torch.from_numpy(arr.view(f"i{arr.dtype.itemsize}")).view(
            getattr(torch, dtype))
    return torch.from_numpy(arr)


def load_checkpoint(path: str, tree_like, *,
                    device=DEFAULT_DEVICE) -> tuple:
    """Restore into the structure of ``tree_like``, as tensors on
    ``device``. Returns (tree, manifest). Raises ``ValueError`` if the
    leaf count differs from ``tree_like``'s or the restored tree's digest
    is not the manifest's."""
    dev = resolve(device)
    with open(path + ".manifest", "rb") as f:
        manifest = msgpack.unpackb(f.read())
    like, treedef = _tree.flatten(tree_like)
    n_like = len(like)
    if manifest["n_leaves"] != n_like:
        raise ValueError(
            f"checkpoint {path} holds {manifest['n_leaves']} leaves, "
            f"tree_like has {n_like}")
    with np.load(path + ".npz") as data:
        leaves = [_restore(data[f"leaf_{i}"], dtype)
                  for i, dtype in enumerate(manifest["dtypes"])]
    # verify integrity on the host copy, before it moves to the device
    if _digest(leaves) != manifest["digest"]:
        raise ValueError(f"checkpoint digest mismatch for {path}")
    return _tree.unflatten(treedef, [leaf.to(dev) for leaf in leaves]), \
        manifest
