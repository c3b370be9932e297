"""msgpack serialization for trees of numpy arrays and tensors (wire format).

Copy of ``repro.core.serialization`` with the one crossing the port
needs: tensors (on any device) turn into numpy arrays on the way out, so
the bytes on the wire are the reference's for equal values.
"""
from __future__ import annotations

import msgpack
import numpy as np
import torch

_ARR = "__nd__"


def _encode(obj):
    if isinstance(obj, (np.ndarray, np.generic)) or hasattr(obj, "__array__"):
        arr = np.asarray(obj)
        return {_ARR: True, "d": str(arr.dtype), "s": list(arr.shape),
                "b": arr.tobytes()}
    raise TypeError(f"cannot serialize {type(obj)}")


def _decode(obj):
    if isinstance(obj, dict) and obj.get(_ARR):
        return np.frombuffer(obj["b"], dtype=obj["d"]).reshape(obj["s"])
    return obj


def _to_numpy(tree):
    """Tensors -> numpy through dicts, lists and tuples (bf16 widens to
    f32: numpy has no bfloat16). Dicts come back in sorted-key order, as
    the reference's ``jax.tree.map`` rebuilds them, so the msgpack bytes
    are the reference's."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16
                else t).numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def pack(tree) -> bytes:
    # tensors -> numpy on the way out
    return msgpack.packb(_to_numpy(tree), default=_encode, use_bin_type=True)


def unpack(blob: bytes):
    return msgpack.unpackb(blob, object_hook=_decode, raw=False,
                           strict_map_key=False)
