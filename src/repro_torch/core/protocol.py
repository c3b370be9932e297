"""Round protocols — only the client-side delta helper is ported so far.

``pack_delta`` is the helper ``core/client.py`` shares with the protocol
module in the reference (``repro.core.protocol.pack_delta``): the posted
update of the compressed planes is the packed trained params minus the
packed base params. The phase machines (``SyncProtocol``,
``AsyncBuffProtocol``) come with the control plane.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import pack_pytree


def pack_delta(trained, base) -> torch.Tensor:
    """Packed ``trained - base`` as a (T,) f32 tensor on the leaves'
    device."""
    buf_t, _ = pack_pytree(trained)
    buf_b, _ = pack_pytree(base)
    return buf_t - buf_b
