"""Device rules of the port's control plane.

``Consortium``, ``FederationScheduler``, ``FLServer``, ``ClientAgent``
and ``FLClientNode`` run on CUDA unless given ``device="cpu"``: without
CUDA they raise instead of falling back. An unknown protocol name raises
``KeyError``.
"""
import pytest
import torch

from repro_torch.core import (ClientAgent, Consortium, FederationScheduler,
                              FLClientNode, FLServer, make_protocol)


def test_control_plane_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    calls = [
        lambda **kw: Consortium(["a", "b"], **kw),
        lambda **kw: FederationScheduler(b"k" * 32, **kw),
        lambda **kw: FLServer(b"k" * 32, **kw),
        lambda **kw: ClientAgent("c", None, None, **kw),
        lambda **kw: FLClientNode("c", None, None, "run", ["c"], b"s",
                                  **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the CPU works, and the consortium hands it down
    con = Consortium(["a", "b"], device="cpu")
    assert con.server.device.type == con.scheduler.device.type == "cpu"
    assert FLServer(b"k" * 32, device="cpu").device.type == "cpu"
    assert ClientAgent("c", None, None, device="cpu").device.type == "cpu"


def test_unknown_protocol_raises_key_error():
    with pytest.raises(KeyError, match="unknown protocol"):
        make_protocol("nope")
