"""Device and scope rules of the port's control plane.

``Consortium``, ``FederationScheduler``, ``FLServer``, ``ClientAgent``
and ``FLClientNode`` run on CUDA unless given ``device="cpu"``: without
CUDA they raise instead of falling back. What is not ported yet (ROADMAP
queue A item 12: the async protocol, device fleets, the intra-silo tier)
raises ``NotImplementedError`` and names the item; it never falls back
to the sync path.
"""
import pytest
import torch

from repro_torch.core import (ClientAgent, Consortium, FederationScheduler,
                              FLClientNode, FLServer, make_protocol)
from repro_torch.core.protocol import IntraSiloProtocol
from repro_torch.data.synthetic import make_silo_datasets
from test_torch_fl_sync import one_torch_thread

DECISIONS = {"arch": "fedforecast-100m", "rounds": 1, "local_steps": 1,
             "batch_size": 2, "data_schema": None}


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


def test_async_protocol_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 12"):
        make_protocol("async_buff")
    with pytest.raises(NotImplementedError, match="item 12"):
        IntraSiloProtocol()
    with pytest.raises(KeyError, match="unknown protocol"):
        make_protocol("nope")
    con = Consortium(["a", "b"], device="cpu")
    job = con.server.job_creator.from_contract(con.negotiate(
        {**DECISIONS, "protocol": "async_buff",
         "secure_aggregation": False}))
    with pytest.raises(NotImplementedError, match="item 12"):
        con.server.start_run(job)
    # through the scheduler the admission fails, on the provenance trail
    with pytest.raises(RuntimeError, match="not admitted"):
        con.start(job, make_silo_datasets(2, vocab=512, seq_len=32))
    failed = con.server.metadata.query(operation="admit_job",
                                       outcome="failed")
    assert failed and "item 12" in failed[0]["details"]["error"]


@pytest.mark.parametrize("fleet", [{"devices_per_silo": 2},
                                   {"device_cohort_size": 1}])
def test_device_fleets_are_not_ported(fleet):
    con = Consortium(["a", "b"], device="cpu")
    job = con.server.job_creator.from_contract(con.negotiate(
        {**DECISIONS, **fleet}))
    con.start(job, make_silo_datasets(2, vocab=512, seq_len=32))
    with pytest.raises(NotImplementedError, match="item 12"), \
            one_torch_thread():
        con.run_to_completion()
