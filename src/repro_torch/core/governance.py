"""Governance Manager (paper §V, §VII): negotiation cockpit + contracts.

The Governance Cockpit manages a proposal/negotiation lifecycle:
participants propose values for the FL process parameters (data format,
hyperparameters, aggregation strategy, rounds, ...), vote, and — once every
required participant accepts — the decisions freeze into a
``GovernanceContract``. Every operation is recorded as provenance metadata
(paper: "all operations performed within the Cockpit are recorded").

The contract is what the Job Creator turns into an FL Job.
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.metadata import MetadataStore


@dataclass
class Proposal:
    proposal_id: str
    author: str
    parameter: str            # e.g. "arch", "rounds", "lr", "data_schema"
    value: Any
    rationale: str = ""
    votes: Dict[str, bool] = field(default_factory=dict)
    status: str = "open"      # open | accepted | rejected | superseded


@dataclass
class GovernanceContract:
    contract_id: str
    participants: List[str]
    decisions: Dict[str, Any]
    created_at: float
    version: int = 1

    def to_dict(self) -> dict:
        return {"contract_id": self.contract_id,
                "participants": list(self.participants),
                "decisions": dict(self.decisions),
                "created_at": self.created_at, "version": self.version}


# sane defaults for anything the participants did not negotiate explicitly
DEFAULT_DECISIONS = {
    "arch": "fedforecast-100m",
    "rounds": 5,
    "local_steps": 10,
    "batch_size": 8,
    "lr": 3e-4,
    "optimizer": "adamw",
    "outer_optimizer": "fedavg",
    "aggregation": "fedavg",          # fedavg | trimmed_mean | median
    "train_test_split": 0.9,
    "eval_metrics": ["ce"],
    "secure_aggregation": True,
    "hyperparameter_search": None,    # or {"parameter": "lr", "values": []}
    "data_schema": None,              # negotiated data format (validation.py)
    "priority": 0,                    # federation-scheduler admission rank
    "protocol": "sync",               # sync | async_buff (protocol programs)
    "async_buffer_size": 4,           # async_buff: updates folded per commit
    "compression": "none",            # none | topk | int8 (compressed plane)
    "compression_ratio": 0.1,         # topk: fraction of coordinates kept
    "quant_bits": 8,                  # int8: bits per quantized value (2..8)
    # composable privacy (DESIGN.md §Composable privacy): secure+int8
    # masked-quantized rounds and the optional per-round DP noise stage
    "quant_range": 0.0,               # fixed masked grid half-range (0=auto)
    "dp_epsilon": 0.0,                # per-round ε (0 disables the stage)
    "dp_delta": 1e-5,                 # per-round δ of the Gaussian mechanism
    "dp_clip": 1.0,                   # per-silo L2 clip on the weighted delta
    "dp_seed": 0,                     # base seed of per-silo noise streams
    # hierarchical device fleets (DESIGN.md §Hierarchical federation):
    # each silo fronts its own cross-device population and posts one
    # pre-aggregated delta upward; the fleet shape is negotiated like
    # every other decision (inner tier itself is always plain FedAvg)
    "devices_per_silo": 1,            # 1 = flat silo, no inner tier
    "device_cohort_size": 0,          # devices sampled per round (0 = all)
    "device_dropout": 0.0,            # Bernoulli per-device dropout prob
    "device_clip": 0.0,               # L2 clip per device delta (0 = off)
}


class GovernanceCockpit:
    """Negotiation state machine for one consortium."""

    def __init__(self, required_participants: List[str],
                 metadata: MetadataStore):
        self.required = list(required_participants)
        self.metadata = metadata
        self.proposals: Dict[str, Proposal] = {}
        self.contract: Optional[GovernanceContract] = None

    # ------------------------------------------------------------------
    def propose(self, author: str, parameter: str, value,
                rationale: str = "") -> Proposal:
        if author not in self.required:
            raise PermissionError(f"{author} is not a registered participant")
        p = Proposal(proposal_id=uuid.uuid4().hex[:12], author=author,
                     parameter=parameter, value=value, rationale=rationale)
        p.votes[author] = True     # proposing implies accepting
        self.proposals[p.proposal_id] = p
        self.metadata.record_provenance(
            actor=author, operation="propose", subject=parameter,
            outcome="open", details={"value": value, "id": p.proposal_id,
                                     "rationale": rationale})
        return p

    def vote(self, participant: str, proposal_id: str, accept: bool):
        if participant not in self.required:
            raise PermissionError(f"{participant} is not a participant")
        p = self.proposals[proposal_id]
        if p.status != "open":
            raise ValueError(f"proposal {proposal_id} is {p.status}")
        p.votes[participant] = accept
        self.metadata.record_provenance(
            actor=participant, operation="vote", subject=p.parameter,
            outcome="accept" if accept else "reject",
            details={"id": proposal_id})
        self._maybe_close(p)
        return p

    def _maybe_close(self, p: Proposal):
        if any(v is False for v in p.votes.values()):
            p.status = "rejected"
        elif all(u in p.votes and p.votes[u] for u in self.required):
            # supersede earlier accepted proposals for the same parameter
            for other in self.proposals.values():
                if (other.parameter == p.parameter
                        and other.status == "accepted"):
                    other.status = "superseded"
            p.status = "accepted"
        if p.status != "open":
            self.metadata.record_provenance(
                actor="cockpit", operation="close_proposal",
                subject=p.parameter, outcome=p.status,
                details={"id": p.proposal_id, "value": p.value})

    # ------------------------------------------------------------------
    def accepted_decisions(self) -> Dict[str, Any]:
        out = dict(DEFAULT_DECISIONS)
        for p in self.proposals.values():
            if p.status == "accepted":
                out[p.parameter] = p.value
        return out

    def finalize(self) -> GovernanceContract:
        """Freeze decisions into a contract (requires no open proposals)."""
        open_ps = [p for p in self.proposals.values() if p.status == "open"]
        if open_ps:
            raise ValueError(
                f"{len(open_ps)} proposals still open: "
                f"{[p.parameter for p in open_ps]}")
        version = (self.contract.version + 1) if self.contract else 1
        self.contract = GovernanceContract(
            contract_id=uuid.uuid4().hex[:12],
            participants=list(self.required),
            decisions=self.accepted_decisions(),
            created_at=time.time(),
            version=version)
        self.metadata.record_provenance(
            actor="cockpit", operation="finalize_contract",
            subject=self.contract.contract_id, outcome="finalized",
            details=self.contract.to_dict())
        return self.contract

    def request_new_negotiation(self, participant: str, reason: str = ""):
        """SAAM task 3: a participant requests a fresh negotiation round."""
        if participant not in self.required:
            raise PermissionError(f"{participant} is not a participant")
        for p in self.proposals.values():
            if p.status == "open":
                p.status = "superseded"
        self.metadata.record_provenance(
            actor=participant, operation="request_negotiation",
            subject="governance", outcome="opened", details={"reason": reason})
