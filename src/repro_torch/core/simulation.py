"""Consortium builder + cooperative driver for in-process FL simulations.

Wires N organizations and one FLServer through a ``FederationScheduler``
and runs the pull-based protocol to completion. Since the scheduler became
the runtime (DESIGN.md §Federation scheduler), the Consortium is a thin
single-job wrapper over it: the same admission, wake-condition loop and
provenance trail drive one job here and sixteen in ``bench_multi_job``.
Used by tests, examples and benchmarks — the same components a multi-host
deployment would run behind REST endpoints.

Port of ``repro.core.simulation``. ``device`` (default ``"cuda"``, which
raises without CUDA) goes down to the scheduler, the server and every
silo agent; ``initial_params`` is the server's injected initial global
(the reference draws its own from ``jax.random``).
"""
from __future__ import annotations

import secrets
from typing import List, Optional

from repro_torch.core.client import ClientConfig
from repro_torch.core.jobs import FLJob
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.scheduler import FederationScheduler
from repro_torch.device import DEFAULT_DEVICE


class Consortium:
    def __init__(self, organizations: List[str], *, seed: int = 0,
                 master_key: Optional[bytes] = None,
                 metadata_path: Optional[str] = None,
                 transport=None, wan=None, telemetry=None,
                 device=DEFAULT_DEVICE, initial_params=None):
        self.master_key = master_key or secrets.token_bytes(32)
        metadata = MetadataStore(path=metadata_path) if metadata_path else None
        # transport/wan/telemetry plumb straight through to the
        # MessageBoard: the same consortium runs over the in-proc dict or
        # a board-hosting subprocess (tests/test_transport.py proves twin
        # equivalence), with or without the flight recorder
        self.scheduler = FederationScheduler(self.master_key,
                                             metadata=metadata,
                                             transport=transport, wan=wan,
                                             telemetry=telemetry,
                                             device=device)
        self.server = self.scheduler.new_server(
            seed=seed, initial_params=initial_params)
        self.organizations = organizations
        self.admin = "server-admin"
        self.server.clients.create_user(
            "bootstrap", self.admin, "coordinator", "admin-pw",
            role="server_admin")
        self.participants = {}
        self.client_ids = {}
        for org in organizations:
            user = f"{org}-participant"
            self.server.clients.create_user(self.admin, user, org, f"pw-{org}")
            self.participants[org] = user
            cid = self.server.clients.request_registration(user, org)
            self.server.clients.approve_client(self.admin, cid)
            self.client_ids[org] = cid
        self.nodes = []
        self.run_id: Optional[str] = None

    @property
    def telemetry(self):
        """The federation's shared observability bundle (on the board)."""
        return self.scheduler.telemetry

    # ------------------------------------------------------------------
    def negotiate(self, decisions: dict):
        """Run a (scripted) negotiation: org0 proposes, everyone accepts."""
        cockpit = self.server.open_negotiation(
            list(self.participants.values()))
        users = list(self.participants.values())
        for param, value in decisions.items():
            p = cockpit.propose(users[0], param, value)
            for u in users[1:]:
                cockpit.vote(u, p.proposal_id, True)
        return cockpit.finalize()

    def start(self, job: FLJob, datasets, *,
              client_config: Optional[ClientConfig] = None):
        datasets_by_cid = {}
        for org, ds in zip(self.organizations, datasets):
            cid = self.client_ids[org]
            if cid not in self.scheduler.agents:
                self.scheduler.register_agent(cid, ds, capacity=1,
                                              config=client_config)
            datasets_by_cid[cid] = ds
        run_id = self.scheduler.submit(
            job, server=self.server,
            cohort=[self.client_ids[o] for o in self.organizations],
            datasets=datasets_by_cid, client_config=client_config)
        entry = self.scheduler.entries[run_id]
        if entry.state != "running":        # single job over a fresh fleet
            raise RuntimeError(f"job was not admitted: {entry.state}")
        self.run_id = run_id
        self.nodes = [self.scheduler.agents[self.client_ids[org]].node(run_id)
                      for org in self.organizations]
        return run_id

    def _cid(self, org_or_cid: str) -> str:
        return self.client_ids.get(org_or_cid, org_or_cid)

    def run_to_completion(self, max_ticks: int = 10_000,
                          drop_at: Optional[dict] = None,
                          target_loss: Optional[float] = None,
                          on_phase=None) -> str:
        """Drive the scheduler until this consortium's job is terminal.

        ``drop_at`` injects client dropout: ``{org_or_client_id: when}``
        where ``when`` is either an absolute pass index (int) or a
        ``(phase, round)`` tuple — the silo stops serving the run
        (vanishes, no farewell message) the first time the server reports
        that phase at that round (for async jobs, round = commit index).
        E.g. ``{"solarx": ("collect", 1)}`` kills solarx right as round
        1's collect opens, before it can post its update. Tier-aware:
        ``("inner_round", r)`` kills the silo at its *own* inner-round
        boundary for outer round ``r`` — before its device cohort trains
        and before anything is posted (the boundary hook raises
        ``InnerRoundAborted`` inside the silo's tick).

        ``on_phase(run_id, phase)`` observes every server phase report,
        and additionally fires as ``on_phase(run_id, "inner_round")``
        whenever one of this consortium's silos enters an inner round —
        the inner tier has no server phase, so the hook is the only
        uniform way to watch both tiers.

        ``target_loss`` stops early — returns ``"target_reached"`` the
        first pass a committed history entry's ``mean_train_loss`` is at
        or below it. That is the time-to-target probe benchmarks use to
        compare protocols (sync rounds vs async commits) on equal terms.
        """
        from repro_torch.core.client import InnerRoundAborted
        sched, run_id = self.scheduler, self.run_id
        entry = sched.entries[run_id]
        if (entry.state == "suspended"
                and self.server.run.phase != "paused"):
            sched.reactivate(run_id)        # admin resumed a paused run
        specs = {self._cid(k): v for k, v in (drop_at or {}).items()}
        dead = set()
        # the closures below read the driver's current pass through this
        # explicit shared cell — one binding, stated once, instead of the
        # old per-iteration `_t=t` default-argument trick (the late-
        # binding footgun ruff's B023 exists for)
        current = {"pass": 0}

        def drop(cid):
            dead.add(cid)
            sched.drop_client(run_id, cid)

        def is_inner(when):
            return (isinstance(when, (tuple, list))
                    and when[0] == "inner_round")

        def report(rid, phase):
            if rid != run_id:
                return
            run = self.server.run
            for cid, when in specs.items():
                if cid in dead or is_inner(when):
                    continue          # inner specs fire via boundary hooks
                if isinstance(when, int):
                    if current["pass"] >= when:
                        drop(cid)
                elif run is not None and phase == when[0] \
                        and run.round == when[1]:
                    drop(cid)
            if on_phase is not None:
                on_phase(rid, phase)

        def inner_boundary(cid, rnd, stage):
            if stage != "enter":
                return
            if on_phase is not None:
                on_phase(run_id, "inner_round")
            when = specs.get(cid)
            if cid not in dead and is_inner(when) and rnd == when[1]:
                drop(cid)
                raise InnerRoundAborted(
                    f"{cid} dropped at inner-round boundary r{rnd}")

        hooked = [n for n in self.nodes if n.run_id == run_id]
        for node in hooked:
            node.inner_hooks.append(inner_boundary)
        try:
            for t in range(max_ticks):
                current["pass"] = t
                sched.step(on_phase=report)
                if target_loss is not None and any(
                        h.get("mean_train_loss", float("inf"))
                        <= target_loss
                        for h in self.server.run.history):
                    return "target_reached"
                phase = self.server.run.phase
                if phase in ("done", "paused"):
                    return phase
        finally:
            for node in hooked:
                node.inner_hooks.remove(inner_boundary)
        raise RuntimeError("run did not converge within tick budget")
