"""Federation scheduler: concurrent multi-job runtime over a shared fleet.

FL-APU's scenario is many companies collaborating through one FL server —
but real cross-silo deployments run many *collaborations* concurrently:
hyperparameter trials, per-region model variants, staggered contract start
dates. The ``FederationScheduler`` is that runtime (DESIGN.md §Federation
scheduler):

* **Shared substrate** — one ``MetadataStore`` (single provenance chain
  covering every scheduling decision), one ``ClientManagement`` registry,
  one ``MessageBoard``. Every run's resources live under its own
  ``runs/<run_id>/...`` namespace, so jobs never collide on the board.
* **Admission queue** — governance contracts arrive as ``FLJob``s with a
  ``priority``; the queue orders by (priority desc, submission FIFO) and
  admits a job only when every silo in its cohort has a free capacity
  slot (a silo declares how many concurrent local trainings it can run).
  Backfill is allowed — a small job may overtake a blocked big one — but
  once the blocked job has waited ``patience`` passes the queue reserves
  capacity for it (no further backfill), so nothing starves.
* **Event-driven loop** — each admitted job is one ``FLServer`` state
  machine. After every tick the server reports a ``WakeCondition``
  *derived from its active protocol phase's declared wait-set*
  (``repro_torch.core.protocol``: board paths it waits for, or "poll me"); the
  loop compares the board's mutation counter against the snapshot and
  *skips* servers with nothing to do instead of blindly round-robin
  ticking them. Deletions leave per-path tombstone seqs on the board, so
  a wake snapshot taken before a round GC can still observe the change.
  ``stats`` counts the skipped idle ticks — ``bench_multi_job`` turns
  that into the proof.
* **Provenance** — every submit/admit/preempt/suspend/complete decision is
  a record on the shared hash chain, queryable via ``metadata.query``.

Dropout semantics hold per job independently: each FLServer runs its
own deadlines, cohort shrinking and mask repair against its own round
namespace.

Port of ``repro.core.scheduler``; the scheduler carries a ``device``
(default ``"cuda"``) down to every server and client agent it builds.
"""
from __future__ import annotations

import secrets
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.client import ClientAgent, ClientConfig
from repro_torch.core.clients import ClientManagement
from repro_torch.core.communicator import (ClientCommunicator, MessageBoard,
                                     ServerCommunicator)
from repro_torch.core.jobs import FLJob
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.protocol import WakeCondition
from repro_torch.core.server import FLServer
from repro_torch.device import DEFAULT_DEVICE, resolve


@dataclass
class JobEntry:
    """One submitted job and its scheduling state."""
    run_id: str
    server: FLServer
    job: FLJob
    cohort: List[str]
    priority: int = 0
    seq: int = 0                       # submission order (FIFO tiebreak)
    state: str = "queued"          # queued|running|suspended|done|failed
    datasets: Dict[str, object] = field(default_factory=dict)
    client_config: Optional[ClientConfig] = None
    queued_passes: int = 0             # aged for the fairness reservation
    wake: Optional[WakeCondition] = None
    wake_seq: int = 0                  # board.seq snapshot at last tick
    ticks: int = 0
    idle_skips: int = 0


class FederationScheduler:
    """Advance many FL runs over one silo fleet in one cooperative loop."""

    def __init__(self, master_key: Optional[bytes] = None, *,
                 metadata: Optional[MetadataStore] = None,
                 clients: Optional[ClientManagement] = None,
                 board: Optional[MessageBoard] = None,
                 transport=None, wan=None, telemetry=None,
                 event_driven: bool = True, patience: int = 32,
                 preemptive: bool = False, server_id: str = "fl-server",
                 device=DEFAULT_DEVICE):
        self.device = resolve(device)
        self.master_key = master_key or secrets.token_bytes(32)
        # `is None`, not truthiness: an empty MetadataStore is falsy
        self.metadata = MetadataStore() if metadata is None else metadata
        self.clients = (ClientManagement(self.metadata) if clients is None
                        else clients)
        # transport/wan: storage backend + WAN cost model for the board
        # this scheduler builds; ignored when a prebuilt board is passed
        # (telemetry likewise — the board anchors the shared bundle)
        self.board = (MessageBoard(self.clients, self.metadata,
                                   transport=transport, wan=wan,
                                   telemetry=telemetry)
                      if board is None else board)
        self.telemetry = self.board.telemetry
        self.comm = ServerCommunicator(self.board, self.master_key, server_id)
        self.pair_secret = self.master_key + b"/pairwise"
        self.event_driven = event_driven
        self.patience = patience
        self.preemptive = preemptive
        self.agents: Dict[str, ClientAgent] = {}
        self.capacity: Dict[str, int] = {}
        self.leases: Dict[str, Set[str]] = {}      # cid -> run_ids holding
        self.queue: List[JobEntry] = []            # a slot on that silo
        self.running: List[JobEntry] = []
        self.entries: Dict[str, JobEntry] = {}
        self.passes = 0
        self._seq = 0
        self._last_progress = 0       # pass of the last admit/complete
        reg = self.telemetry.metrics
        self._c = {k: reg.counter(f"sched.{k}")
                   for k in ("passes", "server_ticks", "idle_skips",
                             "admitted", "preempted", "completed",
                             "suspended")}

    @property
    def stats(self) -> dict:
        """Scheduling counters (legacy dict shape), assembled fresh from
        the metrics registry — a caller's snapshot never mutates under
        later passes."""
        return {k: c.read() for k, c in self._c.items()}

    # ------------------------------------------------------------------
    # Fleet setup
    # ------------------------------------------------------------------
    def new_server(self, *, seed: int = 0, server_id: str = "fl-server",
                   initial_params=None) -> FLServer:
        """An FLServer state machine bound to the shared substrate, on the
        scheduler's device; ``initial_params`` is its injected init."""
        return FLServer(self.master_key, metadata=self.metadata,
                        server_id=server_id, seed=seed,
                        clients=self.clients, board=self.board,
                        device=self.device, initial_params=initial_params)

    def register_agent(self, client_id: str, dataset, *, capacity: int = 1,
                       config: Optional[ClientConfig] = None,
                       tick_every: int = 1) -> ClientAgent:
        """Bring a registered+approved silo into the schedulable fleet."""
        token = self.clients.ensure_token(client_id)
        comm = ClientCommunicator(
            self.board, client_id, token,
            channel_key=self.comm.channel_key(client_id),
            broadcast_key=self.comm.broadcast_key(),
            ca_key=self.master_key)
        agent = ClientAgent(client_id, comm, dataset, capacity=capacity,
                            config=config, tick_every=tick_every,
                            device=self.device)
        self.agents[client_id] = agent
        self.capacity[client_id] = int(capacity)
        self.leases.setdefault(client_id, set())
        self.metadata.record_provenance(
            actor="scheduler", operation="register_agent", subject=client_id,
            outcome="registered", details={"capacity": int(capacity),
                                           "tick_every": int(tick_every)})
        return agent

    def bootstrap_silo(self, org: str, dataset, *, capacity: int = 1,
                       config: Optional[ClientConfig] = None,
                       tick_every: int = 1) -> str:
        """Convenience: user account -> registration -> approval -> agent,
        in one call. Returns the client id."""
        user = f"{org}-participant"
        if user not in self.clients.users:
            self.clients.create_user("scheduler", user, org, f"pw-{org}")
        cid = self.clients.request_registration(user, org)
        self.clients.approve_client("scheduler", cid)
        self.register_agent(cid, dataset, capacity=capacity, config=config,
                            tick_every=tick_every)
        return cid

    def _free(self, client_id: str) -> int:
        return self.capacity.get(client_id, 0) - len(
            self.leases.get(client_id, ()))

    # ------------------------------------------------------------------
    # Job intake + admission
    # ------------------------------------------------------------------
    def submit(self, job: FLJob, *, server: Optional[FLServer] = None,
               cohort: Optional[List[str]] = None,
               priority: Optional[int] = None,
               datasets: Optional[Dict[str, object]] = None,
               client_config: Optional[ClientConfig] = None) -> str:
        """Queue a job for admission. Returns its pre-allocated run id.

        ``cohort`` defaults to the whole registered fleet; ``datasets``
        optionally overrides a silo's default dataset for this job (twin
        runs and per-contract data splits need that determinism).
        """
        cohort = sorted(cohort) if cohort is not None else sorted(self.agents)
        unknown = [c for c in cohort if c not in self.agents]
        if unknown:
            raise ValueError(f"no registered agent for silos: {unknown}")
        if not cohort:
            raise ValueError("cannot submit a job with an empty cohort")
        over = [c for c in cohort if self.capacity[c] < 1]
        if over:
            raise ValueError(f"silos with zero capacity: {over}")
        if server is not None:
            live = [e.run_id for e in self.entries.values()
                    if e.server is server
                    and e.state not in ("done", "failed")]
            if live:
                raise ValueError(
                    f"server already bound to live job(s) {live}; an "
                    f"FLServer drives one run at a time — pass a new one "
                    f"(scheduler.new_server) or let the old job finish")
        entry = JobEntry(
            run_id=f"run-{uuid.uuid4().hex[:8]}",
            server=server or self.new_server(seed=self._seq),
            job=job, cohort=list(cohort),
            priority=job.priority if priority is None else int(priority),
            seq=self._seq, datasets=dict(datasets or {}),
            client_config=client_config)
        self._seq += 1
        self.entries[entry.run_id] = entry
        self.queue.append(entry)
        self.metadata.record_provenance(
            actor="scheduler", operation="submit_job", subject=entry.run_id,
            outcome="queued", details={"job": job.job_id, "cohort": cohort,
                                       "priority": entry.priority})
        self._admit()
        return entry.run_id

    def _required_cohort(self, entry: JobEntry) -> List[str]:
        """The silos this entry needs slots on: the server's *surviving*
        cohort once its run exists (dropout may have shrunk it — a
        re-admitted run must not demand slots on silos it lost), the
        submitted cohort before that."""
        run = entry.server.run
        if run is not None and run.run_id == entry.run_id:
            return list(run.cohort)
        return entry.cohort

    def _admit(self):
        """Admit every queued job whose cohort has free slots everywhere.

        Scan order is (priority desc, FIFO). A blocked job does not stop
        younger jobs from backfilling — until it has waited ``patience``
        passes, at which point the scan stops at it: capacity drains to
        the aged job and nothing behind it can overtake. This bounds
        queue wait for every job (no starvation) while keeping silos busy.
        """
        self.queue.sort(key=lambda e: (-e.priority, e.seq))
        for entry in list(self.queue):
            if all(self._free(cid) > 0
                   for cid in self._required_cohort(entry)):
                self._start(entry)
            elif entry.queued_passes >= self.patience:
                break                       # reservation: no more backfill
        # strictly-higher-priority work may preempt lower-priority runs.
        # The aged head-of-line reservation applies here too: once the
        # scan hits a job that aged past patience and still cannot admit
        # (its blockers are not preemptable), nothing younger may keep
        # consuming slots via preemption — otherwise a stream of younger
        # preemptors starves the aged job indefinitely.
        if self.preemptive:
            for entry in list(self.queue):
                admitted = False
                if self._maybe_preempt(entry) and all(
                        self._free(cid) > 0
                        for cid in self._required_cohort(entry)):
                    self._start(entry)
                    admitted = True
                if not admitted and entry.queued_passes >= self.patience:
                    break               # reservation: no more preemption

    def _maybe_preempt(self, entry: JobEntry) -> bool:
        """Suspend strictly-lower-priority running jobs that hold slots
        ``entry`` needs. Returns True if anything was preempted.

        Preemption only fires when EVERY blocked slot is recoverable from
        strictly-lower-priority victims — preempting while some slot is
        pinned by an equal/higher-priority peer would suspend victims
        without ever admitting ``entry`` (and the next pass would backfill
        and preempt them again: a pause/resume livelock that re-runs the
        victims' interrupted rounds forever and admits nobody).
        """
        need = self._required_cohort(entry)
        blocked = [cid for cid in need if self._free(cid) < 1]
        if not blocked:
            return False
        victims = sorted((e for e in self.running
                          if e.priority < entry.priority),
                         key=lambda e: (e.priority, -e.seq))

        def holds(victim, cid):
            # the lease set is the accounting truth — a victim's admission
            # cohort may still name silos it lost to dropout
            return victim.run_id in self.leases.get(cid, ())

        for cid in blocked:
            recoverable = sum(1 for v in victims if holds(v, cid))
            if self._free(cid) + recoverable < 1:
                return False            # a peer pins this slot: no point
        preempted = False
        for victim in victims:
            if not any(holds(victim, cid) for cid in blocked):
                continue
            self.preempt(victim.run_id,
                         reason=f"higher-priority job {entry.run_id} "
                                f"(priority {entry.priority}) waiting")
            preempted = True
            blocked = [cid for cid in need if self._free(cid) < 1]
            if not blocked:
                break
        return preempted

    def _start(self, entry: JobEntry):
        # "fresh" = this entry's run does not exist on its server yet. A
        # server whose *previous* run is terminal counts as fresh too:
        # start_run replaces it (sequential runs on one server, e.g. a
        # Consortium started twice).
        run = entry.server.run
        fresh = run is None or run.run_id != entry.run_id
        cohort = self._required_cohort(entry)
        self.queue.remove(entry)
        tel = self.telemetry
        sid = (tel.open_span("sched.admit" if fresh else "sched.readmit",
                             cat="scheduler", actor="scheduler",
                             run_id=entry.run_id,
                             attrs={"cohort": len(cohort),
                                    "priority": entry.priority})
               if tel.enabled else 0)
        try:
            if fresh:
                entry.server.start_run(entry.job, run_id=entry.run_id,
                                       cohort=cohort, rotate_tokens=False)
            elif entry.server.run.phase == "paused":
                # resuming a preempted/suspended run: the server machinery
                # re-runs the interrupted round against the surviving cohort
                entry.server.admin_resume("scheduler")
            for cid in cohort:
                self.leases[cid].add(entry.run_id)
            for cid in cohort:
                self.agents[cid].attach(
                    entry.run_id, cohort, self.pair_secret,
                    dataset=entry.datasets.get(cid),
                    config=entry.client_config)
        except Exception as exc:
            # leave nothing half-admitted: release whatever was granted,
            # park the job as failed (inspectable, never silently lost),
            # and keep the loop alive for every other job
            for cid in cohort:
                self.leases[cid].discard(entry.run_id)
                if cid in self.agents:
                    self.agents[cid].release(entry.run_id)
            entry.state = "failed"
            self.metadata.record_provenance(
                actor="scheduler", operation="admit_job",
                subject=entry.run_id, outcome="failed",
                details={"error": str(exc), "cohort": cohort})
            tel.close_span(sid, outcome="failed", error=str(exc))
            if tel.enabled:
                # flight-recorder dump: the spans leading up to the
                # failed admission, frozen for post-mortem inspection
                tel.record_incident(entry.run_id,
                                    f"admission failed: {exc}")
            return
        waited, entry.queued_passes = entry.queued_passes, 0
        entry.cohort = cohort
        entry.state = "running"
        self._last_progress = self.passes
        entry.wake = WakeCondition(poll=True)
        entry.wake_seq = 0
        self.running.append(entry)
        self._c["admitted"].inc()
        tel.close_span(sid, outcome="admitted", waited_passes=waited)
        self.metadata.record_provenance(
            actor="scheduler",
            operation="admit_job" if fresh else "readmit_job",
            subject=entry.run_id, outcome="admitted",
            details={"cohort": cohort, "priority": entry.priority,
                     "waited_passes": waited,
                     "leases": {c: len(self.leases[c]) for c in cohort}})

    # ------------------------------------------------------------------
    # Event loop
    # ------------------------------------------------------------------
    def _runnable(self, entry: JobEntry) -> bool:
        if not self.event_driven:
            return True
        w = entry.wake
        if w is None:
            return False                    # terminal; reaped this pass
        if w.poll:
            return True
        return self.board.latest_seq(w.paths) > entry.wake_seq

    def step(self, on_phase: Optional[Callable[[str, str], None]] = None):
        """One scheduler pass: admit, tick runnable servers, tick agents,
        reap. ``on_phase(run_id, phase)`` fires for every running job
        right after its server had the chance to tick — drivers use it to
        inject faults (dropout) or observe progress at exact phase
        boundaries."""
        self.passes += 1
        self._c["passes"].inc()
        tel = self.telemetry
        pass_sid = (tel.open_span("sched.pass", cat="scheduler",
                                  actor="scheduler",
                                  attrs={"pass": self.passes})
                    if tel.enabled else 0)
        for entry in self.queue:
            entry.queued_passes += 1
        self._admit()
        for entry in list(self.running):
            if self._runnable(entry):
                snapshot = self.board.seq
                if tel.enabled:
                    with tel.span("sched.tick", cat="scheduler",
                                  actor="scheduler", run_id=entry.run_id):
                        entry.server.tick()
                else:
                    entry.server.tick()
                entry.ticks += 1
                self._c["server_ticks"].inc()
                entry.wake = entry.server.wake_condition()
                entry.wake_seq = snapshot
            else:
                entry.idle_skips += 1
                self._c["idle_skips"].inc()
            if on_phase is not None:
                run = entry.server.run
                on_phase(entry.run_id, run.phase if run else "idle")
        for cid in sorted(self.agents):
            self.agents[cid].tick(self.passes)
        self._reap()
        tel.close_span(pass_sid, running=len(self.running),
                       queued=len(self.queue))

    def _reap(self):
        for entry in list(self.running):
            phase = entry.server.run.phase
            if phase not in ("done", "paused"):
                self._release_lost_silos(entry)
                continue
            self._last_progress = self.passes
            self.running.remove(entry)
            for cid in entry.cohort:
                self.leases[cid].discard(entry.run_id)
                self.agents[cid].release(entry.run_id)
            if phase == "done":
                entry.state = "done"
                self._c["completed"].inc()
                self.metadata.record_provenance(
                    actor="scheduler", operation="complete_job",
                    subject=entry.run_id, outcome="completed",
                    details={"ticks": entry.ticks,
                             "idle_skips": entry.idle_skips})
            else:
                entry.state = "suspended"
                self._c["suspended"].inc()
                self.metadata.record_provenance(
                    actor="scheduler", operation="suspend_job",
                    subject=entry.run_id, outcome="suspended",
                    details={"reason": entry.server.run.pause_reason})
                # (incident dump happens server-side at the pause itself —
                # FLServer._note_phase — so reap does not double-record)
        # freed capacity is re-leased at the next pass's _admit — keeping
        # admission at the pass boundary preserves the loop invariant that
        # every admitted job is ticked on every pass it spends runnable

    def _release_lost_silos(self, entry: JobEntry):
        """A silo the server dropped from a live run (deadline dropout)
        serves that run no longer: free its capacity slot and its agent
        attachment, or the shrunk run would pin fleet capacity — and
        block new admissions onto the silo — for its whole remaining
        lifetime."""
        survivors = entry.server.run.cohort
        for cid in entry.cohort:
            if cid in survivors or entry.run_id not in self.leases.get(
                    cid, ()):
                continue
            self.leases[cid].discard(entry.run_id)
            self.agents[cid].release(entry.run_id)
            self.metadata.record_provenance(
                actor="scheduler", operation="release_silo", subject=cid,
                outcome="released",
                details={"run_id": entry.run_id, "reason": "dropped"})

    def run(self, *, max_passes: int = 10_000,
            on_phase: Optional[Callable[[str, str], None]] = None,
            stop_when: Optional[Callable[[], bool]] = None) -> int:
        """Drive the loop until every job is done/suspended (or
        ``stop_when`` fires). Returns the total pass count."""
        for _ in range(max_passes):
            self.step(on_phase=on_phase)
            if stop_when is not None and stop_when():
                return self.passes
            if not self.running and not self.queue:
                return self.passes
            if not self.running and self.queue and (
                    self.passes - self._last_progress > self.patience + 2):
                raise RuntimeError(
                    "admission deadlock: queued jobs "
                    f"{[e.run_id for e in self.queue]} can never fit the "
                    f"fleet capacity {self.capacity}")
        raise RuntimeError(f"scheduler did not drain in {max_passes} passes")

    # ------------------------------------------------------------------
    # Admin operations
    # ------------------------------------------------------------------
    def preempt(self, run_id: str, reason: str = ""):
        """Suspend a running job and requeue it (slots free immediately;
        the job re-admits by priority/FIFO like any queued work)."""
        entry = self.entries[run_id]
        if entry.state != "running":
            return
        tel = self.telemetry
        sid = (tel.open_span("sched.preempt", cat="scheduler",
                             actor="scheduler", run_id=run_id,
                             attrs={"reason": reason})
               if tel.enabled else 0)
        entry.server.pause("scheduler", f"preempted: {reason}")
        self.running.remove(entry)
        for cid in entry.cohort:
            self.leases[cid].discard(run_id)
            self.agents[cid].release(run_id)
        entry.state = "queued"
        entry.queued_passes = 0
        self.queue.append(entry)
        self._c["preempted"].inc()
        tel.close_span(sid)
        self.metadata.record_provenance(
            actor="scheduler", operation="preempt_job", subject=run_id,
            outcome="requeued", details={"reason": reason})

    def reactivate(self, run_id: str):
        """Requeue a suspended job (after ``admin_resume`` or to retry a
        preempted one); admission re-leases its surviving cohort."""
        entry = self.entries[run_id]
        if entry.state != "suspended":
            return
        entry.state = "queued"
        entry.queued_passes = 0
        self.queue.append(entry)
        self.metadata.record_provenance(
            actor="scheduler", operation="reactivate_job", subject=run_id,
            outcome="queued", details={})
        self._admit()

    def drop_client(self, run_id: str, client_id: str):
        """Fault injection / operator removal: the silo stops serving the
        run (vanishes, no farewell). The per-job dropout machinery —
        deadlines, cohort shrink, mask repair — takes it from there."""
        agent = self.agents.get(client_id)
        if agent is not None:
            agent.release(run_id)

    def monitor(self) -> dict:
        """Fleet-level snapshot (complements FLServer.monitor per run).

        Every value is freshly built plain data — nothing shares live
        mutable references with the scheduler, so the snapshot a caller
        holds cannot change under later passes (regression-tested in
        tests/test_telemetry.py)."""
        return {
            "passes": self.passes,
            "queued": [e.run_id for e in self.queue],
            "running": {e.run_id: e.server.run.phase for e in self.running},
            "leases": {cid: sorted(runs)
                       for cid, runs in self.leases.items() if runs},
            "capacity": dict(self.capacity),
            "stats": self.stats,       # property: assembled fresh per read
        }
