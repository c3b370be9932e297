"""FL Server (paper §V): FL Manager (Run Manager + coordinators + Model
Aggregator), Model Deployer, Database/Model store, Reporting hooks.

The Run Manager is a thin executor over a *protocol program*
(``repro_torch.core.protocol``): the run's phase sequence — which resources to
publish, which per-client posts to block on, when to aggregate — is
composed from ``Phase`` objects by the job's ``Protocol`` (sync rounds or
FedBuff-style async buffered aggregation). ``tick()`` polls the active
phase one cycle; ``wake_condition()`` is *derived* from the phase's
declared wait-set, so the scheduler's event loop and the phase logic can
never drift apart. The server only ever *publishes* resources and *reads*
resources clients posted — it never invokes client-side operations
(requirement 6). The in-process driver alternates server and client
ticks; a real deployment would run the same state machine behind a REST
service.

Port of ``repro.core.server``. The server runs on an explicit ``device``
(default ``"cuda"``, which raises without CUDA): ``ModelStore`` keeps the
params there, the streaming sinks fold there (K1 for the fp32 secure
plane, K3 for int8, K4 for secure int8), and the outer step runs there.
Params cross into numpy only where they are published on the board. The
reference draws the initial global from ``jax.random``; the port takes it
injected (``initial_params``), or draws from its own seeded generator.

Sync protocol phases:
  waiting_clients -> validating -> round k (distribute -> collect ->
  [repair] -> aggregate -> evaluate) -> [hyperparameter repeat] ->
  deploying -> done
  (or 'paused' on validation failure — paper §VII Data Validation — or when
  dropout shrinks the cohort below ``min_cohort``)

Dropout tolerance (DESIGN.md §Dropout-tolerant rounds): every polling phase
counts its poll cycles; once ``job.round_deadline_ticks`` expires the Run
Manager drops cohort members whose heartbeat went stale (live stragglers
get one extra deadline window) instead of polling forever. A masked round
that loses clients passes through the ``repair`` phase, where survivors
post packed mask corrections that the aggregator folds into the reduction.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.checkpoint import pytree_digest
from repro_torch.convert import params_to_numpy
from repro_torch.core.aggregation import aggregate
from repro_torch.core import telemetry
from repro_torch.core.packing import PackedLayout, unpack_pytree
from repro_torch.core.clients import ClientManagement
from repro_torch.core.communicator import MessageBoard, ServerCommunicator
from repro_torch.core.contribution import (data_size_contribution,
                                     update_norm_contribution)
from repro_torch.core.governance import GovernanceCockpit
from repro_torch.core.jobs import FLJob, JobCreator
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.protocol import (Protocol, WakeCondition,  # noqa: F401
                                 make_protocol)
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import build_model


def _f32_like(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``a`` as an f32 tensor of ``p``'s shape on ``p``'s device."""
    return a.to(p.device, torch.float32).reshape(p.shape)


class ModelStore:
    """Database Manager slice for trained models: digest -> params (+meta)."""

    def __init__(self, metadata: MetadataStore):
        self.metadata = metadata
        self._models: Dict[str, dict] = {}

    def put(self, params, origin: str, details: dict) -> str:
        digest = pytree_digest(params)
        self._models[digest] = {"params": params, "origin": origin,
                                "details": details}
        self.metadata.record_model(digest, origin, details)
        return digest

    def get(self, digest: str):
        return self._models[digest]["params"]

    def list(self) -> List[str]:
        return sorted(self._models)


@dataclass
class RunState:
    run_id: str
    job: FLJob
    # board namespace root every run resource hangs off. The phase
    # machinery (protocol.py) only ever builds paths relative to this,
    # so the round program is tier/namespace-agnostic (DESIGN.md
    # §Hierarchical federation); defaults to the flat "runs/<id>" root.
    ns: str = ""
    phase: str = "waiting_clients"
    round: int = 0
    cohort: List[str] = field(default_factory=list)
    global_digest: Optional[str] = None
    init_digest: Optional[str] = None
    hp_index: int = 0
    history: List[dict] = field(default_factory=list)
    pause_reason: Optional[str] = None
    # --- dropout tolerance ---------------------------------------------
    dropped: List[str] = field(default_factory=list)
    round_cohort: List[str] = field(default_factory=list)  # at distribute
    ticks: int = 0                      # global poll-cycle counter
    phase_ticks: int = 0                # cycles spent in the current phase
    heartbeats: Dict[str, int] = field(default_factory=dict)  # board version
    heartbeat_tick: Dict[str, int] = field(default_factory=dict)
    repair_epoch: int = 0
    round_attempt: int = 0              # bumped on resume: re-run the round
    pending_round: Optional[dict] = None   # stashed collect while repairing
    # --- outer (FedOpt) optimizer — explicit state, reset on hp restart --
    outer: Any = None
    outer_state: Any = None
    # --- protocol-private state (e.g. the async fold buffer) -------------
    proto: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if not self.ns:
            self.ns = f"runs/{self.run_id}"


class FLServer:
    def __init__(self, master_key: bytes, metadata: Optional[MetadataStore]
                 = None, server_id: str = "fl-server", seed: int = 0, *,
                 clients: Optional[ClientManagement] = None,
                 board: Optional[MessageBoard] = None,
                 device=DEFAULT_DEVICE, initial_params=None):
        """Standalone by default; pass shared ``clients``/``board``/
        ``metadata`` to run many FLServer state machines over one silo
        fleet and one message board (the federation scheduler does).

        ``device``: where the model store, the sinks and the outer step
        live. ``initial_params`` (a tree of arrays or tensors) is every
        run's initial global; ``None`` draws it from a generator seeded
        with ``seed``.

        ``is None`` checks, not truthiness: an empty shared MetadataStore
        has ``len() == 0`` and must still be adopted, not replaced."""
        self.device = resolve(device)
        self.metadata = MetadataStore() if metadata is None else metadata
        self.clients = (ClientManagement(self.metadata) if clients is None
                        else clients)
        self.board = (MessageBoard(self.clients, self.metadata)
                      if board is None else board)
        self.comm = ServerCommunicator(self.board, master_key, server_id)
        self.telemetry = self.board.telemetry
        self.job_creator = JobCreator(self.metadata)
        self.store = ModelStore(self.metadata)
        self.cockpit: Optional[GovernanceCockpit] = None
        self.run: Optional[RunState] = None
        self.protocol: Optional[Protocol] = None
        self.pair_secret = master_key + b"/pairwise"
        self.seed = seed
        self.initial_params = initial_params
        self._gen: Optional[torch.Generator] = None
        self._phase_sid = 0            # open span id of the active phase
        self._phase_key = None         # (run_id, phase) that span covers

    # ------------------------------------------------------------------
    # Governance wiring
    # ------------------------------------------------------------------
    def open_negotiation(self, participants: List[str]) -> GovernanceCockpit:
        """SAAM task 8: the admin sets up a negotiation process."""
        self.cockpit = GovernanceCockpit(participants, self.metadata)
        return self.cockpit

    # ------------------------------------------------------------------
    # Run lifecycle
    # ------------------------------------------------------------------
    def start_run(self, job: FLJob, *, run_id: Optional[str] = None,
                  cohort: Optional[List[str]] = None,
                  rotate_tokens: bool = True) -> str:
        """Open a run. ``cohort`` restricts it to a subset of the fleet
        (default: every active client); ``rotate_tokens=False`` keeps
        existing device tokens alive — required when the silos are
        multiplexed across concurrent runs by the federation scheduler
        (a rotation here would cut off their other jobs mid-round)."""
        run_id = run_id or f"run-{uuid.uuid4().hex[:8]}"
        active = self.clients.active_clients()
        cohort = sorted(cohort) if cohort is not None else active
        unknown = [c for c in cohort if c not in active]
        if unknown:
            raise RuntimeError(f"cohort members not active: {unknown}")
        self.protocol = make_protocol(job.protocol)
        self.run = RunState(run_id=run_id, job=job, cohort=list(cohort),
                            phase=self.protocol.initial)
        if not self.run.cohort:
            raise RuntimeError("no active clients in the registry")
        if rotate_tokens:
            self.clients.issue_tokens(run_id)
        else:
            for cid in cohort:
                self.clients.ensure_token(cid)
        self.metadata.record_run_start(run_id, job.to_dict())
        if job.dp_epsilon > 0:
            # the negotiated privacy budget is part of the run's audit
            # trail from the first record: ε/δ/clip, the calibrated
            # per-round noise, and the naive R-fold composition bound
            # (DESIGN.md §Composable privacy)
            from repro_torch.core.compression import dp_sigma_total
            self.metadata.record_provenance(
                actor="run_manager", operation="dp_accounting",
                subject=run_id, outcome="recorded",
                details={"epsilon": job.dp_epsilon,
                         "delta": job.dp_delta, "clip": job.dp_clip,
                         "sigma_round": dp_sigma_total(
                             job.dp_epsilon, job.dp_delta, job.dp_clip),
                         "rounds": job.rounds,
                         "epsilon_total_naive":
                             job.dp_epsilon * job.rounds,
                         "dp_seed": job.dp_seed})
        # initial global model
        params = self._initial_params(job)
        digest = self.store.put(params, "init",
                                {"run_id": run_id, "round": -1})
        self.run.global_digest = digest
        self.run.init_digest = digest
        # publish job + per-client session info (token distribution would be
        # out-of-band in production; modelled via per-client channel here)
        self.comm.publish(f"{self.run.ns}/job", job.to_dict())
        for cid in self.run.cohort:
            self.comm.publish(f"{self.run.ns}/session/{cid}",
                              {"token_issued": True, "run_id": run_id},
                              client_id=cid)
        self.protocol.phase(self.run.phase).enter(self)
        self._note_phase()
        self._publish_status()
        return run_id

    def _note_phase(self):
        """Keep exactly one open trace span per (run, active phase): close
        the previous phase's span on any transition — however it happened
        (poll return, helper-set deadline pause, external ``pause``) — and
        open the next one. Spans therefore measure enter→exit per phase
        *visit*, across however many ticks the phase takes. A ``paused``
        transition also dumps the run's flight-recorder ring as an
        incident. No-op when telemetry is disabled."""
        tel = self.telemetry
        if not tel.enabled or self.run is None:
            return
        r = self.run
        key = (r.run_id, r.phase, r.round, r.hp_index, r.round_attempt)
        if key == self._phase_key:
            return
        tel.close_span(self._phase_sid)
        self._phase_key = key
        if r.phase == "done":
            self._phase_sid = 0        # terminal: nothing left to time
        else:
            self._phase_sid = tel.open_span(
                f"phase:{r.phase}", cat="phase", actor="server",
                run_id=r.run_id,
                attrs={"round": r.round, "hp_index": r.hp_index,
                       "attempt": r.round_attempt})
        if r.phase == "paused":
            tel.record_incident(r.run_id, r.pause_reason or "paused")

    def _initial_params(self, job: FLJob):
        """The injected init on this server's device, or a draw from the
        server's generator (successive runs draw successive inits, as the
        reference splits its key per run)."""
        if self.initial_params is not None:
            return _tree.tree_map(
                lambda a: (a.detach() if isinstance(a, torch.Tensor)
                           else torch.from_numpy(np.array(a))
                           ).to(self.device), self.initial_params)
        model = build_model(self._arch_cfg(job), device=self.device)
        if self._gen is None:
            self._gen = model.generator(self.seed)
        return model.init(self._gen)

    def _arch_cfg(self, job: FLJob):
        from repro_torch.configs import get_config
        cfg = get_config(job.arch)
        return cfg.reduced() if job.reduced else cfg

    def _job_lr(self, job: FLJob) -> float:
        hp = job.hyperparameter_search
        if hp and hp.get("parameter") == "lr":
            return float(hp["values"][self.run.hp_index])
        return job.lr

    def publish_round_global(self, cohort: List[str]):
        """Publish the current round/commit's global model on the round's
        broadcast channel. Single-sourced "who publishes the global":
        both the sync distribute phase and the async commit loop go
        through here, and an inner-tier executor replaces it wholesale
        (the silo hands base params to its devices directly — no board)."""
        r = self.run
        params = self.store.get(r.global_digest)
        self.comm.publish(
            f"{r.ns}/round/{r.hp_index}/{r.round}/global",
            {"digest": r.global_digest,
             "params": params_to_numpy(params),
             "round": r.round, "lr": self._job_lr(r.job),
             "cohort": list(cohort),
             "weight_denom": r.job.local_steps * r.job.batch_size})

    def _publish_status(self):
        r = self.run
        self.comm.publish(f"{r.ns}/status", {
            "phase": r.phase, "round": r.round, "hp_index": r.hp_index,
            "global_digest": r.global_digest,
            "lr": self._job_lr(r.job),
            "pause_reason": r.pause_reason,
            "dropped": list(r.dropped),
            "attempt": r.round_attempt,
        })

    # ------------------------------------------------------------------
    # Protocol executor
    # ------------------------------------------------------------------
    def tick(self) -> str:
        """Advance the run one poll cycle: poll the active phase, apply
        its transition (helper-set transitions — e.g. a deadline pause —
        take precedence over the poll return value), publish status. The
        board's telemetry is in scope (``telemetry.scope``), so the outer
        step records under the run's spans."""
        with telemetry.scope(self.telemetry):
            return self._poll()

    def _poll(self) -> str:
        r = self.run
        if r is None:
            return "idle"
        r.ticks += 1
        self._refresh_heartbeats()
        prev_phase = r.phase
        nxt = self.protocol.phase(r.phase).poll(self)
        if r.phase == prev_phase and nxt is not None:
            r.phase = nxt
        if r.phase != prev_phase:
            r.phase_ticks = 0
            self.protocol.phase(r.phase).enter(self)
        self._note_phase()
        self._publish_status()
        return r.phase

    def wake_condition(self) -> Optional[WakeCondition]:
        """What would make the next ``tick()`` do useful work — derived
        from the active phase's declared wait-set (``Phase.wait_paths`` /
        ``Phase.wake``), never from a parallel table.

        Phases blocked on per-client posts yield the missing board paths
        so an event-driven scheduler only ticks this server when one of
        them lands; phases with immediate work yield ``poll=True``; runs
        with a round deadline ask to be polled every pass (phase_ticks
        must count real poll cycles for the dropout machinery); terminal
        phases yield ``None``: never wake.
        """
        r = self.run
        if r is None:
            return WakeCondition(poll=True)          # ready to start a run
        phase = self.protocol.phase(r.phase)
        if phase.terminal:
            return None
        if r.job.round_deadline_ticks:
            return WakeCondition(poll=True)          # deadlines count polls
        return phase.wake(self)

    # --- liveness / deadline bookkeeping ------------------------------
    def _refresh_heartbeats(self):
        """Track when each cohort member's heartbeat counter last advanced
        (slow vs gone, DESIGN.md §Dropout-tolerant rounds)."""
        r = self.run
        if not r.job.round_deadline_ticks:
            return                       # no deadlines -> no liveness needed
        for cid, version in self.comm.collect_heartbeats(r.run_id,
                                                         r.cohort).items():
            if version != r.heartbeats.get(cid):
                r.heartbeats[cid] = version
                r.heartbeat_tick[cid] = r.ticks

    def _heartbeat_stale(self, cid: str, window: int) -> bool:
        r = self.run
        return r.ticks - r.heartbeat_tick.get(cid, -(10 ** 9)) > window

    def _enforce_deadline(self, missing: List[str], waiting_for: str):
        """Shrink the cohort once a polling phase blows its deadline.

        No-op before ``round_deadline_ticks`` poll cycles (or when the job
        sets no deadline). At the deadline, members whose heartbeat went
        stale are dropped; members that are still heartbeating (slow, not
        gone) get one extra deadline window before the hard deadline drops
        them too. Pauses the run when the cohort falls below
        ``min_cohort``.
        """
        r = self.run
        deadline = r.job.round_deadline_ticks
        if not deadline or r.phase_ticks < deadline:
            return
        hard = r.phase_ticks >= 2 * deadline
        to_drop = [cid for cid in missing
                   if hard or self._heartbeat_stale(cid, deadline)]
        if to_drop:
            self._drop_clients(to_drop, waiting_for)

    def _drop_clients(self, cids: List[str], waiting_for: str):
        r = self.run
        for cid in cids:
            r.cohort.remove(cid)
            r.dropped.append(cid)
            self.metadata.record_provenance(
                actor="run_manager", operation="client_dropped",
                subject=cid, outcome="dropped",
                details={"waiting_for": waiting_for, "round": r.round,
                         "hp_index": r.hp_index,
                         "phase_ticks": r.phase_ticks})
        if len(r.cohort) < r.job.min_cohort:
            r.phase = "paused"
            r.pause_reason = (
                f"cohort shrank to {len(r.cohort)} (< min_cohort "
                f"{r.job.min_cohort}) after dropping {cids} while waiting "
                f"for {waiting_for}")
            self.metadata.record_provenance(
                actor="run_manager", operation="pause_run",
                subject=r.run_id, outcome="paused",
                details={"reason": r.pause_reason,
                         "dropped": list(r.dropped)})

    def _poll_cohort(self, path_for, waiting_for: str, *,
                     on_arrival=None, seen=None, lazy: bool = False):
        """One poll cycle over a per-client resource, with the deadline.

        Probes presence via one batched ``board.stat_many`` sweep (a
        single transport round trip per tick) — posted payloads are NOT
        decrypted while stragglers are outstanding (a masked update is
        tens of MB; decrypting the whole cohort on every poll tick would
        dwarf the actual aggregation). Enforces the phase deadline on the
        missing set. Three completion modes:

        * default — decrypt exactly once, when every *surviving* cohort
          member has posted: returns ``{cid: payload}``, else ``None``
          (still waiting, or the run just paused);
        * ``on_arrival`` — streaming collect (DESIGN.md §Sharded
          streaming aggregation): each *newly posted* payload is
          decrypted once, on the tick it lands, and handed to the
          callback so the phase can fold it into an O(T) accumulator and
          drop it; ``seen`` (caller-persisted set) tracks who was
          surfaced. Returns ``True`` when the surviving cohort is fully
          surfaced, else ``None`` — the payloads were already streamed
          out, there is nothing left to return;
        * ``lazy`` — returns a decrypt-on-access mapping over the
          surviving cohort instead of eagerly materializing every
          payload (the repair fold consumes corrections in bounded
          batches).
        """
        r = self.run
        metas = self.board.stat_many([path_for(cid) for cid in r.cohort])
        missing = [cid for cid in r.cohort if metas[path_for(cid)] is None]
        if on_arrival is not None:
            # posted clients are never dropped (deadlines act on the
            # missing set only), so folding before the deadline check is
            # safe — nothing folded here can leave the cohort this tick
            for cid in list(r.cohort):
                if cid not in seen and metas[path_for(cid)] is not None:
                    on_arrival(cid, self.comm.collect(path_for(cid), cid))
                    seen.add(cid)
        if missing:
            self._enforce_deadline(missing, waiting_for)
            if r.phase == "paused":
                return None
            if any(cid in missing for cid in r.cohort):
                return None              # keep polling live stragglers
        if on_arrival is not None:
            return True                  # payloads already streamed out
        if lazy:
            from repro_torch.core import streaming
            return streaming.LazyCohort(
                self.comm, {cid: path_for(cid) for cid in r.cohort})
        return {cid: self.comm.collect(path_for(cid), cid)
                for cid in r.cohort}

    def _fold_update(self, container, cid: str, payload, weight: float):
        """Route one client's round payload into the round's aggregation
        container the moment it arrives (streaming collect). The packed
        and compressed planes fold into an O(T) streaming sink
        (``core/streaming.py``) and the heavy buffer is dropped; the
        plain pytree plane keeps a dict — median/trimmed-mean need the
        full update set, so it stays on the legacy retained path."""
        from repro_torch.core import streaming
        r = self.run
        job = r.job
        if job.secure_aggregation and job.compression != "none":
            contract = (int(payload["size"]), int(payload["mbits"]),
                        float(payload["grid"]))
            if container is None:
                sink = streaming.ModularSink(
                    contract[0], mbits=contract[1], grid=contract[2],
                    device=self.device, telemetry=self.telemetry,
                    run_id=r.run_id)
                container = streaming.StreamedUpdates(sink, "masked_int")
                container.contract = contract
            elif (payload.get("scheme") != "masked_int8"
                  or contract != container.contract):
                # same loud failure as the stacked reduce_masked
                raise ValueError(
                    "masked updates disagree on the shared coding "
                    "contract (size / mask modulus / quantization grid)")
            container.sink.fold(payload["z"])
            container.note_folded(cid)
            return container
        if job.secure_aggregation:
            if container is None:
                sink = streaming.MaskedF32Sink(
                    int(np.size(payload)), device=self.device,
                    telemetry=self.telemetry, run_id=r.run_id)
                container = streaming.StreamedUpdates(sink, "masked_f32")
            container.sink.fold(payload, 1.0)
            container.note_folded(cid)
            return container
        if job.compression != "none":
            from repro_torch.core.compression import quantized_values
            scheme = payload.get("scheme")
            t = int(payload["size"])
            if container is None:
                sink = (streaming.TopkSink(t, device=self.device)
                        if scheme == "topk"
                        else streaming.QuantSink(
                            t, device=self.device, telemetry=self.telemetry,
                            run_id=r.run_id))
                container = streaming.StreamedUpdates(
                    sink, f"compressed_{scheme}")
            elif container.plane != f"compressed_{scheme}":
                raise ValueError(
                    f"mixed compression schemes in one cohort: "
                    f"{sorted({container.plane.split('_', 1)[1], scheme})}")
            elif t != container.sink.t:
                raise ValueError(
                    "compressed updates disagree on buffer size")
            if scheme == "topk":
                container.sink.fold(cid, payload["idx"], payload["val"],
                                    weight)
            else:
                container.sink.fold(cid, quantized_values(payload),
                                    payload["scales"], weight)
            container.note_folded(cid)
            return container
        container = container if container is not None else {}
        container[cid] = payload
        return container

    # --- Model Aggregator ---------------------------------------------
    def _aggregate_and_advance(self, updates, sizes, losses,
                               corrections=None):
        from repro_torch.core import streaming
        r = self.run
        job = r.job
        cids = sorted(updates)
        streamed = isinstance(updates, streaming.StreamedUpdates)
        old_params = self.store.get(r.global_digest)
        if job.secure_aggregation and job.compression != "none":
            # masked-quantized plane (DESIGN.md §Composable privacy): the
            # cohort posted integer residue streams mod 2**mbits. The
            # modular sum (streamed into a (T,) uint32 accumulator —
            # uint32 wrap preserves residues, so the fold order is
            # irrelevant and the result is bit-exact vs the stacked
            # reduce; dropout corrections subtracted mod M) cancels the
            # pairwise masks, the centered residue is scaled by the
            # cohort-common grid and — like the fp32 masked plane —
            # divided by the survivors' total pre-scaled weight: exact
            # weighted FedAvg over base + mean delta.
            layout = PackedLayout.for_tree(old_params)
            denom = float(sum(sizes[c] for c in cids)) / float(
                job.local_steps * job.batch_size)
            with self.telemetry.kernel_span(
                    "masked_dequant_reduce", run_id=r.run_id,
                    device=self.device, scheme="secure+compressed",
                    cohort=str(len(cids))):
                if streamed:
                    if (corrections is not None and corrections
                            is not streaming.CORRECTIONS_FOLDED):
                        for c in cids:
                            updates.sink.fold_correction(corrections[c])
                    total = updates.sink.finalize()
                else:
                    corr = ((corrections[c] for c in cids)
                            if corrections is not None else None)
                    total = streaming.stream_reduce_masked(
                        (updates[c] for c in cids), corrections=corr,
                        device=self.device, telemetry=self.telemetry,
                        run_id=r.run_id)
            mean_delta = unpack_pytree(total / np.float32(denom), layout)
            new_global = _tree.tree_map(
                lambda p, dlt: p.to(torch.float32) + _f32_like(dlt, p),
                old_params, mean_delta)
        elif job.secure_aggregation:
            # packed data plane: masked (T,) buffers folded into a (T,)
            # f32 accumulator as they arrived (dropout corrections fold
            # as negative-weight rows after a repair round), then a
            # single unpack into the parameter structure. Clients
            # pre-scale by n_examples/weight_denom before masking, so the
            # uniform sum divided by the survivors' total scaled weight
            # is exact weighted FedAvg (masks only telescope under equal
            # weights).
            layout = PackedLayout.for_tree(old_params)
            denom = float(sum(sizes[c] for c in cids)) / float(
                job.local_steps * job.batch_size)
            with self.telemetry.kernel_span(
                    "masked_sum", run_id=r.run_id, device=self.device,
                    scheme="secure", cohort=str(len(cids))):
                if streamed:
                    if (corrections is not None and corrections
                            is not streaming.CORRECTIONS_FOLDED):
                        for c in cids:
                            updates.sink.fold_correction(corrections[c])
                    total = updates.sink.finalize()
                else:
                    corr = ((corrections[c] for c in cids)
                            if corrections is not None else None)
                    total = streaming.stream_masked_packed(
                        (updates[c] for c in cids),
                        np.ones(len(cids), np.float32), corrections=corr,
                        device=self.device, telemetry=self.telemetry,
                        run_id=r.run_id)
            new_global = unpack_pytree(total / denom, layout)
        elif job.compression != "none":
            # compressed data plane: clients posted lossy-coded packed
            # *deltas* (wire dicts), folded through the fused
            # dequantize-scale-accumulate kernel in bounded batches with
            # raw example counts as weights (weighted scatter-add for
            # topk); dividing the accumulated sum by the total weight at
            # the end is the same weighted FedAvg — normalization
            # commutes with the sum.
            layout = PackedLayout.for_tree(old_params)
            with self.telemetry.kernel_span(
                    "dequant_reduce", run_id=r.run_id, device=self.device,
                    scheme="compressed", cohort=str(len(cids))):
                if streamed:
                    sink = updates.sink
                    tw = sink.total_weight or 1.0
                    total = sink.finalize() / np.float32(tw)
                    comp_norms = {c: sink.norms[c] for c in cids}
                else:
                    w = np.asarray([sizes[c] for c in cids], np.float64)
                    w = (w / w.sum()).astype(np.float32)
                    total, delta_norms = streaming.stream_reduce_compressed(
                        (updates[c] for c in cids), w, return_norms=True,
                        device=self.device, telemetry=self.telemetry,
                        run_id=r.run_id)
                    comp_norms = dict(zip(cids, delta_norms))
            mean_delta = unpack_pytree(total, layout)
            new_global = _tree.tree_map(
                lambda p, d: p.to(torch.float32) + _f32_like(d, p),
                old_params, mean_delta)
        else:
            # plain pytree plane: median / trimmed-mean need the full
            # update set, so this is the one plane that retains the
            # cohort's updates (collect keeps a dict here, never a sink)
            ups = [updates[c] for c in cids]
            weights = ([sizes[c] for c in cids]
                       if job.aggregation == "fedavg" else None)
            new_global = aggregate(job.aggregation, ups, weights,
                                   device=self.device)
        # outer (server) optimizer step — FedOpt family; explicit RunState
        # fields so hyperparameter restarts can reset momentum
        from repro_torch.optim import OUTER_REGISTRY
        if r.outer is None:
            r.outer = OUTER_REGISTRY[job.outer_optimizer]()
            r.outer_state = r.outer.init(old_params)
        new_global = _tree.tree_map(_f32_like, new_global, old_params)
        new_params, r.outer_state = r.outer.step(
            old_params, new_global, r.outer_state)
        digest = self.store.put(new_params, "aggregate", {
            "run_id": r.run_id, "round": r.round, "hp_index": r.hp_index,
            "aggregation": job.aggregation,
            "secure": job.secure_aggregation,
            "cohort": cids, "repaired": corrections is not None})
        # contribution measurement (Evaluation Coordinator). Weighted
        # FedAvg commits w_i * delta_i, so the norm measure is weighted by
        # the same n_examples the aggregate used — an unweighted norm
        # would score a counterfactual the server never committed.
        contrib = data_size_contribution(sizes)
        if job.secure_aggregation:
            contrib_norm = {}            # server never sees plain updates
            # (masked-quantized rounds included: residue streams carry
            # no recoverable per-client norm — contribution.py refuses
            # them loudly rather than scoring masked noise)
        elif job.compression != "none":
            # per-client delta norms fell out of the reduction pass above
            raw = {c: comp_norms[c] * sizes[c] for c in cids}
            total_norm = sum(raw.values()) or 1.0
            contrib_norm = {c: n / total_norm for c, n in raw.items()}
        else:
            contrib_norm = update_norm_contribution(
                updates, old_params,
                weights=sizes if job.aggregation == "fedavg" else None)
        metrics = {"mean_train_loss": float(np.mean(list(losses.values()))),
                   "train_losses": {k: float(v) for k, v in losses.items()}}
        self.metadata.record_round(r.run_id, r.round, metrics, digest,
                                   {"data_size": contrib,
                                    "update_norm": contrib_norm})
        r.history.append({"round": r.round, "hp_index": r.hp_index,
                          **metrics, "digest": digest})
        r.global_digest = digest
        if job.gc_round_resources:
            # the round's updates (and any repair corrections) are spent
            # the moment the aggregate is committed — they are the bulk of
            # the board's bytes, so free them immediately
            base = f"{r.ns}/round/{r.hp_index}/{r.round}"
            for pattern in (f"{base}/update/*", f"{base}/repair/*"):
                for path in self.board.list(pattern):
                    self.board.delete(path)
        r.phase = "evaluate"

    # ------------------------------------------------------------------
    # Admin operations (Governance & Management Website backend)
    # ------------------------------------------------------------------
    def admin_force_deploy(self, admin: str, digest: str):
        """SAAM tasks 4/18: deploy a specific (possibly historic) model."""
        if self.run is None:
            raise RuntimeError("no run")
        params = self.store.get(digest)
        self.comm.publish(f"{self.run.ns}/release",
                          {"digest": digest, "forced_by": admin})
        self.comm.publish(f"{self.run.ns}/release/params",
                          {"digest": digest,
                           "params": params_to_numpy(params)})
        self.metadata.record_provenance(
            actor=admin, operation="force_deploy", subject=digest,
            outcome="published")

    def pause(self, actor: str, reason: str):
        """Externally pause a live run (scheduler preemption, operator
        intervention). The run lands in the same ``paused`` state the
        dropout/validation machinery uses, so ``admin_resume`` restores it
        with the usual protocol-specific semantics — a preempted masked
        round is re-collected against the surviving cohort, never resumed
        from stale updates."""
        r = self.run
        if r is None or r.phase in ("done", "paused"):
            return
        r.phase = "paused"
        r.pause_reason = reason
        self.metadata.record_provenance(
            actor=actor, operation="pause_run", subject=r.run_id,
            outcome="paused", details={"reason": reason})
        self._note_phase()
        self._publish_status()

    def admin_resume(self, admin: str):
        """Resume a paused run. The re-entry point and its bookkeeping are
        the protocol's call (``Protocol.resume``): the sync protocol
        re-runs the interrupted round (attempt bump + board wipe) or
        continues into evaluate when the aggregate was already committed;
        the async protocol just resumes serving its buffer."""
        if self.run and self.run.phase == "paused":
            r = self.run
            r.pause_reason = None
            r.phase_ticks = 0
            r.phase = self.protocol.resume(self)
            self.protocol.phase(r.phase).enter(self)
            self.metadata.record_provenance(
                actor=admin, operation="resume_run",
                subject=r.run_id, outcome="resumed",
                details={"round_attempt": r.round_attempt,
                         "resumed_into": r.phase,
                         "cohort": list(r.cohort)})
            self._note_phase()
            self._publish_status()

    def monitor(self) -> dict:
        """SAAM task 24: monitoring snapshot of the FL process."""
        r = self.run
        return {
            "phase": r.phase if r else "idle",
            "round": r.round if r else None,
            "protocol": self.protocol.name if self.protocol else None,
            "dropped_clients": list(r.dropped) if r else [],
            # board.stats is a property assembled fresh from the metrics
            # registry — already a detached snapshot, no copy needed
            "board": self.board.stats,
            "registered_clients": self.clients.active_clients(),
            "models_stored": len(self.store.list()),
            "metadata_records": len(self.metadata),
        }
