"""Protocol programs: composable round protocols for the FL server.

Port of ``repro.core.protocol``. The server is a *sequence of interaction
phases* with the silos (paper §VI–§VIII):

* a ``Phase`` is one interaction step — ``enter()`` runs once on
  transition into the phase, ``poll()`` runs once per server tick and
  returns the next phase name (or ``None`` to keep waiting), and
  ``wait_paths()`` *declares* the board resources the phase blocks on, so
  the executor derives ``FLServer.wake_condition()`` from it;
* a ``Protocol`` composes named phases into a program and owns the
  protocol-specific resume semantics (``resume()``);
* ``FLServer`` is a thin executor: ``tick()`` polls the active phase,
  applies the transition, publishes status.

Three programs are ported:

``SyncProtocol`` — waiting_clients → validating → distribute → collect →
[repair] → evaluate → (next round / hp restart) → deploying → done, with
the dropout-deadline and mask-repair machinery. The collect folds each
arrival into a streaming sink on the server's device (K1 for the fp32
secure plane) and the repair folds each correction into the same sink as
a weight -1 row.

``AsyncBuffProtocol`` — FedBuff-style buffered asynchronous aggregation
(Nguyen et al., *Federated Learning with Buffered Asynchronous
Aggregation*): clients train continuously against the latest committed
global and post packed *delta* buffers tagged with the commit they
trained from; the server folds each fresh delta into a (T,) f32 buffer on
its device, discounted by staleness (``staleness_weight``), and commits a
new global every ``job.async_buffer_size`` folds. The fold is plain
PyTorch, as the reference's is numpy: no kernel. Masks cannot telescope
across asynchronous folds, so job creation rejects
``secure_aggregation=True`` for this protocol (jobs.py).

``IntraSiloProtocol`` — the same phase machinery run as a silo's *inner*
round engine over a sampled device cohort (DESIGN.md §Hierarchical
federation); its executor is ``core.client.InnerRoundEngine``, whose
fold goes through ``MaskedF32Sink`` and so K1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.convert import params_to_numpy
from repro_torch.core.packing import (PackedLayout, as_f32, pack_pytree,
                                      unpack_pytree)
from repro_torch.core.validation import DataSchema, validate_stats


@dataclass(frozen=True)
class WakeCondition:
    """What a run is waiting for (DESIGN.md §Federation scheduler).

    ``paths``: board resources whose appearance/overwrite should wake the
    run — the scheduler compares their mutation counters against a
    snapshot instead of blindly ticking. ``poll=True``: the run has work
    to do (or deadlines to count) on every scheduler pass. A terminal run
    returns ``None`` — never wake again.
    """
    paths: tuple = ()
    poll: bool = False


class Phase:
    """One interaction step of a protocol program.

    ``poll(server)`` advances the phase by one poll cycle and returns the
    next phase name, or ``None`` to stay. Server helpers a phase calls
    (``_poll_cohort``, ``_aggregate_and_advance``, ``_drop_clients``) may
    transition the run directly (e.g. to ``paused``); such helper-set
    transitions take precedence over the poll return value.

    ``wait_paths(server)`` declares what the phase blocks on: a list of
    board paths (the executor watches the missing ones), or ``None`` for
    immediate work — poll me every pass. ``wake(server)`` turns that
    declaration into the ``WakeCondition``; override it only when the
    missing-path filter is wrong for the phase (async phases watch
    *overwrites* of paths that already exist).
    """

    name: str = "?"
    terminal: bool = False        # done/paused: never wake, reap

    def enter(self, server) -> None:
        """Runs once when the run transitions into this phase."""

    def poll(self, server) -> Optional[str]:
        raise NotImplementedError

    def wait_paths(self, server) -> Optional[List[str]]:
        return None               # default: immediate work, poll every pass

    def wake(self, server) -> Optional[WakeCondition]:
        if self.terminal:
            return None
        paths = self.wait_paths(server)
        if paths is None:
            return WakeCondition(poll=True)
        # one batched sweep over the whole wait-set (single transport
        # round trip), not a stat per path per tick
        metas = server.board.stat_many(paths)
        missing = [p for p in paths if metas[p] is None]
        if not missing:
            return WakeCondition(poll=True)      # everything arrived
        return WakeCondition(paths=tuple(missing))


class Protocol:
    """A named composition of phases plus protocol-level semantics."""

    name: str = "?"
    initial: str = "waiting_clients"

    def __init__(self):
        self.phases: Dict[str, Phase] = {}
        for p in self.build_phases():
            if p.name in self.phases:
                raise ValueError(f"duplicate phase name {p.name!r}")
            self.phases[p.name] = p

    def build_phases(self) -> Sequence[Phase]:
        raise NotImplementedError

    def phase(self, name: str) -> Phase:
        return self.phases[name]

    def resume(self, server) -> str:
        """Protocol-specific resume-from-paused bookkeeping; returns the
        phase name to resume into (the executor transitions + records)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# shared terminal / bootstrap phases
# ---------------------------------------------------------------------------
class PausedPhase(Phase):
    name = "paused"
    terminal = True

    def poll(self, server):
        return None                   # needs admin intervention


class DonePhase(Phase):
    name = "done"
    terminal = True

    def poll(self, server):
        return None


class WaitingClientsPhase(Phase):
    """Wait for every cohort member's hello resource."""

    name = "waiting_clients"

    def __init__(self, next_phase: str = "validating"):
        self.next_phase = next_phase

    def poll(self, server):
        r = server.run
        r.phase_ticks += 1
        hellos = server._poll_cohort(
            lambda cid: f"{r.ns}/hello/{cid}", "hello")
        if hellos is None:
            return None
        return self.next_phase

    def wait_paths(self, server):
        r = server.run
        return [f"{r.ns}/hello/{cid}" for cid in r.cohort]


class ValidatingPhase(Phase):
    """Data Validator: check every client's data sheet vs the schema."""

    name = "validating"

    def __init__(self, next_phase: str = "distribute"):
        self.next_phase = next_phase

    def poll(self, server):
        r = server.run
        r.phase_ticks += 1
        schema_d = r.job.data_schema
        if schema_d is None:
            return self.next_phase
        schema = DataSchema.from_dict(schema_d)
        stats = server._poll_cohort(
            lambda cid: f"{r.ns}/validation/{cid}",
            "validation_stats")
        if stats is None:
            return None               # still waiting (pull model)
        results = [validate_stats(cid, schema, stats[cid])
                   for cid in r.cohort]
        bad = [res for res in results if not res.ok]
        for res in results:
            server.metadata.record_provenance(
                actor="data_validator", operation="validate_data",
                subject=res.client_id,
                outcome="ok" if res.ok else "violation",
                details={"violations": res.violations})
        if bad:
            # paper: identify the client, pause the process, report
            r.pause_reason = (
                f"data validation failed for "
                f"{[b.client_id for b in bad]}: "
                f"{[v for b in bad for v in b.violations]}")
            return "paused"
        return self.next_phase

    def wait_paths(self, server):
        r = server.run
        if r.job.data_schema is None:
            return None               # nothing to validate: immediate
        return [f"{r.ns}/validation/{cid}" for cid in r.cohort]


# ---------------------------------------------------------------------------
# synchronous round program (behavior-preserving re-expression)
# ---------------------------------------------------------------------------
class DistributePhase(Phase):
    """Publish the round's global model on the broadcast channel."""

    name = "distribute"

    def poll(self, server):
        r = server.run
        if r.job.gc_round_resources:
            self._gc_rounds_before(server, r.hp_index, r.round)
        # masked rounds: clients mask against *this round's* cohort (it
        # shrinks across rounds) and pre-scale their update by
        # n_examples / weight_denom so weighted FedAvg telescopes
        r.round_cohort = list(r.cohort)
        server.publish_round_global(r.round_cohort)
        return "collect"

    @staticmethod
    def _gc_rounds_before(server, hp: int, rnd: int):
        """Delete spent board resources of rounds strictly before
        ``(hp, rnd)`` (job.gc_round_resources): their evals were consumed,
        their globals redistributed — only the current round's resources
        are live. Keeps board memory bounded under many concurrent jobs."""
        r = server.run
        for path in server.board.list(f"{r.ns}/round/*"):
            # parse (hp, round) relative to the run's namespace root —
            # the phase machinery must not assume how deep ns nests
            parts = path[len(r.ns) + 1:].split("/")
            try:
                key = (int(parts[1]), int(parts[2]))
            except (IndexError, ValueError):
                continue
            if key < (hp, rnd):
                server.board.delete(path)


def publish_dropout(server, base: str, dropped_round: List[str]):
    """Announce the dropout set; survivors answer with corrections posted
    under the matching repair epoch (epochs advance when the dropout set
    grows mid-repair, invalidating stale corrections)."""
    r = server.run
    r.repair_epoch += 1
    server.comm.publish(f"{base}/dropout", {
        "epoch": r.repair_epoch, "dropped": sorted(dropped_round),
        "survivors": sorted(r.cohort)})
    server.metadata.record_provenance(
        actor="run_manager", operation="publish_dropout",
        subject=f"{r.run_id}/r{r.round}", outcome="repair_requested",
        details={"epoch": r.repair_epoch,
                 "dropped": sorted(dropped_round)})


class CollectPhase(Phase):
    """Poll the cohort's round updates; aggregate when complete, or open a
    mask-repair round when a masked cohort lost members mid-collect.

    Streaming collect (DESIGN.md §Sharded streaming aggregation): each
    update is decrypted once — on the tick it lands — its scalars
    (n_examples, train_loss) are kept, and its heavy payload is folded
    straight into an O(T) accumulator sink (``core/streaming.py``) and
    dropped. The server never holds the (N, T) cohort; only the plain
    pytree plane (median/trimmed-mean need the full set) retains updates.
    """

    name = "collect"

    @staticmethod
    def _fresh_stream():
        return {"seen": set(), "sizes": {}, "losses": {}, "updates": None}

    def enter(self, server):
        server.run.proto["collect_stream"] = self._fresh_stream()

    def poll(self, server):
        r = server.run
        r.phase_ticks += 1
        base = f"{r.ns}/round/{r.hp_index}/{r.round}"
        st = r.proto.setdefault("collect_stream", self._fresh_stream())

        def arrive(cid, m):
            # compressed rounds (masked-quantized included) post a wire
            # dict, plain masked rounds one packed fp32 buffer, plain
            # rounds a pytree; key by the job's data plane so a
            # mismatched client fails loudly here at the collect boundary
            payload = (m["comp"] if r.job.compression != "none"
                       else m["packed"] if r.job.secure_aggregation
                       else m["params"])
            st["sizes"][cid] = m["n_examples"]
            st["losses"][cid] = m["train_loss"]
            st["updates"] = server._fold_update(
                st["updates"], cid, payload, m["n_examples"])

        done = server._poll_cohort(lambda cid: f"{base}/update/{cid}",
                                   "round_update",
                                   on_arrival=arrive, seen=st["seen"])
        if not done:
            return None
        r.proto.pop("collect_stream", None)
        updates = st["updates"] if st["updates"] is not None else {}
        sizes = {c: st["sizes"][c] for c in r.cohort}
        losses = {c: st["losses"][c] for c in r.cohort}
        dropped_round = [c for c in r.round_cohort if c not in r.cohort]
        if r.job.secure_aggregation and dropped_round:
            # survivors' buffers still carry masks toward the dropped
            # peers; stash the collect (the sink, not the buffers — those
            # are gone) and run a mask-repair round
            r.pending_round = {"updates": updates, "sizes": sizes,
                               "losses": losses}
            publish_dropout(server, base, dropped_round)
            return "repair"
        server._aggregate_and_advance(updates, sizes, losses)
        return None                   # _aggregate_and_advance transitioned

    def wait_paths(self, server):
        r = server.run
        base = f"{r.ns}/round/{r.hp_index}/{r.round}"
        return [f"{base}/update/{cid}" for cid in r.cohort]


class RepairPhase(Phase):
    """Mask-repair round (DESIGN.md §Dropout-tolerant rounds): every
    survivor re-derives its pairwise masks against the dropped peers and
    posts a packed correction; once all corrections for the current epoch
    arrived the aggregator folds them into the reduction so the surviving
    sum telescopes exactly."""

    name = "repair"

    def enter(self, server):
        server.run.proto.pop("repair_stream", None)

    def poll(self, server):
        from repro_torch.core import streaming
        r = server.run
        r.phase_ticks += 1
        base = f"{r.ns}/round/{r.hp_index}/{r.round}"
        pending = r.pending_round
        sink_updates = (pending["updates"] if isinstance(
            pending["updates"], streaming.StreamedUpdates) else None)
        st = r.proto.setdefault(
            "repair_stream", {"seen": set(), "epoch": r.repair_epoch})
        if st["epoch"] != r.repair_epoch:
            # the dropout set grew after corrections were folded: every
            # old-epoch correction targets the wrong dropout set — back
            # each one out of the accumulator (its payload is still
            # posted under the old epoch path; round GC runs at commit)
            if sink_updates is not None:
                for cid in sorted(st["seen"]):
                    m = server.comm.collect(
                        f"{base}/repair/{st['epoch']}/{cid}", cid)
                    sink_updates.sink.unfold_correction(m["correction"])
            st["seen"] = set()
            st["epoch"] = r.repair_epoch
        n_before = len(r.cohort)
        if sink_updates is not None:
            # corrections stream like updates do in collect: decrypted
            # once on arrival, folded into the pending sink, dropped —
            # the aggregation-commit path is left with flush + finalize
            def arrive(cid, m):
                sink_updates.sink.fold_correction(m["correction"])

            done = server._poll_cohort(
                lambda cid: f"{base}/repair/{r.repair_epoch}/{cid}",
                "mask_repair", on_arrival=arrive, seen=st["seen"])
        else:
            # legacy dict-shaped pending (tests drive this): lazy mapping,
            # each correction decrypted when its fold batch stages it
            done = server._poll_cohort(
                lambda cid: f"{base}/repair/{r.repair_epoch}/{cid}",
                "mask_repair", lazy=True)
        if r.phase == "paused":
            return None
        if len(r.cohort) != n_before:
            # the dropout set grew mid-repair: corrections already posted
            # (even a complete set) target the old dropout set — bump the
            # epoch and ask the remaining survivors again (the epoch
            # mismatch above unfolds anything already folded, next tick)
            publish_dropout(
                server, base,
                [c for c in r.round_cohort if c not in r.cohort])
            r.phase_ticks = 0
            return None
        if done is None:
            return None
        r.proto.pop("repair_stream", None)
        r.pending_round = None
        if sink_updates is not None:
            # survivors that were folded during collect and dropped
            # mid-repair get backed out of the accumulator: their posted
            # update is still on the board (round GC runs at commit), so
            # refetch and unfold; the new epoch's corrections cancel the
            # masks the remaining survivors still carry toward them
            def refetch(cid):
                m = server.comm.collect(f"{base}/update/{cid}", cid)
                return (m["comp"] if r.job.compression != "none"
                        else m["packed"])

            sink_updates.restrict_to(r.cohort, refetch)
            updates = sink_updates
            corrections = streaming.CORRECTIONS_FOLDED
        else:
            updates = {c: pending["updates"][c] for c in r.cohort}
            corrections = streaming.LazyView(done, "correction")
        server._aggregate_and_advance(
            updates,
            {c: pending["sizes"][c] for c in r.cohort},
            {c: pending["losses"][c] for c in r.cohort},
            corrections=corrections)
        return None                   # _aggregate_and_advance transitioned

    def wait_paths(self, server):
        r = server.run
        base = f"{r.ns}/round/{r.hp_index}/{r.round}"
        return [f"{base}/repair/{r.repair_epoch}/{cid}" for cid in r.cohort]


class EvaluatePhase(Phase):
    """Evaluation Coordinator: collect client-side evals of the round's
    global (evaluation happens on clients — private test data), attach
    the mean to the latest history entry, then ``advance()`` — for the
    sync protocol, to the next round, the next hyperparameter trial, or
    deploy. Protocol variants override ``advance``/``subject`` only; the
    eval-collection mechanics stay single-sourced here."""

    name = "evaluate"

    def poll(self, server):
        r = server.run
        r.phase_ticks += 1
        base = f"{r.ns}/round/{r.hp_index}/{r.round}"
        evals = server._poll_cohort(lambda cid: f"{base}/eval/{cid}",
                                    "round_eval")
        if evals is None:
            return None
        mean_eval = float(np.mean([e["eval_loss"] for e in evals.values()]))
        r.history[-1]["mean_eval_loss"] = mean_eval
        server.metadata.record_provenance(
            actor="evaluation_coordinator", operation="round_eval",
            subject=self.subject(r), outcome="ok",
            details={"mean_eval_loss": mean_eval})
        return self.advance(server)

    def subject(self, r) -> str:
        return f"{r.run_id}/r{r.round}"

    def advance(self, server) -> str:
        r = server.run
        r.round += 1
        if r.round >= r.job.rounds:
            hp = r.job.hyperparameter_search
            if hp and r.hp_index + 1 < len(hp["values"]):
                # FL Run Manager repeats the process with new
                # hyperparameters — every trial restarts from the *init*
                # model (not the first trial's round-0 aggregate) and with
                # fresh outer-optimizer state, so trials are comparable
                r.hp_index += 1
                r.round = 0
                params = server.store.get(r.init_digest)
                r.global_digest = server.store.put(
                    params, "hp_restart", {"hp_index": r.hp_index})
                r.outer = None
                r.outer_state = None
                return "distribute"
            return "deploying"
        return "distribute"

    def wait_paths(self, server):
        r = server.run
        base = f"{r.ns}/round/{r.hp_index}/{r.round}"
        return [f"{base}/eval/{cid}" for cid in r.cohort]


class DeployingPhase(Phase):
    """Model Deployer: publish the release; clients pull and decide."""

    name = "deploying"

    def poll(self, server):
        r = server.run
        best = min(r.history, key=lambda h: h.get("mean_eval_loss",
                                                  float("inf")))
        server.comm.publish(f"{r.ns}/release", {
            "digest": best["digest"], "round": best["round"],
            "mean_eval_loss": best.get("mean_eval_loss")})
        params = server.store.get(best["digest"])
        server.comm.publish(f"{r.ns}/release/params", {
            "digest": best["digest"],
            "params": params_to_numpy(params)})
        server.metadata.record_run_end(r.run_id, "completed",
                                       best["digest"])
        return "done"


class SyncProtocol(Protocol):
    """The paper's synchronous flow as a composed phase program."""

    name = "sync"

    def build_phases(self):
        return (WaitingClientsPhase(next_phase="validating"),
                ValidatingPhase(next_phase="distribute"),
                DistributePhase(), CollectPhase(), RepairPhase(),
                EvaluatePhase(), DeployingPhase(), PausedPhase(),
                DonePhase())

    def resume(self, server) -> str:
        """If the current round's aggregate was already committed (the
        pause hit during evaluate), resume straight into evaluate —
        re-running the round would double-apply it and duplicate its
        history entry. Otherwise re-run the round: bump the attempt so
        clients reset their done-markers, and clear the aborted attempt's
        resources NOW — before any client can fetch the stale global
        (masked updates against the old cohort must never be collected)."""
        r = server.run
        r.pending_round = None        # discard any half-collected round
        aggregated = (bool(r.history)
                      and r.history[-1]["round"] == r.round
                      and r.history[-1]["hp_index"] == r.hp_index
                      and "mean_eval_loss" not in r.history[-1])
        if aggregated:
            return "evaluate"
        r.round_attempt += 1
        base = f"{r.ns}/round/{r.hp_index}/{r.round}"
        for path in server.board.list(f"{base}/*"):
            server.board.delete(path)
        return "validating"


# ---------------------------------------------------------------------------
# asynchronous buffered aggregation (FedBuff-style)
# ---------------------------------------------------------------------------
STALENESS_ALPHA = 0.5


def staleness_weight(tau) -> float:
    """FedBuff polynomial staleness discount: ``(1 + τ)^-α`` with α=0.5.

    τ is the number of commits the global advanced since the client
    fetched its base model. Strictly positive for every τ ≥ 0 — a stale
    update is discounted, never discarded — and equal to 1 at τ=0.
    """
    return float((1.0 + float(tau)) ** -STALENESS_ALPHA)


def fold_weights(taus: Sequence[float]) -> List[float]:
    """Commit-normalized staleness weights for one buffered commit: each
    update's ``staleness_weight`` divided by the buffer's total, so the
    folded delta is a convex combination of the buffered deltas (weights
    strictly positive, summing to 1)."""
    raw = [staleness_weight(t) for t in taus]
    total = sum(raw)
    return [w / total for w in raw]


def _f32_scalar(x: float, device) -> torch.Tensor:
    """``x`` rounded to f32, as a 0-d tensor on ``device``. Dividing by a
    CPU scalar, PyTorch's CUDA kernel multiplies by its reciprocal, one
    rounding more than numpy's f32 division; a device tensor keeps the
    true division."""
    return torch.tensor(np.float32(x), device=device)


class AsyncServePhase(Phase):
    """Buffered asynchronous aggregation (DESIGN.md §Protocol programs).

    The server publishes commit ``c``'s global at the standard round path
    ``round/<hp>/<c>/global`` and keeps serving: every poll it scans the
    cohort's ``async/update/<cid>`` resources (clients overwrite in place;
    the board's monotonic overwrite version tells new from seen without
    decryption), folds each fresh packed delta into the buffer weighted by
    ``staleness_weight(commit - base_commit)``, and commits a new global
    once ``job.async_buffer_size`` folds accumulated: normalized fold,
    outer-optimizer step, history entry, next global published. After
    ``job.rounds`` commits the run moves to the final evaluate phase.
    Slow silos never stall the commit cadence — their late deltas land in
    a later buffer, discounted by how far the global moved.

    The buffer is a (T,) f32 tensor on the server's device; each posted
    delta (numpy off the board) moves there once, at its fold.
    """

    name = "async_serve"

    def enter(self, server):
        r = server.run
        st = r.proto
        st.setdefault("seen", {})     # cid -> last folded overwrite version
        st.setdefault("buffer", None)  # weighted delta sum (T,)
        st.setdefault("weight", 0.0)  # un-normalized staleness-weight sum
        st.setdefault("folds", 0)
        st.setdefault("fold_losses", [])
        st.setdefault("fold_sizes", {})
        st.setdefault("fold_taus", [])
        self._publish_commit(server)

    def _publish_commit(self, server):
        server.publish_round_global(server.run.cohort)

    def poll(self, server):
        r = server.run
        st = r.proto
        # overwrite detection across the whole cohort in one batched
        # metadata sweep — the async server polls every tick, so this is
        # the hottest probe path in the buffered protocol
        paths = {cid: f"{r.ns}/async/update/{cid}"
                 for cid in r.cohort}
        metas = server.board.stat_many(paths.values())
        for cid in r.cohort:
            path = paths[cid]
            meta = metas[path]
            if meta is None or meta["version"] <= st["seen"].get(cid, 0):
                continue
            msg = server.comm.collect(path, cid)
            st["seen"][cid] = meta["version"]
            self._fold(server, cid, msg)
            if st["folds"] >= r.job.async_buffer_size:
                done = self._commit(server)
                if done:
                    return "evaluate"
        return None

    def _fold(self, server, cid: str, msg: dict):
        r = server.run
        st = r.proto
        tau = max(0, r.round - int(msg["base_commit"]))
        w = staleness_weight(tau)
        if r.job.compression != "none":
            # compressed plane: the staleness-weighted fold consumes the
            # dequantized delta — decompression happens exactly once, at
            # fold time, on the host, and the dense f32 delta then moves
            # to the buffer's device like a plain one
            from repro_torch.core.compression import decompress
            delta = decompress(msg["comp"])
        else:
            delta = msg["delta"]
        delta = as_f32(delta, server.device).reshape(-1)
        # numpy's ``buffer + w * delta`` rounds w to f32 first (NEP 50),
        # then rounds the product and the sum once each. ``add_(delta,
        # alpha=w)`` would contract both into one FMA (on CUDA and on the
        # CPU's vectorised path), so the fold is two ops: bitwise equal
        # to the reference's
        wd = delta * float(np.float32(w))
        st["buffer"] = wd if st["buffer"] is None else st["buffer"].add_(wd)
        st["weight"] += w
        st["folds"] += 1
        st["fold_losses"].append(float(msg["train_loss"]))
        st["fold_sizes"][cid] = (st["fold_sizes"].get(cid, 0)
                                 + int(msg["n_examples"]))
        st["fold_taus"].append(tau)

    def _commit(self, server) -> bool:
        """Normalize the buffer, step the outer optimizer, publish the
        next global. Returns True when the commit budget is exhausted."""
        r = server.run
        st = r.proto
        # the async protocol spends its whole life in one phase, so the
        # per-phase spans can't show commit cadence — each commit gets its
        # own span (folds + staleness tell the staleness-discount story)
        with server.telemetry.span(
                "async.commit", cat="phase", actor="server",
                run_id=r.run_id,
                attrs={"commit": r.round, "folds": st["folds"]}):
            return self._commit_inner(server)

    def _commit_inner(self, server) -> bool:
        r = server.run
        st = r.proto
        job = r.job
        old_params = server.store.get(r.global_digest)
        layout = PackedLayout.for_tree(old_params)
        # convex combination of buffered deltas: weights are the positive
        # staleness discounts normalized by their sum (fold_weights); the
        # f32 division and the leaf add are numpy's, bit for bit
        buf = st["buffer"]
        mean_delta = unpack_pytree(
            buf / _f32_scalar(st["weight"], buf.device), layout)
        new_global = _tree.tree_map(
            lambda p, d: p.to(torch.float32)
            + d.to(p.device, torch.float32).reshape(p.shape),
            old_params, mean_delta)
        from repro_torch.optim import OUTER_REGISTRY
        if r.outer is None:
            r.outer = OUTER_REGISTRY[job.outer_optimizer]()
            r.outer_state = r.outer.init(old_params)
        new_params, r.outer_state = r.outer.step(
            old_params, new_global, r.outer_state)
        commit = r.round
        digest = server.store.put(new_params, "async_commit", {
            "run_id": r.run_id, "commit": commit, "hp_index": r.hp_index,
            "folds": st["folds"], "staleness": list(st["fold_taus"])})
        metrics = {"mean_train_loss": float(np.mean(st["fold_losses"])),
                   "folds": st["folds"],
                   "mean_staleness": float(np.mean(st["fold_taus"]))}
        from repro_torch.core.contribution import data_size_contribution
        server.metadata.record_round(
            r.run_id, commit, metrics, digest,
            {"data_size": data_size_contribution(st["fold_sizes"])})
        server.metadata.record_provenance(
            actor="run_manager", operation="async_commit",
            subject=f"{r.run_id}/c{commit}", outcome="committed",
            details={"folds": st["folds"],
                     "staleness": list(st["fold_taus"]),
                     "weights": fold_weights(st["fold_taus"])})
        r.history.append({"round": commit, "hp_index": r.hp_index,
                          **metrics, "digest": digest})
        r.global_digest = digest
        st["buffer"] = None
        st["weight"] = 0.0
        st["folds"] = 0
        st["fold_losses"] = []
        st["fold_sizes"] = {}
        st["fold_taus"] = []
        r.round = commit + 1
        if job.gc_round_resources:
            # prior commits' globals are spent the moment a newer one is
            # published (clients always fetch the status round's global)
            for path in server.board.list(
                    f"{r.ns}/round/{r.hp_index}/*/global"):
                try:
                    rel = path[len(r.ns) + 1:].split("/")
                    if int(rel[2]) < r.round:
                        server.board.delete(path)
                except (IndexError, ValueError):
                    continue
        self._publish_commit(server)
        return r.round >= job.rounds

    def wait_paths(self, server):
        r = server.run
        return [f"{r.ns}/async/update/{cid}" for cid in r.cohort]

    def wake(self, server):
        # the watched resources are overwritten in place, so "missing"
        # filtering is wrong here: wake whenever any of them changes
        # (the board's mutation counter bumps on every overwrite)
        return WakeCondition(paths=tuple(self.wait_paths(server)))


class AsyncEvaluatePhase(EvaluatePhase):
    """Final evaluation of the last committed global: clients see the
    standard ``evaluate`` status (round = commit count) and post their
    eval of ``round/<hp>/<commits>/global`` — the model published by the
    last commit. The mean lands on the last history entry, so deploying
    releases the final committed model. Only the advance decision and the
    provenance subject differ from the sync evaluate."""

    def subject(self, r) -> str:
        return f"{r.run_id}/final"

    def advance(self, server) -> str:
        return "deploying"


class AsyncBuffProtocol(Protocol):
    """waiting_clients → validating → async_serve → evaluate → deploying."""

    name = "async_buff"

    def build_phases(self):
        return (WaitingClientsPhase(next_phase="validating"),
                ValidatingPhase(next_phase="async_serve"),
                AsyncServePhase(), AsyncEvaluatePhase(),
                DeployingPhase(), PausedPhase(), DonePhase())

    def resume(self, server) -> str:
        """Phase-aware re-entry. Buffered updates are staleness-tagged,
        so nothing collected before a mid-serve pause is stale in the
        sync sense — resume serving where the run left off (re-publishing
        the current commit's global, via enter). But a pause after the
        commit budget was exhausted must NOT re-enter serving (that would
        fold one commit past the budget); it resumes into the final
        evaluate, or straight into deploying when the eval mean already
        landed. A pause before serving ever started re-validates, like
        the sync protocol."""
        r = server.run
        if not r.proto:
            return "validating"       # paused before async_serve.enter ran
        if r.round >= r.job.rounds:   # commit budget already exhausted
            evaluated = (bool(r.history)
                         and "mean_eval_loss" in r.history[-1])
            return "deploying" if evaluated else "evaluate"
        return "async_serve"


# ---------------------------------------------------------------------------
# intra-silo tier (DESIGN.md §Hierarchical federation)
#
# The phase machinery above is tier-agnostic on purpose: a Phase only ever
# talks to the executor it is handed. The outer tier's executor is
# FLServer (board paths under ``run.ns``, cohort of silo client ids, the
# server publishes the global); the inner tier's executor is a silo's
# ``InnerRoundEngine`` (core/client.py) — no board at all, a cohort of
# device *indices* sampled per outer round, and the silo itself holding
# the base params. ``IntraSiloProtocol`` is deliberately NOT registered in
# PROTOCOLS: it is not a negotiable job-level protocol but the recursive
# round engine a device-fleet silo instantiates per outer round.
# ---------------------------------------------------------------------------
def _device_rng(silo_id, seed: int, rnd: int, tag: int):
    """Deterministic per-(silo, seed, round, purpose) generator. Uses the
    silo's hashed string identity (data.synthetic.silo_key), never
    Python's per-process ``hash``."""
    from repro_torch.data.synthetic import silo_key
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (2 ** 63), silo_key(silo_id), int(rnd), int(tag)]))


def sample_device_cohort(silo_id, seed: int, rnd: int, n_devices: int,
                         cohort_size: int) -> List[int]:
    """Sample the inner round's device cohort — a pure function of
    ``(silo_id, seed, rnd)``, so a re-run (resume, twin bench, repaired
    attempt) samples the same devices. ``cohort_size <= 0`` means the
    whole fleet participates."""
    n = int(n_devices)
    k = n if int(cohort_size) <= 0 else min(int(cohort_size), n)
    if k >= n:
        return list(range(n))
    rng = _device_rng(silo_id, seed, rnd, 0xC0)
    return sorted(rng.choice(n, size=k, replace=False).tolist())


def sample_device_dropout(silo_id, seed: int, rnd: int,
                          cohort: Sequence[int], p: float) -> List[int]:
    """Bernoulli(p) device dropout over the sampled cohort, deterministic
    in ``(silo_id, seed, rnd)``. Never empties the cohort: if every
    sampled device drops, the first sampled device is kept — an inner
    round with zero survivors would post a zero-weight update and poison
    the outer weighted mean, so the guard is part of the contract."""
    if float(p) <= 0.0 or not cohort:
        return []
    rng = _device_rng(silo_id, seed, rnd, 0xD0)
    mask = rng.random(len(cohort)) < float(p)
    dropped = [d for d, m in zip(cohort, mask) if m]
    if len(dropped) == len(cohort):
        dropped = dropped[1:]
    return dropped


class DeviceSamplePhase(Phase):
    """Sample the outer round's device cohort and its dropout set."""

    name = "device_sample"

    def poll(self, engine):
        engine.sample_cohort()
        return "device_train"


class DeviceTrainPhase(Phase):
    """Train-and-fold a bounded batch of surviving devices per poll.

    The inner tier's analogue of the streaming collect: each device's
    clipped packed delta is folded into the engine's O(T) sink the moment
    it finishes training, and dropped — polls stay cooperative (the silo
    agent can interleave other jobs' ticks) and the fleet never
    materializes as a (K, T) matrix."""

    name = "device_train"

    def poll(self, engine):
        return "inner_done" if engine.train_some() else None


class InnerDonePhase(Phase):
    name = "inner_done"
    terminal = True

    def poll(self, engine):
        return None


class IntraSiloProtocol(Protocol):
    """The recursive inner round program a device-fleet silo runs per
    outer round: device_sample → device_train → inner_done.

    The inner tier is plain FedAvg *only* (jobs.py matrix): per-device
    deltas fold in the clear inside the silo's own trust domain, where
    the silo already sees its devices' raw data — masking adds nothing.
    Pairwise secure-agg masks would not telescope anyway: they cancel
    across a *stable* cohort, and inner cohorts are ephemeral 5%-ish
    samples that change every round, so the mask graph never closes.
    Privacy toward the *federation* is the outer tier's job, and it
    composes unchanged because the silo posts one pre-aggregated delta
    on the standard wire format.
    """

    name = "intra_silo"
    initial = "device_sample"

    def build_phases(self):
        return (DeviceSamplePhase(), DeviceTrainPhase(), InnerDonePhase())

    def resume(self, engine) -> str:
        return "device_sample"    # an interrupted inner round re-runs whole


PROTOCOLS = {
    "sync": SyncProtocol,
    "async_buff": AsyncBuffProtocol,
}


def make_protocol(name: str) -> Protocol:
    try:
        return PROTOCOLS[name]()
    except KeyError:
        raise KeyError(
            f"unknown protocol {name!r}; known: {sorted(PROTOCOLS)}"
        ) from None


# client-side helper shared with core.client: pack a trained-params /
# base-params pair into the posted delta buffer
def pack_delta(trained, base) -> torch.Tensor:
    """Packed ``trained - base`` as a (T,) f32 tensor on the leaves'
    device."""
    buf_t, _ = pack_pytree(trained)
    buf_b, _ = pack_pytree(base)
    return buf_t - buf_b
