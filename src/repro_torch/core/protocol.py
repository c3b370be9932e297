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

``SyncProtocol`` is ported: waiting_clients → validating → distribute →
collect → [repair] → evaluate → (next round / hp restart) → deploying →
done, with the dropout-deadline and mask-repair machinery. The collect
folds each arrival into a streaming sink on the server's device (K1 for
the fp32 secure plane) and the repair folds each correction into the same
sink as a weight -1 row.

Not ported yet (ROADMAP queue A item 12): ``AsyncBuffProtocol``
(FedBuff-style buffered asynchronous aggregation) and the intra-silo
tier ``IntraSiloProtocol``. Both raise ``NotImplementedError``; the name
``async_buff`` stays in ``PROTOCOLS`` so job validation matches the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.convert import params_to_numpy
from repro_torch.core.packing import pack_pytree
from repro_torch.core.validation import DataSchema, validate_stats

# the end of every "not ported" error of the async and hierarchical tiers
NOT_PORTED = ("is not ported yet (ROADMAP queue A item 12: async, "
              "contribution and hierarchical)")


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


class AsyncBuffProtocol(Protocol):
    """FedBuff-style buffered asynchronous aggregation — not ported."""

    name = "async_buff"

    def __init__(self):
        raise NotImplementedError(f"protocol 'async_buff' {NOT_PORTED}")


class IntraSiloProtocol(Protocol):
    """A device-fleet silo's inner round program — not ported."""

    name = "intra_silo"
    initial = "device_sample"

    def __init__(self):
        raise NotImplementedError(f"the intra-silo tier {NOT_PORTED}")


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
