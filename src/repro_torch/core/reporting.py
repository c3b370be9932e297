"""Reporting (paper §V): read stored information, prepare reports.

Builds the FL-run report the Governance & Management Website displays
(SAAM tasks 2/13), the client-side report (task 38), and — with the
flight recorder (DESIGN.md §Observability) — the merged operational
views: ``run_timeline`` (one run's provenance + experiment records and
phase spans on a single ordered timeline) and ``fleet_report`` (the
scheduler's whole-federation snapshot joined with the metrics registry).
"""
from __future__ import annotations

import math
from typing import List, Optional

from repro_torch.core.metadata import MetadataStore


def run_report(metadata: MetadataStore, run_id: str) -> dict:
    history = metadata.run_history(run_id)
    rounds = [r for r in history if r.get("event") == "round"]
    start = next((r for r in history if r.get("event") == "run_start"), None)
    end = next((r for r in history if r.get("event") == "run_end"), None)
    # Loss curve: prefer mean_train_loss, fall back to a bare "loss";
    # rounds reporting neither (e.g. an eval-only or repair bookkeeping
    # round written by an external tool) contribute NaN — a float, so
    # consumers' np.isfinite/plotting still work — rather than a None
    # that would blow up arithmetic, or a KeyError on a missing
    # "metrics" altogether.
    def loss_of(r) -> float:
        metrics = r.get("metrics") or {}
        loss = metrics.get("mean_train_loss", metrics.get("loss"))
        return float(loss) if loss is not None else math.nan
    return {
        "run_id": run_id,
        "job": start["job"] if start else None,
        "status": end["status"] if end else "running",
        "n_rounds": len(rounds),
        "rounds": [{
            "round": r.get("round"),
            "metrics": r.get("metrics") or {},
            "model_digest": r.get("model_digest"),
            "contributions": r.get("contributions", {}),
        } for r in rounds],
        "final_digest": end.get("final_digest") if end else None,
        "loss_curve": [loss_of(r) for r in rounds],
    }


def governance_report(metadata: MetadataStore) -> List[dict]:
    """All governance decisions with full provenance (traceability)."""
    ops = ("propose", "vote", "close_proposal", "finalize_contract",
           "request_negotiation")
    return [r for r in metadata.query(kind="provenance")
            if r["operation"] in ops]


def client_report(metadata: MetadataStore, client_id: str) -> dict:
    recs = [r for r in metadata.query(kind="provenance")
            if r.get("actor") == client_id]
    return {
        "client_id": client_id,
        "operations": [{"op": r["operation"], "subject": r["subject"],
                        "outcome": r["outcome"]} for r in recs],
        "trainings": [r for r in recs if r["operation"] == "local_train"],
        "deployments": [r for r in recs if r["operation"] == "deploy_model"],
    }


def run_timeline(metadata: MetadataStore, run_id: str,
                 telemetry=None) -> dict:
    """One run's life on a single ordered timeline.

    Merges the experiment records (run_start / rounds / run_end) with
    every provenance record whose subject is the run or lives in its
    namespace (``<run_id>/...`` — round subjects, dropout, repair), in
    chain order (``seq``). With a :class:`~repro_torch.core.telemetry.Telemetry`
    attached, the run's recorded phase spans join as a ``phases`` section
    with wall/sim durations — "where did round 7 spend its time" as one
    view instead of three tools.
    """
    prefix = run_id + "/"
    events = []
    for r in metadata.query(kind="experiment"):
        if r.get("run_id") == run_id:
            events.append({"seq": r["seq"], "ts": r["ts"],
                           "source": "experiment",
                           "event": r.get("event"),
                           "round": r.get("round"),
                           "metrics": r.get("metrics")})
    for r in metadata.query(kind="provenance"):
        subject = r.get("subject", "")
        if subject == run_id or subject.startswith(prefix):
            events.append({"seq": r["seq"], "ts": r["ts"],
                           "source": "provenance",
                           "actor": r.get("actor"),
                           "operation": r.get("operation"),
                           "subject": subject,
                           "outcome": r.get("outcome")})
    events.sort(key=lambda e: e["seq"])
    phases = []
    if telemetry is not None:
        for sp in telemetry.spans(run_id):
            if sp.cat != "phase":
                continue
            wall = (sp.t1 - sp.t0) if sp.t1 is not None else None
            sim = (sp.sim1 - sp.sim0
                   if sp.sim0 is not None and sp.sim1 is not None else None)
            phases.append({"name": sp.name, "actor": sp.actor,
                           "wall_s": wall, "sim_s": sim,
                           "open": sp.t1 is None,
                           "attrs": dict(sp.attrs or {})})
    return {"run_id": run_id, "events": events, "phases": phases}


def fleet_report(scheduler, run_ids: Optional[List[str]] = None) -> dict:
    """Whole-federation operational snapshot: the scheduler's monitor
    view, per-run states, and a point-in-time metrics-registry snapshot
    (board traffic, scheduling counters, kernel timings, WAN clocks via
    the registered collectors). Plain detached data throughout."""
    entries = scheduler.entries
    ids = list(run_ids) if run_ids is not None else sorted(entries)
    return {
        "monitor": scheduler.monitor(),
        "runs": {rid: {
            "state": entries[rid].state,
            "phase": (entries[rid].server.run.phase
                      if entries[rid].server.run else "idle"),
            "ticks": entries[rid].ticks,
            "idle_skips": entries[rid].idle_skips,
            "priority": entries[rid].priority,
        } for rid in ids if rid in entries},
        "metrics": scheduler.telemetry.metrics.snapshot(),
        "incidents": [{"run_id": i["run_id"], "reason": i["reason"],
                       "spans": len(i["spans"])}
                      for i in scheduler.telemetry.incidents],
    }
