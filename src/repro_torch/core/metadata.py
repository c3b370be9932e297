"""Metadata Management (paper §VII): provenance + experiment tracking.

Two record families, per Peregrina et al. [17] as adopted by FL-APU:
  * provenance  — who performed which operation, on what, with what outcome
                  (governance decisions, registrations, deployments, ...)
  * experiment  — training-run tracking: config, per-round metrics, model
                  digests — never raw data (privacy by design)

The store is append-only (trace integrity) with a hash chain over records so
tampering is detectable — the "traceability of governance decisions and
tracking of training processes" the paper calls out in the abstract.

A file-backed store (``path=...``) is durable across process restarts:
``__init__`` reloads the JSONL trail and chains new records onto the last
persisted hash, so ``verify_chain()`` attests one unbroken trail spanning
every server incarnation that wrote to the file.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, List, Optional


class MetadataStore:
    def __init__(self, path: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None):
        """``clock`` stamps every record's ``ts`` (default ``time.time``).
        Inject a fake for deterministic provenance under test, or the
        WanModel's ``elapsed`` so WAN-bench trails carry simulated time —
        the same timeline the telemetry sim-clock lane plots."""
        self._records: List[dict] = []
        self._path = path
        self._clock = clock or time.time
        self._last_hash = "0" * 64
        if path and os.path.exists(path):
            self.load(path)

    def load(self, path: str):
        """Reload a persisted JSONL trail (server restart): records are
        adopted verbatim — hashes included — so the chain head continues
        where the dead process stopped. Raises if the file is not the
        prefix-intact trail this store would have written."""
        if self._records:
            raise RuntimeError("load() only into an empty store")
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    self._records.append(json.loads(line))
        if self._records:
            self._last_hash = self._records[-1]["hash"]
        if not self.verify_chain():
            raise ValueError(f"hash chain in {path} is broken or tampered")

    # ------------------------------------------------------------------
    def _append(self, record: dict) -> dict:
        record = dict(record)
        record["seq"] = len(self._records)
        record["ts"] = record.get("ts", self._clock())
        record["prev_hash"] = self._last_hash
        payload = json.dumps(record, sort_keys=True, default=str)
        record["hash"] = hashlib.sha256(payload.encode()).hexdigest()
        self._last_hash = record["hash"]
        self._records.append(record)
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(record, default=str) + "\n")
        return record

    # ------------------------------------------------------------------
    # provenance
    # ------------------------------------------------------------------
    def record_provenance(self, actor: str, operation: str, subject: str,
                          outcome: str, details: Optional[dict] = None):
        return self._append({
            "kind": "provenance", "actor": actor, "operation": operation,
            "subject": subject, "outcome": outcome,
            "details": details or {},
        })

    # ------------------------------------------------------------------
    # experiment tracking
    # ------------------------------------------------------------------
    def record_run_start(self, run_id: str, job: dict):
        return self._append({"kind": "experiment", "event": "run_start",
                             "run_id": run_id, "job": job})

    def record_round(self, run_id: str, round_idx: int, metrics: dict,
                     model_digest: str, contributions: Optional[dict] = None):
        return self._append({
            "kind": "experiment", "event": "round", "run_id": run_id,
            "round": round_idx, "metrics": metrics,
            "model_digest": model_digest,
            "contributions": contributions or {},
        })

    def record_run_end(self, run_id: str, status: str,
                       final_digest: Optional[str] = None):
        return self._append({"kind": "experiment", "event": "run_end",
                             "run_id": run_id, "status": status,
                             "final_digest": final_digest})

    def record_model(self, digest: str, origin: str, details: dict):
        return self._append({"kind": "model", "digest": digest,
                             "origin": origin, "details": details})

    # ------------------------------------------------------------------
    # queries (Reporting reads through these)
    # ------------------------------------------------------------------
    def query(self, **filters) -> List[dict]:
        out = []
        for r in self._records:
            if all(r.get(k) == v for k, v in filters.items()):
                out.append(r)
        return out

    def runs(self) -> List[str]:
        return [r["run_id"] for r in self.query(kind="experiment",
                                                event="run_start")]

    def run_history(self, run_id: str) -> List[dict]:
        return [r for r in self._records
                if r.get("kind") == "experiment" and r.get("run_id") == run_id]

    def verify_chain(self) -> bool:
        """Integrity check over the append-only hash chain."""
        prev = "0" * 64
        for r in self._records:
            if r["prev_hash"] != prev:
                return False
            body = {k: v for k, v in r.items() if k != "hash"}
            payload = json.dumps(body, sort_keys=True, default=str)
            if hashlib.sha256(payload.encode()).hexdigest() != r["hash"]:
                return False
            prev = r["hash"]
        return True

    def __len__(self):
        return len(self._records)
