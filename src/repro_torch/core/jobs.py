"""Job Creator (paper §V): governance contract (or admin input) -> FL Job.

An FL Job carries *all* parameters for one FL process: model architecture,
rounds, local training config, train/test split, evaluation metrics,
preprocessing ops, the negotiated data schema, aggregation strategy, and
(optionally) a hyperparameter sweep the FL Run Manager repeats rounds for.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.governance import GovernanceContract
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.validation import DataSchema


@dataclass
class FLJob:
    job_id: str
    arch: str
    rounds: int
    local_steps: int
    batch_size: int
    lr: float
    optimizer: str
    outer_optimizer: str
    aggregation: str
    train_test_split: float
    eval_metrics: List[str]
    secure_aggregation: bool
    data_schema: Optional[dict]
    preprocessing: List[dict] = field(default_factory=list)
    hyperparameter_search: Optional[dict] = None
    contract_id: Optional[str] = None
    created_by: str = "admin"
    reduced: bool = True        # CPU-scale model variant for the container
    # dropout tolerance (DESIGN.md §Dropout-tolerant rounds):
    #   round_deadline_ticks — poll cycles a waiting phase tolerates before
    #     the server starts shrinking the cohort (0 = wait forever, the old
    #     behaviour); clients with a live heartbeat get one extra deadline
    #     window before being dropped.
    #   min_cohort — smallest cohort the run may shrink to; below it the
    #     run pauses with a recorded provenance reason.
    round_deadline_ticks: int = 0
    min_cohort: int = 1
    # federation scheduler (DESIGN.md §Federation scheduler):
    #   priority — admission-queue rank; higher admits first, ties FIFO.
    #     Negotiable through governance like any other contract parameter.
    #   gc_round_resources — let the Run Manager delete a round's spent
    #     board resources (updates, repairs, prior-round globals) once the
    #     aggregate is committed; keeps the board's memory bounded when
    #     many jobs run concurrently. Off by default: single-job tests and
    #     post-hoc audits read round resources after completion.
    priority: int = 0
    gc_round_resources: bool = False
    # protocol programs (DESIGN.md §Protocol programs):
    #   protocol — which round protocol the Run Manager executes:
    #     "sync" (the paper's synchronous flow) or "async_buff"
    #     (FedBuff-style buffered asynchronous aggregation). Negotiable
    #     through governance like any other contract parameter, and
    #     recorded on the provenance chain with the rest of the job at
    #     run start (traceability requirement).
    #   async_buffer_size — async_buff only: number of client updates the
    #     server folds (staleness-discounted) before committing a new
    #     global model. job.rounds then counts *commits*.
    protocol: str = "sync"
    async_buffer_size: int = 4
    # compressed data plane (DESIGN.md §Compressed data plane):
    #   compression — negotiated lossy coding of posted update buffers:
    #     "none" (raw fp32 packed buffers), "topk" (magnitude
    #     sparsification to index+value pairs) or "int8" (per-chunk
    #     stochastic quantization). Clients carry error-feedback
    #     residuals so convergence tracks the uncompressed twin.
    #     Incompatible with secure_aggregation: pairwise masks only
    #     cancel when transmitted bit-exactly, and lossy coding destroys
    #     that (see _validate).
    #   compression_ratio — topk only: fraction of coordinates kept.
    #   quant_bits — int8 only: bits per quantized value (2..8; values
    #     ride the wire as int8 regardless).
    compression: str = "none"
    compression_ratio: float = 0.1
    quant_bits: int = 8
    # composable privacy (DESIGN.md §Composable privacy):
    #   quant_range — secure+int8: half-range of the cohort-common fixed
    #     quantization grid. Per-client adaptive scales cannot be applied
    #     after a modular masked sum, so every cohort member quantizes on
    #     the same grid; 0.0 = the compression layer's default. Also
    #     honored by plain int8 (fixed-grid twin runs).
    #   dp_epsilon / dp_delta / dp_clip — per-round (ε, δ)-DP on the
    #     cohort sum: each silo L2-clips its weighted packed delta to
    #     dp_clip and adds sigma_total/sqrt(N) Gaussian noise in the
    #     integer domain before coding. dp_epsilon == 0 disables the
    #     stage. Negotiated like any other decision and recorded on the
    #     provenance chain at run start (server.start_run).
    #   dp_seed — base seed of the per-silo noise streams, so smoke runs
    #     can be made bit-deterministic (CI --dp-seed flag).
    quant_range: float = 0.0
    dp_epsilon: float = 0.0
    dp_delta: float = 1e-5
    dp_clip: float = 1.0
    dp_seed: int = 0
    # hierarchical device fleets (DESIGN.md §Hierarchical federation):
    #   devices_per_silo — size of the simulated cross-device population
    #     behind each silo (1 = flat silo; >1 turns the silo into a
    #     mini-aggregator running an IntraSiloProtocol per outer round).
    #   device_cohort_size — devices sampled per outer round (0 = the
    #     whole fleet). devices_per_silo=1 with device_cohort_size=1
    #     routes through the inner engine and reproduces the flat silo
    #     bit-for-bit through the outer wire (tests pin this twin).
    #   device_dropout — Bernoulli per-device dropout probability over
    #     the sampled cohort (a phone goes offline mid-round); the inner
    #     fold simply re-weights over the survivors, never below one.
    #   device_clip — L2 clip applied to each device's packed delta
    #     before the inner fold (0 = off): bounds any single device's
    #     pull on the silo's posted update.
    devices_per_silo: int = 1
    device_cohort_size: int = 0
    device_dropout: float = 0.0
    device_clip: float = 0.0

    @property
    def device_fleet(self) -> bool:
        """True when the job runs the inner cross-device tier."""
        return self.devices_per_silo > 1 or self.device_cohort_size > 0

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}

    @staticmethod
    def from_dict(d: dict) -> "FLJob":
        return FLJob(**{k: d[k] for k in FLJob.__dataclass_fields__
                        if k in d})


class JobCreator:
    def __init__(self, metadata: MetadataStore):
        self.metadata = metadata

    def from_contract(self, contract: GovernanceContract,
                      **overrides) -> FLJob:
        d = dict(contract.decisions)
        d.update(overrides)
        job = self._build(d, contract_id=contract.contract_id,
                          created_by="governance")
        self.metadata.record_provenance(
            actor="job_creator", operation="create_job_from_contract",
            subject=job.job_id, outcome="created",
            details={"contract": contract.contract_id, "arch": job.arch})
        return job

    def from_admin(self, admin: str, decisions: dict) -> FLJob:
        """SAAM task 7: the FL Server Administrator creates a (test) job."""
        from repro_torch.core.governance import DEFAULT_DECISIONS
        d = dict(DEFAULT_DECISIONS)
        d.update(decisions)
        job = self._build(d, created_by=admin)
        self.metadata.record_provenance(
            actor=admin, operation="create_job_manual", subject=job.job_id,
            outcome="created", details={"arch": job.arch})
        return job

    def _build(self, d: dict, contract_id=None, created_by="admin") -> FLJob:
        schema = d.get("data_schema")
        if isinstance(schema, DataSchema):
            schema = schema.to_dict()
        self._validate(d)
        return FLJob(
            job_id=f"job-{uuid.uuid4().hex[:8]}",
            arch=d["arch"],
            rounds=int(d["rounds"]),
            local_steps=int(d["local_steps"]),
            batch_size=int(d["batch_size"]),
            lr=float(d["lr"]),
            optimizer=d["optimizer"],
            outer_optimizer=d.get("outer_optimizer", "fedavg"),
            aggregation=d.get("aggregation", "fedavg"),
            train_test_split=float(d.get("train_test_split", 0.9)),
            eval_metrics=list(d.get("eval_metrics", ["ce"])),
            secure_aggregation=bool(d.get("secure_aggregation", True)),
            data_schema=schema,
            preprocessing=list(d.get("preprocessing", [])),
            hyperparameter_search=d.get("hyperparameter_search"),
            contract_id=contract_id,
            created_by=created_by,
            reduced=bool(d.get("reduced", True)),
            round_deadline_ticks=int(d.get("round_deadline_ticks", 0)),
            min_cohort=int(d.get("min_cohort", 1)),
            priority=int(d.get("priority", 0)),
            gc_round_resources=bool(d.get("gc_round_resources", False)),
            protocol=d.get("protocol", "sync"),
            async_buffer_size=int(d.get("async_buffer_size", 4)),
            compression=d.get("compression", "none"),
            compression_ratio=float(d.get("compression_ratio", 0.1)),
            quant_bits=int(d.get("quant_bits", 8)),
            quant_range=float(d.get("quant_range", 0.0)),
            dp_epsilon=float(d.get("dp_epsilon", 0.0)),
            dp_delta=float(d.get("dp_delta", 1e-5)),
            dp_clip=float(d.get("dp_clip", 1.0)),
            dp_seed=int(d.get("dp_seed", 0)),
            devices_per_silo=int(d.get("devices_per_silo", 1)),
            device_cohort_size=int(d.get("device_cohort_size", 0)),
            device_dropout=float(d.get("device_dropout", 0.0)),
            device_clip=float(d.get("device_clip", 0.0)),
        )

    def _reject(self, d: dict, subject, reason: str, message: str):
        """Record a matrix rejection on the provenance chain and raise.

        The provenance event carries the FULL offending decision
        combination in ``details`` (not just the subject): an auditor
        reconstructing why a negotiated pairing was refused needs the
        whole tuple, because the matrix rejects *combinations*, never
        individual values.
        """
        decisions = {
            "secure_aggregation": bool(d.get("secure_aggregation", True)),
            "compression": d.get("compression", "none"),
            "protocol": d.get("protocol", "sync"),
            "aggregation": d.get("aggregation", "fedavg"),
            "dp_epsilon": float(d.get("dp_epsilon", 0.0) or 0.0),
            "hyperparameter_search": bool(d.get("hyperparameter_search")),
        }
        # fleet keys join the snapshot only when a fleet is declared: a
        # flat job's offending combination doesn't involve them, and the
        # golden provenance tests pin the flat shape
        devices = int(d.get("devices_per_silo", 1))
        dev_cohort = int(d.get("device_cohort_size", 0))
        if devices > 1 or dev_cohort > 0:
            decisions["devices_per_silo"] = devices
            decisions["device_cohort_size"] = dev_cohort
        self.metadata.record_provenance(
            actor="job_creator", operation="create_job",
            subject=str(subject), outcome="rejected",
            details={"reason": reason, "decisions": decisions})
        raise ValueError(message)

    def _validate(self, d: dict):
        """Reject unsupported combinations at job creation, not mid-round.

        The compatibility matrix (DESIGN.md §Composable privacy) in one
        place: pairwise masks only telescope through a linear reduction
        (secure => fedavg) over a synchronized cohort (secure => sync);
        they survive int8 coding via integer-domain masking but NOT topk
        (index sets leak the update support); the DP noise stage rides
        the quantized integer plane (dp => int8 + sync). Every rejection
        lands a provenance event carrying the full decision combination
        (``_reject``); tests/test_composable_privacy.py pins the whole
        cross-product to a golden table so cell changes are deliberate.
        """
        secure = bool(d.get("secure_aggregation", True))
        agg = d.get("aggregation", "fedavg")
        compression = d.get("compression", "none")
        protocol = d.get("protocol", "sync")
        dp_epsilon = float(d.get("dp_epsilon", 0.0) or 0.0)
        if secure and agg != "fedavg":
            self._reject(
                d, agg, "secure_aggregation requires fedavg",
                f"secure_aggregation=True is incompatible with "
                f"aggregation={agg!r}: pairwise masks only cancel through "
                f"a linear reduction (use fedavg, or disable secure "
                f"aggregation for robust strategies)")
        deadline = int(d.get("round_deadline_ticks", 0))
        if deadline < 0:
            raise ValueError("round_deadline_ticks must be >= 0")
        if int(d.get("min_cohort", 1)) < 1:
            raise ValueError("min_cohort must be >= 1")
        from repro_torch.core.protocol import PROTOCOLS
        if protocol not in PROTOCOLS:
            raise ValueError(f"unknown protocol {protocol!r}; known: "
                             f"{sorted(PROTOCOLS)}")
        if protocol == "async_buff":
            # the server folds each update the moment it arrives, so it
            # sees individual (unmasked) contributions by construction —
            # pairwise masks cannot telescope across asynchronous folds
            if secure:
                self._reject(
                    d, protocol,
                    "async_buff requires secure_aggregation=False",
                    "protocol='async_buff' is incompatible with "
                    "secure_aggregation=True: buffered folds consume "
                    "updates one at a time, so pairwise masks never "
                    "cancel (disable secure aggregation for async jobs)")
            if agg != "fedavg":
                self._reject(
                    d, protocol, "async_buff requires fedavg",
                    f"protocol='async_buff' folds a weighted linear "
                    f"buffer (fedavg); aggregation={agg!r} is not "
                    f"supported asynchronously")
            if d.get("hyperparameter_search"):
                self._reject(
                    d, protocol,
                    "async_buff excludes hyperparameter_search",
                    "protocol='async_buff' does not support "
                    "hyperparameter_search (commits have no trial "
                    "boundary to restart from)")
            if int(d.get("async_buffer_size", 4)) < 1:
                raise ValueError("async_buffer_size must be >= 1")
        # --- hierarchical device fleets ----------------------------------
        # The inner tier is always plain FedAvg (see IntraSiloProtocol):
        # per-device deltas fold inside the silo's own trust domain, and
        # pairwise masks across ephemeral per-round device cohorts never
        # telescope — so there are no inner-tier privacy knobs to
        # negotiate, only fleet shape. The *outer* planes (secure-agg,
        # int8/topk, DP) compose unchanged: the silo posts one
        # pre-aggregated delta on the standard wire format.
        devices = int(d.get("devices_per_silo", 1))
        dev_cohort = int(d.get("device_cohort_size", 0))
        if devices < 1:
            raise ValueError("devices_per_silo must be >= 1")
        if dev_cohort < 0 or dev_cohort > devices:
            raise ValueError(
                "device_cohort_size must be in [0, devices_per_silo] "
                "(0 = the whole fleet)")
        if not 0.0 <= float(d.get("device_dropout", 0.0)) < 1.0:
            raise ValueError("device_dropout must be in [0, 1)")
        if float(d.get("device_clip", 0.0)) < 0:
            raise ValueError("device_clip must be >= 0")
        if (devices > 1 or dev_cohort > 0) and protocol == "async_buff":
            self._reject(
                d, protocol, "device_fleet requires protocol='sync'",
                f"devices_per_silo={devices} is incompatible with "
                f"protocol='async_buff': an inner round samples its "
                f"device cohort at an outer-round boundary, and the "
                f"buffered protocol's continuously-training silos have "
                f"no such boundary to sample against (negotiate "
                f"protocol='sync' for device fleets)")
        # --- compressed data plane compatibility matrix ------------------
        # allowed: plain/weighted sync fedavg, async_buff (staleness-
        # weighted folds consume dequantized deltas), secure+int8 (masks
        # drawn over the quantized integer domain cancel exactly under
        # the modular sum). Rejected: secure+topk (the index set IS the
        # update support — masking values cannot hide which coordinates
        # moved) and the robust sort-based strategies (they need the full
        # dense update matrix; sorting sparsified/quantized coordinates
        # is meaningless).
        from repro_torch.core.compression import SCHEMES
        if compression not in SCHEMES:
            raise ValueError(f"unknown compression {compression!r}; "
                             f"known: {sorted(SCHEMES)}")
        if compression != "none":
            if secure and compression != "int8":
                self._reject(
                    d, compression,
                    "secure_aggregation composes with int8 only: topk "
                    "index sets leak the update support",
                    f"compression={compression!r} is incompatible with "
                    f"secure_aggregation=True: a top-k message transmits "
                    f"the selected coordinate indices in the clear, so "
                    f"the update's support leaks regardless of masking "
                    f"(negotiate compression='int8', whose integer-domain "
                    f"masks cancel exactly under the modular sum)")
            if agg != "fedavg":
                self._reject(
                    d, compression, "compression requires fedavg",
                    f"compression={compression!r} reduces a weighted "
                    f"linear sum of dequantized deltas (fedavg); "
                    f"aggregation={agg!r} needs the full dense update "
                    f"matrix and is not supported compressed")
            ratio = float(d.get("compression_ratio", 0.1))
            if not 0.0 < ratio <= 1.0:
                raise ValueError("compression_ratio must be in (0, 1]")
            bits = int(d.get("quant_bits", 8))
            if not 2 <= bits <= 8:
                raise ValueError("quant_bits must be in [2, 8]")
        if float(d.get("quant_range", 0.0)) < 0:
            raise ValueError("quant_range must be >= 0")
        # --- DP noise stage ----------------------------------------------
        if dp_epsilon < 0:
            raise ValueError("dp_epsilon must be >= 0")
        if dp_epsilon > 0:
            if compression != "int8":
                self._reject(
                    d, compression,
                    "dp noise stage requires compression='int8'",
                    f"dp_epsilon={dp_epsilon} needs compression='int8': "
                    f"the clip+noise stage is calibrated on the packed "
                    f"quantized-integer plane, got "
                    f"compression={compression!r}")
            if protocol != "sync":
                self._reject(
                    d, protocol, "dp noise stage requires protocol='sync'",
                    f"dp_epsilon={dp_epsilon} needs protocol='sync': "
                    f"staleness-discounted asynchronous folds break the "
                    f"per-round sensitivity accounting")
            if not 0 < float(d.get("dp_delta", 1e-5)) < 1:
                raise ValueError("dp_delta must be in (0, 1)")
            if float(d.get("dp_clip", 1.0)) <= 0:
                raise ValueError("dp_clip must be > 0")
