"""FL Client (paper §VI): FL Pipeline, Client Model Deployer (manager,
personalization, decision maker, inference manager, model monitoring),
Communicator, Database Manager slice.

Like the server, the client is a cooperative state machine driven by
``tick()`` — every tick is one poll cycle against the message board. The
client is strictly *proactive*: it fetches configuration, models and status
and posts its own resources; nothing on the client runs because the server
asked it to (requirement 6).

Port of ``repro.core.client``: ``FLClientNode`` (the sync round, the
async loop, repair, eval, deploy, serving), ``ClientAgent`` and the
hierarchical tier (``DeviceNode``, ``InnerRoundEngine``). A node trains,
evaluates and serves on its ``device`` (default ``"cuda"``, which raises
without CUDA); the reference's jitted executables become the port's eager
loss and ``make_train_step``, shared per ``(arch, reduced, device)``.
Payloads cross into numpy only where they are posted on the board, and
fetched params go straight onto the device. A device-fleet silo folds its
devices' clipped deltas into ``MaskedF32Sink`` on its own device, so each
flush of up to ``DEFAULT_STREAM_BATCH`` deltas is one K1 launch.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.checkpoint import pytree_digest
from repro_torch.core import secure_agg, telemetry
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.communicator import ClientCommunicator
from repro_torch.core.packing import pack_pytree
from repro_torch.core.jobs import FLJob
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.validation import apply_preprocessing
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.training import make_train_step


@dataclass
class ClientConfig:
    deploy_threshold: float = 10.0     # max acceptable eval loss (CE)
    monitor_threshold: float = 12.0    # alert threshold for deployed model
    personalization_steps: int = 2     # local fine-tune steps on the release
    eval_batches: int = 2


# ---------------------------------------------------------------------------
# Shared model/step caches: the built model and its train step are pure
# functions of (arch, reduced, device, optimizer, lr), not of the job or the
# node, so every FLClientNode in the process shares one. Both caches are
# LRU-bounded, as in the reference.
# ---------------------------------------------------------------------------
_MODEL_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_STEP_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_MODEL_CACHE_MAX = 8
_STEP_CACHE_MAX = 32

# internal tag for the release fine-tune step — deliberately NOT a string,
# so it can never collide with a governance-negotiated job.optimizer value
PERSONALIZE = object()


class InnerRoundAborted(RuntimeError):
    """Raised by an inner-round boundary hook to kill a silo's round
    before anything is trained or posted (tier-aware fault injection:
    ``Consortium.run_to_completion(drop_at={org: ("inner_round", r)})``).
    The silo simply never posts — the server-side dropout machinery
    handles the disappearance like any other vanished client."""


def _lru_get(cache, key, build, cap):
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    value = cache[key] = build()
    while len(cache) > cap:
        cache.popitem(last=False)
    return value


def shared_model(arch: str, reduced: bool, device=DEFAULT_DEVICE):
    dev = resolve(device)

    def build():
        from repro_torch.configs import get_config
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
        model = build_model(cfg, device=dev)
        return (cfg, model, torch.no_grad()(model.loss_fn))
    return _lru_get(_MODEL_CACHE, (arch, bool(reduced), str(dev)), build,
                    _MODEL_CACHE_MAX)


def shared_step(arch: str, reduced: bool, optimizer, lr: float,
                device=DEFAULT_DEVICE):
    dev = resolve(device)

    def build():
        _, model, _ = shared_model(arch, reduced, dev)
        if optimizer is PERSONALIZE:
            opt = sgd(lr, momentum=0.0)   # release fine-tune: no momentum
        elif optimizer == "adamw":
            opt = adamw(lr, weight_decay=0.0)
        else:
            # any other negotiated value falls back to momentum-SGD, same
            # as the pre-cache behaviour (the string is not validated)
            opt = sgd(lr, momentum=0.9)
        return (opt, make_train_step(model, opt))
    key = (arch, bool(reduced), str(dev),
           "~personalize" if optimizer is PERSONALIZE else ("s:" + optimizer),
           float(lr))
    return _lru_get(_STEP_CACHE, key, build, _STEP_CACHE_MAX)


class FLClientNode:
    def __init__(self, client_id: str, comm: ClientCommunicator, dataset,
                 run_id: str, cohort: List[str], pair_secret: bytes,
                 config: Optional[ClientConfig] = None,
                 metadata: Optional[MetadataStore] = None,
                 device=DEFAULT_DEVICE):
        self.client_id = client_id
        self.device = resolve(device)
        self.comm = comm
        self.dataset = dataset
        self.run_id = run_id
        # board namespace root for this run's resources — mirror of
        # RunState.ns on the server side, so neither tier hardcodes the
        # "runs/<id>" layout
        self.ns = f"runs/{run_id}"
        self.cohort = sorted(cohort)
        self.pair_secret = pair_secret
        # `is None`, not truthiness — same guard as metadata below; a
        # falsy-but-real config must be adopted, not silently replaced
        self.config = ClientConfig() if config is None else config
        # the federation-wide observability bundle rides the board — the
        # same instance the scheduler and servers stamp their spans on
        self.telemetry = comm.board.telemetry
        # `is None`, not truthiness: the agent shares its (possibly still
        # empty, hence falsy) store across this silo's nodes — replacing
        # it would split the silo's provenance trail per run
        self.metadata = MetadataStore() if metadata is None else metadata
        # pipeline state
        self.job: Optional[FLJob] = None
        self.model = None
        self._train_step = None
        self._opt = None
        self.opt_state = None
        self.round_done = -1
        self.hp_seen = 0
        self.eval_done = -1
        self.eval_hp = 0
        self.said_hello = False
        self.posted_stats = False
        # compressed data plane (DESIGN.md §Compressed data plane):
        # error-feedback residual state, created with the job
        self._ef = None
        # liveness + dropout repair (DESIGN.md §Dropout-tolerant rounds)
        self._hb = 0
        self._packed_size: Optional[int] = None
        self._repair_done = None            # (hp, round, epoch) last posted
        self._attempt_seen = 0              # server round_attempt mirrored
        # hierarchical device fleet (DESIGN.md §Hierarchical federation):
        # built with the job when it negotiates devices_per_silo > 1 (or
        # an explicit device_cohort_size); inner_hooks fire at inner-round
        # boundaries — the tier-aware analogue of the scheduler's
        # on_phase callback (Consortium wires drop_at through them)
        self.fleet = None
        self.inner_hooks: List = []
        # deployment state
        self.deployed_params = None
        self.deployed_digest: Optional[str] = None
        self.monitor_history: List[dict] = []
        self.notifications: List[str] = []
        self._fixed_eval_batch = None

    # ------------------------------------------------------------------
    def tick(self) -> str:
        """One poll cycle. Returns a short description of what happened.
        The board's telemetry is in scope (``telemetry.scope``), so the
        train step, the pack and mask and the sinks record under this
        node's spans (``client.train``, ``client.compress``)."""
        with telemetry.scope(self.telemetry):
            return self._poll()

    def _poll(self) -> str:
        # heartbeat first: the server watches the refresh stamp to tell
        # slow from gone when a round deadline expires. Posted while the
        # job is still unknown (the waiting_clients phase needs liveness
        # too) and skipped entirely for jobs that run without deadlines.
        if self.job is None or self.job.round_deadline_ticks:
            self._hb += 1
            self.comm.heartbeat(self.run_id, self._hb)
        if self.job is None:
            job_d = self.comm.fetch(f"{self.ns}/job",
                                    broadcast=True)
            if job_d is None:
                return "waiting_job"
            self._setup_job(FLJob.from_dict(job_d))
            return "job_fetched"
        if not self.said_hello:
            self.comm.post(f"{self.ns}/hello/{self.client_id}",
                           {"client": self.client_id})
            self.said_hello = True
            return "hello"
        if not self.posted_stats and self.job.data_schema is not None:
            stats = dict(self.dataset.stats())
            declared = getattr(self.dataset, "n_examples", None)
            stats["n_examples"] = declared if declared is not None else 10 ** 6
            self.comm.post(f"{self.ns}/validation/{self.client_id}",
                           stats)
            self.posted_stats = True
            self.metadata.record_provenance(
                actor=self.client_id, operation="post_data_stats",
                subject=self.run_id, outcome="posted")
            return "stats_posted"

        # conditional fetch: status is polled every tick but changes at
        # most once per round — unchanged ticks cost a metadata round
        # trip, not a re-download + decrypt
        status = self.comm.fetch_cached(f"{self.ns}/status",
                                        broadcast=True)
        if status is None:
            return "waiting_status"
        attempt = status.get("attempt", 0)
        if attempt != self._attempt_seen:
            # the admin resumed an interrupted round: the server re-runs it
            # with the surviving cohort, so local round/eval state resets
            self._attempt_seen = attempt
            self.round_done = -1
            self.eval_done = -1
            self._repair_done = None
            if self._ef is not None:
                # the aborted attempt's posted update was wiped server-side,
                # so the residual refers to mass the server never folded
                self._ef.reset()
        phase = status["phase"]
        if phase == "paused":
            self._notify(f"run paused: {status.get('pause_reason')}")
            return "paused"
        if phase in ("collect", "distribute"):
            return self._do_round(status)
        if phase == "repair":
            return self._do_repair(status)
        if phase == "async_serve":
            return self._do_async(status)
        if phase == "evaluate":
            return self._do_eval(status)
        if phase == "done":
            return self._do_deploy()
        return f"idle({phase})"

    # ------------------------------------------------------------------
    def _setup_job(self, job: FLJob):
        self.job = job
        # models and steps are shared process-wide: a silo serving N
        # concurrent jobs on one architecture builds them once, not N times
        self.cfg, self.model, self._loss_jit = shared_model(
            job.arch, job.reduced, self.device)
        if job.compression != "none":
            from repro_torch.core.compression import make_error_feedback
            # noise streams (stochastic rounding, DP) key off the silo's
            # stable identity, not the registered device id — device ids
            # are minted fresh every registration (clients.py uuid), and
            # reproducibility (twin runs, fixed-seed DP benches) needs a
            # re-run over the same silo to draw the same streams
            noise_id = str(getattr(self.dataset, "silo_id", None)
                           or self.client_id)
            self._ef = make_error_feedback(job, noise_id,
                                           device=self.device)
        if job.device_fleet:
            # device-fleet mode: this silo fronts its own cross-device
            # population. Sharding is keyed by the silo dataset's seed so
            # twin runs over the same silos sample the same fleets.
            from repro_torch.data.synthetic import make_device_shards
            self.fleet = make_device_shards(
                self.dataset, job.devices_per_silo,
                seed=int(getattr(self.dataset, "seed", 0)))
        self.metadata.record_provenance(
            actor=self.client_id, operation="fetch_job", subject=job.job_id,
            outcome="configured", details={"arch": job.arch})

    def _get_step(self, lr: float):
        return shared_step(self.job.arch, self.job.reduced,
                           self.job.optimizer, lr, self.device)

    def _batch_from(self, dataset):
        batch = dataset.batch(self.job.batch_size)
        if self.job.preprocessing:
            batch = apply_preprocessing(batch, self.job.preprocessing)
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def _local_batch(self):
        return self._batch_from(self.dataset)

    def _fit(self, dataset, base_params, lr: float):
        """Model Trainer: the job's local steps on ``dataset``, from
        ``base_params``. Returns ``(params, loss, n_examples)`` —
        n_examples is the nominal training budget capped by the dataset's
        declared size (a silo or device smaller than the budget carries
        proportionally less FedAvg weight; for masked rounds the silo's
        pre-scale factor stays <= 1, so masking strength is preserved).
        One loop for every tier and protocol: the flat sync round, the
        async continuous loop and each simulated device's inner-round
        training all run exactly this, so tiers can never drift on
        training/weighting semantics."""
        opt, train_step = self._get_step(lr)
        params = base_params
        opt_state = opt.init(params)
        loss = np.nan
        for _ in range(self.job.local_steps):
            batch = self._batch_from(dataset)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
        n_examples = self.job.local_steps * self.job.batch_size
        declared = getattr(dataset, "n_examples", None)
        if declared is not None:             # 0 means a truly empty silo
            n_examples = min(n_examples, int(declared))
        return params, loss, n_examples

    def run_inner_round(self, base_params, lr: float, rnd: int = 0):
        """The round's local contribution, tier-aware.

        Flat silo (no device fleet): one ``_fit`` over the silo's own
        data. Device-fleet mode: drive the ``IntraSiloProtocol`` over a
        sampled device cohort via an ``InnerRoundEngine`` and return the
        silo's pre-aggregated result. Either way the return contract is
        ``(params, loss, n_examples)``, so the outer wire format — and
        everything layered on it: secure-agg, int8/topk compression, DP
        — composes without knowing the silo is a mini-aggregator.

        ``inner_hooks`` fire at the boundary (both modes, so tier-aware
        ``drop_at`` specs behave uniformly); a hook may raise
        ``InnerRoundAborted`` to kill this silo's round before anything
        is trained or posted.
        """
        for hook in list(self.inner_hooks):
            hook(self.client_id, rnd, "enter")
        if self.fleet is None:
            result = self._fit(self.dataset, base_params, lr)
            for hook in list(self.inner_hooks):
                hook(self.client_id, rnd, "exit")
            return result
        engine = InnerRoundEngine(self, rnd, lr, base_params)
        tel = self.telemetry
        with tel.span("client.inner_round", cat="client",
                      actor=self.client_id, run_id=self.run_id,
                      attrs={"round": rnd}) as sp:
            params, loss, n_examples = engine.run()
            sp.set(sampled=len(engine.cohort), dropped=len(engine.dropped),
                   folded=engine.folded, loss=float(loss))
        per_sec = engine.folded / engine.elapsed if engine.elapsed else 0.0
        # span, counter and provenance names are the reference's: the
        # telemetry tests and chip_smoke.py read them
        m = tel.metrics
        m.counter("fleet.devices_folded").inc(engine.folded)
        m.counter("fleet.devices_dropped").inc(len(engine.dropped))
        m.counter("fleet.inner_rounds").inc()
        self.metadata.record_provenance(
            actor=self.client_id, operation="inner_round",
            subject=f"{self.run_id}/r{rnd}", outcome="folded",
            details={"round": rnd, "sampled": len(engine.cohort),
                     "dropped": len(engine.dropped),
                     "folded": engine.folded,
                     "devices_per_sec": per_sec,
                     "peak_fold_bytes": engine.peak_fold_bytes})
        for hook in list(self.inner_hooks):
            hook(self.client_id, rnd, "exit")
        return params, loss, n_examples

    def _do_round(self, status) -> str:
        rnd, hp = status["round"], status["hp_index"]
        if self.round_done >= rnd and self.hp_seen == hp:
            return "round_already_done"
        base = f"{self.ns}/round/{hp}/{rnd}"
        tel = self.telemetry
        with tel.span("client.fetch", cat="client", actor=self.client_id,
                      run_id=self.run_id, attrs={"round": rnd}):
            msg = self.comm.fetch(f"{base}/global", broadcast=True)
        if msg is None:
            return "waiting_global"
        base_params = params_from_numpy(msg["params"], self.device)
        try:
            with tel.span("client.train", cat="client",
                          actor=self.client_id, run_id=self.run_id,
                          attrs={"round": rnd}) as sp:
                params, loss, n_examples = self.run_inner_round(
                    base_params, float(status.get("lr", self.job.lr)), rnd)
                sp.set(loss=float(loss))
        except InnerRoundAborted:
            # a boundary hook killed this silo's round (tier-aware fault
            # injection): vanish without posting — the server's dropout
            # machinery takes it from here
            return "inner_round_aborted"
        comp_sp = tel.span("client.compress", cat="client",
                           actor=self.client_id, run_id=self.run_id,
                           attrs={"round": rnd})
        comp_sp.__enter__()
        if self.job.secure_aggregation and self.job.compression != "none":
            # masked-quantized plane (DESIGN.md §Composable privacy): the
            # error-feedback compressor quantizes the weighted packed
            # *delta* onto the cohort-common fixed grid, optionally adds
            # integer-domain DP noise, and masks the widened stream mod
            # 2**mbits against *this round's* cohort — the server's
            # modular sum cancels the masks bit-exactly and decodes one
            # cohort total. Pre-scaling by n_examples/weight_denom keeps
            # weighted FedAvg exact under the uniform modular sum, same
            # as the fp32 masked plane below.
            from repro_torch.core.protocol import pack_delta
            round_cohort = sorted(msg.get("cohort") or self.cohort)
            weight = n_examples / float(
                msg.get("weight_denom")
                or (self.job.local_steps * self.job.batch_size))
            if self.hp_seen != hp:
                self._ef.reset()
            delta = pack_delta(params, base_params)
            self._packed_size = int(delta.numel())
            payload = {"comp": self._ef.step_masked(
                           delta, weight=weight, client_id=self.client_id,
                           cohort=round_cohort,
                           pair_secret=self.pair_secret),
                       "n_examples": n_examples, "train_loss": loss}
        elif self.job.secure_aggregation:
            # packed data plane: flatten once, mask the whole buffer in one
            # vectorized pass, post the (T,) fp32 buffer — the server never
            # sees per-tensor structure of the masked update. Masks are
            # derived against *this round's* cohort (it shrinks when peers
            # drop out), and the update is pre-scaled by
            # n_examples/weight_denom so the server's uniform-weight sum
            # is exact weighted FedAvg (masks cancel only under equal
            # server-side weights).
            round_cohort = sorted(msg.get("cohort") or self.cohort)
            weight = n_examples / float(
                msg.get("weight_denom")
                or (self.job.local_steps * self.job.batch_size))
            buf, _ = pack_pytree(params)
            self._packed_size = int(buf.shape[0])
            masked = secure_agg.mask_packed(
                buf * weight, self.client_id, round_cohort,
                self.pair_secret, device=self.device)
            payload = {"packed": masked.cpu().numpy(),
                       "n_examples": n_examples, "train_loss": loss}
        elif self.job.compression != "none":
            # compressed data plane: post the error-feedback-corrected,
            # lossy-coded packed *delta* (the server reconstructs
            # base + weighted-mean delta — algebraically the same FedAvg).
            # A hyperparameter restart jumps the global back to init, so
            # the carried residual is stale and is dropped with it.
            from repro_torch.core.protocol import pack_delta
            if self.hp_seen != hp:
                self._ef.reset()
            payload = {"comp": self._ef.step(pack_delta(params,
                                                        base_params)),
                       "n_examples": n_examples, "train_loss": loss}
        else:
            payload = {"params": params_to_numpy(params),
                       "n_examples": n_examples, "train_loss": loss}
        comp_sp.__exit__(None, None, None)
        with tel.span("client.post", cat="client", actor=self.client_id,
                      run_id=self.run_id, attrs={"round": rnd}):
            self.comm.post(f"{base}/update/{self.client_id}", payload)
        self.round_done, self.hp_seen = rnd, hp
        self.metadata.record_provenance(
            actor=self.client_id, operation="local_train",
            subject=f"{self.run_id}/r{rnd}", outcome="update_posted",
            details={"loss": loss, "masked": self.job.secure_aggregation})
        return "update_posted"

    def _do_async(self, status) -> str:
        """Continuous-train loop for async buffered jobs (DESIGN.md
        §Protocol programs): every tick, fetch the *latest committed*
        global (the commit index rides the status resource), run the
        local steps, and post the packed parameter *delta* tagged with
        the commit it was trained from — the server discounts it by how
        far the global has moved by the time it folds it. No per-round
        done-marker: an async client trains as fast as its own poll
        cadence allows, which is exactly the heterogeneity the protocol
        absorbs (fast silos contribute more updates, slow silos' stale
        updates are down-weighted, nobody stalls anybody)."""
        rnd, hp = status["round"], status["hp_index"]
        base = f"{self.ns}/round/{hp}/{rnd}"
        # an async silo contributes several updates against one commit's
        # global — conditional fetch re-downloads it only when the server
        # actually committed a new one
        msg = self.comm.fetch_cached(f"{base}/global", broadcast=True)
        if msg is None:
            return "waiting_global"
        tel = self.telemetry
        base_params = params_from_numpy(msg["params"], self.device)
        try:
            with tel.span("client.train", cat="client",
                          actor=self.client_id, run_id=self.run_id,
                          attrs={"base_commit": rnd}) as sp:
                params, loss, n_examples = self.run_inner_round(
                    base_params, float(status.get("lr", self.job.lr)), rnd)
                sp.set(loss=float(loss))
        except InnerRoundAborted:
            return "inner_round_aborted"
        from repro_torch.core.protocol import pack_delta
        delta = pack_delta(params, base_params)
        if self.job.compression != "none":
            # same error-feedback state as the sync path. Telescoping
            # assumes every post gets folded; async posts overwrite in
            # place, so a deployment where clients post faster than the
            # server folds would drop overwritten posts' mass (here the
            # scheduler folds between client passes, so each post lands)
            payload = {"comp": self._ef.step(delta), "base_commit": rnd,
                       "n_examples": n_examples, "train_loss": loss}
        else:
            payload = {"delta": delta.cpu().numpy(), "base_commit": rnd,
                       "n_examples": n_examples, "train_loss": loss}
        with tel.span("client.post", cat="client", actor=self.client_id,
                      run_id=self.run_id, attrs={"base_commit": rnd}):
            self.comm.post(
                f"{self.ns}/async/update/{self.client_id}", payload)
        self.metadata.record_provenance(
            actor=self.client_id, operation="local_train_async",
            subject=f"{self.run_id}/c{rnd}", outcome="update_posted",
            details={"loss": loss, "base_commit": rnd})
        return "async_update_posted"

    def _do_repair(self, status) -> str:
        """Dropout repair (DESIGN.md §Dropout-tolerant rounds): re-derive
        my pairwise masks against the dropped peers and post the packed
        correction buffer so the server can telescope the survivor sum."""
        rnd, hp = status["round"], status["hp_index"]
        base = f"{self.ns}/round/{hp}/{rnd}"
        info = self.comm.fetch(f"{base}/dropout", broadcast=True)
        if info is None:
            return "waiting_dropout"
        key = (hp, rnd, info["epoch"])
        if self._repair_done == key:
            return "repair_already_done"
        if self.client_id not in info["survivors"]:
            return "not_a_survivor"
        size = self._packed_size
        if size is None:                     # lost state? derive the length
            glob = self.comm.fetch(f"{base}/global",  # from the round's
                                   broadcast=True)    # global model
            if glob is None:
                return "waiting_global_repair"
            size = self._packed_size = int(sum(
                np.asarray(l).size
                for l in _tree.leaves(glob["params"])))
        if self.job.compression != "none":
            # masked-quantized plane: the correction is an integer mask
            # stream over the padded buffer, mod the same modulus both
            # endpoints derive from the *round* cohort (survivors plus
            # dropped — the cohort the orphaned masks were drawn against)
            from repro_torch.core import compression
            tpad = size + (-size) % compression.CHUNK
            mbits = secure_agg.mask_modulus_bits(
                len(info["survivors"]) + len(info["dropped"]),
                self.job.quant_bits)
            corr = secure_agg.int_repair_correction(
                tpad, self.client_id, info["dropped"], self.pair_secret,
                mbits, device=self.device)
            wire_dtype = np.uint16 if mbits <= 16 else np.uint32
            # the uint32 tensor's bits, viewed on the host as uint32
            corr = corr.view(torch.int32).cpu().numpy().view(np.uint32)
            payload = {"correction": (corr & np.uint32((1 << mbits) - 1)
                                      ).astype(wire_dtype),
                       "mbits": mbits}
        else:
            corr = secure_agg.repair_correction(
                size, self.client_id, info["dropped"], self.pair_secret,
                device=self.device)
            payload = {"correction": corr.cpu().numpy()}
        self.comm.post(f"{base}/repair/{info['epoch']}/{self.client_id}",
                       payload)
        self._repair_done = key
        self.metadata.record_provenance(
            actor=self.client_id, operation="mask_repair",
            subject=f"{self.run_id}/r{rnd}", outcome="correction_posted",
            details={"dropped": list(info["dropped"]),
                     "epoch": info["epoch"]})
        return "repair_posted"

    def _eval_params(self, params, batches: int) -> float:
        losses = []
        for _ in range(batches):
            batch = self._local_batch()
            loss, _ = self._loss_jit(params, batch)
            losses.append(float(loss))
        return float(np.mean(losses))

    def _do_eval(self, status) -> str:
        rnd, hp = status["round"], status["hp_index"]
        if self.eval_done >= rnd and self.eval_hp == hp:
            return "eval_already_done"
        base = f"{self.ns}/round/{hp}/{rnd}"
        # Model Evaluator: private held-out batches on the latest global
        # (the new aggregate is distributed next round; this round's global
        # is the model this client can evaluate without a push)
        rel = self.comm.fetch(f"{base}/global", broadcast=True)
        if rel is None:
            return "waiting_global_eval"
        params = params_from_numpy(rel["params"], self.device)
        eval_loss = self._eval_params(params, self.config.eval_batches)
        self.comm.post(f"{base}/eval/{self.client_id}",
                       {"eval_loss": eval_loss})
        self.eval_done, self.eval_hp = rnd, hp
        return "eval_posted"

    # ------------------------------------------------------------------
    # Client Model Deployer (paper §VI)
    # ------------------------------------------------------------------
    def _do_deploy(self) -> str:
        if self.deployed_digest is not None:
            return self._monitor_deployed()
        rel = self.comm.fetch(f"{self.ns}/release", broadcast=True)
        blob = self.comm.fetch(f"{self.ns}/release/params",
                               broadcast=True)
        if rel is None or blob is None:
            return "waiting_release"
        params = params_from_numpy(blob["params"], self.device)
        # --- Model Personalization -------------------------------------
        personalized = self._personalize(params)
        # --- Decision Maker ---------------------------------------------
        eval_loss = self._eval_params(personalized,
                                      self.config.eval_batches)
        if eval_loss <= self.config.deploy_threshold:
            self.deployed_params = personalized
            self.deployed_digest = pytree_digest(personalized)
            self.metadata.record_provenance(
                actor=self.client_id, operation="deploy_model",
                subject=blob["digest"], outcome="deployed",
                details={"eval_loss": eval_loss,
                         "personalized_digest": self.deployed_digest})
            return "deployed"
        self._notify(
            f"model rejected by decision maker: eval {eval_loss:.3f} > "
            f"threshold {self.config.deploy_threshold}")
        self.metadata.record_provenance(
            actor=self.client_id, operation="deploy_model",
            subject=blob["digest"], outcome="rejected",
            details={"eval_loss": eval_loss})
        self.deployed_digest = "rejected"
        return "rejected"

    def _personalize(self, params):
        if self.config.personalization_steps <= 0:
            return params
        opt, step = shared_step(self.job.arch, self.job.reduced,
                                PERSONALIZE, 1e-4, self.device)
        opt_state = opt.init(params)
        for _ in range(self.config.personalization_steps):
            params, opt_state, _ = step(params, opt_state,
                                        self._local_batch())
        return params

    def _monitor_deployed(self) -> str:
        """Model Monitoring: fixed test set, alert past threshold."""
        if self.deployed_params is None:
            return "nothing_deployed"
        if self._fixed_eval_batch is None:
            self._fixed_eval_batch = self._local_batch()
        loss, _ = self._loss_jit(self.deployed_params,
                                 self._fixed_eval_batch)
        entry = {"eval_loss": float(loss)}
        self.monitor_history.append(entry)
        if float(loss) > self.config.monitor_threshold:
            self._notify(f"deployed model degraded: {float(loss):.3f} > "
                         f"{self.config.monitor_threshold}")
        return "monitored"

    def _notify(self, message: str):
        """Trigger administrator notification (SAAM task 39)."""
        self.notifications.append(message)
        self.metadata.record_provenance(
            actor=self.client_id, operation="notify_admin", subject="alert",
            outcome="raised", details={"message": message})

    # ------------------------------------------------------------------
    # Inference Manager + Model Subscription API (SAAM tasks 35/40)
    # ------------------------------------------------------------------
    def predict(self, tokens: np.ndarray, n_steps: int = 4) -> np.ndarray:
        """Serve the deployed model: greedy continuation of ``tokens``.

        Follows the reference's positions: the cache holds ``S + n_steps``
        positions and the i-th decode step sits at ``S + i``, leaving out
        the model's meta tokens. ``launch/serve.py`` counts them instead
        (``tests/test_torch_serve.py::test_serve_positions_count_meta_tokens``),
        so for a model with meta tokens (``hymba-1.5b``) the two differ;
        ``predict`` stays the reference's twin (``tests/test_torch_serve.py::
        test_client_predict_matches_reference_on_hymba``)."""
        if self.deployed_params is None:
            raise RuntimeError("no model deployed")
        m = self.model
        params = self.deployed_params
        B, S = tokens.shape
        cache_len = m.cache_len_for(S + n_steps)
        batch = {"tokens": torch.from_numpy(np.asarray(tokens))}
        out = []
        with torch.no_grad(), telemetry.scope(self.telemetry):
            logits, cache = m.prefill(params, batch, cache_len)
            tok = torch.argmax(logits, -1).to(torch.int32)
            for i in range(n_steps):
                out.append(tok.cpu().numpy()[:, 0])
                pos = torch.full((B, 1), S + i, dtype=torch.int32,
                                 device=self.device)
                logits, cache = m.decode_step(params, cache, tok, pos)
                tok = torch.argmax(logits, -1).to(torch.int32)
        return np.stack(out, axis=1)


class DeviceNode:
    """One simulated edge device in a silo's fleet (DESIGN.md
    §Hierarchical federation). Deliberately tiny: it owns nothing but its
    identity and its lazily-materialized data shard — the train step is
    the process-wide ``shared_step`` and the silo's ``InnerRoundEngine``
    drives sampling, clipping and folding. ``__slots__`` because a
    10k-device fleet materializes one of these per sampled device per
    round."""

    __slots__ = ("device_index", "shard")

    def __init__(self, device_index: int, shard):
        self.device_index = device_index
        self.shard = shard

    def train(self, node: "FLClientNode", base_params, lr: float):
        """The device's local steps: exactly the silo's ``_fit`` loop on
        the device's own shard, so the two tiers can never drift on
        training/weighting semantics."""
        return node._fit(self.shard, base_params, lr)


class InnerRoundEngine:
    """Silo-side executor of the ``IntraSiloProtocol`` — the inner-tier
    mirror of ``FLServer.tick()``'s thin-executor contract: the protocol's
    phases own the round shape (sample → train/fold → done), the engine
    just holds the inner round's state and polls the active phase.

    The fold is the same O(T) streaming discipline the outer server uses
    (``core/streaming.py``): each device's clipped packed delta folds
    into a ``MaskedF32Sink`` on the silo's device, weighted by its example
    count, the moment the device finishes training, then is dropped — the
    engine never holds a (K, T) cohort matrix, and each flush of up to
    ``DEFAULT_STREAM_BATCH`` staged deltas is one K1 launch on the card.
    """

    # bounded training batch per poll: ticks stay cooperative, so a silo
    # agent can interleave other jobs between inner polls if it drives
    # the engine tick-by-tick instead of via run()
    DEVICES_PER_POLL = 32

    def __init__(self, node: FLClientNode, rnd: int, lr: float,
                 base_params):
        from repro_torch.core.protocol import IntraSiloProtocol
        self.node = node
        self.job = node.job
        self.round = int(rnd)
        self.lr = float(lr)
        self.base_params = base_params
        self.protocol = IntraSiloProtocol()
        self.phase = self.protocol.initial
        self.cohort: List[int] = []       # sampled device indices
        self.dropped: List[int] = []      # Bernoulli-dropped subset
        self._queue: List[int] = []       # survivors still to train
        self._single_mode = False
        self._single = None               # (params, loss, n) shortcut
        self.sink = None                  # lazy MaskedF32Sink
        self.folded = 0
        self.loss_sum = 0.0
        self.weight_sum = 0
        self.elapsed = 0.0

    @property
    def peak_fold_bytes(self) -> int:
        """The sink's high-water mark: the (T,) accumulator plus the rows
        staged at a flush, at most ``DEFAULT_STREAM_BATCH`` (36·T bytes,
        4.19 GB at ``fedforecast-100m`` width, whatever the cohort). On
        the card the flush's ``torch.stack`` copy of the staged rows comes
        on top, and each training device holds its params, grads and AdamW
        moments (about 1.9 GB at that width)."""
        return 0 if self.sink is None else int(self.sink.peak_bytes)

    # --- executor ------------------------------------------------------
    def tick(self) -> str:
        """One poll cycle, same transition contract as FLServer.tick()."""
        nxt = self.protocol.phase(self.phase).poll(self)
        if nxt is not None and nxt != self.phase:
            self.phase = nxt
            self.protocol.phase(self.phase).enter(self)
        return self.phase

    def _wait_for_card(self):
        # the reference blocks on every step's loss; here the last K1
        # flush and the unpack may still be queued on the card, and a
        # clock read before they finish would overstate devices_per_sec
        # and shorten the client.inner_round span
        if self.sink is not None and self.sink.device.type == "cuda":
            torch.cuda.synchronize(self.sink.device)

    def run(self):
        """Drive the inner protocol to its terminal phase and return the
        silo's pre-aggregated ``(params, loss, n_examples)``."""
        t0 = time.perf_counter()
        while not self.protocol.phase(self.phase).terminal:
            self.tick()
        self._wait_for_card()
        self.elapsed = time.perf_counter() - t0
        out = self.result()
        self._wait_for_card()
        return out

    # --- phase callbacks (invoked by the IntraSiloProtocol phases) -----
    def sample_cohort(self):
        from repro_torch.core import protocol
        job, node = self.job, self.node
        silo = getattr(node.dataset, "silo_id", node.client_id)
        seed = int(getattr(node.dataset, "seed", 0))
        self.cohort = protocol.sample_device_cohort(
            silo, seed, self.round, job.devices_per_silo,
            job.device_cohort_size)
        self.dropped = protocol.sample_device_dropout(
            silo, seed, self.round, self.cohort, job.device_dropout)
        gone = set(self.dropped)
        self._queue = [d for d in self.cohort if d not in gone]
        # exactly one surviving device: return its trained params as-is.
        # The mean of one delta IS that delta, and skipping the
        # pack/unpack round trip keeps the degenerate one-device fleet
        # bit-for-bit identical to the flat silo (the twin tests' anchor,
        # on the CPU and on the card, where training repeats bitwise)
        self._single_mode = len(self._queue) == 1

    def train_some(self) -> bool:
        take = self._queue[:self.DEVICES_PER_POLL]
        self._queue = self._queue[self.DEVICES_PER_POLL:]
        for idx in take:
            self._train_device(idx)
        return not self._queue

    def _train_device(self, idx: int):
        node = self.node
        dev = DeviceNode(idx, node.fleet.shard(idx, self.round))
        tel = node.telemetry
        with tel.span("device.train", cat="device",
                      actor=f"{node.client_id}/dev{idx}",
                      run_id=node.run_id,
                      attrs={"round": self.round, "device": idx}) as sp:
            params, loss, n = dev.train(node, self.base_params, self.lr)
            sp.set(loss=float(loss), n_examples=int(n))
        self.loss_sum += float(loss) * int(n)
        self.weight_sum += int(n)
        self.folded += 1
        if self._single_mode:
            self._single = (params, float(loss), int(n))
            return
        from repro_torch.core.protocol import pack_delta
        delta = pack_delta(params, self.base_params)
        clip = float(self.job.device_clip)
        if clip > 0.0:
            # the reference's norm is numpy's float32 dot (BLAS sdot);
            # torch sums in another order, so a clipped delta differs from
            # the reference's at the 1e-7 relative level (its twins hold
            # 1e-4). The scale is formed as the reference forms it: clip /
            # norm in f64, rounded to f32
            norm = float(torch.linalg.vector_norm(delta))
            if norm > clip:
                delta.mul_(float(np.float32(clip / norm)))
        if self.sink is None:
            from repro_torch.core import streaming
            self.sink = streaming.MaskedF32Sink(
                delta.shape[0], device=delta.device, telemetry=tel,
                run_id=node.run_id)
        self.sink.fold(delta, float(n))

    def result(self):
        if self._single is not None:
            return self._single
        if self.sink is None:
            raise RuntimeError("inner round folded no devices")
        from repro_torch.core.packing import PackedLayout, unpack_pytree
        loss = self.loss_sum / float(self.weight_sum)
        # weighted FedAvg over the surviving device cohort: the sink's
        # weighted sum of clipped deltas divided by the total example
        # weight, applied to the silo's base params
        from repro_torch.core.protocol import _f32_scalar
        total = self.sink.finalize()
        mean = total / _f32_scalar(self.weight_sum, total.device)
        layout = PackedLayout.for_tree(self.base_params)
        delta_tree = unpack_pytree(mean, layout)
        params = _tree.tree_map(
            lambda p, d: p.to(torch.float32)
            + d.to(p.device, torch.float32).reshape(p.shape),
            self.base_params, delta_tree)
        return params, float(loss), int(self.weight_sum)


class OversubscribedError(RuntimeError):
    """A silo was asked to serve more concurrent jobs than it declared."""


class ClientAgent:
    """Silo-side job agent (DESIGN.md §Federation scheduler).

    One agent per silo: it owns the silo's single identity — client id,
    device token, communicator — and multiplexes it across the concurrent
    FL jobs the federation scheduler admitted onto this silo, one
    ``FLClientNode`` per run. ``capacity`` is the silo's declared ceiling
    on concurrent local trainings; ``attach`` refuses to exceed it, so
    even a buggy scheduler cannot oversubscribe a silo from the client
    side. ``tick_every`` models silo-side poll latency (a slow silo polls
    the board every k-th scheduler pass) — the event-driven server loop
    skips runs that are only waiting on such silos.
    """

    def __init__(self, client_id: str, comm: ClientCommunicator, dataset,
                 *, capacity: int = 1, config: Optional[ClientConfig] = None,
                 metadata: Optional[MetadataStore] = None,
                 tick_every: int = 1, device=DEFAULT_DEVICE):
        self.client_id = client_id
        self.device = resolve(device)
        self.comm = comm
        self.dataset = dataset
        self.capacity = int(capacity)
        self.config = config
        # `is None`, not truthiness (the thrice-fixed bug class, now
        # guarded by tests/test_truthiness_guard.py): the scheduler hands
        # every agent the federation's shared — and initially empty,
        # hence falsy — MetadataStore; `or` would silently replace it and
        # split this silo's provenance off the shared trail
        self.metadata = MetadataStore() if metadata is None else metadata
        self.tick_every = max(1, int(tick_every))
        self.nodes: Dict[str, FLClientNode] = {}    # run_id -> node (kept
        self.active: List[str] = []                 # after release, for
        self.ticks = 0                              # audit/inspection)

    @property
    def load(self) -> int:
        return len(self.active)

    def node(self, run_id: str) -> FLClientNode:
        return self.nodes[run_id]

    def attach(self, run_id: str, cohort: List[str], pair_secret: bytes, *,
               dataset=None, config: Optional[ClientConfig] = None
               ) -> FLClientNode:
        """Start (or resume) serving a run. Reuses the run's existing node
        on re-admission so pipeline state (round markers, deployment)
        survives suspension."""
        if run_id not in self.active:
            if self.load >= self.capacity:
                raise OversubscribedError(
                    f"silo {self.client_id} already serves {self.load} "
                    f"concurrent jobs (declared capacity {self.capacity})")
            self.active.append(run_id)
        if run_id not in self.nodes:
            self.nodes[run_id] = FLClientNode(
                self.client_id, self.comm,
                dataset if dataset is not None else self.dataset,
                run_id, cohort, pair_secret,
                config=config or self.config, metadata=self.metadata,
                device=self.device)
        return self.nodes[run_id]

    def release(self, run_id: str):
        """Stop serving a run (completion, suspension, or dropout). The
        node object stays around for inspection and future re-attach."""
        if run_id in self.active:
            self.active.remove(run_id)

    def tick(self, scheduler_pass: Optional[int] = None) -> str:
        if scheduler_pass is not None and scheduler_pass % self.tick_every:
            return "throttled"
        self.ticks += 1
        for run_id in list(self.active):
            try:
                self.nodes[run_id].tick()
            except PermissionError:
                # identity revoked mid-run: this silo is out of the
                # federation. Stop serving every run (each job's dropout
                # machinery handles the disappearance); one revoked silo
                # must not crash the whole in-process loop.
                self.metadata.record_provenance(
                    actor=self.client_id, operation="agent_revoked",
                    subject=run_id, outcome="detached",
                    details={"runs": list(self.active)})
                self.active.clear()
                return "revoked"
        return "ticked" if self.active else "idle"
