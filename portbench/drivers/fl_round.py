"""Driver: back-to-back secure FedAvg rounds over the silos (closed loop).

A round, as ``FLClientNode._do_round`` and the server's collect phase run
it, less the board's codec: every silo trains a fresh AdamW for the
job's local steps from the round's global on its own non-IID stream,
packs its update, scales it by its weight, masks it with the fast PRG
and moves the masked buffer to the host; the server folds the buffers
from host memory into a ``MaskedF32Sink`` (K1), finalizes, divides by the
cohort's weight, unpacks and takes the ``fedavg`` outer step.

Set-up warms every call of a round with a short round whose result is
thrown away. The window's first round starts from the seed's weights,
each later one from the previous round's global; it closes at the first
round boundary after ``--seconds``. The check reads the window's first
and last rounds: the first silo's first ``checked_steps`` steps against
the reference's AdamW from the round's starting global, and the round's
global against the weighted mean of its silos' trained parameters.
"""
from __future__ import annotations

import hashlib
import statistics
import time

import torch

from portbench import counts, devtrace, feeds, harness
from portbench.reference import model as ref


def worst_leaf_gap(prog: dict, want: dict, leaves=None) -> float:
    """The largest |norm_prog - norm_ref| over leaves, each against the
    reference's norm of that leaf or of the median leaf, the larger."""
    names = [n for n in want if leaves is None or n in leaves]
    median = statistics.median(want[n] for n in names)
    return max(abs(prog[n] - want[n]) / max(want[n], median) for n in names)


def median_leaf_gap(prog: dict, want: dict, leaves=None) -> float:
    """The median over leaves of the gap that ``worst_leaf_gap`` takes the
    largest of."""
    names = [n for n in want if leaves is None or n in leaves]
    median = statistics.median(want[n] for n in names)
    return statistics.median(abs(prog[n] - want[n]) / max(want[n], median)
                             for n in names)


def agg_error(trained, committed, weights, dtype=torch.float64) -> float:
    """max |committed - weighted mean of trained| over max |mean|, the mean
    taken leaf by leaf in ``dtype``."""
    num = den = 0.0
    total = sum(weights)
    for path, got in ref.leaf_paths(committed):
        mean = sum(w * ref.leaf(t, path).to(dtype)
                   for w, t in zip(weights, trained))
        mean = (mean / total).double()
        num = max(num, float((got.double() - mean).abs().max()))
        den = max(den, float(mean.abs().max()))
    return num / den


def run(ctx) -> harness.Outcome:
    from repro_torch.core.packing import pack_pytree, unpack_pytree
    from repro_torch.core.secure_agg import mask_packed
    from repro_torch.core.streaming import MaskedF32Sink
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, fedavg
    from repro_torch.training import make_train_step
    ctx.mark("imports")

    tr, cfg, dev, seed = ctx.traffic, ctx.cfg, ctx.device, ctx.seed
    silos, steps = tr["silos"], tr["local_steps"]
    batch, seq = tr["batch"], tr["seq_len"]
    opt_kw = {k: tr[k] for k in ("b1", "b2", "eps", "max_grad_norm")}
    n_check = tr["checked_steps"]
    spans = ctx.spans

    init = ref.make_params(cfg, harness.derive_seed(seed, "weights"), dev)
    model = build_model(ctx.program_cfg, device=dev)
    ctx.check_tree(model.abstract_params(), init)
    opt = adamw(tr["lr"], weight_decay=0.0, **opt_kw)
    step = make_train_step(model, opt)
    outer = fedavg()
    ctx.mark("weights")
    feed = feeds.SiloFeed(silos, vocab=cfg["vocab"], seq=seq, batch=batch,
                          steps=steps, alpha=tr["dirichlet_alpha"],
                          pool_rounds=tr["pool_rounds"], seed=seed,
                          device=dev)
    secret = hashlib.sha256(f"portbench pair secret {seed}".encode()).digest()
    cohort = sorted(silos)
    n_examples = steps * batch
    weight = n_examples / float(steps * batch)       # n_examples / denom
    denom = len(silos) * weight

    t_size = sum(t.numel() for t in ref.tree_leaves(init))

    def one_round(glob, rnd, probe=None, n_steps=steps):
        sink = MaskedF32Sink(t_size, device=dev)
        trained = []
        for si, cid in enumerate(silos):
            p, o = glob, opt.init(glob)
            for k in range(n_steps):
                with spans("train_step"):
                    p, o, met = step(p, o, feed.batch(si, rnd, k))
                if probe is not None and si == 0 and k < n_check:
                    probe(k, p, o, met)
            with spans("mask"):
                buf, layout = pack_pytree(p)
                masked = mask_packed(buf * weight, cid, cohort, secret,
                                     device=dev)
            with spans("handover"):
                sink.fold(masked.cpu().numpy(), 1.0)
            trained.append(p)
        with spans("fold"):
            agg = unpack_pytree(sink.finalize() / denom, layout)
            new, _ = outer.step(glob, agg, {})
        ctx.sync()
        return new, trained

    # set-up: every call of a round once, each silo ``warmup_steps`` steps
    # on data no window round reads; the result is thrown away
    one_round(init, -1, n_steps=tr["warmup_steps"])
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    spans.times.clear()

    # the window: round 0 starts from the seed's weights again, each later
    # round from the one before's global. Of every round the first silo's
    # first ``checked_steps`` steps are kept on the card (its losses, its
    # first moment after step 1, its parameters after the last), with the
    # round's trained trees and global, for the first and the last round
    rounds, first, last = 0, None, None
    glob = init
    t0 = time.perf_counter()
    while True:
        kept = _Kept(glob, rounds, n_check)
        with spans("round"):
            new, trained = one_round(glob, rounds, kept.probe)
        kept.trained, kept.committed = trained, new
        if first is None:
            first = kept
        last = kept
        glob, rounds = new, rounds + 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    peak = ctx.memory_peak()
    record = None
    if ctx.trace:
        _, prof = devtrace.profile(lambda: one_round(glob, rounds), 1, spans)
        record = harness.Record(spans=spans, profile=prof, peaks=ctx.peaks)
        record.counts = {
            "k1": counts.k1(len(silos), t_size),
            "round": counts.round_work(cfg, len(silos), steps, batch, seq)}
    del model, opt, step, glob, new, trained, kept

    # the checks, once the window has closed: the reference follows the
    # checked steps of the window's first round from the seed's weights and
    # of its last from the global the round started from
    t_check = time.perf_counter()
    ctx.reference_mode()

    def follow(kept, quant=None, rows=None):
        bs = [feed.batch(0, kept.rnd, k)["tokens"] for k in range(n_check)]
        if rows is not None:
            bs = [b[:rows] for b in bs]
        losses, grad, final = ref.adamw_steps(
            cfg, kept.start, bs, lr=tr["lr"], quant=quant, **opt_kw)
        return {"loss": losses,
                "grad": {n: float(torch.linalg.vector_norm(g))
                         for n, g in grad.items()},
                "change": {n: float(torch.linalg.vector_norm(
                    final[n] - ref.leaf(kept.start, n))) for n in final}}

    def numbers(got, want):
        moved = _moving_leaves(want["grad"])
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(got["loss"], want["loss"])),
            "grad_gap": worst_leaf_gap(got["grad"], want["grad"]),
            "change_gap": worst_leaf_gap(got["change"], want["change"],
                                         moved),
            "change_mid": median_leaf_gap(got["change"], want["change"],
                                          moved)}

    wants = {}

    def want(kept):
        if kept.rnd not in wants:
            wants[kept.rnd] = follow(kept)
        return wants[kept.rnd]

    def by_round(read):
        """Each number of ``read(kept)`` for the first and the last round
        (``<number>.first``, ``<number>.last``) and the larger of the two."""
        rows = {"first": read(first)}
        rows["last"] = rows["first"] if last is first else read(last)
        out = {k: max(r[k] for r in rows.values()) for k in rows["first"]}
        for which, r in rows.items():
            out.update({f"{k}.{which}": v for k, v in r.items()})
        return out

    readings = by_round(lambda k: {
        **numbers(k.norms(opt_kw["b1"]), want(k)),
        "agg_err": agg_error(k.trained, k.committed, [weight] * len(silos))})
    control = None
    if ctx.control:
        control = {
            "control": by_round(lambda k: {
                **numbers(follow(k, quant="fp8"), want(k)),
                "agg_err": agg_error(k.trained,
                                     _mean_in(k.trained, torch.bfloat16),
                                     [1.0] * len(silos))}),
            "half_batch": by_round(lambda k: numbers(
                follow(k, rows=batch // 2), want(k))),
            "agg_drop_silo": by_round(lambda k: {"agg_err": agg_error(
                k.trained, _mean_in(k.trained[:-1], torch.float32),
                [1.0] * len(silos))})}
    return harness.Outcome(
        metrics={"round_s": window / rounds, "setup_s": setup_s},
        attempted=rounds, failed=0, readings=readings, memory_peak_bytes=peak,
        record=record, control=control,
        seconds={"window": window, "check": time.perf_counter() - t_check})


class _Kept:
    """What the check reads of one window round, kept on the card without
    waiting for it: the global it started from, the first silo's losses,
    first moment after step 1 and parameters after step ``n_check``, and
    (set after the round) its trained trees and committed global."""

    def __init__(self, start, rnd: int, n_check: int):
        self.start, self.rnd, self.n_check = start, rnd, n_check
        self.loss, self.m, self.params = [], None, None
        self.trained = self.committed = None

    def probe(self, k, p, o, met):
        self.loss.append(met["loss"].detach().clone())
        if k == 0:
            self.m = {n: v.detach().clone()
                      for n, v in ref.leaf_paths(o["m"])}
        if k == self.n_check - 1:
            self.params = {n: v.detach().clone()
                           for n, v in ref.leaf_paths(p)}

    def norms(self, b1: float) -> dict:
        """The losses, the first gradient as the optimizer holds it
        (``m / (1 - b1)``) and each leaf's change, as norms."""
        return {"loss": [float(x) for x in self.loss],
                "grad": {n: float(torch.linalg.vector_norm(v.float()))
                         / (1 - b1) for n, v in self.m.items()},
                "change": {n: float(torch.linalg.vector_norm(
                    (v - ref.leaf(self.start, n)).float()))
                    for n, v in self.params.items()}}


def _moving_leaves(grad_norms: dict) -> set:
    """Leaves whose reference gradient is over a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(grad_norms.values())
    return {n for n, g in grad_norms.items() if g >= 1e-3 * median}


def _mean_in(trees, dtype) -> dict:
    """The leafwise mean of ``trees``, summed in ``dtype``."""
    return ref.tree_map2(lambda *xs: (sum(x.to(dtype) for x in xs)
                                      / len(xs)).float(), *trees)
