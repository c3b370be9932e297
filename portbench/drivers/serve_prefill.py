"""Driver: prefills of fresh prompt batches (closed loop).

Each request is a batch of ``batch`` prompts of ``prompt_len`` tokens from
the seed's pool; the program prefills it (``Model.prefill`` with the
kernel path, behind the model's meta tokens) into a fresh cache and its
first tokens are read to the host. The next request follows. The window
closes at the first request boundary after ``--seconds``. Once it has
closed, ``checked_requests`` requests drawn from the seed are compared
with the reference at their last prompt position.
"""
from __future__ import annotations

import time

import torch

from portbench import counts, devtrace, feeds, harness, serving


def run(ctx) -> harness.Outcome:
    tr, cfg, dev, seed = ctx.traffic, ctx.cfg, ctx.device, ctx.seed
    B, T = tr["batch"], tr["prompt_len"]
    spans = ctx.spans
    model, params = serving.served_model(ctx)
    ctx.mark("weights")
    n0 = cfg.get("n_meta_tokens", 0) + T
    cache_len = model.cache_len_for(n0)
    pool = feeds.prompt_pool(tr["prompt_pool"], B, T, cfg["vocab"], seed, dev)

    def request(i):
        with spans("prefill"):
            logits, _ = model.prefill(params, {"tokens": pool[i % len(pool)]},
                                      cache_len)
            served = torch.argmax(logits, -1).cpu()
        return logits, served

    with torch.no_grad():
        for i in range(tr["warmup_requests"]):
            request(i)
        ctx.sync()
        setup_s = time.perf_counter() - ctx.t_start
        spans.times.clear()
        done = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            done.append(request(len(done)))
        window = time.perf_counter() - t0
        peak = ctx.memory_peak()
        record = None
        if ctx.trace:
            units = tr["profiled_requests"]
            _, prof = devtrace.profile(
                lambda: [request(i) for i in range(units)], units, spans)
            windows = [counts.layer_window(cfg, i)
                       for i in range(cfg["n_layers"])]
            record = harness.Record(spans=spans, profile=prof,
                                    peaks=ctx.peaks, counts={
                "prefill": counts.prefill(cfg, B, T),
                "k6": _summed([counts.k6(cfg, B, n0, w) for w in windows]),
                "k7": _summed([counts.k7(cfg, B, n0)] * cfg["n_layers"])})
    n_done = len(done)
    picked = serving.sample(n_done, tr["checked_requests"], seed)
    kept = [(i % len(pool), done[i][0], done[i][1]) for i in picked]
    del model, params, done
    t_check = time.perf_counter()
    ctx.reference_mode()
    params = serving.reference_params(ctx)
    readings, control = [], []
    for p, logits, served in kept:
        readings.append(serving.compare(cfg, params, pool[p], served, logits))
        if ctx.control:
            control.append(serving.compare(cfg, params, pool[p], served,
                                           quant="fp8"))
    return harness.Outcome(
        metrics={"prefill_tokens_per_s": n_done * B * T / window,
                 "setup_s": setup_s},
        attempted=n_done * B, failed=0,
        readings=serving.worst(readings),
        memory_peak_bytes=peak, record=record,
        seconds={"window": window, "check": time.perf_counter() - t_check},
        control={"control": serving.worst(control)} if control else None)


def _summed(works):
    return {"flops": sum(w["flops"] for w in works),
            "bytes": sum(w["bytes"] for w in works),
            "precision": works[0]["precision"]}
