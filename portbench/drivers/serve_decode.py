"""Driver: greedy decoding of fresh prompt batches (closed loop).

Each request is a batch of ``batch`` prompts of ``prompt_len`` tokens from
the seed's pool: the program prefills it (``Model.prefill``, the kernel
path) into a cache of the whole horizon, then runs ``gen`` greedy
``Model.decode_step`` calls, each token read to the host after its step
as ``FLClientNode.predict`` does. The next request follows, its prefill
inside the window. The window closes at the first step boundary after
``--seconds``. Once it has closed, every request of the window, the one
cut off too, is compared with the reference over its prompt and the
tokens served after it.
"""
from __future__ import annotations

import statistics
import time

import torch

from portbench import counts, devtrace, feeds, harness, serving


def run(ctx) -> harness.Outcome:
    tr, cfg, dev, seed = ctx.traffic, ctx.cfg, ctx.device, ctx.seed
    B, T, gen = tr["batch"], tr["prompt_len"], tr["gen"]
    spans = ctx.spans
    model, params = serving.served_model(ctx)
    ctx.mark("weights")
    n0 = cfg.get("n_meta_tokens", 0) + T
    cache_len = model.cache_len_for(n0 + gen)
    pool = feeds.prompt_pool(tr["prompt_pool"], B, T, cfg["vocab"], seed, dev)

    def start(r):
        """Prefill request ``r``: (its record, the cache, the last token)."""
        with spans("prefill"):
            logits, cache = model.prefill(
                params, {"tokens": pool[r % len(pool)]}, cache_len)
            tok = torch.argmax(logits, -1)
            host = tok.cpu()
        return {"prompt": r % len(pool), "served": [host],
                "logits": [logits]}, cache, tok

    def step(rec, cache, tok, i):
        pos = torch.full((B, 1), n0 + i, dtype=torch.int32, device=dev)
        with spans("decode_step"):
            logits, cache = model.decode_step(params, cache, tok, pos)
            tok = torch.argmax(logits, -1)
            host = tok.cpu()
        rec["served"].append(host)
        rec["logits"].append(logits)
        return cache, tok

    with torch.no_grad():
        rec, cache, tok = start(0)
        for i in range(tr["warmup_steps"]):
            cache, tok = step(rec, cache, tok, i)
        ctx.sync()
        setup_s = time.perf_counter() - ctx.t_start
        spans.times.clear()
        del rec, cache, tok

        done, gaps, steps = [], [], 0
        t0 = time.perf_counter()
        while steps == 0 or time.perf_counter() - t0 < ctx.seconds:
            rec, cache, tok = start(len(done))
            done.append(rec)
            last = time.perf_counter()
            for i in range(gen):
                cache, tok = step(rec, cache, tok, i)
                now = time.perf_counter()
                gaps.append(now - last)
                last = now
                steps += 1
                if now - t0 >= ctx.seconds:
                    break
        window = time.perf_counter() - t0
        del cache, tok
        peak = ctx.memory_peak()
        record = None
        if ctx.trace:
            rec, cache, tok = start(len(done))
            units = tr["profiled_steps"]

            def profiled(cache=cache, tok=tok):
                for i in range(units):
                    cache, tok = step(rec, cache, tok, i)
            _, prof = devtrace.profile(profiled, units, spans)
            record = harness.Record(spans=spans, profile=prof,
                                    peaks=ctx.peaks, counts={
                "decode_step": counts.decode_steps(cfg, B, n0, gen)})
            del rec, cache, tok
    del model, params
    t_check = time.perf_counter()
    ctx.reference_mode()
    params = serving.reference_params(ctx)
    readings, control = [], []
    for rec in done:
        prompt = pool[rec["prompt"]]
        served = torch.cat(rec["served"], dim=1)
        logits = torch.cat(rec["logits"], dim=1)
        readings.append(serving.compare(cfg, params, prompt, served, logits))
        if ctx.control:
            control.append(serving.compare(cfg, params, prompt, served,
                                           quant="fp8"))
    return harness.Outcome(
        metrics={"decode_ms_per_token": 1e3 * window / steps,
                 "decode_gap_ms_p95": 1e3 * statistics.quantiles(
                     gaps, n=20)[18],
                 "setup_s": setup_s},
        attempted=len(done) * B, failed=0,
        readings=serving.worst(readings),
        memory_peak_bytes=peak, record=record,
        seconds={"window": window, "check": time.perf_counter() - t_check},
        control={"control": serving.worst(control)} if control else None)
