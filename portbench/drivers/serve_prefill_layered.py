"""Driver: prefills of fresh prompt batches (closed loop) of a model too
large for a float32 reference beside it, checked layer by layer.

As ``serve_prefill``: each request is a batch of ``batch`` prompts of
``prompt_len`` tokens from the seed's pool, prefilled by the program
(``Model.prefill`` on its kernel path) into a fresh cache, its first
tokens read to the host; the window closes at the first request boundary
after ``--seconds``. The weights are drawn from the seed per leaf and
layer straight into the served dtype (``reference/nemotron_h.py``'s
``make_params``). Once the window has closed the program's model and
weights are freed, and ``checked_requests`` requests drawn from the seed
are compared with the float32 reference at their last prompt position,
the reference running one layer at a time over all of them at once, each
layer's weights drawn again from the seed.
"""
from __future__ import annotations

import time

import torch

from portbench import counts_hybrid_moe, devtrace, feeds, harness, serving
from portbench.reference import nemotron_h as nref


def compare(want, got, served) -> dict:
    """``serving.compare``'s numbers of one request at one position: want
    and got (B, V) logits, served (B,) ids."""
    gap = want.max(-1).values - want.gather(-1, served[:, None])[:, 0]
    centred = want - want.mean(-1, keepdim=True)
    err = ((got - want).square().mean(-1).sqrt()
           / centred.square().mean(-1).sqrt())
    return {"gap": float(gap.max()), "logit_err": float(err.max())}


def run(ctx) -> harness.Outcome:
    from repro_torch.models import build_model
    ctx.mark("imports")
    tr, cfg, dev, seed = ctx.traffic, ctx.cfg, ctx.device, ctx.seed
    B, T = tr["batch"], tr["prompt_len"]
    spans = ctx.spans
    wseed = harness.derive_seed(seed, "weights")
    params = nref.make_params(cfg, wseed, dev,
                              dtype=getattr(torch, cfg["dtype"]))
    model = build_model(ctx.program_cfg, impl="kernel", device=dev)
    ctx.check_tree(model.abstract_params(), params)
    ctx.mark("weights")
    cache_len = model.cache_len_for(T)
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
            record = harness.Record(spans=spans, profile=prof,
                                    peaks=ctx.peaks,
                                    counts=counts_hybrid_moe.prefill(cfg, B, T))
    n_done = len(done)
    picked = serving.sample(n_done, tr["checked_requests"], seed)
    kept = [(i % len(pool), done[i][0][:, -1], done[i][1][:, -1])
            for i in picked]
    del model, params, done
    t_check = time.perf_counter()
    ctx.reference_mode()
    prompts = torch.cat([pool[p] for p, _, _ in kept])       # (R * B, T)
    readings, control = [], []
    with torch.no_grad():
        want = nref.logits_from_seed(cfg, wseed, prompts, [T - 1])[:, 0]
        for r, (_, logits, served) in enumerate(kept):
            rows = slice(r * B, (r + 1) * B)
            readings.append(compare(want[rows], logits.to(want),
                                    served.to(want.device)))
        if ctx.control:
            fp8 = nref.logits_from_seed(cfg, wseed, prompts, [T - 1],
                                        quant="fp8")[:, 0]
            for r in range(len(kept)):
                rows = slice(r * B, (r + 1) * B)
                control.append(compare(want[rows], fp8[rows],
                                       fp8[rows].argmax(-1)))
    return harness.Outcome(
        metrics={"prefill_tokens_per_s": n_done * B * T / window,
                 "setup_s": setup_s},
        attempted=n_done * B, failed=0,
        readings=serving.worst(readings),
        memory_peak_bytes=peak, record=record,
        seconds={"window": window, "check": time.perf_counter() - t_check},
        control={"control": serving.worst(control)} if control else None)
