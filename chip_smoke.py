#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (every failed check exits non-zero):

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions; exits if CUDA is absent or the card is not sm_90.
2. Build: compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (one
   process per source, in parallel) and prints the seconds it took.
3. Kernels against their plain PyTorch versions on the card: K1
   ``masked_sum`` and K2 ``masked_sum_corrected`` at N in {1,2,3,8} x
   T in {127, 5000, 4097, 8192} and at the round's shapes (N = 3 and 2,
   T = 116,411,136), atol 1e-5 on unit-normal inputs (the kernel sums
   rows in another order than cuBLAS); two launches must agree bitwise.
   Times are CUDA-event medians of 20 runs after a warm-up.
4. One secure FedAvg round of ``fedforecast-100m`` at full width (12
   layers, d_model 768, bf16 compute on fp32 master weights, random init
   from a seed): 3 silos train 3 AdamW steps each, pre-scale, pack and
   mask; the server folds the masked buffers through ``MaskedF32Sink``
   (K1), finalizes, divides, unpacks and takes the ``fedavg`` outer step.
   The aggregate must equal the plain mean of the unmasked buffers.
5. Dropout repair at full width: ``solarx`` drops after masking; the
   survivors' corrections are folded streamed (K1) and combined stacked
   (K2); both must equal the plain survivor sum.
6. Trace: one more train step under ``torch.profiler``; prints the card's
   busy time against the untraced step time (the device idle share).

Launch counters are reset before phase 4 and read after phase 5: both
kernels must have run on the main path. The line before the last is the
``kernels`` JSON record; the last line is the device record.
"""
from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SILOS = ["windco", "solarx", "gridpower"]
DROPPED = "solarx"
SECRET = hashlib.sha256(b"chip-smoke pair secret").digest()
LOCAL_STEPS, BATCH_SIZE, SEQ_LEN, LR = 3, 8, 256, 3e-4
INIT_SEED = 0
KERNEL_ATOL = 1e-5
ROUND_ATOL = 1e-6
SMALL_N = (1, 2, 3, 8)
SMALL_T = (127, 5000, 4097, 8192)
REPS = 20

# HBM rate (bytes/s) by card, from the published data sheets
HBM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
FP32_RATE = 67e12            # H100 SXM fp32 outside the tensor cores


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def median_ms(fn, reps: int = REPS) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sync_seconds(fn, *args, **kw):
    """``(fn(*args, **kw), seconds)`` with the device synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase(device, n_main: int, n_repair: int, t_main: int, card: str,
                 rate: float):
    import torch
    from repro_torch.kernels.secure_agg import ops, ref

    gen = torch.Generator(device=device).manual_seed(1234)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    err = {"masked_sum": 0.0, "masked_sum_corrected": 0.0}

    def compare(x, c, w):
        k1a, k1b = ops.masked_sum(x, w), ops.masked_sum(x, w)
        k2a = ops.masked_sum_corrected(x, c, w)
        k2b = ops.masked_sum_corrected(x, c, w)
        check(torch.equal(k1a, k1b) and torch.equal(k2a, k2b),
              f"repeat launches bitwise equal at {tuple(x.shape)}")
        e1 = float((k1a - ref.masked_sum_ref(x, w)).abs().max())
        e2 = float((k2a - ref.masked_sum_corrected_ref(x, c, w)).abs().max())
        err["masked_sum"] = max(err["masked_sum"], e1)
        err["masked_sum_corrected"] = max(err["masked_sum_corrected"], e2)
        check(e1 <= KERNEL_ATOL and e2 <= KERNEL_ATOL,
              f"kernels match plain at {tuple(x.shape)}: {e1:.3g} {e2:.3g}")
        return e1, e2

    for n in SMALL_N:
        for t in SMALL_T:
            compare(randn(n, t), randn(n, t), randn(n))
    print(f"kernels: {len(SMALL_N) * len(SMALL_T)} small shapes match "
          f"(max err K1 {err['masked_sum']:.3g}, K2 "
          f"{err['masked_sum_corrected']:.3g}, atol {KERNEL_ATOL})",
          flush=True)

    x = randn(n_main, t_main)
    xr = x[:n_repair]                     # leading rows: contiguous
    c = randn(n_repair, t_main)
    w, wr = randn(n_main), randn(n_repair)
    e1 = float((ops.masked_sum(x, w) - ref.masked_sum_ref(x, w)).abs().max())
    e2 = float((ops.masked_sum_corrected(xr, c, wr)
                - ref.masked_sum_corrected_ref(xr, c, wr)).abs().max())
    check(e1 <= KERNEL_ATOL and e2 <= KERNEL_ATOL,
          f"kernels match plain at T={t_main}: {e1:.3g} {e2:.3g}")
    check(torch.equal(ops.masked_sum(x, w), ops.masked_sum(x, w))
          and torch.equal(ops.masked_sum_corrected(xr, c, wr),
                          ops.masked_sum_corrected(xr, c, wr)),
          "repeat launches bitwise equal at the round's shapes")
    err["masked_sum"] = max(err["masked_sum"], e1)
    err["masked_sum_corrected"] = max(err["masked_sum_corrected"], e2)

    def bound(n_rows_read: int, n: int, flops_per_col: int):
        nbytes = (n_rows_read * t_main + t_main + n) * 4
        by_bytes = nbytes / rate * 1e3
        by_ops = flops_per_col * t_main / FP32_RATE * 1e3
        return (max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations", nbytes)

    rows = []
    b1, by1, nb1 = bound(n_main, n_main, 2 * n_main)
    k1 = {"name": "masked_sum", "route": "cuda",
          "source": "src/repro_torch/csrc/secure_agg.cu",
          "replaces": "src/repro/kernels/secure_agg/kernel.py:68",
          "shape": [n_main, t_main],
          "max_abs_err": err["masked_sum"],
          "ms": median_ms(lambda: ops.masked_sum(x, w)),
          "plain_ms": median_ms(lambda: ref.masked_sum_ref(x, w)),
          "bound_ms": b1, "bound_by": by1,
          "library_ms": median_ms(lambda: w @ x)}
    rows.append((k1, nb1))
    b2, by2, nb2 = bound(2 * n_repair, n_repair, 3 * n_repair)
    k2 = {"name": "masked_sum_corrected", "route": "cuda",
          "source": "src/repro_torch/csrc/secure_agg.cu",
          "replaces": "src/repro/kernels/secure_agg/kernel.py:94",
          "shape": [n_repair, t_main],
          "max_abs_err": err["masked_sum_corrected"],
          "ms": median_ms(lambda: ops.masked_sum_corrected(xr, c, wr)),
          "plain_ms": median_ms(
              lambda: ref.masked_sum_corrected_ref(xr, c, wr)),
          "bound_ms": b2, "bound_by": by2,
          "library_ms": None}
    rows.append((k2, nb2))
    for k, nbytes in rows:
        lib = ("n/a" if k["library_ms"] is None
               else f"{k['library_ms']:.4f} ms")
        print(f"kernel {k['name']} N={k['shape'][0]} T={t_main}: "
              f"{k['ms']:.4f} ms ({nbytes / k['ms'] / 1e6:.0f} GB/s), "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, library {lib}, max err "
              f"{k['max_abs_err']:.3g} [{card}]", flush=True)
    return [k for k, _ in rows]


# ---------------------------------------------------------------------------
# phases 4 and 5: the round and the repair, through the port's entry points
# ---------------------------------------------------------------------------
def round_phase(cfg, device, card: str):
    """One secure round at ``cfg``; returns what the checks and the
    repair need."""
    import torch
    from repro_torch.checkpoint import pytree_digest
    from repro_torch.core.packing import pack_pytree, unpack_pytree
    from repro_torch.core.secure_agg import mask_packed
    from repro_torch.core.streaming import MaskedF32Sink
    from repro_torch.data.synthetic import make_silo_datasets
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, fedavg
    from repro_torch.training import make_train_step

    model = build_model(cfg, device=device)
    params = model.init(model.generator(INIT_SEED))
    datasets = dict(zip(SILOS, make_silo_datasets(
        len(SILOS), vocab=cfg.vocab, seq_len=SEQ_LEN, seed=1)))
    held_out = {c: ds.batch(BATCH_SIZE) for c, ds in datasets.items()}

    def eval_loss(p):
        with torch.no_grad():
            return sum(float(model.loss_fn(p, b)[0])
                       for b in held_out.values()) / len(held_out)

    before = eval_loss(params)
    cohort = sorted(SILOS)
    opt = adamw(LR, weight_decay=0.0)
    step = make_train_step(model, opt)
    stage = {"train_step": [], "pack": [], "mask": []}
    plain, masked, losses = {}, {}, []
    for cid in SILOS:
        p, o = params, opt.init(params)
        for _ in range(LOCAL_STEPS):
            batch = datasets[cid].batch(BATCH_SIZE)
            (p, o, met), s = sync_seconds(step, p, o, batch)
            stage["train_step"].append(s)
            losses.append(float(met["loss"]))
        n_examples = LOCAL_STEPS * BATCH_SIZE
        weight = n_examples / float(LOCAL_STEPS * BATCH_SIZE)
        (buf, layout), s = sync_seconds(pack_pytree, p)
        stage["pack"].append(s)
        plain[cid] = buf
        masked[cid], s = sync_seconds(mask_packed, buf * weight, cid,
                                      cohort, SECRET, device=device)
        stage["mask"].append(s)
        del p, o
    check(all(math.isfinite(v) for v in losses),
          f"finite train losses {losses}")

    def server():
        sink = MaskedF32Sink(layout.total_size, device=device)
        for cid in SILOS:
            sink.fold(masked[cid], 1.0)
        return sink.finalize(), sink
    (total, sink), s_fold = sync_seconds(server)
    denom = float(len(SILOS) * LOCAL_STEPS * BATCH_SIZE) / float(
        LOCAL_STEPS * BATCH_SIZE)
    mean = total / denom
    agg, s_unpack = sync_seconds(unpack_pytree, mean, layout)
    new_global, _ = fedavg().step(params, agg, {})
    plain_mean = torch.stack([plain[c] for c in SILOS]).mean(0)
    err = float((mean - plain_mean).abs().max())
    check(err <= ROUND_ATOL,
          f"masks cancel: aggregate vs plain mean {err:.3g}")
    after = eval_loss(new_global)
    check(math.isfinite(before) and math.isfinite(after),
          "finite eval losses")
    print(f"round: T={layout.total_size} params, {len(SILOS)} silos x "
          f"{LOCAL_STEPS} steps (batch {BATCH_SIZE} x {SEQ_LEN}); train "
          f"losses {[round(v, 4) for v in losses]}; held-out eval loss "
          f"{before:.4f} -> {after:.4f}; aggregate vs plain mean max err "
          f"{err:.3g} (atol {ROUND_ATOL}); fold batches {sink.fold_batches}",
          flush=True)
    med = {k: statistics.median(v) for k, v in stage.items()}
    print(f"round stages (s): train step median {med['train_step']:.4f} "
          f"(first {stage['train_step'][0]:.4f}), pack {med['pack']:.4f}, "
          f"mask {med['mask']:.4f}, fold+finalize {s_fold:.4f}, unpack "
          f"{s_unpack:.4f} [{card}]", flush=True)
    print(f"round: new global digest {pytree_digest(new_global)}",
          flush=True)
    return {"T": layout.total_size, "plain": plain, "masked": masked,
            "step": step, "opt": opt, "global": new_global,
            "batch": datasets[SILOS[0]].batch(BATCH_SIZE),
            "step_s": med["train_step"]}


def repair_phase(state, device, card: str):
    import torch
    from repro_torch.core.secure_agg import (aggregate_masked_packed,
                                             repair_correction)
    from repro_torch.core.streaming import MaskedF32Sink

    t = state["T"]
    survivors = [c for c in SILOS if c != DROPPED]
    corr, s_corr = sync_seconds(lambda: {
        c: repair_correction(t, c, [DROPPED], SECRET, device=device)
        for c in survivors})

    def streamed():
        sink = MaskedF32Sink(t, device=device)
        for c in survivors:
            sink.fold(state["masked"][c])
            sink.fold_correction(corr[c])
        return sink.finalize()
    stream_total, s_stream = sync_seconds(streamed)
    stack_total, s_stack = sync_seconds(lambda: aggregate_masked_packed(
        [state["masked"][c] for c in survivors],
        weights=torch.ones(len(survivors)),
        corrections=[corr[c] for c in survivors], device=device))
    plain_sum = sum(state["plain"][c] for c in survivors)
    e_ss = float((stream_total - stack_total).abs().max())
    e_sp = float((stream_total - plain_sum).abs().max())
    e_kp = float((stack_total - plain_sum).abs().max())
    check(max(e_ss, e_sp, e_kp) <= ROUND_ATOL,
          f"repair agrees: streamed~stacked {e_ss:.3g}, streamed~plain "
          f"{e_sp:.3g}, stacked~plain {e_kp:.3g}")
    print(f"repair: dropped {DROPPED}; streamed vs stacked {e_ss:.3g}, "
          f"streamed vs plain {e_sp:.3g}, stacked vs plain {e_kp:.3g} "
          f"(atol {ROUND_ATOL}); corrections {s_corr:.4f} s, streamed "
          f"fold {s_stream:.4f} s, stacked combine {s_stack:.4f} s "
          f"[{card}]", flush=True)


def trace_phase(state, card: str):
    """One more train step, on the new global, under ``torch.profiler``:
    the card's busy time in it against the untraced median step time,
    i.e. how far the host holds the card back."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, opt, params, batch = (state[k] for k in
                                ("step", "opt", "global", "batch"))
    opt_state = opt.init(params)
    step(params, opt_state, batch)                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced_s = sync_seconds(step, params, opt_state, batch)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    wall_ms = state["step_s"] * 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:4]
    print(f"trace: train step device busy {busy_ms:.2f} ms in "
          f"{sum(e.count for e in kernels)} kernel launches; untraced step "
          f"median {wall_ms:.2f} ms -> device idle share "
          f"{1 - busy_ms / wall_ms:.3f}; traced step {traced_s * 1e3:.2f} "
          f"ms; top: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
              for e in top) + f" [{card}]", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{name} capability {cap}", flush=True)
    check(cap == (9, 0), f"an sm_90 card (got {cap})")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.secure_agg import ops

    t0 = time.perf_counter()
    libs = _build.build_all(force=True)
    print(f"build: {[p.name for p in libs]} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    cfg = get_config("fedforecast-100m")
    rate = hbm_rate(name)
    t_main = 116_411_136            # fedforecast-100m packed size
    kernels = kernel_phase(device, len(SILOS), len(SILOS) - 1, t_main, card,
                           rate)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state = round_phase(cfg, device, card)
    check(state["T"] == t_main, f"packed size {state['T']} == {t_main}")
    check(ops.LAUNCHES["masked_sum"] > 0, "K1 launched in the round")
    repair_phase(state, device, card)
    launches = dict(ops.LAUNCHES)
    check(launches["masked_sum_corrected"] > 0, "K2 launched in the repair")
    print(f"main path: launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    trace_phase(state, card)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
