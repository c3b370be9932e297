#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (every failed check exits non-zero):

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions; exits if CUDA is absent or the card is not sm_90.
2. Build: compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (one
   process per source, in parallel) and prints the seconds it took, the
   ``-Xptxas -v`` registers and spills of the K6/K7 kernels, and the
   count of ``HGMMA`` (wgmma) instructions in K6's SASS, which must not
   be 0.
3. Kernels against their plain PyTorch versions on the card: K1
   ``masked_sum`` and K2 ``masked_sum_corrected`` at N in {1,2,3,8} x
   T in {127, 5000, 4097, 8192} and at the round's shapes (N = 3 and 2,
   T = 116,411,136), atol 1e-5 on unit-normal inputs (the kernel sums
   rows in another order than cuBLAS); two launches must agree bitwise.
   Times are CUDA-event medians of 20 reps after a warm-up, each rep the
   mean of 5 back-to-back calls.
4. One secure FedAvg round of ``fedforecast-100m`` at full width (12
   layers, d_model 768, bf16 compute on fp32 master weights, random init
   from a seed): 3 silos train 3 AdamW steps each, pre-scale, pack and
   mask; the server folds the masked buffers through ``MaskedF32Sink``
   (K1), finalizes, divides, unpacks and takes the ``fedavg`` outer step.
   The aggregate must equal the plain mean of the unmasked buffers.
5. Dropout repair at full width: ``solarx`` drops after masking; the
   survivors' corrections are folded streamed (K1) and combined stacked
   (K2); both must equal the plain survivor sum.
5b. ``fl run``: the FL-APU sync run end to end through the port's
   control plane, at full width: ``Consortium`` (the silos of phase 4,
   ``device`` the card, phase 4's init injected as the server's initial
   global) negotiates the contract (2 secure rounds of 3 AdamW steps,
   batch 8 x 256, lr 3e-4, round deadline 3 ticks, round GC on), the
   Job Creator turns it into a job, and the run goes waiting_clients ->
   validating -> distribute -> collect (``MaskedF32Sink``, K1) ->
   evaluate, then round 1 with ``solarx`` dropped as its collect opens
   -> repair (corrections as weight -1 rows of the same sink, K1) ->
   evaluate -> deploying -> done; then one ``predict`` on a survivor.
   Gates: done, the provenance chain verifies, 2 rounds committed, round
   1 repaired over 2 silos, round 0's global within 1e-5 of phase 4's
   (same init, batches, steps and lr; only the masks' rounding differs),
   round 1 moves no weight by more than 1e-2, finite losses,
   ``mask_repair`` and ``deploy_model`` from both survivors, predicted
   tokens in range. Prints the run's wall and per-round seconds, host
   seconds by telemetry span (``phase:*``, ``client.*``,
   ``kernel:masked_sum*``), the board's bytes and the host codec seconds
   of one 465.6 MB message.
5c. ``fleet``: ``windco``'s ``InnerRoundEngine`` driven directly over a
   10,000-device fleet (dropout 0.05, clip 15.0), two inner rounds at
   device cohorts 8 and 16, each device 3 AdamW steps of 8 x 256 from
   phase 4's init; each clipped delta folds into ``MaskedF32Sink`` (K1).
   Gates: the engine's mean delta within 1e-6 of the plain twin (the same
   deltas summed in f64 on the card, divided by the f64 weight), peak
   fold bytes at cohort 16 at most 1.01x those at cohort 8, sampled ==
   dropped + folded, K1 launched at least ceil(folded / 8) times, and a
   one-device fleet at cohort 1 bitwise equal to ``_fit`` on a twin
   dataset. Prints seconds and devices/s a round, the median
   ``device.train`` ms, the K1 fold ms (``kernel:masked_sum_stream``),
   the peak fold bytes, the delta norms and how many were clipped.
5d. ``fleet run``: ``Consortium`` over the 3 silos, each fronting a
   10,000-device fleet (cohort 8, dropout 0.05, clip 15.0), one secure
   round (the silos' inner folds and the server's fold through K1), then
   evaluate, deploy and one ``predict``. Gates: done, chain intact, one
   ``inner_round`` record a silo with 8 sampled, the global moves no
   weight by more than 1e-2, finite losses, tokens in range, K1 launched
   on the ``fleet`` path (5c and 5d). Prints as ``fl run`` does, with the
   silos' devices/s and peak fold bytes.
5e. ``async run``: ``Consortium`` with ``protocol="async_buff"`` (secure
   aggregation off, as the job matrix requires), the silos polling every
   1st, 2nd and 3rd scheduler pass, 2 folds a commit, 3 commits, then the
   final evaluate, deploy and one ``predict``. Gates: done, chain intact,
   3 commits, each commit's provenance weights positive and summing to 1
   within 1e-12, a fold with staleness > 0, commit 0's global bitwise
   equal to the reference's numpy fold recomputed from the messages the
   server collected, finite losses, tokens in range; the ``async`` path
   launches no kernel (its fold is plain PyTorch, as the reference's is
   numpy). Prints wall, per-commit seconds, host seconds by span and the
   board's bytes.
5f. ``train pod``: ``repro_torch.launch.train.run_pod`` as ``--mode pod
   --full`` runs it: ``fedforecast-100m`` at full width, 2 silos stacked
   on the card (every leaf with a leading silo dim, placed by
   ``param_pspecs`` over a one-card mesh), batch 8 x 256, 8 steps, FedAvg
   every 4, lr 3e-4, seed 0. Gates: finite per-silo losses; after each
   FedAvg the silos bitwise equal and within 1 f32 ulp of the f64 mean;
   at step 0 silo 1 bitwise equal to ``make_train_step`` alone on its
   slice and batch; the int8 ``make_fedavg_pod_step`` of the last trained
   stack within each leaf's largest per-silo scale + 1e-6 of the f32
   mean, silos bitwise equal. The path launches no kernel (the step runs
   ``impl="xla"`` and the FedAvg is plain PyTorch, as the reference's).
   Prints the median pod-step and silo-step ms, the fp32 and int8 FedAvg
   ms, the peak GiB and, from one traced pod step, the device idle share.
5g. ``train sim``: ``run_sim`` as ``--mode sim --full --rounds 1`` runs
   it (3 silos, 5 local steps of 4 x 64, secure aggregation on). Gates:
   done, chain intact, finite losses, K1 launched. Prints wall and
   per-round seconds, host seconds by span, the board's bytes and the
   host codec seconds of one 465.6 MB message, as ``fl run`` does.
5h. ``agg split``: the four ``sharding.agg`` ops over ``agg_mesh([card] *
   2)`` and ``agg_mesh([card] * 3)`` (the T split on one card), at K1 (3,
   T), K2 (2, T), K3 (3, Tp), K4 (1, Tp) and K4 with corrections (2, Tp),
   and again at T - 77 (K1, K2) and Tp - 1024 (K3, K4, whose T stays a
   1024 multiple) so that the padding runs. Gates: K1-K3 within 1e-5 of
   the unsplit launch, K4 bitwise, one launch a shard, and the 2-shard
   K1 over phase 4's three masked buffers bitwise equal to what a
   ``MaskedF32Sink`` (which takes no mesh) finalizes from them. Prints
   the split and unsplit ms side by side and how many split results are
   bitwise equal.
6. The compressed planes at full width, on phase 4's trained silos
   (deltas = ``pack_delta(trained, init)``, T padded to Tp, a 1024
   multiple):
   a. int8 round: ``ErrorFeedback("int8").step`` per silo (host numpy
      quantize + zlib), ``QuantSink`` weighted by n_examples (K3),
      divided by the total weight; must match the f64 host sum of the
      decompressed posts within 1e-6.
   b. secure int8 round: ``ErrorFeedback.step_masked`` (fixed grid,
      integer pairwise masks mod 2**16 computed on the card),
      ``ModularSink`` and its finalize (K4); the decoded sum must equal
      ``float32(sum q) * grid`` of the fixed-grid plain twin bitwise.
   c. integer dropout repair: ``solarx`` drops after masking; the
      survivors' ``int_repair_correction`` run on the card, folded
      streamed (K4) and combined stacked (K4 with corrections); both
      bitwise equal to the survivors' twin sum and to each other.
   d. ``combine_pytrees`` over the trained params, weights 1/3 (K5):
      within the largest per-client int8 scale of the plain mean.
   e. ``aggregate_packed("fedavg")`` over the trained buffers (K1):
      within 1e-6 of the plain mean.
7. Trace: one more train step under ``torch.profiler``; prints the card's
   busy time against the untraced step time (the device idle share).
7b. ``threefry``: phase 4's three packed buffers masked with
   ``prg="threefry"`` (the reference's ``jax.random.bits`` stream, T =
   116,411,136) and folded through ``MaskedF32Sink`` (K1): the mean
   within 1e-6 of the plain mean; the card's bits for the first and the
   last 2**20 counters under each of ``windco``'s pair keys bitwise equal
   to the CPU's. Prints the ms a pair of the threefry and the fast
   stream.
8. Serving ``hymba-1.5b`` at full width (32 layers, d_model 1600, 25
   heads over 5 kv heads, 50 SSD heads, 128 meta tokens, bf16, random
   init from a seed) through ``repro_torch.launch.serve``: batch 4, a
   1920-token prompt (a 2048-position stream, so the 1024 windows cut),
   one prefill with K6 and K7 in every layer, then 31 decode steps from
   the ring cache and the SSM state. Prints prefill and decode times and
   rates and the sample continuation. Checks: the prefill logits against
   an ``impl="xla"`` twin on the same params, and prefill(S + 1) against
   prefill(S) + ``decode_step``: in f32 (the weights widened) at rtol =
   atol = 1e-3; in bf16 the kernel path's drift from the f32 plain path
   at most 1.5x the bf16 plain path's. Then one prefill and one decode
   step under ``torch.profiler``: a device idle share line each.
9. ``zoo``: every other architecture of ``repro_torch.configs`` served
   through ``repro_torch.launch.serve`` (random init from a seed, bf16,
   ``impl="kernel"``, a warm-up generate of 2 tokens, then a timed one of
   8): at full width gemma2-9b (2 x 6144; K6 at head dim 256, softcap 50,
   window 4096 on 21 layers), gemma3-4b (1 x 32,768; qk-norm, K6 at head
   dim 256 and window 1024, decode from the 1024-slot ring above
   ``MAX_FULL_CACHE``), olmoe-1b-7b (4 x 1920; 64 experts top-8 at
   capacity 1.25), mamba2-780m (4 x 2048; K7 at N 128), minicpm3-4b (4 x
   1920; MLA, no kernel, as in the reference), internvl2-2b (4 x (256
   patches + 1664 tokens)), seamless-m4t-large-v2 (4 x 1024 frames; the
   non-causal encoder through K6, a bos decoded at position 0); and at
   ``reduced()`` dbrx-132b and command-r-plus-104b (about 264 and 208 GB
   in bf16, over one card). Each prints prefill ms and prompt tok/s,
   decode ms a token, init and serve peak GiB and its launches, which
   must be one K6 a (GQA) attention layer (the encoder's for the
   enc-dec) and one K7 an SSM layer. Checks as phase 8's, on the same
   weights: the prefill logits against an ``impl="xla"`` twin, and
   prefill + decode against a prefill one token longer (the enc-dec:
   decode at 1 against the teacher-forced decoder over [bos, t0]; a
   MoE: on its dropless copy, since at the published capacity a prefill
   drops what a decode step keeps), in f32 within 1e-3 and in bf16 as a
   drift ratio to the f32 plain path of at most 1.5; the twins of
   gemma2-9b, gemma3-4b and minicpm3-4b are cut to 14, 6 and 31 layers
   (printed), and gemma3-4b's second check runs on its first 8191
   tokens.
10. ``dryrun``: ``repro_torch.launch.dryrun`` on meta tensors at the
   shapes the card timed: phase 4's train step (8 x 256), the ``train
   pod`` step (two of it), phase 8's hymba-1.5b prefill and the prefill
   of each ``ZOO`` architecture. Each prints its FLOPs, traffic bytes,
   compute and memory terms over the H100 SXM datasheet figures, the
   bound, the measured median (a prefill's of ``PREFILL_REPS``) and the
   share (bound / measured). Gates: the train step's meta FLOP count
   equals ``FlopCounterMode``'s count of the same step on the card
   (after phase 7b), and neither the train step nor the pod step is
   faster than its bound. The prefills are not gated: the dry run counts
   the ``impl="xla"`` program, and the timed prefills ran
   ``impl="kernel"``, whose K6 skips the blocks a window or the causal
   mask hides, so their share is the plain program's bound over the
   kernel path's time, not a lower bound of it. The live-bytes
   tracker's predicted peak of the train step is printed beside the
   card's ``max_memory_allocated`` rise.

Phase 3 also holds K3 ``dequant_reduce``, K4 ``masked_dequant_reduce``
(with and without corrections) and K5 ``secure_agg_combine`` against
their plain versions at small shapes and at the round's shapes: K3 and
K5 within 1e-5, K4 bitwise; and K6 ``flash_attention`` at the
``FLASH_CASES`` shapes (f32 2e-5 through its CUDA-core kernel, bf16 2e-2
through its tensor-core kernel and within half a bf16 ulp of the f32
plain version, a ragged S and head dim 256 included) and the serve
shapes, hymba-1.5b's with window 1024 and 0 and gemma2-9b's (B 2, S
6144, 16 / 8 heads, head dim 256, softcap 50) with window 4096 and 0
(TFLOP/s, share of the bound, ratio to SDPA), K7 ``ssd_scan`` at the
``SSD_CASES`` and ``SSD_EXTRA`` shapes in f32 and bf16 and the serve
shapes of hymba-1.5b and mamba2-780m (N 128) (2e-4 against the chunked
form, its three passes in plain torch and, off the serve shape, the
sequential oracle; each pass's device time), with K6's library
yardstick ``F.scaled_dot_product_attention`` timed beside it (never on
the path). Two launches must agree bitwise.

Launch counters are reset before phase 4 and read after phase 5 (K1 and
K2 must have run), reset before phase 5b and read after it (K1 must have
run), reset before 5c and read after 5d (the ``fleet`` path: K1 must
have run), reset before 5e and read after it (the ``async`` path: no
kernel), reset before 5f and read after it (the ``train pod`` path: no
kernel), reset before 5g and read after it (the ``train sim`` path: K1
must have run); 5h reads the counters around each checked split call and
leaves its timing calls out (the ``agg split`` path: K1, K2, K3 and K4
in both variants, once a shard);
reset again before phase 6a and read after 6e (K3, K4
in both variants, K5 and K1 must have run), reset before phase 7b and
read after it (the ``threefry`` path: K1 must have run), and reset
before phase 8's
timed serve run and read after it (K6's tensor-core kernel and K7 once a
layer, K6's f32 kernel never), and around each timed generate of phase
9 (the ``zoo`` path, summed); the kernels line gives the sum of the
eleven paths; phase 10 launches no kernel (meta tensors). Each phase
prints its seconds and peak device memory. The line before the last is
the ``kernels`` JSON record; the last line is the device record.
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
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.timing import (  # noqa: E402
    device_ms_by_kernel, median_ms)

SILOS = ["windco", "solarx", "gridpower"]
DROPPED = "solarx"
SECRET = hashlib.sha256(b"chip-smoke pair secret").digest()
LOCAL_STEPS, BATCH_SIZE, SEQ_LEN, LR = 3, 8, 256, 3e-4
INIT_SEED = 0
KERNEL_ATOL = 1e-5
ROUND_ATOL = 1e-6
SMALL_N = (1, 2, 3, 8)
SMALL_T = (127, 5000, 4097, 8192)
SMALL_T_CHUNKED = (1024, 5120, 8192, 13 * 1024)   # K3/K4: 1024 multiples
CHUNK = 1024
# the jobs of the compressed phases: int8 with adaptive per-chunk scales,
# the defaults of DEFAULT_DECISIONS (duck-typed for make_error_feedback)
INT8_JOB = SimpleNamespace(compression="int8", compression_ratio=0.1,
                           quant_bits=8, quant_range=0.0)

# slice 3: K6/K7 shapes (copies of tests/test_kernels.py's sweeps) and the
# serve phase, hymba-1.5b at full width: a 1920-token prompt behind the 128
# meta tokens makes a 2048-position stream, so the 1024 windows really cut
FLASH_CASES = [
    # B, S, H, Hkv, D, causal, window, softcap
    (2, 256, 4, 2, 64, True, 0, 0.0),
    (1, 256, 4, 4, 64, True, 64, 50.0),
    (2, 128, 8, 2, 32, False, 0, 0.0),
    (1, 512, 2, 1, 64, True, 128, 0.0),
    (1, 384, 6, 3, 128, True, 0, 30.0),
    (2, 200, 6, 2, 64, True, 64, 0.0),        # ragged S
    # head dim 256 (gemma2-9b, gemma3-4b): causal, windowed and
    # softcapped, non-causal with a ragged S
    (2, 256, 4, 2, 256, True, 0, 0.0),
    (1, 384, 4, 2, 256, True, 128, 50.0),
    (2, 200, 2, 1, 256, False, 0, 0.0),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# K6's bf16 store against the f32 plain version on the widened inputs: a
# round to nearest is off by at most half a bf16 ulp, 2^-8 of the value,
# plus twice the f32 tolerance; a truncating store or a biased widening
# is off by up to a whole ulp and fails
BF16_HALF_ULP = 2.0 ** -8
SSD_CASES = [
    # b, S, H, P, N, chunk
    (2, 64, 4, 8, 16, 16),
    (1, 128, 2, 16, 8, 32),
    (2, 96, 3, 8, 4, 32),
    (1, 80, 2, 8, 16, 32),
]
# beyond the sweep: ragged last chunks (77 = 2 x 32 + 13; 45 = 2 x 20 +
# 5, with the chunk of 20 padded to 24 rows for the register tiles) and
# mamba2's N = 128 at P 64, chunk 128
SSD_EXTRA = [
    (2, 77, 3, 8, 4, 32),
    (1, 45, 2, 8, 4, 20),
    (1, 256, 2, 64, 128, 128),
]
# K7 against its plain chunked form, f32 both: sums over at most Q terms
# and a chain of S/Q chunk states in another order; the SSD sweep's bar
SSD_TOL = 2e-4
SERVE_ARCH = "hymba-1.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1920, 32
# prefill logits, kernel path vs the plain twin and vs prefill + decode,
# in f32 on the served weights widened: both sides f32, sums in other
# orders (tighter than the reference's bf16 rule of 2e-2,
# tests/test_decode_consistency.py:47). In the served bf16 every path,
# the plain one too, drifts from the f32 computation by rounding that 32
# layers amplify, past 2e-2; there the kernel path may drift at most
# SERVE_BF16_RATIO times as far as the plain path does
SERVE_F32_TOL = 1e-3
PREFILL_REPS = 5            # timed prefills a median (phase 10 reads it)
SERVE_BF16_RATIO = 1.5

# HBM rate (bytes/s) by card, from the published data sheets
HBM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
FP32_RATE = 67e12            # H100 SXM fp32 outside the tensor cores
BF16_RATE = 989e12           # H100 SXM bf16 tensor cores, dense


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def sync_seconds(fn, *args, **kw):
    """``(fn(*args, **kw), seconds)`` with the device synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_of(nbytes: int, nops: int, rate: float,
             op_rate: float = FP32_RATE):
    """(bound ms, 'bytes' or 'operations'): the larger of bytes over the
    HBM rate and operations over ``op_rate``, by default the fp32
    CUDA-core rate (integer ops are counted at the fp32 rate too; the
    published table has no int32 rate outside the tensor cores)."""
    by_bytes = nbytes / rate * 1e3
    by_ops = nops / op_rate * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


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

    rows = []
    nb1 = (n_main * t_main + t_main + n_main) * 4
    b1, by1 = bound_of(nb1, 2 * n_main * t_main, rate)
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
    nb2 = (2 * n_repair * t_main + t_main + n_repair) * 4
    b2, by2 = bound_of(nb2, 3 * n_repair * t_main, rate)
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
        print_kernel(k, nbytes, card)
    return [k for k, _ in rows]


def print_kernel(k: dict, nbytes: int, card: str):
    lib = "n/a" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
    print(f"kernel {k['name']} shape {k['shape']}: {k['ms']:.4f} ms "
          f"({nbytes / k['ms'] / 1e6:.0f} GB/s), bound {k['bound_ms']:.4f} "
          f"ms ({k['bound_by']}, {nbytes} bytes), plain {k['plain_ms']:.4f} "
          f"ms, library {lib}, max err {k['max_abs_err']:.3g} [{card}]",
          flush=True)


def compressed_kernel_phase(device, n_main: int, n_repair: int, t_main: int,
                            card: str, rate: float):
    """K3, K4 (both variants) and K5 against their plain versions on the
    card, at small shapes and at the round's shapes; their times."""
    import torch
    from repro_torch.kernels.compressed_agg import ops as cops
    from repro_torch.kernels.compressed_agg import ref as cref
    from repro_torch.kernels.secure_agg import ops as sops
    from repro_torch.kernels.secure_agg import ref as sref

    gen = torch.Generator(device=device).manual_seed(4321)

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, generator=gen, device=device) * (hi - lo) \
            + lo

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    def u32(*shape):
        # uniform 32-bit patterns, as int32 storage
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device=device, dtype=torch.int32)

    err = {"dequant_reduce": 0.0, "masked_dequant_reduce": 0.0,
           "masked_dequant_reduce_corrected": 0.0, "secure_agg_combine": 0.0}

    def k3(q, s, w):
        a, b = cops.dequant_reduce(q, s, w), cops.dequant_reduce(q, s, w)
        check(torch.equal(a, b), f"K3 repeat bitwise at {tuple(q.shape)}")
        e = float((a - cref.dequant_reduce_ref(q, s, w)).abs().max())
        check(e <= KERNEL_ATOL, f"K3 matches plain at {tuple(q.shape)}: {e}")
        err["dequant_reduce"] = max(err["dequant_reduce"], e)

    def k4(z, g, mbits, c=None):
        name = ("masked_dequant_reduce" if c is None
                else "masked_dequant_reduce_corrected")
        a = cops.masked_dequant_reduce(z, g, modulus_bits=mbits, corr=c)
        b = cops.masked_dequant_reduce(z, g, modulus_bits=mbits, corr=c)
        p = cref.masked_dequant_reduce_ref(z, g, mbits, corr=c)
        check(torch.equal(a, b) and torch.equal(a, p),
              f"{name} bitwise equal to plain at {tuple(z.shape)} "
              f"mbits {mbits}")
        err[name] = max(err[name], float((a - p).abs().max()))

    def k5(q, s, w):
        a = sops.secure_agg_combine(q, s, w)
        b = sops.secure_agg_combine(q, s, w)
        check(torch.equal(a, b), f"K5 repeat bitwise at {tuple(q.shape)}")
        e = float((a - sref.secure_agg_ref(q, s, w)).abs().max())
        check(e <= KERNEL_ATOL, f"K5 matches plain at {tuple(q.shape)}: {e}")
        err["secure_agg_combine"] = max(err["secure_agg_combine"], e)

    for n in SMALL_N:
        for t in SMALL_T_CHUNKED:
            k3(int8(n, t), uniform(1e-6, 1e-2, n, t // CHUNK),
               uniform(0.0, 1.0, n))
            for mbits in (16, 32):
                g = uniform(1e-6, 1e-2, t // CHUNK)
                k4(u32(n, t), g, mbits)
                k4(u32(n, t), g, mbits, u32(n, t))
        for t in SMALL_T:
            w = torch.softmax(uniform(-1.0, 1.0, n), 0)
            k5(int8(n, t), uniform(1e-4, 1e-2, n), w)
    print(f"kernels: K3/K4/K5 match at {len(SMALL_N)} x 4 small shapes "
          f"each (max err K3 {err['dequant_reduce']:.3g}, K5 "
          f"{err['secure_agg_combine']:.3g}, atol {KERNEL_ATOL}; K4 "
          f"bitwise at mbits 16 and 32, with and without corrections)",
          flush=True)

    tp = t_main + (-t_main) % CHUNK
    q3, s3, w3 = (int8(n_main, tp), uniform(1e-6, 1e-2, n_main, tp // CHUNK),
                  uniform(0.0, 1.0, n_main))
    k3(q3, s3, w3)
    g = uniform(1e-6, 1e-2, tp // CHUNK)
    z1 = u32(1, tp)
    z2, c2 = u32(n_repair, tp), u32(n_repair, tp)
    k4(z1, g, 16)
    k4(z2, g, 16, c2)
    q5 = int8(n_main, t_main)
    s5, w5 = uniform(1e-4, 1e-2, n_main), torch.full(
        (n_main,), 1.0 / n_main, device=device)
    k5(q5, s5, w5)

    nb3 = n_main * tp + 4 * n_main * (tp // CHUNK) + 4 * n_main + 4 * tp
    nb4 = 4 * tp + 4 * (tp // CHUNK) + 4 * tp
    nb4c = 2 * 4 * n_repair * tp + 4 * (tp // CHUNK) + 4 * tp
    nb5 = n_main * t_main + 8 * n_main + 4 * t_main
    src_c = "src/repro_torch/csrc/compressed_agg.cu"
    jax_c = "src/repro/kernels/compressed_agg/kernel.py"
    specs = [
        ("dequant_reduce", src_c, f"{jax_c}:45", [n_main, tp], nb3,
         3 * n_main * tp, lambda: cops.dequant_reduce(q3, s3, w3),
         lambda: cref.dequant_reduce_ref(q3, s3, w3)),
        ("masked_dequant_reduce", src_c, f"{jax_c}:94", [1, tp], nb4,
         6 * tp, lambda: cops.masked_dequant_reduce(z1, g, modulus_bits=16),
         lambda: cref.masked_dequant_reduce_ref(z1, g, 16)),
        ("masked_dequant_reduce_corrected", src_c, f"{jax_c}:110",
         [n_repair, tp], nb4c, (2 * n_repair + 5) * tp,
         lambda: cops.masked_dequant_reduce(z2, g, modulus_bits=16, corr=c2),
         lambda: cref.masked_dequant_reduce_ref(z2, g, 16, corr=c2)),
        ("secure_agg_combine", "src/repro_torch/csrc/secure_agg.cu",
         "src/repro/kernels/secure_agg/kernel.py:59", [n_main, t_main], nb5,
         2 * n_main * t_main + n_main,
         lambda: sops.secure_agg_combine(q5, s5, w5),
         lambda: sref.secure_agg_ref(q5, s5, w5)),
    ]
    rows = []
    for name, source, replaces, shape, nbytes, nops, fn, plain in specs:
        b, by = bound_of(nbytes, nops, rate)
        # no single PyTorch call computes any of these functions
        k = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "shape": shape,
             "max_abs_err": err[name], "ms": median_ms(fn),
             "plain_ms": median_ms(plain), "bound_ms": b, "bound_by": by,
             "library_ms": None}
        print_kernel(k, nbytes, card)
        rows.append(k)
    return rows


def attention_kernel_phase(device, card: str, rate: float):
    """K6 flash attention and K7 the SSD scan against their plain
    versions on the card, at the sweeps' shapes and at the serve path's;
    their times, bounds and (K6) the library call's time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref

    gen = torch.Generator(device=device).manual_seed(6789)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    err = {"flash_attention": 0.0, "ssd_scan": 0.0, "bf16_half_ulp": 0.0}

    def plain_attention(q, k, v, causal, window, cap):
        return fref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=q.shape[-1] ** -0.5, causal=causal, window=window,
            softcap=cap).transpose(1, 2)

    def k6(q, k, v, causal, window, cap, tol):
        a = fops.flash_attention(q, k, v, causal=causal, window=window,
                                 logit_softcap=cap)
        b = fops.flash_attention(q, k, v, causal=causal, window=window,
                                 logit_softcap=cap)
        check(torch.equal(a, b), f"K6 repeat bitwise at {tuple(q.shape)}")
        p = plain_attention(q, k, v, causal, window, cap)
        d = (a.float() - p.float()).abs()
        ok = bool((d <= tol + tol * p.float().abs()).all())
        e = float(d.max())
        check(ok, f"K6 matches plain at {tuple(q.shape)} {q.dtype} window "
              f"{window}: max err {e:.3g} (tol {tol})")
        err["flash_attention"] = max(err["flash_attention"], e)
        if q.dtype == torch.bfloat16:
            p32 = plain_attention(q.float(), k.float(), v.float(), causal,
                                  window, cap)
            t32 = 2 * FLASH_TOL["float32"]
            used = float(((a.float() - p32).abs() / (
                BF16_HALF_ULP * p32.abs() + t32 + t32 * p32.abs())).max())
            check(used <= 1.0, f"K6 bf16 store within half an ulp of the f32 "
                  f"plain version at {tuple(q.shape)} window {window}: "
                  f"{used:.3f} of the limit")
            err["bf16_half_ulp"] = max(err["bf16_half_ulp"], used)
        return e

    for B, S, H, Hkv, D, causal, window, cap in FLASH_CASES:
        for name, tol in FLASH_TOL.items():
            dt = getattr(torch, name)
            k6(randn(B, S, H, D, dtype=dt), randn(B, S, Hkv, D, dtype=dt),
               randn(B, S, Hkv, D, dtype=dt), causal, window, cap, tol)
    print(f"kernels: K6 matches plain at {len(FLASH_CASES)} shapes x "
          f"{{f32, bf16}} (max err {err['flash_attention']:.3g}; tol "
          f"{FLASH_TOL}); bf16 store vs f32 plain at most "
          f"{err['bf16_half_ulp']:.3f} of its half-ulp limit", flush=True)

    def ssd_inputs(b, S, H, P, N, dtype=torch.float32):
        # x, B and C as views into one fused (b, S, H*P + 2N) buffer, the
        # layout the model hands K7 (ssm.py: slices of the conv output)
        xbc = randn(b, S, H * P + 2 * N, dtype=dtype)
        x = xbc[..., :H * P].reshape(b, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = F.softplus(randn(b, S, H)) * 0.1
        A = -torch.exp(randn(H) * 0.3)
        return x, dt, A, Bm, Cm

    def k7(args, chunk, oracle):
        y, h = sops.ssd_scan(*args, chunk=chunk)
        y2, h2 = sops.ssd_scan(*args, chunk=chunk)
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"K7 repeat bitwise at {tuple(args[0].shape)}")
        wants = [sref.ssd_chunked(*args, chunk=chunk),
                 sref.ssd_three_pass(*args, chunk=chunk)]
        if oracle:
            wants.append(sref.ssd_ref(*args))
        e = 0.0
        for yw, hw in wants:
            for got, want in ((y, yw), (h, hw)):
                d = (got - want).abs()
                e = max(e, float(d.max()))
                check(bool((d <= SSD_TOL + SSD_TOL * want.abs()).all()),
                      f"K7 matches plain at {tuple(args[0].shape)} chunk "
                      f"{chunk}: max err {float(d.max()):.3g}")
        err["ssd_scan"] = max(err["ssd_scan"], e)
        return e

    for b, S, H, P, N, chunk in SSD_CASES + SSD_EXTRA:
        for dt in (torch.float32, torch.bfloat16):
            k7(ssd_inputs(b, S, H, P, N, dtype=dt), chunk, oracle=True)
    print(f"kernels: K7 matches the chunked form, its three passes in plain "
          f"torch and the sequential oracle at "
          f"{len(SSD_CASES + SSD_EXTRA)} shapes x {{f32, bf16}} (max err "
          f"{err['ssd_scan']:.3g}, "
          f"tol {SSD_TOL})", flush=True)

    def k6_serve_shape(B, S, H, Hkv, D, window, cap, what):
        q, k, v = (randn(B, S, h, D, dtype=bf) for h in (H, Hkv, Hkv))
        e = k6(q, k, v, True, window, cap, FLASH_TOL["bfloat16"])
        pos = torch.arange(S, device=device)
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        pairs = int(mask.sum())
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)
        b_ms, by = bound_of(nbytes, 4 * B * H * D * pairs, rate,
                            op_rate=BF16_RATE)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        k6row = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
            "shape": [B, S, H, Hkv, D, window], "max_abs_err": e,
            "ms": median_ms(lambda: fops.flash_attention(
                q, k, v, causal=True, window=window, logit_softcap=cap)),
            # the plain version materializes (B, H, S, S) f32 scores: 5
            # reps of it are enough beside the kernel's 20
            "plain_ms": median_ms(lambda: plain_attention(
                q, k, v, True, window, cap), reps=5),
            "bound_ms": b_ms, "bound_by": by,
            # timed only: the port never calls it; SDPA has no softcap, so
            # at a softcapped shape it computes a little less
            "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=D ** -0.5,
                enable_gqa=True))}
        print_kernel(k6row, nbytes, card)
        print(f"kernel flash_attention {what} window {window} softcap "
              f"{cap}: {pairs} visible pairs, "
              f"{4 * B * H * D * pairs / k6row['ms'] / 1e9:.1f} TFLOP/s, "
              f"{b_ms / k6row['ms']:.3f} of its bound, "
              f"{k6row['library_ms'] / k6row['ms']:.2f}x faster than SDPA "
              f"(bf16 tensor-core kernel); max err vs bf16 plain {e:.3g}; "
              f"bf16 store vs f32 plain at most {err['bf16_half_ulp']:.3f} "
              f"of its half-ulp limit [{card}]", flush=True)
        return k6row

    # the serve paths' shapes: hymba-1.5b at B 4 x 2048 positions (phase
    # 8), gemma2-9b at B 2 x 6144, head dim 256, softcap 50 (phase 9)
    bf = torch.bfloat16
    S = SERVE_PROMPT + 128
    rows = [k6_serve_shape(SERVE_BATCH, S, 25, 5, 64, window, 0.0,
                           "hymba-1.5b") for window in (1024, 0)]
    rows += [k6_serve_shape(2, 6144, 16, 8, 256, window, 50.0, "gemma2-9b")
             for window in (4096, 0)]

    def k7_serve_shape(b, S, H, P, N, Q, what):
        args = ssd_inputs(b, S, H, P, N, dtype=bf)
        e = k7(args, Q, oracle=False)
        nc = -(-S // Q)
        # C B^T is shared by every head (ngroups = 1): once a (batch,
        # chunk); its product with the decayed x and the two state
        # products a head
        flops = b * nc * (Q * (Q + 1) * N
                          + H * 2 * (Q * (Q + 1) // 2 * P + 2 * Q * N * P))
        nbytes = (2 * b * S * H * P + 4 * b * S * H + 4 * H
                  + 2 * 2 * b * S * N + 4 * b * S * H * P + 4 * b * H * P * N)
        b_ms, by = bound_of(nbytes, flops, rate)
        k7row = {"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan/kernel.py:72",
                 "shape": [b, S, H, P, N, Q], "max_abs_err": err["ssd_scan"],
                 "ms": median_ms(lambda: sops.ssd_scan(*args, chunk=Q)),
                 "plain_ms": median_ms(lambda: sref.ssd_chunked(*args,
                                                                chunk=Q)),
                 "bound_ms": b_ms, "bound_by": by,
                 "library_ms": None}    # no single PyTorch call computes it
        print_kernel(k7row, nbytes, card)
        passes = device_ms_by_kernel(lambda: sops.ssd_scan(*args, chunk=Q))
        print(f"kernel ssd_scan {what}: {flops / k7row['ms'] / 1e9:.2f} "
              f"TFLOP/s (f32), {b_ms / k7row['ms']:.3f} of its bound; passes "
              "(device ms a call, profiler): " + "; ".join(
                  f"{name} {ms:.4f}" for name, ms in passes.items())
              + f"; max err at the serve shape {e:.3g} [{card}]", flush=True)
        return k7row

    k7row = k7_serve_shape(SERVE_BATCH, S, 50, 64, 16, 128, "hymba-1.5b")
    k7_serve_shape(4, 2048, 48, 64, 128, 128, "mamba2-780m")
    for row in rows:
        row["max_abs_err"] = err["flash_attention"]
    # the JSON rows are hymba's: K6 at its windowed shape, 28 of its 32
    # layers, and K7
    k7row["max_abs_err"] = err["ssd_scan"]
    return [rows[0], k7row]


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
    plain, masked, trained, losses = {}, {}, {}, []
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
        trained[cid] = p
        del o
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
            "init": params, "trained": trained,
            "n_examples": {c: LOCAL_STEPS * BATCH_SIZE for c in SILOS},
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


# ---------------------------------------------------------------------------
# phase 5b: the FL-APU sync run end to end, through the port's control plane
# ---------------------------------------------------------------------------
FL_MASTER_KEY = hashlib.sha256(b"chip-smoke fl master key").digest()
FL_ROUNDS = 2
FL_DROP = {DROPPED: ("collect", 1)}
FL_ROUND0_ATOL = 1e-5      # round 0 vs round_phase: only mask rounding differs
FL_ROUND1_MOVE = 1e-2      # 3 AdamW steps at lr 3e-4 move a weight <~ 3e-3
FL_SPANS = ("client.fetch", "client.train", "client.compress", "client.post")


def fl_phase(state, device, card: str, reduced: bool = False):
    """Negotiate, create the job and run ``fedforecast-100m`` at full width
    for ``FL_ROUNDS`` secure rounds through ``Consortium``: ``solarx``
    drops as round 1's collect opens, so round 1 repairs; then deploy and
    one ``predict`` on a survivor. Round 0 trains on ``round_phase``'s
    init and batches, so its committed global must match that phase's.
    ``reduced`` runs the 2-layer variant (a CPU rehearsal, after
    ``round_phase`` on the reduced config)."""
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.core import Consortium, Telemetry
    from repro_torch.data.synthetic import make_silo_datasets

    cfg = get_config("fedforecast-100m")
    vocab = (cfg.reduced() if reduced else cfg).vocab

    tel = Telemetry(enabled=True, recorder_cap=1 << 20)
    con = Consortium(SILOS, seed=0, master_key=FL_MASTER_KEY, device=device,
                     telemetry=tel, initial_params=state["init"])
    contract = con.negotiate({
        "arch": "fedforecast-100m", "reduced": reduced, "rounds": FL_ROUNDS,
        "local_steps": LOCAL_STEPS, "batch_size": BATCH_SIZE, "lr": LR,
        "data_schema": {"vocab": vocab, "seq_len": SEQ_LEN},
        "secure_aggregation": True, "round_deadline_ticks": 3,
        "gc_round_resources": True})
    job = con.server.job_creator.from_contract(contract)
    datasets = make_silo_datasets(len(SILOS), vocab=vocab, seq_len=SEQ_LEN,
                                  seed=1)
    for ds in datasets:      # round_phase drew a held-out batch first
        ds.batch(BATCH_SIZE)
    run_id = con.start(job, datasets)
    phase, wall = sync_seconds(con.run_to_completion, drop_at=dict(FL_DROP))
    server = con.server
    run = server.run
    check(phase == "done", f"the FL run ends in done (got {phase})")
    check(server.metadata.verify_chain(), "the provenance chain verifies")
    check(len(run.history) == FL_ROUNDS,
          f"{FL_ROUNDS} rounds committed (got {len(run.history)})")
    models = [server.metadata.query(kind="model", digest=h["digest"])[0]
              for h in run.history]
    check(models[1]["details"]["repaired"]
          and len(models[1]["details"]["cohort"]) == len(SILOS) - 1,
          f"round 1 repaired over {len(SILOS) - 1} silos: "
          f"{models[1]['details']}")
    g0, g1 = (server.store.get(h["digest"]) for h in run.history)

    def max_diff(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(_tree.leaves(a), _tree.leaves(b)))
    e0 = max_diff(g0, state["global"])
    check(e0 <= FL_ROUND0_ATOL,
          f"round 0 global vs round_phase's {e0:.3g} <= {FL_ROUND0_ATOL}")
    move = max_diff(g1, g0)
    check(move <= FL_ROUND1_MOVE,
          f"round 1 moves a weight {move:.3g} <= {FL_ROUND1_MOVE}")
    losses = [v for h in run.history for v in h["train_losses"].values()]
    losses += [h["mean_eval_loss"] for h in run.history]
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    dropped = con.client_ids[DROPPED]
    survivors = [n for n in con.nodes if n.client_id != dropped]
    for op in ("mask_repair", "deploy_model"):
        by = [n.client_id for n in survivors
              if n.metadata.query(operation=op)]
        check(len(by) == len(survivors), f"{op} from every survivor: {by}")
    node = next(n for n in survivors if n.deployed_params is not None)
    prompt = datasets[0].batch(1)["tokens"][:, :32]
    (toks, s_predict) = sync_seconds(node.predict, prompt, 8)
    check(toks.shape == (1, 8) and 0 <= toks.min() and toks.max() < vocab,
          f"predict returns tokens in range: {toks.tolist()}")

    host, by_round = span_seconds(tel, run_id)
    stats = server.board.stats
    print(f"fl run: fedforecast-100m {'reduced' if reduced else 'full width'}"
          f", T={state['T']}, "
          f"{len(SILOS)} silos, {FL_ROUNDS} secure rounds x {LOCAL_STEPS} "
          f"steps, {DROPPED} dropped at round 1's collect; phase {phase}, "
          f"chain intact, round 1 repaired over {len(survivors)}; round 0 "
          f"vs round_phase {e0:.3g} (atol {FL_ROUND0_ATOL}); round 1 moves "
          f"{move:.3g}; train losses {[round(v, 4) for v in losses]}; "
          f"predict {toks.tolist()} [{card}]", flush=True)
    print(f"fl run: wall {wall:.3f} s over {con.scheduler.passes} passes; "
          f"per-round s " + ", ".join(
              f"r{k} {v:.3f}" for k, v in sorted(by_round.items()))
          + f"; predict {s_predict:.3f} s [{card}]", flush=True)
    print_host_seconds("fl run", host, FL_SPANS, card)
    print_board("fl run", stats, card)
    codec_seconds(state["masked"][SILOS[0]], card)


def span_seconds(tel, run_id: str):
    """Host seconds of the run's closed spans: by span name, and the
    round phases' by round (for an async run the round is the commit)."""
    host: dict = {}
    by_round: dict = {}
    for sp in tel.spans(run_id):
        if sp.t1 is None:
            continue
        host[sp.name] = host.get(sp.name, 0.0) + (sp.t1 - sp.t0)
        if sp.name.startswith("phase:") and sp.name not in (
                "phase:waiting_clients", "phase:validating",
                "phase:deploying"):
            rnd = (sp.attrs or {}).get("round")
            by_round[rnd] = by_round.get(rnd, 0.0) + (sp.t1 - sp.t0)
    return host, by_round


def print_host_seconds(what: str, host: dict, spans, card: str):
    keys = sorted(k for k in host if k.startswith("phase:")) + list(
        spans) + sorted(k for k in host if k.startswith("kernel:masked_sum"))
    print(f"{what} host s: " + ", ".join(
        f"{k} {host.get(k, 0.0):.3f}" for k in keys) + f" [{card}]",
        flush=True)


def print_board(what: str, stats: dict, card: str):
    print(f"{what} board: bytes posted {stats['bytes_posted']} (clients "
          f"{stats['bytes_posted_clients']}), fetched "
          f"{stats['bytes_fetched']}, posts {stats['posts']}, fetches "
          f"{stats['fetches']} [{card}]", flush=True)


def codec_seconds(buf, card: str, what: str = "fl run"):
    """Host seconds of one board message the size of a masked update:
    the board's msgpack, encrypt (SHAKE-256 stream + HMAC), decrypt and
    unpack, as ``ClientCommunicator.post`` and ``ServerCommunicator.
    collect`` run them."""
    from repro_torch.core import crypto, serialization
    key = FL_MASTER_KEY
    host, s_host = host_seconds(lambda: buf.cpu().numpy())
    blob, s_pack = host_seconds(serialization.pack, {"packed": host})
    ct, s_enc = host_seconds(crypto.encrypt, key, blob)
    pt, s_dec = host_seconds(crypto.decrypt, key, ct)
    out, s_unpack = host_seconds(serialization.unpack, pt)
    check(out["packed"].tobytes() == host.tobytes(), "codec round trip")
    print(f"{what} codec: one {len(blob)} B message: to host {s_host:.3f} s, "
          f"pack {s_pack:.3f} s, encrypt {s_enc:.3f} s, decrypt "
          f"{s_dec:.3f} s, unpack {s_unpack:.3f} s [{card}]", flush=True)


# ---------------------------------------------------------------------------
# phases 5c-5e: the hierarchical tier and the async buffered protocol
# ---------------------------------------------------------------------------
FLEET_DEVICES, FLEET_DROPOUT, FLEET_CLIP = 10_000, 0.05, 15.0
FLEET_COHORTS = (8, 16)        # phase 5c's two inner rounds
FLEET_RUN_COHORT = 8
FLEET_TWIN_ATOL = 1e-6         # engine mean delta vs the f64 twin
FLEET_PEAK_RATIO = 1.01        # peak fold bytes, cohort 16 over cohort 8
FLEET_SPANS = ("client.fetch", "client.train", "client.inner_round",
               "device.train", "client.compress", "client.post")
# the silos poll every 1st, 2nd and 3rd scheduler pass; with a buffer of 2
# the first two commits fold only fresh updates and the third folds two
# that trained on commit 1 (tau 1), so 3 commits are the fewest that show
# a stale fold (tests/test_torch_fl_async.py runs the same schedule)
ASYNC_CADENCES = (1, 2, 3)
ASYNC_BUFFER, ASYNC_COMMITS = 2, 3
ASYNC_SPANS = ("client.train", "client.post", "async.commit")


def fleet_job(cohort: int, reduced: bool, devices: int = FLEET_DEVICES,
              dropout: float = FLEET_DROPOUT):
    """A job whose silos front a device fleet (the chip-smoke contract:
    3 AdamW steps of 8 x 256 a device, lr 3e-4)."""
    from repro_torch.core.jobs import FLJob
    return FLJob.from_dict({
        "job_id": f"fleet-{cohort}", "arch": "fedforecast-100m",
        "reduced": reduced, "rounds": 1, "local_steps": LOCAL_STEPS,
        "batch_size": BATCH_SIZE, "lr": LR, "optimizer": "adamw",
        "outer_optimizer": "fedavg", "aggregation": "fedavg",
        "train_test_split": 0.2, "eval_metrics": ["loss"],
        "secure_aggregation": False, "data_schema": None,
        "devices_per_silo": devices, "device_cohort_size": cohort,
        "device_dropout": dropout, "device_clip": FLEET_CLIP})


def fleet_node(job, dataset, device, tel):
    """``SILOS[0]``'s ``FLClientNode`` with ``job`` set up (its fleet
    built), outside any board: the inner tier posts nothing."""
    from repro_torch.core.client import FLClientNode
    comm = SimpleNamespace(board=SimpleNamespace(telemetry=tel))
    node = FLClientNode(SILOS[0], comm, dataset, "fleet", [SILOS[0]], SECRET,
                        device=device)
    node._setup_job(job)
    return node


def fleet_phase(state, device, card: str, reduced: bool = False):
    """5c: one silo's ``InnerRoundEngine`` driven directly, at cohorts 8
    and 16 of a 10,000-device fleet, each device training from
    ``round_phase``'s init; each clipped delta folds into
    ``MaskedF32Sink`` (K1). A spy on the sink's ``fold`` keeps the plain
    twin: the same deltas summed in f64 on the card."""
    import torch
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.core import streaming
    from repro_torch.core.client import InnerRoundEngine
    from repro_torch.core.packing import pack_pytree
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.synthetic import make_silo_datasets
    from repro_torch.kernels.secure_agg import ops

    cfg = get_config("fedforecast-100m")
    vocab = (cfg.reduced() if reduced else cfg).vocab
    tel = Telemetry(enabled=True, recorder_cap=1 << 20)
    base = state["init"]
    base_buf = pack_pytree(base)[0].double()
    twin = {"sum": None, "weight": 0.0, "norms": []}
    fold = streaming.MaskedF32Sink.fold

    def spy(sink, buf, weight=1.0):
        d = buf.double()
        twin["norms"].append(float(torch.linalg.vector_norm(d)))
        twin["sum"] = (d.mul_(weight) if twin["sum"] is None
                       else twin["sum"].add_(d.mul_(weight)))
        twin["weight"] += float(weight)
        return fold(sink, buf, weight)

    silo = make_silo_datasets(1, vocab=vocab, seq_len=SEQ_LEN, seed=1)[0]
    rounds = []
    streaming.MaskedF32Sink.fold = spy
    try:
        for rnd, cohort in enumerate(FLEET_COHORTS):
            twin.update(sum=None, weight=0.0, norms=[])
            node = fleet_node(fleet_job(cohort, reduced), silo, device, tel)
            engine = InnerRoundEngine(node, rnd, LR, base)
            k1 = ops.LAUNCHES["masked_sum"]
            (params, loss, n), s = sync_seconds(engine.run)
            k1 = ops.LAUNCHES["masked_sum"] - k1
            check(len(engine.cohort) == cohort
                  and len(engine.cohort) == len(engine.dropped)
                  + engine.folded, f"round {rnd}: sampled {cohort} == "
                  f"dropped {len(engine.dropped)} + folded {engine.folded}")
            # (a CPU rehearsal runs K1's plain version, which counts none)
            flushes = math.ceil(engine.folded / streaming.DEFAULT_STREAM_BATCH)
            check(k1 >= (flushes if device.type == "cuda" else 0),
                  f"round {rnd}: K1 launched {k1} times for "
                  f"{engine.folded} folds")
            check(n == twin["weight"] and math.isfinite(loss),
                  f"round {rnd}: weight {n} == {twin['weight']}, loss {loss}")
            got = pack_pytree(params)[0].double() - base_buf
            err = float((got - twin["sum"] / twin["weight"]).abs().max())
            check(err <= FLEET_TWIN_ATOL,
                  f"round {rnd}: engine mean delta vs the f64 twin {err:.3g}")
            norms = sorted(twin["norms"])
            rounds.append({"cohort": cohort, "dropped": len(engine.dropped),
                           "folded": engine.folded, "k1": k1, "err": err,
                           "s": s, "per_sec": engine.folded / engine.elapsed,
                           "peak": engine.peak_fold_bytes,
                           "norm": norms[len(norms) // 2],
                           "clipped": sum(v >= FLEET_CLIP * (1 - 1e-4)
                                          for v in norms)})
            del params, got, engine
            twin["sum"] = None
    finally:
        streaming.MaskedF32Sink.fold = fold
    ratio = rounds[1]["peak"] / rounds[0]["peak"]
    check(ratio <= FLEET_PEAK_RATIO,
          f"peak fold bytes flat in cohort: {rounds[1]['peak']} / "
          f"{rounds[0]['peak']} = {ratio:.4f} <= {FLEET_PEAK_RATIO}")

    # the single-survivor shortcut: a one-device fleet is the flat silo
    job = fleet_job(1, reduced, devices=1, dropout=0.0)
    silo_a, silo_b = (make_silo_datasets(1, vocab=vocab, seq_len=SEQ_LEN,
                                         seed=1)[0] for _ in range(2))
    engine = InnerRoundEngine(fleet_node(job, silo_a, device, tel), 0, LR,
                              base)
    p1, l1, n1 = engine.run()
    p2, l2, n2 = fleet_node(job, silo_b, device, tel)._fit(silo_b, base, LR)
    check(engine.sink is None and (l1, n1) == (l2, n2)
          and all(torch.equal(a, b) for a, b in
                  zip(_tree.leaves(p1), _tree.leaves(p2))),
          "the single-survivor engine equals _fit bitwise")
    del p1, p2

    spans = tel.spans("fleet")      # the untraced rounds' spans
    train_ms = sorted((sp.t1 - sp.t0) * 1e3 for sp in spans
                      if sp.name == "device.train" and sp.t1 is not None)
    fold_ms = sorted((sp.t1 - sp.t0) * 1e3 for sp in spans
                     if sp.name == "kernel:masked_sum_stream"
                     and sp.t1 is not None)

    # one more inner round at cohort 8 under the profiler: the card's busy
    # time against round 0's untraced seconds (8 devices each) is the
    # fleet tier's device idle share
    trace = None
    if device.type == "cuda":
        node = fleet_node(fleet_job(FLEET_COHORTS[0], reduced), silo, device,
                          tel)
        trace = device_ms_by_kernel(
            lambda: InnerRoundEngine(node, 2, LR, base).run(), calls=1)
    print(f"fleet: fedforecast-100m {'reduced' if reduced else 'full width'}"
          f", T={state['T']}, silo {SILOS[0]}, {FLEET_DEVICES} devices, "
          f"dropout {FLEET_DROPOUT}, clip {FLEET_CLIP}; " + "; ".join(
              f"round {i} cohort {r['cohort']}: dropped {r['dropped']}, "
              f"folded {r['folded']}, K1 launches {r['k1']}, vs f64 twin "
              f"{r['err']:.3g} (atol {FLEET_TWIN_ATOL}), delta norm median "
              f"{r['norm']:.3f}, clipped {r['clipped']}"
              for i, r in enumerate(rounds))
          + f"; single-survivor engine == _fit bitwise [{card}]", flush=True)
    print("fleet: " + "; ".join(
        f"round {i}: {r['s']:.3f} s, {r['per_sec']:.3f} devices/s, peak "
        f"fold bytes {r['peak']}" for i, r in enumerate(rounds))
        + f" (ratio {ratio:.4f}); device.train median "
        f"{statistics.median(train_ms):.2f} ms, max {train_ms[-1]:.2f} ms "
        f"over {len(train_ms)} devices; K1 fold (kernel:masked_sum_stream) "
        f"median "
        f"{statistics.median(fold_ms):.3f} ms over {len(fold_ms)} flushes "
        f"[{card}]", flush=True)
    if trace is not None:
        busy = sum(trace.values())
        k1 = sum(v for k, v in trace.items() if k.startswith("combine_"))
        top = sorted(trace.items(), key=lambda kv: -kv[1])[:4]
        print(f"fleet trace: an inner round of {FLEET_COHORTS[0]} devices: "
              f"device busy {busy:.1f} ms against round 0's untraced "
              f"{rounds[0]['s'] * 1e3:.1f} ms -> device idle share "
              f"{1 - busy / (rounds[0]['s'] * 1e3):.3f}; K1 {k1:.3f} ms; top "
              + "; ".join(f"{k[:40]} {v:.2f} ms" for k, v in top)
              + f" [{card}]", flush=True)


def fleet_run_phase(state, device, card: str, reduced: bool = False):
    """5d: the hierarchical federation end to end: ``Consortium`` over the
    3 silos, each fronting a 10,000-device fleet (cohort 8), one secure
    outer round (``MaskedF32Sink``, K1, on the server; K1 in every silo's
    inner fold), then evaluate, deploy and one ``predict``."""
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.core import Consortium, Telemetry
    from repro_torch.data.synthetic import make_silo_datasets

    cfg = get_config("fedforecast-100m")
    vocab = (cfg.reduced() if reduced else cfg).vocab
    tel = Telemetry(enabled=True, recorder_cap=1 << 20)
    con = Consortium(SILOS, seed=0, master_key=FL_MASTER_KEY, device=device,
                     telemetry=tel, initial_params=state["init"])
    contract = con.negotiate({
        "arch": "fedforecast-100m", "reduced": reduced, "rounds": 1,
        "local_steps": LOCAL_STEPS, "batch_size": BATCH_SIZE, "lr": LR,
        "data_schema": {"vocab": vocab, "seq_len": SEQ_LEN},
        "secure_aggregation": True, "gc_round_resources": True,
        "devices_per_silo": FLEET_DEVICES,
        "device_cohort_size": FLEET_RUN_COHORT,
        "device_dropout": FLEET_DROPOUT, "device_clip": FLEET_CLIP})
    job = con.server.job_creator.from_contract(contract)
    datasets = make_silo_datasets(len(SILOS), vocab=vocab, seq_len=SEQ_LEN,
                                  seed=1)
    run_id = con.start(job, datasets)
    phase, wall = sync_seconds(con.run_to_completion)
    server, run = con.server, con.server.run
    check(phase == "done", f"the fleet run ends in done (got {phase})")
    check(server.metadata.verify_chain(), "the provenance chain verifies")
    check(len(run.history) == 1, f"1 round committed ({len(run.history)})")
    inner = []
    for node in con.nodes:
        recs = node.metadata.query(operation="inner_round")
        check(len(recs) == 1 and recs[0]["details"]["sampled"]
              == FLEET_RUN_COHORT == recs[0]["details"]["dropped"]
              + recs[0]["details"]["folded"],
              f"{node.client_id}: one inner round of {FLEET_RUN_COHORT} "
              f"sampled: {[r['details'] for r in recs]}")
        inner.append(recs[0]["details"])
    g = server.store.get(run.history[0]["digest"])
    move = max(float((x.float() - y.float()).abs().max())
               for x, y in zip(_tree.leaves(g), _tree.leaves(state["init"])))
    check(move <= FL_ROUND1_MOVE,
          f"the fleet round moves a weight {move:.3g} <= {FL_ROUND1_MOVE}")
    losses = list(run.history[0]["train_losses"].values()) + [
        run.history[0]["mean_eval_loss"]]
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    node = next(n for n in con.nodes if n.deployed_params is not None)
    prompt = datasets[0].batch(1)["tokens"][:, :32]
    toks, s_predict = sync_seconds(node.predict, prompt, 8)
    check(toks.shape == (1, 8) and 0 <= toks.min() and toks.max() < vocab,
          f"predict returns tokens in range: {toks.tolist()}")
    host, by_round = span_seconds(tel, run_id)
    width = "reduced" if reduced else "full width"
    print(f"fleet run: fedforecast-100m {width}, {len(SILOS)} silos x "
          f"{FLEET_DEVICES} devices, cohort "
          f"{FLEET_RUN_COHORT}, dropout {FLEET_DROPOUT}, clip {FLEET_CLIP}, "
          f"1 secure round; phase {phase}, chain intact; inner rounds "
          + "; ".join(f"folded {d['folded']} dropped {d['dropped']} "
                      f"{d['devices_per_sec']:.3f} devices/s peak fold "
                      f"bytes {d['peak_fold_bytes']}" for d in inner)
          + f"; moves {move:.3g}; losses {[round(v, 4) for v in losses]}; "
          f"predict {toks.tolist()} [{card}]", flush=True)
    print(f"fleet run: wall {wall:.3f} s over {con.scheduler.passes} passes;"
          f" per-round s " + ", ".join(
              f"r{k} {v:.3f}" for k, v in sorted(by_round.items()))
          + f"; predict {s_predict:.3f} s [{card}]", flush=True)
    print_host_seconds("fleet run", host, FLEET_SPANS, card)
    print_board("fleet run", server.board.stats, card)


def async_phase(state, device, card: str, reduced: bool = False):
    """5e: the async buffered protocol end to end: ``Consortium`` with
    ``protocol="async_buff"`` (secure aggregation off, as the job matrix
    requires), the silos polling at cadences 1/2/3, 2 folds a commit, 3
    commits, then the final evaluate, deploy and one ``predict``. A spy
    on the server's ``comm.collect`` keeps commit 0's folded messages, and
    commit 0's global is recomputed from them in numpy."""
    import numpy as np
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.convert import params_to_numpy
    from repro_torch.core import Consortium, Telemetry
    from repro_torch.core.packing import PackedLayout
    from repro_torch.core.protocol import staleness_weight
    from repro_torch.data.synthetic import make_silo_datasets

    cfg = get_config("fedforecast-100m")
    vocab = (cfg.reduced() if reduced else cfg).vocab
    tel = Telemetry(enabled=True, recorder_cap=1 << 20)
    con = Consortium(SILOS, seed=0, master_key=FL_MASTER_KEY, device=device,
                     telemetry=tel, initial_params=state["init"])
    contract = con.negotiate({
        "arch": "fedforecast-100m", "reduced": reduced,
        "rounds": ASYNC_COMMITS, "local_steps": LOCAL_STEPS,
        "batch_size": BATCH_SIZE, "lr": LR,
        "data_schema": {"vocab": vocab, "seq_len": SEQ_LEN},
        "protocol": "async_buff", "async_buffer_size": ASYNC_BUFFER,
        "secure_aggregation": False, "gc_round_resources": True})
    job = con.server.job_creator.from_contract(contract)
    datasets = make_silo_datasets(len(SILOS), vocab=vocab, seq_len=SEQ_LEN,
                                  seed=1)
    for org, ds, k in zip(SILOS, datasets, ASYNC_CADENCES):
        con.scheduler.register_agent(con.client_ids[org], ds, tick_every=k)
    run_id = con.start(job, datasets)
    server, run = con.server, con.server.run
    folds = []
    collect = server.comm.collect

    def spy(path, cid):
        msg = collect(path, cid)
        if "/async/update/" in path and len(folds) < ASYNC_BUFFER:
            folds.append(msg)          # commit 0's folds, in fold order
        return msg
    server.comm.collect = spy
    phase, wall = sync_seconds(con.run_to_completion)
    check(phase == "done", f"the async run ends in done (got {phase})")
    check(server.metadata.verify_chain(), "the provenance chain verifies")
    commits = server.metadata.query(operation="async_commit")
    check(len(commits) == len(run.history) == ASYNC_COMMITS,
          f"{ASYNC_COMMITS} commits ({len(commits)})")
    for c in commits:
        ws = c["details"]["weights"]
        check(all(w > 0 for w in ws) and abs(sum(ws) - 1.0) <= 1e-12,
              f"commit weights positive, summing to 1: {ws}")
    taus = [c["details"]["staleness"] for c in commits]
    check(any(t > 0 for ts in taus for t in ts),
          f"a stale fold at cadences {ASYNC_CADENCES}: {taus}")

    # commit 0 in numpy, as the reference folds it: buffer + w * delta
    # (w rounded to f32), buffer / float32(weight), then the leaf add
    buffer, weight = None, 0.0
    for msg in folds:
        w = staleness_weight(max(0, 0 - int(msg["base_commit"])))
        delta = np.asarray(msg["delta"], np.float32)
        buffer = w * delta if buffer is None else buffer + w * delta
        weight += w
    mean = buffer / np.float32(weight)
    got = _tree.leaves(params_to_numpy(server.store.get(
        run.history[0]["digest"])))
    init = _tree.leaves(params_to_numpy(state["init"]))
    layout = PackedLayout.for_tree(state["init"])
    check(all(np.array_equal(g, p.astype(np.float32) + mean[
              sp.offset:sp.offset + sp.size].reshape(sp.shape))
              for g, p, sp in zip(got, init, layout.leaves)),
          "commit 0's global equals the numpy fold bitwise")
    del folds, buffer, mean, got, init

    losses = [h["mean_train_loss"] for h in run.history] + [
        run.history[-1]["mean_eval_loss"]]
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    node = con.nodes[0]                # cadence 1: deployed at done
    check(node.deployed_params is not None, "the cadence-1 silo deployed")
    prompt = datasets[0].batch(1)["tokens"][:, :32]
    toks, s_predict = sync_seconds(node.predict, prompt, 8)
    check(toks.shape == (1, 8) and 0 <= toks.min() and toks.max() < vocab,
          f"predict returns tokens in range: {toks.tolist()}")
    host, _ = span_seconds(tel, run_id)
    ends = [sp.t1 for sp in tel.spans(run_id)
            if sp.name == "async.commit" and sp.t1 is not None]
    serve0 = min(sp.t0 for sp in tel.spans(run_id)
                 if sp.name == "phase:async_serve")
    gaps = [b - a for a, b in zip([serve0] + ends, ends)]
    width = "reduced" if reduced else "full width"
    print(f"async run: fedforecast-100m {width}, {len(SILOS)} silos at "
          f"cadences {ASYNC_CADENCES}, "
          f"buffer {ASYNC_BUFFER}, {ASYNC_COMMITS} commits; phase {phase}, "
          f"chain intact; staleness {taus}, weights "
          f"{[c['details']['weights'] for c in commits]}; commit 0 == numpy "
          f"fold bitwise; losses {[round(v, 4) for v in losses]}; predict "
          f"{toks.tolist()} [{card}]", flush=True)
    print(f"async run: wall {wall:.3f} s over {con.scheduler.passes} passes;"
          f" per-commit s " + ", ".join(f"c{i} {g:.3f}"
                                        for i, g in enumerate(gaps))
          + f"; predict {s_predict:.3f} s [{card}]", flush=True)
    print_host_seconds("async run", host, ASYNC_SPANS, card)
    print_board("async run", server.board.stats, card)


# ---------------------------------------------------------------------------
# phases 5f-5h: the training launcher (pod and sim modes) and the T-split
# aggregation
# ---------------------------------------------------------------------------
POD_STEPS, POD_SYNC = 8, 4
POD_SYNC_ULPS = 1.0        # FedAvg vs the f64 mean of the two silos
SPLIT_SHARDS = (2, 3)      # agg_mesh([card] * n): the split on one card
SPLIT_SHORT = 77           # K1/K2 also at T - 77, K3/K4 at Tp - CHUNK


def ulps_off(got, exact) -> float:
    """Largest |got - exact| over f32 ulps of |got| (``exact`` in f64)."""
    import torch
    mag = got.abs()
    ulp = (torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag)
    return float(((got.double() - exact).abs() / ulp.double()).max())


def traced_busy(fn, *args):
    """One call of ``fn`` under ``torch.profiler``: (device busy ms, kernel
    launches, the four longest kernels, traced wall s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced_s = sync_seconds(fn, *args)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:4]
    return (busy_ms, sum(e.count for e in kernels),
            "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                      for e in top), traced_s)


def train_pod_phase(device, card: str, reduced: bool = False):
    """5f: ``repro_torch.launch.train.run_pod`` as ``--mode pod --full``
    runs it: 2 silos stacked on the card, batch 8 x 256, 8 steps, FedAvg
    every 4, lr 3e-4, seed 0. Gates: finite per-silo losses; after each
    FedAvg the two silos bitwise equal, and within 1 f32 ulp of the f64
    mean of the trained silos; at step 0 silo 1 bitwise equal to
    ``make_train_step`` alone on its slice and batch; the int8 FedAvg of
    the last trained stack within each leaf's largest per-silo scale +
    1e-6 of the f32 mean, both silos bitwise equal. ``reduced`` runs the
    2-layer variant (a CPU rehearsal). Returns the median pod-step ms."""
    import numpy as np
    import torch
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import (fedavg_pod_params,
                                      make_fedavg_pod_step,
                                      make_multipod_train_step,
                                      make_train_step)
    from repro_torch.training.steps import silo

    args = train.parse_args(
        ["--mode", "pod", "--steps", str(POD_STEPS), "--sync-every",
         str(POD_SYNC), "--batch-size", str(BATCH_SIZE), "--seq-len",
         str(SEQ_LEN), "--lr", str(LR), "--seed", "0", "--device",
         str(device)] + ([] if reduced else ["--full"]))
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if reduced else cfg
    model = build_model(cfg, device=device)
    opt = adamw(args.lr)
    seen = {"ulps": 0.0, "syncs": 0}

    def on_step(i, st):
        trained, params = st["trained"], st["params"]
        if i == 0:
            before_p, before_o = st["before"]
            p1, _, m1 = make_train_step(model, opt)(
                silo(before_p, 1), silo(before_o, 1), silo(st["batch"], 1))
            same = all(torch.equal(a, b) for a, b in zip(
                _tree.leaves(silo(trained, 1)), _tree.leaves(p1)))
            check(same and torch.equal(st["metrics"]["loss"][1], m1["loss"]),
                  "step 0: silo 1 of the pod step == make_train_step alone "
                  "on its slice and batch, bitwise")
        if not st["synced"]:
            return
        for t, p in zip(_tree.leaves(trained), _tree.leaves(params)):
            check(torch.equal(p[0], p[1]),
                  f"step {i}: the silos are bitwise equal after FedAvg")
            seen["ulps"] = max(seen["ulps"],
                               ulps_off(p[0], t.double().mean(0)))
        seen["syncs"] += 1
        seen["trained"] = trained

    out = train.run_pod(args, on_step=on_step)
    check(bool(torch.isfinite(torch.from_numpy(out["losses"])).all()),
          f"finite per-silo losses {out['losses'].tolist()}")
    check(seen["syncs"] == POD_STEPS // POD_SYNC,
          f"{POD_STEPS // POD_SYNC} FedAvgs (got {seen['syncs']})")
    check(seen["ulps"] <= POD_SYNC_ULPS,
          f"FedAvg within {POD_SYNC_ULPS} ulp of the f64 mean: "
          f"{seen['ulps']:.3g}")

    stack = seen.pop("trained")
    qstep = make_fedavg_pod_step(quantize=True)
    q = qstep(stack)
    q_err, q_bound = 0.0, math.inf
    for t, r in zip(_tree.leaves(stack), _tree.leaves(q)):
        check(torch.equal(r[0], r[1]), "int8 FedAvg: silos bitwise equal")
        dims = tuple(range(1, t.dim()))
        scale = float((torch.amax(t.abs(), dim=dims) if dims
                       else t.abs()).max()) / 127.0
        err = float((r[0] - t.mean(0)).abs().max())
        check(err <= scale + 1e-6,
              f"int8 FedAvg within the largest per-silo scale: {err:.3g} > "
              f"{scale:.3g} + 1e-6")
        q_err = max(q_err, err)
        q_bound = min(q_bound, scale + 1e-6)
    fp32_ms = median_ms(lambda: fedavg_pod_params(stack))
    int8_ms = median_ms(lambda: qstep(stack))
    nbytes = sum(t.numel() * t.element_size() for t in _tree.leaves(stack))
    del q, stack

    step = make_multipod_train_step(model, opt, 2)
    toks = train.pod_batch(np.random.default_rng(1), cfg.vocab,
                           args.batch_size, args.seq_len)
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    step(out["params"], out["opt_state"], batch)           # warm-up
    busy_ms, n_launch, top, traced_s = traced_busy(
        step, out["params"], out["opt_state"], batch)
    step_ms = statistics.median(out["step_s"]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["losses"]
    print(f"train pod: fedforecast-100m {'reduced' if reduced else 'full '
          'width'}, 2 silos stacked on the card, {POD_STEPS} steps of "
          f"{args.batch_size} x {args.seq_len}, FedAvg every {POD_SYNC}; "
          f"losses silo 0 {[round(v, 4) for v in losses[:, 0].tolist()]}, "
          f"silo 1 {[round(v, 4) for v in losses[:, 1].tolist()]}; FedAvg "
          f"within {seen['ulps']:.3g} ulp of the f64 mean (gate "
          f"{POD_SYNC_ULPS}); step 0 silo 1 == lone step bitwise; int8 "
          f"FedAvg max err {q_err:.3g} (<= largest per-silo scale + 1e-6) "
          f"[{card}]", flush=True)
    print(f"train pod: pod step median {step_ms:.2f} ms ("
          f"{step_ms / 2:.2f} ms a silo-step; first "
          f"{out['step_s'][0] * 1e3:.2f}); FedAvg fp32 {fp32_ms:.4f} ms, "
          f"int8 {int8_ms:.4f} ms over {nbytes} B of params; peak "
          f"{peak:.2f} GiB [{card}]", flush=True)
    print(f"trace: pod step device busy {busy_ms:.2f} ms in {n_launch} "
          f"kernel launches; untraced step median {step_ms:.2f} ms -> "
          f"device idle share {1 - busy_ms / step_ms:.3f}; traced step "
          f"{traced_s * 1e3:.2f} ms; top: {top} [{card}]", flush=True)
    return step_ms


def train_sim_phase(state, device, card: str, reduced: bool = False):
    """5g: ``repro_torch.launch.train.run_sim`` as ``--mode sim --full
    --rounds 1`` runs it, the launcher's defaults otherwise (3 silos, 5
    local steps of 4 x 64, secure aggregation on), with a telemetry bundle
    on the board. Gates: done, the chain verifies, finite losses (K1 is
    read by the caller)."""
    from repro_torch.core import Telemetry
    from repro_torch.launch import train

    args = train.parse_args(["--mode", "sim", "--rounds", "1", "--device",
                             str(device)] + ([] if reduced else ["--full"]))
    tel = Telemetry(enabled=True, recorder_cap=1 << 20)
    out = train.run_sim(args, telemetry=tel)
    con = out["consortium"]
    check(out["phase"] == "done", f"the sim run ends in done "
          f"(got {out['phase']})")
    check(out["chain_ok"], "the metadata chain verifies")
    run = con.server.run
    losses = [v for h in run.history for v in h["train_losses"].values()]
    losses += list(out["report"]["loss_curve"])
    check(len(run.history) == 1 and all(math.isfinite(v) for v in losses),
          f"one round, finite losses {losses}")
    host, by_round = span_seconds(tel, out["run_id"])
    print(f"train sim: fedforecast-100m {'reduced' if reduced else 'full '
          'width'}, {args.silos} silos, {args.rounds} secure round x "
          f"{args.local_steps} steps of {args.batch_size} x {args.seq_len}; "
          f"phase {out['phase']}, chain intact; losses "
          f"{[round(v, 4) for v in losses]} [{card}]", flush=True)
    print(f"train sim: wall {out['wall_s']:.3f} s over "
          f"{con.scheduler.passes} passes; per-round s " + ", ".join(
              f"r{k} {v:.3f}" for k, v in sorted(by_round.items()))
          + f" [{card}]", flush=True)
    print_host_seconds("train sim", host, FL_SPANS, card)
    print_board("train sim", con.server.board.stats, card)
    codec_seconds(state["masked"][SILOS[0]], card, "train sim")


def agg_split_phase(state, device, card: str) -> dict:
    """5h: the four ``sharding.agg`` ops over ``agg_mesh([card] * 2)`` and
    ``agg_mesh([card] * 3)`` at the round's shapes (K1 (3, T), K2 (2, T),
    K3 (3, Tp), K4 (1, Tp), K4 with corrections (2, Tp)) and at T - 77
    (K1, K2) or Tp - CHUNK (K3, K4: their T stays a CHUNK multiple), held
    against the unsplit launch: K1-K3 within 1e-5, K4 bitwise, one launch
    a shard; then the 2-shard K1 over phase 4's three masked buffers,
    bitwise equal to a ``MaskedF32Sink`` folding them. Returns the
    launches of the checked split calls, read from the counters (the
    timing calls are left out)."""
    import torch
    from repro_torch.core.streaming import MaskedF32Sink
    from repro_torch.kernels.compressed_agg import ops as cops
    from repro_torch.kernels.secure_agg import ops as sops
    from repro_torch.sharding import agg as shard

    meshes = {n: shard.agg_mesh([device] * n) for n in SPLIT_SHARDS}
    t = state["T"]
    tp = t + (-t) % CHUNK
    gen = torch.Generator(device=device).manual_seed(8765)

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, generator=gen, device=device) * (hi - lo) \
            + lo

    def residues(*shape):            # mod 2**16, as int32 storage
        return torch.randint(0, 1 << 16, shape, generator=gen,
                             device=device, dtype=torch.int32)

    x3 = torch.stack([state["masked"][c] for c in SILOS])
    c2 = torch.stack([state["plain"][c] for c in SILOS[:2]])
    q3 = torch.randint(-127, 128, (3, tp), generator=gen, device=device,
                       dtype=torch.int8)
    s3 = uniform(1e-6, 1e-2, 3, tp // CHUNK)
    grid = uniform(1e-6, 1e-2, tp // CHUNK)
    z1, z2, zc2 = residues(1, tp), residues(2, tp), residues(2, tp)
    w3, w2 = uniform(0.5, 1.5, 3), uniform(0.5, 1.5, 2)

    def cut(a, width):
        return a[..., :width].contiguous()

    def cases(short: bool):
        tt = t - SPLIT_SHORT if short else t
        tq = tp - CHUNK if short else tp
        x, xc, cc = cut(x3, tt), cut(x3[:2], tt), cut(c2, tt)
        q, s = cut(q3, tq), cut(s3, tq // CHUNK)
        g = cut(grid, tq // CHUNK)
        a1, a2, ac = cut(z1, tq), cut(z2, tq), cut(zc2, tq)
        return [
            ("masked_sum", f"K1 (3, {tt})", sops.masked_sum,
             shard.sharded_masked_sum, (x, w3), {}),
            ("masked_sum_corrected", f"K2 (2, {tt})",
             sops.masked_sum_corrected, shard.sharded_masked_sum_corrected,
             (xc, cc, w2), {}),
            ("dequant_reduce", f"K3 (3, {tq})", cops.dequant_reduce,
             shard.sharded_dequant_reduce, (q, s, w3), {}),
            ("masked_dequant_reduce", f"K4 (1, {tq})",
             cops.masked_dequant_reduce, shard.sharded_masked_dequant_reduce,
             (a1, g), {"modulus_bits": 16}),
            ("masked_dequant_reduce_corrected", f"K4+corr (2, {tq})",
             cops.masked_dequant_reduce, shard.sharded_masked_dequant_reduce,
             (a2, g), {"modulus_bits": 16, "corr": ac}),
        ]

    def counts():
        return {**sops.LAUNCHES, **cops.LAUNCHES}

    tally = {k: 0 for k in counts()}
    bitwise = {}
    for short in (False, True):
        for name, what, plain, split, a, kw in cases(short):
            ref = plain(*a, **kw)
            times = [median_ms(lambda f=plain, a=a, kw=kw: f(*a, **kw))] \
                if not short else []
            for n, mesh in meshes.items():
                before = counts()
                got = split(*a, **kw, mesh=mesh)
                after = counts()
                delta = {k: after[k] - before[k] for k in after}
                if device.type == "cuda":    # the plain versions count none
                    check(delta[name] == n and sum(delta.values()) == n,
                          f"{what} over {n} shards launches {name} once a "
                          f"shard: {delta}")
                tally[name] += delta[name]
                check(got.shape == ref.shape, f"{what}: split shape")
                err = float((got - ref).abs().max())
                same = torch.equal(got, ref)
                if name.startswith("masked_dequant"):
                    check(same, f"{what} over {n} shards bitwise equal to "
                          f"the unsplit launch (max err {err:.3g})")
                else:
                    check(err <= KERNEL_ATOL, f"{what} over {n} shards "
                          f"within {KERNEL_ATOL} of unsplit: {err:.3g}")
                bitwise[f"{what} /{n}"] = same
                if not short:
                    times.append(median_ms(
                        lambda f=split, a=a, kw=kw, m=mesh: f(*a, **kw,
                                                              mesh=m)))
            if times:
                print(f"agg split: {what}: unsplit {times[0]:.4f} ms, "
                      + ", ".join(f"{n} shards {ms:.4f} ms" for n, ms in
                                  zip(meshes, times[1:])) + f" [{card}]",
                      flush=True)

    sink = MaskedF32Sink(t, device=device)
    for c in SILOS:
        sink.fold(state["masked"][c])
    sink_total = sink.finalize()
    before = counts()
    split_total = shard.sharded_masked_sum(
        x3, torch.ones(len(SILOS), device=device), mesh=meshes[2])
    delta = counts()["masked_sum"] - before["masked_sum"]
    if device.type == "cuda":
        check(delta == 2, f"the 2-shard K1 launches twice ({delta})")
    tally["masked_sum"] += delta
    check(torch.equal(split_total, sink_total),
          "the 2-shard K1 over the masked buffers == MaskedF32Sink, bitwise")
    print(f"agg split: shards {list(meshes)}; bitwise equal to the unsplit "
          f"launch: {sum(bitwise.values())} of {len(bitwise)} "
          f"(not: {[k for k, v in bitwise.items() if not v]}); the 2-shard "
          f"K1 over the masked buffers == MaskedF32Sink, bitwise [{card}]",
          flush=True)
    return {k: v for k, v in tally.items() if v}


# ---------------------------------------------------------------------------
# phase 6: the compressed planes, on the round's trained silos
# ---------------------------------------------------------------------------
def host_seconds(fn, *args, **kw):
    """``(fn(*args, **kw), seconds)`` on the host clock alone."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def silo_delta(state, cid: str, stage: dict):
    """The silo's packed delta on the card, then on the host (the coding
    is numpy); times both steps into ``stage``."""
    from repro_torch.core.protocol import pack_delta
    delta, s = sync_seconds(pack_delta, state["trained"][cid], state["init"])
    stage.setdefault("pack_delta", []).append(s)
    host, s = sync_seconds(lambda: delta.cpu().numpy())
    stage.setdefault("to_host", []).append(s)
    return host


def print_stages(what: str, stage: dict, card: str):
    print(f"{what} stages (s): " + ", ".join(
        f"{k} " + "/".join(f"{v:.4f}" for v in vals)
        for k, vals in stage.items()) + f" [{card}]", flush=True)


def int8_phase(state, device, card: str):
    """6a: a plain int8 round, adaptive per-chunk scales, through K3."""
    import numpy as np
    from repro_torch.core.compression import (decompress,
                                              make_error_feedback,
                                              quantized_values, wire_bytes)
    from repro_torch.core.streaming import QuantSink

    t = state["T"]
    stage: dict = {}
    msgs = {}
    sink = QuantSink(t, device=device)
    for cid in SILOS:
        host = silo_delta(state, cid, stage)
        ef = make_error_feedback(INT8_JOB, cid, device=device)
        msgs[cid], s = host_seconds(ef.step, host)
        stage.setdefault("quantize_zlib", []).append(s)
        q, s = host_seconds(quantized_values, msgs[cid])
        stage.setdefault("unzlib", []).append(s)
        _, s = sync_seconds(sink.fold, cid, q, msgs[cid]["scales"],
                            state["n_examples"][cid])
        stage.setdefault("fold", []).append(s)
    total, s = sync_seconds(sink.finalize)
    stage["finalize"] = [s]
    mean = (total / float(sink.total_weight)).cpu().numpy()
    tw = sum(float(state["n_examples"][c]) for c in SILOS)
    expect = sum(float(state["n_examples"][c])
                 * decompress(msgs[c]).astype(np.float64)
                 for c in SILOS) / tw
    err = float(np.abs(mean.astype(np.float64) - expect).max())
    check(err <= ROUND_ATOL, f"int8 mean vs f64 host sum {err:.3g}")
    check(np.isfinite(mean).all() and mean.shape == (t,),
          "int8 mean finite, of the packed size")
    wire = sum(wire_bytes(m) for m in msgs.values())
    print(f"int8 round: mean vs f64 host sum of the decompressed posts "
          f"{err:.3g} (atol {ROUND_ATOL}); wire {wire} bytes for "
          f"{len(SILOS)} silos ({wire / (4 * t * len(SILOS)):.3f} of fp32); "
          f"norms {[round(v, 6) for v in sink.norms.values()]}", flush=True)
    print_stages("int8 round", stage, card)


def secure_int8_phase(state, device, card: str):
    """6b: a secure int8 round (integer masks mod 2**16) through K4; the
    decoded sum must equal the fixed-grid plain twin's, bitwise."""
    import numpy as np
    from repro_torch.core.compression import (compress, make_error_feedback,
                                              quantized_values)
    from repro_torch.core.secure_agg import int_mask_offset, \
        mask_modulus_bits
    from repro_torch.core.streaming import ModularSink

    t = state["T"]
    tp = t + (-t) % CHUNK
    cohort = sorted(SILOS)
    mbits = mask_modulus_bits(len(cohort), INT8_JOB.quant_bits)
    check(mbits == 16, f"3 silos ride a 16-bit modulus (got {mbits})")
    stage: dict = {}
    msgs, twin = {}, {}
    for cid in SILOS:
        host = silo_delta(state, cid, stage)
        w = state["n_examples"][cid] / float(LOCAL_STEPS * BATCH_SIZE)
        ef = make_error_feedback(INT8_JOB, cid, device=device)
        msgs[cid], s = sync_seconds(ef.step_masked, host, weight=w,
                                    client_id=cid, cohort=cohort,
                                    pair_secret=SECRET)
        stage.setdefault("quantize_mask", []).append(s)
        # the fixed-grid plain twin: same rounding stream, same buffer
        twin_rng = make_error_feedback(INT8_JOB, cid).rng
        twin[cid] = quantized_values(compress(
            w * host, "int8", grid=ef.grid, rng=twin_rng))
    grid = msgs[SILOS[0]]["grid"]
    check(all(m["mbits"] == mbits and m["z"].dtype == np.uint16
              and m["z"].shape == (tp,) for m in msgs.values()),
          "uint16 residue streams of the padded size")
    # the mask pass alone (it also ran inside each step_masked above)
    _, s = sync_seconds(int_mask_offset, tp, SILOS[0], cohort, SECRET,
                        mbits, device=device)
    stage["int_mask_pass"] = [s]
    sink = ModularSink(t, mbits=mbits, grid=grid, device=device)
    for cid in SILOS:
        _, s = sync_seconds(sink.fold, msgs[cid]["z"])
        stage.setdefault("fold", []).append(s)
    total, s = sync_seconds(sink.finalize)
    stage["finalize"] = [s]
    expect = np.float32(sum(twin[c].astype(np.int64) for c in SILOS)) \
        * np.float32(grid)
    got = total.cpu().numpy()
    check(np.array_equal(got.view(np.uint32), expect.view(np.uint32)),
          "secure int8 decode bitwise equal to the plain twin's "
          f"float32(sum q) * grid (max diff {np.abs(got - expect).max()})")
    print(f"secure int8 round: mbits {mbits}, grid {grid:.6g}; decoded sum "
          f"bitwise equal to the plain twin's float32(sum q) * grid; wire "
          f"{sum(m['z'].nbytes for m in msgs.values())} bytes", flush=True)
    print_stages("secure int8 round", stage, card)
    state["secure_int8"] = {"msgs": msgs, "twin": twin, "mbits": mbits,
                            "grid": grid}


def int_repair_phase(state, device, card: str):
    """6c: solarx drops after masking; integer repair streamed (K4) and
    stacked (K4 with corrections), both bitwise equal to the twin sum."""
    import numpy as np
    import torch
    from repro_torch.core.secure_agg import int_repair_correction, u32_bits
    from repro_torch.core.streaming import ModularSink
    from repro_torch.kernels.compressed_agg.ops import masked_dequant_reduce

    sec = state["secure_int8"]
    msgs, mbits, grid = sec["msgs"], sec["mbits"], sec["grid"]
    t = state["T"]
    tp = t + (-t) % CHUNK
    survivors = [c for c in SILOS if c != DROPPED]
    corr, s_corr = sync_seconds(lambda: {
        c: int_repair_correction(tp, c, [DROPPED], SECRET, mbits,
                                 device=device) for c in survivors})

    def streamed():
        sink = ModularSink(t, mbits=mbits, grid=grid, device=device)
        for c in survivors:
            sink.fold(msgs[c]["z"])
            sink.fold_correction(corr[c])
        return sink.finalize()

    def stacked():
        z = torch.stack([u32_bits(msgs[c]["z"], device) for c in survivors])
        cc = torch.stack([corr[c].view(torch.int32) for c in survivors])
        g = torch.full((tp // CHUNK,), grid, dtype=torch.float32,
                       device=device)
        return masked_dequant_reduce(z, g, modulus_bits=mbits, corr=cc)[:t]
    stream_total, s_stream = sync_seconds(streamed)
    stack_total, s_stack = sync_seconds(stacked)
    expect = np.float32(sum(sec["twin"][c].astype(np.int64)
                            for c in survivors)) * np.float32(grid)
    a, b = stream_total.cpu().numpy(), stack_total.cpu().numpy()
    check(np.array_equal(a.view(np.uint32), b.view(np.uint32)),
          "integer repair: streamed bitwise equal to stacked")
    check(np.array_equal(a.view(np.uint32), expect.view(np.uint32)),
          "integer repair: bitwise equal to the survivors' twin sum "
          f"(max diff {np.abs(a - expect).max()})")
    print(f"integer repair: dropped {DROPPED}; streamed and stacked "
          f"decodes bitwise equal to each other and to the survivors' twin "
          f"sum; corrections (int mask pass) {s_corr:.4f} s, streamed "
          f"fold+decode {s_stream:.4f} s, stacked decode {s_stack:.4f} s "
          f"[{card}]", flush=True)


def combine_phase(state, device, card: str):
    """6d: ``combine_pytrees`` over the trained params, weights 1/3 (K5)."""
    from repro_torch import tree
    from repro_torch.kernels.secure_agg.ops import combine_pytrees

    trees = [state["trained"][c] for c in SILOS]
    w = [1.0 / len(SILOS)] * len(SILOS)
    agg, s = sync_seconds(combine_pytrees, trees, w, device=device)
    mean = tree.tree_map(lambda *xs: sum(xs) / float(len(xs)), *trees)
    max_scale = max(max(float(leaf.abs().max()) for leaf in tree.leaves(p))
                    for p in trees) / 127.0
    err = max(float((a - m).abs().max())
              for a, m in zip(tree.leaves(agg), tree.leaves(mean)))
    check(err <= max_scale,
          f"combine_pytrees within the int8 scale: {err:.3g} > "
          f"{max_scale:.3g}")
    print(f"combine_pytrees: {len(tree.leaves(agg))} leaves, max err vs "
          f"plain mean {err:.3g} (bound: largest per-client scale "
          f"{max_scale:.3g}); {s:.4f} s [{card}]", flush=True)


def aggregate_phase(state, device, card: str):
    """6e: ``aggregate_packed("fedavg")`` over the trained buffers (K1)."""
    import torch
    from repro_torch.core.aggregation import aggregate_packed

    bufs = [state["plain"][c] for c in SILOS]
    out, s = sync_seconds(aggregate_packed, "fedavg", bufs, device=device)
    err = float((out - torch.stack(bufs).mean(0)).abs().max())
    check(err <= ROUND_ATOL, f"aggregate_packed vs plain mean {err:.3g}")
    print(f"aggregate_packed fedavg: max err vs plain mean {err:.3g} (atol "
          f"{ROUND_ATOL}); {s:.4f} s [{card}]", flush=True)


THREEFRY_EDGE = 1 << 20    # counters held bitwise, card vs CPU, at each end


def threefry_phase(state, device, card: str):
    """7b: ``prg="threefry"`` (the reference's ``jax.random.bits`` stream)
    at full width: the three silos' packed buffers of phase 4 masked with
    it, folded through ``MaskedF32Sink`` (K1); the mean must equal the
    plain mean within phase 4's tolerance. The card's bits for the first
    and the last 2**20 counters of each of ``windco``'s pair keys must
    equal the CPU's bitwise. Prints the ms a pair of both streams."""
    import torch
    from repro_torch.core import secure_agg as sa
    from repro_torch.core.streaming import MaskedF32Sink

    t = state["T"]
    cohort = sorted(SILOS)
    masked, mask_s = {}, []
    for cid in SILOS:
        masked[cid], s = sync_seconds(sa.mask_packed, state["plain"][cid],
                                      cid, cohort, SECRET, prg="threefry",
                                      device=device)
        mask_s.append(s)

    def server():
        sink = MaskedF32Sink(t, device=device)
        for cid in SILOS:
            sink.fold(masked[cid], 1.0)
        return sink.finalize()
    total, s_fold = sync_seconds(server)
    plain_mean = torch.stack([state["plain"][c] for c in SILOS]).mean(0)
    err = float((total / float(len(SILOS)) - plain_mean).abs().max())
    check(err <= ROUND_ATOL,
          f"threefry masks cancel: aggregate vs plain mean {err:.3g}")
    del masked, total

    keys, signs = sa.pair_keys(SILOS[0], cohort, SECRET)
    edge = min(THREEFRY_EDGE, t)
    for k0, k1 in keys.tolist():
        for lo in (0, t - edge):
            idx = torch.arange(lo, lo + edge, dtype=torch.int64)
            check(torch.equal(sa.threefry_bits(idx.to(device), k0, k1).cpu(),
                              sa.threefry_bits(idx, k0, k1)),
                  f"threefry bits of counters [{lo}, {lo + edge}) under key "
                  f"({k0}, {k1}): card == CPU, bitwise")
    buf = state["plain"][SILOS[0]]
    pair_ms = {prg: median_ms(lambda prg=prg: sa._apply_masks(
        buf, keys[:1], signs[:1], sa.DEFAULT_SCALE, prg=prg),
        reps=5, inner=1) for prg in ("fast", "threefry")}
    print(f"threefry: T={t}, {len(SILOS)} silos masked with prg='threefry' "
          f"({statistics.median(mask_s):.4f} s a silo), folded through "
          f"MaskedF32Sink in {s_fold:.4f} s; mean vs plain mean max err "
          f"{err:.3g} (atol {ROUND_ATOL}); bits bitwise equal to the CPU's "
          f"at counters [0, {edge}) and [{t - edge}, {t}) under "
          f"{len(keys)} pair keys [{card}]", flush=True)
    print(f"threefry: a pair over T={t}: threefry {pair_ms['threefry']:.2f} "
          f"ms, fast {pair_ms['fast']:.2f} ms ("
          f"{pair_ms['threefry'] / pair_ms['fast']:.2f}x) [{card}]",
          flush=True)


# ---------------------------------------------------------------------------
# phase 8: serving hymba-1.5b at full width (prefill through K6 and K7)
# ---------------------------------------------------------------------------
def serve_setup_phase(device, card: str):
    """Random init from a seed on the card, cast once to bf16, a 1920-token
    prompt per request; one short warm-up ``generate`` (cuBLAS plans, the
    kernels' first launches) before the timed run."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import serve

    model, params, batch = serve.setup(
        SERVE_ARCH, reduced=False, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
        seed=INIT_SEED, impl="kernel", device=device)
    tokens = batch["tokens"]
    cfg = model.cfg
    n = sum(p.numel() for p in tree.leaves(params))
    with torch.no_grad():
        _, s = sync_seconds(serve.generate, model, params, batch, 2)
    print(f"serve setup: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"{cfg.n_ssm_heads} SSD heads, {n} params in {cfg.dtype}; warm-up "
          f"generate {s:.2f} s [{card}]", flush=True)
    return {"model": model, "params": params, "batch": batch,
            "tokens": tokens}


def serve_phase(st, card: str):
    """The main path of slice 3: one ``generate`` (prefill, then 31 decode
    steps from the ring cache and the SSM state)."""
    import torch
    from repro_torch.launch import serve

    model, batch = st["model"], st["batch"]
    with torch.no_grad():
        res = serve.generate(model, st["params"], batch, SERVE_GEN)
    print(serve.report(model, batch, res) + f" [{card}]", flush=True)
    out = res["tokens"]
    check(out.shape == (SERVE_BATCH, SERVE_GEN), f"tokens {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < model.cfg.vocab)).all()),
          "generated ids inside the vocab")
    for key in ("first_logits", "last_logits"):
        check(res[key].shape == (SERVE_BATCH, 1, model.cfg.vocab)
              and bool(torch.isfinite(res[key]).all()),
              f"{key} finite, (B, 1, vocab)")
    st["res"] = res


def prefill_median_ms(model, params, batch, gen: int) -> float:
    """The median ms of ``PREFILL_REPS`` prefills of ``batch`` into the
    cache ``serve.generate`` gives a run of ``gen`` tokens (CUDA events,
    after 3 warm-up prefills): the prefill time phase 10 reads. Called
    after a path's launches were read, so its launches count nowhere."""
    import torch
    from repro_torch.launch import serve

    cache_len = model.cache_len_for(serve.stream_len(model, batch) + gen)
    with torch.no_grad():
        return median_ms(lambda: model.prefill(params, batch, cache_len),
                         reps=PREFILL_REPS, inner=1)


def serve_checks(model, params, batch, res, layers, check_tokens, device,
                 card: str):
    """The serve checks of phases 8 and 9, at ``layers`` deep:
    (1) the kernel path's prefill logits against an ``impl="xla"`` twin on
    the same params; (2) prefill + one ``decode_step`` against a prefill
    one token longer (an enc-dec: decode of t0 at position 1 against the
    teacher-forced decoder over [bos, t0]); a MoE's check (2) runs on its
    dropless copy. Each in f32 (the served weights widened) within
    ``SERVE_F32_TOL``, and in the served bf16 as a drift ratio of at most
    ``SERVE_BF16_RATIO`` to the plain path: each bf16 path's logits (its
    decode for (2)) against the f32 plain path's (a reduced config is
    f32: its f32 gates are the served ones). Check (2) runs on the first
    ``check_tokens`` prompt tokens where given."""
    import dataclasses

    import torch
    from repro_torch import tree
    from repro_torch.launch import serve
    from repro_torch.models import build_model, encdec
    from repro_torch.models.layers import rms_norm

    cfg = model.cfg
    name = cfg.name
    cfgL, pL = zoo_cut(cfg, params, layers)
    bf16 = cfg.dtype == "bfloat16"
    cfg32 = dataclasses.replace(cfgL, dtype="float32")
    p32 = tree.tree_map(lambda a: a.float(), pL) if bf16 else pL
    n0 = serve.stream_len(model, batch)
    B = batch["tokens"].shape[0]
    print(f"serve check {name}: twins at {cfgL.n_layers} of {cfg.n_layers} "
          f"layers [{card}]", flush=True)

    def diff(a, b):
        d = (a.float() - b.float()).abs()
        top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        return d, f"max abs diff {float(d.max()):.4g}, mean " \
            f"{float(d.mean()):.4g}, top-1 agreement {top1:.3f}"

    def f32_gate(a, b, what):
        d, text = diff(a, b)
        print(f"serve check {name} {what} (f32): {text} (rtol = atol = "
              f"{SERVE_F32_TOL}) [{card}]", flush=True)
        check(bool((d <= SERVE_F32_TOL + SERVE_F32_TOL * b.float().abs())
                   .all()), f"{name} {what} (f32) within {SERVE_F32_TOL}")

    def bf16_gate(kernel_gap, plain_gap, what):
        ratio = kernel_gap / plain_gap if plain_gap else float("nan")
        print(f"serve check {name} {what} (bf16): kernel path "
              f"{kernel_gap:.4g}, plain path {plain_gap:.4g} (ratio "
              f"{ratio:.3f}, at most {SERVE_BF16_RATIO}) [{card}]",
              flush=True)
        check(kernel_gap <= SERVE_BF16_RATIO * plain_gap,
              f"{name} {what} (bf16): kernel path within "
              f"{SERVE_BF16_RATIO}x the plain path's drift")

    def runs(c32, c16):
        out = {"kernel f32": (build_model(c32, impl="kernel", device=device),
                              p32),
               "xla f32": (build_model(c32, impl="xla", device=device), p32)}
        if bf16:
            out["kernel bf16"] = (build_model(c16, impl="kernel",
                                              device=device), pL)
            out["xla bf16"] = (build_model(c16, impl="xla", device=device),
                               pL)
        return out

    cache_len = n0 + 1
    with torch.no_grad():
        logits = {}
        if layers >= cfg.n_layers:
            logits["kernel " + ("bf16" if bf16 else "f32")] = \
                res["first_logits"]
        for key, (m, p) in runs(cfg32, cfgL).items():
            if key not in logits:
                logits[key] = m.prefill(p, batch, cache_len)[0]
        f32_gate(logits["kernel f32"], logits["xla f32"],
                 "kernel prefill vs xla twin")
        if bf16:
            bf16_gate(*(float(diff(logits[k], logits["xla f32"])[0].max())
                        for k in ("kernel bf16", "xla bf16")),
                      "prefill logits vs the f32 plain path")
        del logits

        t0 = res["tokens"][:, :1]
        if check_tokens:
            batch = {**batch, "tokens": batch["tokens"][:, :check_tokens]}
            n0 = serve.stream_len(model, batch)
            cache_len = n0 + 1
            print(f"serve check {name}: prefill + decode on the first "
                  f"{check_tokens} prompt tokens [{card}]", flush=True)
        dl32, dl16 = zoo_dropless(cfg32), zoo_dropless(cfgL)
        if cfg.moe is not None:
            print(f"serve check {name}: prefill + decode on the dropless copy "
                  f"(capacity_factor {dl32.moe.capacity_factor}): at its "
                  f"{cfg.moe.capacity_factor} a prefill may drop the latest "
                  "tokens of an over-full expert, a decode step of "
                  f"{B} tokens drops none [{card}]", flush=True)
        def decode_and_full(m, p):
            """(decode logits of t0 after the prompt, the logits it must
            match)."""
            if cfg.is_encoder_decoder:
                _, cache = m.prefill(p, batch, 2)
                dec, _ = m.decode_step(p, cache, t0, torch.ones(
                    (B, 1), dtype=torch.int32, device=device))
                p_c = m.cast(p)
                enc_out = m._encode(p_c, batch["frames"])
                dec_in = m._embed_tokens(p_c, torch.cat(
                    [torch.zeros_like(t0), t0], 1))
                hidden = encdec.decoder_apply(
                    m.cfg, p_c["dec_stack"], dec_in,
                    torch.arange(2, dtype=torch.int32,
                                 device=device).expand(B, 2),
                    enc_out, torch.ones(enc_out.shape[:2], dtype=torch.bool,
                                        device=device), impl=m.impl)
                return dec, m._logits(p_c, rms_norm(
                    hidden[:, -1:], p_c["final_norm"], m.cfg.norm_eps))
            ext = {**batch, "tokens": torch.cat([batch["tokens"], t0], 1)}
            _, cache = m.prefill(p, batch, cache_len)
            dec, _ = m.decode_step(p, cache, t0, torch.full(
                (B, 1), n0, dtype=torch.int32, device=device))
            del cache
            return dec, m.prefill(p, ext, cache_len)[0]

        what = ("decode at 1 vs the teacher-forced decoder"
                if cfg.is_encoder_decoder else
                "prefill(S) + decode vs prefill(S+1)")
        both = runs(dl32, dl16)
        dec, full = decode_and_full(*both.pop("kernel f32"))
        f32_gate(dec, full, what)
        if bf16:
            # each bf16 path's decode against the f32 plain path's longer
            # prefill: the drift both paths share is bf16's
            _, want = decode_and_full(*both.pop("xla f32"))
            bf16_gate(*(float(diff(decode_and_full(*both[k])[0],
                                   want)[0].max())
                        for k in ("kernel bf16", "xla bf16")),
                      what + ", against the f32 plain path")


def serve_check_phase(st, device, card: str):
    """``serve_checks`` on the served hymba-1.5b at its full depth."""
    serve_checks(st["model"], st["params"], st["batch"], st["res"],
                 st["model"].cfg.n_layers, None, device, card)


def serve_trace_phase(st, card: str):
    """One prefill and one decode step under ``torch.profiler``: the card's
    busy time against the untraced times of the serve phase (the device
    idle share), and the kernels that took the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, params, tokens, res = (st[k] for k in
                                  ("model", "params", "tokens", "res"))
    n_meta = model.cfg.n_meta_tokens
    S = tokens.shape[1]
    cache_len = model.cache_len_for(n_meta + S + SERVE_GEN)
    pos = torch.full((SERVE_BATCH, 1), n_meta + S, dtype=torch.int32,
                     device=tokens.device)
    untraced = {"prefill": res["prefill_s"] * 1e3,
                "decode step": res["decode_s"] * 1e3 / (SERVE_GEN - 1)}
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tokens}, cache_len)
        tok = res["tokens"][:, :1]
        torch.cuda.synchronize()
        runs = {"prefill": lambda: model.prefill(
                    params, {"tokens": tokens}, cache_len),
                "decode step": lambda: model.decode_step(
                    params, cache, tok, pos)}
        for what, fn in runs.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, traced_s = sync_seconds(fn)
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            check(busy_ms > 0, f"the profiler saw device time ({what})")
            wall = untraced[what]
            top = sorted(kernels, key=lambda e: e.self_device_time_total,
                         reverse=True)[:5]
            ours = {"K6": ("flash_wgmma_k", "flash_fwd_k"),
                    "K7": ("chunk_k", "pass_k", "output_k")}
            parts = []
            for kname, keys in ours.items():
                mine = [e for e in kernels if any(k in e.key for k in keys)]
                ms = sum(e.self_device_time_total for e in mine) / 1e3
                parts.append(f"{kname} {ms:.2f} ms in "
                             f"{sum(e.count for e in mine)} launches "
                             f"({ms / busy_ms:.3f} of busy)")
            print(f"trace: {what} " + ", ".join(parts) + f" [{card}]",
                  flush=True)
            print(f"trace: {what} device busy {busy_ms:.2f} ms in "
                  f"{sum(e.count for e in kernels)} kernel launches; "
                  f"untraced {wall:.2f} ms -> device idle share "
                  f"{1 - busy_ms / wall:.3f}; traced {traced_s * 1e3:.2f} "
                  "ms; top: " + "; ".join(
                      f"{e.key[:40]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.2f} ms"
                      for e in top) + f" [{card}]", flush=True)


# ---------------------------------------------------------------------------
# phase 9: the model zoo at full width (slice 7)
# ---------------------------------------------------------------------------
# arch, batch, prompt positions (patches or frames included), the depth of
# the check twins and the tokens of the prefill + decode check (None: as
# served). gemma2-9b's 6144 positions let its 4096 windows cut; gemma3-4b's
# 32,768 + 8 positions pass MAX_FULL_CACHE, so it decodes from the
# 1024-slot ring; internvl2-2b's prompt is 256 patches and 1664 tokens;
# seamless-m4t-large-v2's 1024 frames. The check twins of gemma2-9b and
# gemma3-4b are cut to 14 and 6 layers (5 local, 1 global): a full-depth
# f32 twin of gemma2-9b is 37 GB beside the served 18.5 GB and its caches,
# and gemma3-4b's plain attention over 32,768 positions takes about 0.2 s
# a layer and call; minicpm3-4b's to 31 of 62, to keep the script's time
# (its full-depth checks took 23 s on an H100). gemma3-4b's prefill +
# decode check runs on the first 8191 tokens: the plain path (as the
# reference's) takes a sequence that is not a whole number of 512-row
# chunks as one block, and over 32,769 positions that block's f32 scores
# are 34 GB
ZOO = [
    ("gemma2-9b", 2, 6144, 14, None),
    ("gemma3-4b", 1, 32_768, 6, 8191),
    ("olmoe-1b-7b", 4, 1920, None, None),
    ("mamba2-780m", 4, 2048, None, None),
    ("minicpm3-4b", 4, 1920, 31, None),
    ("internvl2-2b", 4, 1920, None, None),
    ("seamless-m4t-large-v2", 4, 1024, None, None),
]
# about 264 and 208 GB in bf16, over one 80 GB card: served reduced()
ZOO_REDUCED = ("dbrx-132b", "command-r-plus-104b")
ZOO_BF16_GB = {"dbrx-132b": 264, "command-r-plus-104b": 208}
ZOO_REDUCED_PROMPT = 256
ZOO_GEN = 8


def zoo_expected(cfg) -> dict:
    """The kernel launches one prefill of ``cfg`` makes: K6 once an
    attention layer (the encoder's for an enc-dec; MLA's attention is
    plain, as in the reference), by the tensor-core kernel in bf16 and the
    CUDA-core kernel in f32; K7 once an SSM layer."""
    from repro_torch.configs.base import ATTN_MLA, BLOCK_HYBRID, BLOCK_SSM
    k6 = 0
    if cfg.is_encoder_decoder:
        k6 = cfg.n_encoder_layers
    elif cfg.block_kind != BLOCK_SSM and cfg.attn_kind != ATTN_MLA:
        k6 = cfg.n_layers
    k7 = cfg.n_layers if cfg.block_kind in (BLOCK_SSM, BLOCK_HYBRID) else 0
    k6_name = ("flash_attention" if cfg.dtype == "bfloat16"
               else "flash_attention_f32")
    return {k6_name: k6, "ssd_scan": k7}


def zoo_cut(cfg, params: dict, layers: int):
    """(cfg, params) of the first ``layers`` layers (views of the served
    params; an enc-dec keeps as many encoder as decoder layers)."""
    import dataclasses

    from repro_torch import tree
    if layers >= cfg.n_layers:
        return cfg, params
    ch = {"n_layers": layers}
    if cfg.is_encoder_decoder:
        ch["n_encoder_layers"] = layers
    cut = {k: (tree.tree_map(lambda a: a[:layers], v)
               if k in ("stack", "enc_stack", "dec_stack") else v)
           for k, v in params.items()}
    return dataclasses.replace(cfg, **ch), cut


def zoo_dropless(cfg):
    """A MoE config whose capacity reaches every token (capacity_factor =
    E / K): a prefill then drops nothing, as a decode step does not."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def zoo_arch(arch: str, batch_size: int, prompt: int, layers, check_tokens,
             reduced: bool, device, card: str, counters) -> dict:
    """Serve one architecture through ``repro_torch.launch.serve`` (random
    init from a seed, bf16 at full width; a warm-up ``generate`` of 2
    tokens, then the timed one of ``ZOO_GEN`` with the launch counts set
    to 0 just before it and read just after), then ``serve_checks``.
    Returns the timed run's launches, the arch's peak GiB and the
    prefill's median ms (``prefill_median_ms``)."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    (model, params, batch), setup_s = sync_seconds(
        serve.setup, arch, reduced=reduced, batch=batch_size,
        prompt_len=prompt, seed=INIT_SEED, impl="kernel", device=device)
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = model.cfg
    n = sum(p.numel() for p in tree.leaves(params))
    n0 = serve.stream_len(model, batch)
    cache_len = model.cache_len_for(n0 + ZOO_GEN)
    shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    print(f"zoo {arch}: {'reduced() ' if reduced else ''}{cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv, head dim {cfg.resolved_head_dim}, {n} "
          f"params in {cfg.dtype}; batch {batch_size} x {prompt} prompt "
          f"positions ({shapes}), "
          f"a {n0 + ZOO_GEN}-position stream in {cache_len} cache slots; "
          f"setup {setup_s:.2f} s, init peak {init_peak:.2f} GiB [{card}]",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        serve.generate(model, params, batch, 2)             # warm-up
        for c in counters:
            c.reset_launches()
        res = serve.generate(model, params, batch, ZOO_GEN)
    counts = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prefill_ms = prefill_median_ms(model, params, batch, ZOO_GEN)
    steps = ZOO_GEN - 1
    print(f"zoo {arch}: prefill {res['prefill_s'] * 1e3:.1f} ms "
          f"({batch_size * prompt / res['prefill_s']:.0f} prompt tok/s), "
          f"decode {res['decode_s'] * 1e3 / steps:.2f} ms a token "
          f"({batch_size * steps / res['decode_s']:.1f} tok/s), serve peak "
          f"{peak:.2f} GiB; launches {counts}; prefill median "
          f"{prefill_ms:.2f} ms of {PREFILL_REPS} [{card}]", flush=True)
    out = res["tokens"]
    check(out.shape == (batch_size, ZOO_GEN), f"{arch} tokens {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"{arch} generated ids inside the vocab")
    for key in ("first_logits", "last_logits"):
        check(res[key].shape == (batch_size, 1, cfg.vocab)
              and bool(torch.isfinite(res[key]).all()),
              f"{arch} {key} finite, (B, 1, vocab)")
    want = zoo_expected(cfg)
    for k, v in counts.items():
        check(v == want.get(k, 0), f"{arch}: one prefill launches {k} "
              f"{want.get(k, 0)} times (got {v})")
    serve_checks(model, params, batch, res, layers or cfg.n_layers,
                 check_tokens, device, card)
    return counts, max(init_peak, peak,
                       torch.cuda.max_memory_allocated() / 2 ** 30), \
        prefill_ms


def zoo_phase(device, card: str, counters) -> dict:
    """Every architecture of the zoo but hymba-1.5b (phase 8) and
    fedforecast-100m (phases 4-7): ``ZOO`` at full width, ``ZOO_REDUCED``
    at ``reduced()``. Returns the launches of their timed runs, summed,
    the phase's peak GiB (each architecture resets the peak) and each
    architecture's prefill median ms."""
    import torch
    total: dict = {}
    prefill_ms: dict = {}
    top = 0.0
    todo = [(*row, False) for row in ZOO] + [
        (a, 2, ZOO_REDUCED_PROMPT, None, None, True) for a in ZOO_REDUCED]
    for arch, batch_size, prompt, layers, check_tokens, reduced in todo:
        if reduced:
            print(f"zoo {arch}: about {ZOO_BF16_GB[arch]} GB of weights in "
                  "bf16 at full width, over one 80 GB card: served "
                  f"reduced() (f32) [{card}]", flush=True)
        t0 = time.perf_counter()
        counts, peak, prefill_ms[arch] = zoo_arch(
            arch, batch_size, prompt, layers, check_tokens, reduced, device,
            card, counters)
        top = max(top, peak)
        torch.cuda.empty_cache()
        print(f"zoo {arch}: {time.perf_counter() - t0:.2f} s [{card}]",
              flush=True)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total, top, prefill_ms


# ---------------------------------------------------------------------------
# phase 10: the dry run, held against the steps the card timed
# ---------------------------------------------------------------------------
def train_card_count(state) -> dict:
    """Phase 4's train step once more on the card, under the dry run's
    counters (``dryrun.count``: ``FlopCounterMode`` and the live-bytes
    tracker, here on the card's tensors), with the card's
    ``max_memory_allocated`` rise over the step; and the step's median
    ms of phase 4. Read by phase 10."""
    import torch
    from repro_torch.launch import dryrun

    step, opt, params, batch = (state[k] for k in
                                ("step", "opt", "global", "batch"))
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dryrun.count(step, (params, opt_state, batch))
    torch.cuda.synchronize()
    out["rise"] = torch.cuda.max_memory_allocated() - base
    out["ms"] = state["step_s"] * 1e3
    return out


def dryrun_phase(timed: dict, card: str):
    """10: ``repro_torch.launch.dryrun`` on meta tensors at the shape of
    each step the card timed (phase 4's train step, the ``train pod``
    step as two of it, phase 8's hymba-1.5b prefill, the prefills of
    ``ZOO``): FLOPs, traffic bytes, the compute and memory terms over the
    H100 SXM datasheet figures, the bound, the measured median and the
    share (bound / measured). Gates: the train step's meta FLOP count
    equals, as an integer, ``FlopCounterMode``'s count of the same step
    on the card, and neither the train step nor the pod step, which run
    the counted ``impl="xla"`` program, is faster than its bound. Prints
    the tracker's predicted peak beside the card's
    ``max_memory_allocated`` rise (reported, not gated). The prefills ran
    ``impl="kernel"``, whose K6 skips the attention blocks that a window
    or the causal mask hides and the plain path computes: their share
    is the plain program's bound over the kernel path's time, printed as
    such and not gated, since it is no lower bound of the timed work."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import no_collectives, roofline_terms
    from repro_torch.launch.mesh import H100

    def shape(mode, batch, seq):
        return InputShape(f"{mode}_{batch}x{seq}", seq, batch, mode)

    on_card = timed["train card"]
    train = dryrun.measure("fedforecast-100m",
                           shape("train", BATCH_SIZE, SEQ_LEN))
    meta_flops = int(train["per_device"]["flops"])
    check(meta_flops == on_card["flops"],
          f"train step: meta FLOPs {meta_flops} == the card's "
          f"{on_card['flops']}")
    meta_peak = train["per_device"]["temp_bytes"]
    print(f"dryrun train step: {meta_flops} FLOPs on meta == "
          f"{on_card['flops']} counted on the card; tracker peak "
          f"{meta_peak} B on meta, {on_card['temp_bytes']} B on the card's "
          f"tensors; the card's max_memory_allocated rise {on_card['rise']} "
          f"B, {on_card['rise'] / meta_peak:.3f}x the prediction [{card}]",
          flush=True)
    # (name, record, steps, measured ms, gated: the timed program is the
    # counted one)
    rows = [("fedforecast-100m train step", train, 1, on_card["ms"], True),
            ("fedforecast-100m train pod step (2 silo steps)", train, 2,
             timed["pod ms"], True),
            (f"{SERVE_ARCH} prefill", dryrun.measure(
                SERVE_ARCH, shape("prefill", SERVE_BATCH, SERVE_PROMPT)), 1,
             timed["serve prefill ms"], False)]
    rows += [(f"{arch} prefill", dryrun.measure(
        arch, shape("prefill", batch_size, prompt)), 1,
        timed["zoo prefill ms"][arch], False)
        for arch, batch_size, prompt, _, _ in ZOO]
    for name, rec, n, ms, gated in rows:
        flops = n * rec["per_device"]["flops"]
        nbytes = n * rec["per_device"]["hbm_traffic_bytes"]
        terms = roofline_terms(flops, nbytes, no_collectives(), H100,
                               n_chips=1)
        bound_ms = terms["step_time_lower_bound_s"] * 1e3
        share = bound_ms / ms
        what = ("share of bound" if gated else "plain (impl='xla') "
                "program's bound over the kernel path's median, not a "
                "lower bound, ungated")
        print(f"dryrun {name}: {rec['shape']}, {flops:.6g} FLOPs, "
              f"{nbytes:.6g} B; compute {terms['compute_s'] * 1e3:.3f} ms, memory "
              f"{terms['memory_s'] * 1e3:.3f} ms -> bound {bound_ms:.3f} ms "
              f"({terms['dominant']}); measured median {ms:.2f} ms; {what} "
              f"{share:.4f}; meta run {rec['compile_s']:.2f} s [{card}]",
              flush=True)
        if gated:
            check(share <= 1.0, f"{name}: measured {ms:.2f} ms is not "
                  f"faster than its bound {bound_ms:.3f} ms")


def run_phase(name: str, peaks: list, card: str, fn, *args):
    """Run one phase; print its seconds and peak device memory."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    out, s = sync_seconds(fn, *args)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    peaks.append(peak)
    print(f"phase {name}: {s:.2f} s, peak device memory {peak:.2f} GiB "
          f"[{card}]", flush=True)
    return out


def trace_phase(state, card: str):
    """One more train step, on the new global, under ``torch.profiler``:
    the card's busy time in it against the untraced median step time,
    i.e. how far the host holds the card back."""
    step, opt, params, batch = (state[k] for k in
                                ("step", "opt", "global", "batch"))
    opt_state = opt.init(params)
    step(params, opt_state, batch)                 # warm-up
    busy_ms, n_launch, top, traced_s = traced_busy(step, params, opt_state,
                                                   batch)
    wall_ms = state["step_s"] * 1e3
    print(f"trace: train step device busy {busy_ms:.2f} ms in "
          f"{n_launch} kernel launches; untraced step "
          f"median {wall_ms:.2f} ms -> device idle share "
          f"{1 - busy_ms / wall_ms:.3f}; traced step {traced_s * 1e3:.2f} "
          f"ms; top: {top} [{card}]", flush=True)


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

    # the plain versions' f32 products stay f32 (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.compressed_agg import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.secure_agg import ops
    from repro_torch.kernels.ssd_scan import ops as sops
    counters = (ops, cops, fops, sops)

    t0 = time.perf_counter()
    libs = _build.build_all(force=True)
    print(f"build: {[p.name for p in libs]} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for lib in ("flash_attention", "ssd_scan"):
        print(f"build {lib}: " + "; ".join(_build.ptxas_report(lib)),
              flush=True)
    hgmma = _build.sass_count("flash_attention", "HGMMA")
    print(f"build flash_attention: {hgmma} HGMMA instructions in its SASS",
          flush=True)
    check(hgmma > 0, "K6's bf16 kernel runs wgmma (HGMMA in its SASS)")

    cfg = get_config("fedforecast-100m")
    rate = hbm_rate(name)
    t_main = 116_411_136            # fedforecast-100m packed size
    peaks: list = []
    kernels = run_phase("kernels K1/K2", peaks, card, kernel_phase, device,
                        len(SILOS), len(SILOS) - 1, t_main, card, rate)
    kernels += run_phase("kernels K3/K4/K5", peaks, card,
                         compressed_kernel_phase, device, len(SILOS),
                         len(SILOS) - 1, t_main, card, rate)
    kernels += run_phase("kernels K6/K7", peaks, card, attention_kernel_phase,
                         device, card, rate)

    def reset_launches():
        for c in counters:
            c.reset_launches()

    def read_path(name: str, expected):
        """The launch counts of the path just driven; each expected
        kernel must have launched in it."""
        counts = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        for k in expected:
            check(counts[k] > 0, f"{k} launched on the {name} path")
        print(f"{name} path: launches {counts}", flush=True)
        return counts

    # the main path: slice 1's fp32 secure round and repair, slice 5's FL
    # run through the control plane, slice 6's fleet and async runs, slice
    # 8's training launcher (pod and sim) and the T split, slice
    # 2's compressed planes on the round's trained silos, then slice 3's
    # serve run; the counts are set to 0 just before each and read just
    # after it
    torch.cuda.empty_cache()
    peaks.clear()
    reset_launches()
    state = run_phase("round", peaks, card, round_phase, cfg, device, card)
    check(state["T"] == t_main, f"packed size {state['T']} == {t_main}")
    run_phase("repair", peaks, card, repair_phase, state, device, card)
    fp32 = read_path("fp32 secure", ("masked_sum", "masked_sum_corrected"))
    reset_launches()
    run_phase("fl run", peaks, card, fl_phase, state, device, card)
    fl = read_path("fl", ("masked_sum",))
    reset_launches()
    run_phase("fleet", peaks, card, fleet_phase, state, device, card)
    run_phase("fleet run", peaks, card, fleet_run_phase, state, device, card)
    fleet = read_path("fleet", ("masked_sum",))
    reset_launches()
    run_phase("async run", peaks, card, async_phase, state, device, card)
    asynchronous = read_path("async", ())
    check(not any(asynchronous.values()),
          "the async path launches no kernel (its fold is plain PyTorch, "
          "as the reference's is numpy)")
    print("async path: no repo kernel, as in the reference (the fold is "
          "plain PyTorch on the card)", flush=True)
    reset_launches()
    timed = {"pod ms": run_phase("train pod", peaks, card, train_pod_phase,
                                 device, card)}
    pod = read_path("train pod", ())
    check(not any(pod.values()),
          "the train pod path launches no kernel (its step runs "
          "impl='xla' and its FedAvg is plain PyTorch, as the reference's)")
    print("train pod path: no repo kernel, as in the reference (the step "
          "runs impl='xla', the FedAvg is plain PyTorch on the card)",
          flush=True)
    reset_launches()
    run_phase("train sim", peaks, card, train_sim_phase, state, device,
              card)
    sim = read_path("train sim", ("masked_sum",))
    reset_launches()
    split = run_phase("agg split", peaks, card, agg_split_phase, state,
                      device, card)
    split = {k: split.get(k, 0) for k in fp32}
    for k in ("masked_sum", "masked_sum_corrected", "dequant_reduce",
              "masked_dequant_reduce", "masked_dequant_reduce_corrected"):
        check(split[k] > 0, f"{k} launched on the agg split path")
    print(f"agg split path: launches {split} (the split calls only)",
          flush=True)
    reset_launches()
    for what, fn in (("int8 round", int8_phase),
                     ("secure int8 round", secure_int8_phase),
                     ("integer repair", int_repair_phase),
                     ("combine_pytrees", combine_phase),
                     ("aggregate_packed", aggregate_phase)):
        run_phase(what, peaks, card, fn, state, device, card)
    compressed = read_path("compressed", (
        "dequant_reduce", "masked_dequant_reduce",
        "masked_dequant_reduce_corrected", "secure_agg_combine",
        "masked_sum"))
    run_phase("trace", peaks, card, trace_phase, state, card)
    reset_launches()
    run_phase("threefry", peaks, card, threefry_phase, state, device, card)
    threefry = read_path("threefry", ("masked_sum",))
    timed["train card"] = train_card_count(state)
    del state
    torch.cuda.empty_cache()

    serve_state = run_phase("serve setup", peaks, card, serve_setup_phase,
                            device, card)
    reset_launches()
    run_phase("serve", peaks, card, serve_phase, serve_state, card)
    served = read_path("serve", ("flash_attention", "ssd_scan"))
    timed["serve prefill ms"] = prefill_median_ms(
        serve_state["model"], serve_state["params"], serve_state["batch"],
        SERVE_GEN)
    n_layers = serve_state["model"].cfg.n_layers
    check(served["flash_attention"] == served["ssd_scan"] == n_layers,
          f"one prefill launches K6 and K7 once a layer ({n_layers})")
    check(served["flash_attention_f32"] == 0,
          "the bf16 serve path runs K6's tensor-core kernel only")
    launches = {k: fp32[k] + fl[k] + fleet[k] + asynchronous[k] + pod[k]
                + sim[k] + split[k] + compressed[k] + threefry[k]
                + served[k] for k in fp32}
    for k in kernels:
        check(launches[k["name"]] > 0, f"{k['name']} launched on the path")
    print(f"main path: launches {launches}; peak device memory "
          f"{max(peaks):.2f} GiB [{card}]", flush=True)
    run_phase("serve checks", peaks, card, serve_check_phase, serve_state,
              device, card)
    run_phase("serve trace", peaks, card, serve_trace_phase, serve_state,
              card)
    del serve_state
    torch.cuda.empty_cache()

    # the phase resets the peak for each architecture: it reports its own
    (zoo, zoo_peak, timed["zoo prefill ms"]), s = sync_seconds(
        zoo_phase, device, card, counters)
    peaks.append(zoo_peak)
    print(f"phase zoo: {s:.2f} s, peak device memory {zoo_peak:.2f} GiB "
          f"[{card}]", flush=True)
    print(f"zoo path: launches {zoo} (the timed runs' sum) [{card}]",
          flush=True)
    for k in ("flash_attention", "ssd_scan"):
        check(zoo[k] > 0, f"{k} launched on the zoo path")
    launches = {k: launches[k] + zoo.get(k, 0) for k in launches}
    print(f"main path with the zoo: launches {launches} [{card}]",
          flush=True)
    run_phase("dryrun", peaks, card, dryrun_phase, timed, card)

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
