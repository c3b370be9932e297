"""Time source-level variants of K6 and K7 against the committed kernels.

    python -m repro_torch.kernels.variants [--reps 20]

Each variant is a committed ``csrc`` source with a few text substitutions:
a design alternative, or one part of the work switched off to see what it
costs. Every variant is built with the same ``nvcc`` flags into
``build/repro_torch/variants/`` (all at once) and timed at the serve
path's shapes (hymba-1.5b: K6 at B 4, S 2048, H 25 / Hkv 5, D 64, bf16,
window 1024 and global; K7 at b 4, S 2048, H 50, P 64, N 16, chunk 128,
bf16 x/B/C) as the median over reps of the mean of 5 back-to-back
launches between CUDA events, the committed kernel timed in the same
call. A variant marked exact must reproduce the committed kernel's output
bitwise; the others change the arithmetic and are timed only. Prints,
per variant, its time, K7's time per pass (``torch.profiler``), and
ptxas's registers and spills. Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import re

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.timing import device_ms_by_kernel, median_ms
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.ssd_scan import kernel as skernel

FA_PV = ("          wgmma_rs_n64(o + 32 * p, ph[kk], db);\n"
         "          wgmma_rs_n64(o + 32 * p, pl[kk], db);")
FA_BK64 = ("static constexpr int BK = D == 128 ? 64 : 128;",
           "static constexpr int BK = 64;")


def fa_rows(rows: int):
    """K6 with ``rows`` query rows a CTA: rows / 64 consumer warpgroups."""
    return [("constexpr int kBQ = 128;                // query rows a CTA",
             f"constexpr int kBQ = {rows};"),
            ("constexpr int kConsumers = 256;         // two warpgroups of "
             "64 rows each", f"constexpr int kConsumers = {2 * rows};")]


# name: (source, [(old, new), ...], exact)
VARIANTS = {
    "K6 3-stage ring": ("flash_attention", [(
        "constexpr int kStages = 2;", "constexpr int kStages = 3;")], True),
    "K6 64-key tiles, two CTAs an SM": ("flash_attention", [FA_BK64, (
        "__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")],
        False),
    "K6 three consumer warpgroups, 64-key tiles": (
        "flash_attention", [FA_BK64] + fa_rows(192), False),
    "K6 four consumer warpgroups, 64-key tiles": (
        "flash_attention", [FA_BK64] + fa_rows(256), False),
    "K6 without the P_lo product": ("flash_attention", [(
        FA_PV, FA_PV.split("\n")[0])], False),
    "K6 without P V": ("flash_attention", [(FA_PV, "")], False),
    "K6 without S = Q K^T": ("flash_attention", [(
        "    qk(i, s);\n",
        "    mbar_wait(&full[i % kStages], (i / kStages) & 1);\n"
        "#pragma unroll\n    for (int j = 0; j < SN; ++j) s[j] = j & 7;\n")],
        False),
    "K6 without exp": ("flash_attention", [(
        "const float p = ex2(fmaf(s[j], f, -mf[(j >> 1) & 1]));",
        "const float p = fmaf(s[j], f, -mf[(j >> 1) & 1]);")], False),
    "K7 output pass of 256 threads, 8 x 4 tiles": ("ssd_scan", [
        ("constexpr int kOutThreads = 512;",
         "constexpr int kOutThreads = 256;"),
        ("constexpr int kTT = 4;", "constexpr int kTT = 8;")], True),
    "K7 without the chunk states' sum": ("ssd_scan", [(
        "    for (int s = 0; s < Qp; ++s) {\n      const float w = bw",
        "    for (int s = 0; s < 0; ++s) {\n      const float w = bw")],
        False),
}


def registers(log: str) -> str:
    """ptxas's registers and spill stores of the bf16 kernels in ``log``."""
    return "; ".join(s for s in _build.ptxas_summary(log)
                     if "wgmma" in s or "bf16" in s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("variants: needs a CUDA card")
    texts, source = {}, {}
    for lib in ("flash_attention", "ssd_scan"):
        texts[lib] = source[lib] = (_build.CSRC / f"{lib}.cu").read_text()
    keys = {}
    for i, (name, (lib, subs, _)) in enumerate(VARIANTS.items()):
        text = source[lib]
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in {lib}.cu")
            text = text.replace(old, new)
        keys[name] = f"v{i}"
        texts[keys[name]] = text
    lib_of = {**{k: k for k in source},
              **{keys[n]: v[0] for n, v in VARIANTS.items()}}
    libs = {}
    for key, (path, log) in _build.build_texts(texts, "variants").items():
        bind = skernel.bind if lib_of[key] == "ssd_scan" else fkernel.bind
        libs[key] = (lib_of[key], bind(ctypes.CDLL(str(path))), log)

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(14)
    bf = torch.bfloat16
    B, S, H, Hkv, D = 4, 2048, 25, 5, 64
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(bf)
               for h in (H, Hkv, Hkv))
    b, Hs, P, N, Q = 4, 50, 64, 16, 128
    xbc = torch.randn(b, S, Hs * P + 2 * N, generator=gen,
                      device=dev).to(bf)
    ssd = (xbc[..., :Hs * P].reshape(b, S, Hs, P),
           F.softplus(torch.randn(b, S, Hs, generator=gen, device=dev)) * .1,
           -torch.exp(torch.randn(Hs, generator=gen, device=dev) * 0.3),
           xbc[..., Hs * P:Hs * P + N], xbc[..., Hs * P + N:])

    def run(key):
        lib, handle, _ = libs[key]
        if lib == "flash_attention":
            outs = []
            for window in (1024, 0):
                o = torch.empty_like(q)
                call = (lambda o=o, w=window: fkernel.flash_attention_bshd(
                    q, k, v, o, scale=D ** -0.5, causal=True, window=w,
                    softcap=0.0, lib=handle))
                call()
                outs.append((o, median_ms(call, args.reps)))
            return outs, ""
        y = torch.empty(b, S, Hs, P, device=dev)
        st = torch.empty(b, Hs, P, N, device=dev)
        def call():
            skernel.ssd_scan_chunked(*ssd, y, st, chunk=Q, lib=handle)
        call()
        passes = device_ms_by_kernel(call)
        return [(y, median_ms(call, args.reps))], ", ".join(
            f"{name} {ms:.4f}" for name, ms in passes.items())

    card = torch.cuda.get_device_name(dev)
    ref = {lib: run(lib) for lib in ("flash_attention", "ssd_scan")}
    for lib, (outs, passes) in ref.items():
        print(f"committed {lib}: " + ", ".join(
            f"{ms:.4f} ms" for _, ms in outs) + (f" ({passes})" if passes
                                                  else "")
              + f"; {registers(libs[lib][2])} [{card}]", flush=True)
    for name, (lib, _, exact) in VARIANTS.items():
        outs, passes = run(keys[name])
        same = all(torch.equal(o, r) for (o, _), (r, _)
                   in zip(outs, ref[lib][0]))
        if exact and not same:
            raise SystemExit(f"variant {name!r} is not bitwise equal")
        print(f"{name}: " + ", ".join(
            f"{ms:.4f} ms ({ms / r:.2f}x)" for (_, ms), (_, r)
            in zip(outs, ref[lib][0])) + (f" ({passes})" if passes else "")
              + f"; {'bitwise equal' if same else 'timed only'}; "
              f"{registers(libs[keys[name]][2])} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
