"""Serving driver: batched prefill + decode against a deployed model
(port of ``repro.launch.serve``).

This is the client-side Inference Manager / Model Subscription API (paper
section VI) as a standalone service loop: a batch of requests is
prefix-filled once, then decoded token by token from the ring-buffer KV
cache and the SSM state. With ``--impl kernel`` (the default) the prefill
runs K6 flash attention and K7 the SSD scan; decode takes the plain
attention and the O(1) recurrence, as in the reference.

Positions and the cache length count the model's meta tokens (hymba's
128): decode step i writes stream position ``n_meta + S + i``. (The
reference's serve loop leaves them out; its decode-consistency test
counts them, and that contract is the one served here.)

  python -m repro_torch.launch.serve --arch hymba-1.5b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --device cpu --batch 2 --prompt-len 24 --gen 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import build_model


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 64, seed: int = 0, impl: str = "kernel",
          device=DEFAULT_DEVICE):
    """(model, params in the compute dtype, prompt tokens (B,S) int64):
    random init from ``seed``, cast once for serving; prompts drawn with
    numpy from ``seed``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, impl=impl, device=resolve(device))
    params = model.cast(model.init(model.generator(seed)))
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int64)
    ).to(model.device)
    return model, params, tokens


def generate(model, params: dict, tokens: torch.Tensor, gen: int) -> dict:
    """Prefill ``tokens`` (B,S), then greedy-decode ``gen`` tokens.

    Returns ``tokens`` (B, gen) int64, ``prefill_s`` and ``decode_s``
    (host clock, the device synchronised), ``first_logits`` (the
    prefill's) and ``last_logits`` (the last step's), both (B,1,V)."""
    B, S = tokens.shape
    n_meta = model.cfg.n_meta_tokens
    cache_len = model.cache_len_for(n_meta + S + gen)
    dev = model.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    first = logits
    tok = torch.argmax(logits, -1)                            # (B,1)
    out = [tok]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        pos = torch.full((B, 1), n_meta + S + i, dtype=torch.int32,
                         device=dev)
        logits, cache = model.decode_step(params, cache, tok, pos)
        tok = torch.argmax(logits, -1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t1
    return {"tokens": torch.cat(out, 1), "prefill_s": t_prefill,
            "decode_s": t_decode, "first_logits": first,
            "last_logits": logits}


def report(model, tokens: torch.Tensor, res: dict) -> str:
    B, S = tokens.shape
    gen = res["tokens"].shape[1]
    tp, td = res["prefill_s"], res["decode_s"]
    steps = max(gen - 1, 1)
    return "\n".join([
        f"arch={model.cfg.name} impl={model.impl} device={model.device} "
        f"batch={B} prompt={S} meta={model.cfg.n_meta_tokens} gen={gen}",
        f"prefill: {tp * 1e3:.1f} ms ({B * S / max(tp, 1e-9):.0f} tok/s)",
        f"decode:  {td * 1e3:.1f} ms ({td * 1e3 / steps:.2f} ms/token, "
        f"{B * (gen - 1) / max(td, 1e-9):.1f} tok/s)",
        "sample continuation: "
        f"{res['tokens'][0][:10].tolist()}"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="fedforecast-100m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--impl", default="kernel", choices=("kernel", "xla"),
                    help="xla: prefill through the plain attention and "
                         "scan, to hold the kernels' output against")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be >= 1")
    model, params, tokens = setup(
        args.arch, reduced=args.reduced, batch=args.batch,
        prompt_len=args.prompt_len, seed=args.seed, impl=args.impl,
        device=args.device)
    with torch.no_grad():
        res = generate(model, params, tokens, args.gen)
    print(report(model, tokens, res), flush=True)
    return res


if __name__ == "__main__":
    main()
