"""Serving driver: batched prefill + decode against a deployed model
(port of ``repro.launch.serve``).

This is the client-side Inference Manager / Model Subscription API (paper
section VI) as a standalone service loop: a batch of requests is
prefix-filled once, then decoded token by token from the ring-buffer KV
cache, MLA's latent cache, the SSM state or an enc-dec decoder's self and
cross caches. With ``--impl kernel`` (the default) the prefill runs K6
flash attention and K7 the SSD scan where the architecture has them;
decode takes the plain attention and the O(1) recurrence, as in the
reference. Every architecture of ``repro_torch.configs`` serves; a
vision model's prompt is its patch embeddings then its tokens, an
enc-dec model's its frame embeddings (the frontends are stubs: features
drawn with numpy from ``--seed``, as the reference's).

Positions and the cache length count the model's meta tokens (hymba's
128) and patches: decode step i writes stream position ``n_prefix + S +
i``. An enc-dec decoder starts at a bos token at position 0 and decodes
at ``1 + i``. (The reference's serve loop leaves the meta tokens out and
decodes an enc-dec at ``S + i``, after a gap; its decode-consistency
test counts the meta tokens, and the contracts served here are the ones
the teacher-forced forward passes agree with.)

  python -m repro_torch.launch.serve --arch gemma2-9b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --device cpu --batch 2 --prompt-len 24 --gen 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DEFAULT_DEVICE, resolve, synchronize
from repro_torch.models import build_model

MIN_TOKENS = 8      # a vision prompt keeps at least this many tokens


def make_batch(cfg, batch: int, prompt_len: int, seed: int,
               device) -> dict:
    """The reference serve loop's batch for ``cfg``, drawn with numpy from
    ``seed``: text ``{"tokens"}``; vision ``{"patches" (B, P, d_frontend),
    "tokens" (B, max(S - P, 8))}``; enc-dec ``{"frames" (B, S,
    d_frontend), "tokens" (B, S)}``. Features are float32 normals, token
    ids int64."""
    rng = np.random.default_rng(seed)
    B, S = batch, prompt_len

    def tokens(n):
        return rng.integers(0, cfg.vocab, (B, n)).astype(np.int64)

    def normal(n):
        return rng.normal(size=(B, n, cfg.frontend.d_frontend)).astype(
            np.float32)

    if cfg.is_encoder_decoder:
        out = {"frames": normal(S), "tokens": tokens(S)}
    elif cfg.frontend is not None:
        P = cfg.frontend.num_tokens
        out = {"patches": normal(P), "tokens": tokens(max(S - P, MIN_TOKENS))}
    else:
        out = {"tokens": tokens(S)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def setup(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 64, seed: int = 0, impl: str = "kernel",
          device=DEFAULT_DEVICE):
    """(model, params in the compute dtype, batch dict of ``make_batch``):
    random init from ``seed`` straight into the compute dtype for serving
    (no f32 masters); the prompts drawn with numpy from ``seed``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, impl=impl, device=resolve(device))
    params = model.init(model.generator(seed), dtype=getattr(torch, cfg.dtype))
    return model, params, make_batch(cfg, batch, prompt_len, seed,
                                     model.device)


def stream_len(model, batch: dict) -> int:
    """Positions a prefill of ``batch`` fills in the decode stream: the
    meta tokens, patches and tokens; 1 (the bos) for an enc-dec."""
    if model.cfg.is_encoder_decoder:
        return 1
    n = model.cfg.n_meta_tokens + batch["tokens"].shape[1]
    if "patches" in batch:
        n += batch["patches"].shape[1]
    return n


def prompt_len(batch: dict) -> int:
    """Prompt positions a request brings: its frames, or its patches and
    tokens."""
    if "frames" in batch:
        return batch["frames"].shape[1]
    return batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                       if "patches" in batch else 0)


def generate(model, params: dict, batch: dict, gen: int) -> dict:
    """Prefill ``batch`` (a ``make_batch`` dict), then greedy-decode
    ``gen`` tokens.

    Returns ``tokens`` (B, gen) int64, ``prefill_s`` and ``decode_s``
    (host clock, the device synchronised), ``first_logits`` (the
    prefill's) and ``last_logits`` (the last step's), both (B,1,V)."""
    B = batch["tokens"].shape[0]
    n0 = stream_len(model, batch)
    cache_len = model.cache_len_for(n0 + gen)
    dev = model.device
    synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache_len)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0
    first = logits
    tok = torch.argmax(logits, -1)                            # (B,1)
    out = [tok]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        pos = torch.full((B, 1), n0 + i, dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, cache, tok, pos)
        tok = torch.argmax(logits, -1)
        out.append(tok)
    synchronize(dev)
    t_decode = time.perf_counter() - t1
    return {"tokens": torch.cat(out, 1), "prefill_s": t_prefill,
            "decode_s": t_decode, "first_logits": first,
            "last_logits": logits}


def report(model, batch: dict, res: dict) -> str:
    B, S = batch["tokens"].shape[0], prompt_len(batch)
    gen = res["tokens"].shape[1]
    tp, td = res["prefill_s"], res["decode_s"]
    steps = max(gen - 1, 1)
    extra = "".join(f" {k}={v.shape[1]}" for k, v in batch.items()
                    if k != "tokens")
    return "\n".join([
        f"arch={model.cfg.name} impl={model.impl} device={model.device} "
        f"batch={B} prompt={S}{extra} meta={model.cfg.n_meta_tokens} "
        f"gen={gen}",
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
    model, params, batch = setup(
        args.arch, reduced=args.reduced, batch=args.batch,
        prompt_len=args.prompt_len, seed=args.seed, impl=args.impl,
        device=args.device)
    with torch.no_grad():
        res = generate(model, params, batch, args.gen)
    print(report(model, batch, res), flush=True)
    return res


if __name__ == "__main__":
    main()
