"""What the serving drivers share: the served model from the seed's
weights, and the comparison of served tokens and logits with the
reference.

The comparison of a request: the reference runs once over the prompt and
the tokens that were served after it, in float32, and at every position
that produced a served token it gives
  gap       the reference's best logit less its logit of the served token
            (0 where they agree; the widest over the positions counts)
  logit_err the RMS of the served logits less the reference's, over the
            RMS of the reference's about their mean (the largest counts)
Greedy decoding serves the argmax, so a small gap is rounding between
near-equal logits and a large one a wrong token. The control puts the
reference computed with fp8 projections in the program's place: its
logits, and the tokens it ranks first.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.reference import model as ref


def served_model(ctx):
    """(model, params): the program's model on its kernel path over the
    seed's weights, in the dtype the configuration serves."""
    from repro_torch.models import build_model
    ctx.mark("imports")
    dtype = getattr(torch, ctx.cfg["dtype"])
    params = ref.make_params(ctx.cfg, harness.derive_seed(ctx.seed, "weights"),
                             ctx.device, dtype=dtype)
    model = build_model(ctx.program_cfg, impl="kernel", device=ctx.device)
    ctx.check_tree(model.abstract_params(), params)
    return model, params


def reference_params(ctx) -> dict:
    """The same weights drawn again from the seed, as served, widened to
    float32."""
    dtype = getattr(torch, ctx.cfg["dtype"])
    params = ref.make_params(ctx.cfg, harness.derive_seed(ctx.seed, "weights"),
                             ctx.device, dtype=dtype)
    return ref.tree_map2(lambda a: a.float(), params)


def compare(cfg: dict, params: dict, prompt, served, logits=None,
            quant=None) -> dict:
    """One request: ``prompt`` (B, T) ids, ``served`` (B, k+1) the tokens
    served after it, ``logits`` (B, k+1, V) the served logits. With
    ``quant`` the reference at that precision stands in for the program:
    its logits, and the tokens it puts first."""
    n0 = cfg.get("n_meta_tokens", 0) + prompt.shape[1]
    k = served.shape[1] - 1
    stream = torch.cat([prompt, served[:, :k].to(prompt.device)], dim=1)
    positions = list(range(n0 - 1, n0 + k))
    with torch.no_grad():
        want = ref.logits_at(cfg, params, stream, positions)
        if quant is not None:
            logits = ref.logits_at(cfg, params, stream, positions, quant=quant)
            served = logits.argmax(-1)
    served = served.to(want.device)
    got = logits.to(want.device, torch.float32)
    gap = want.max(-1).values - want.gather(-1, served[..., None])[..., 0]
    centred = want - want.mean(-1, keepdim=True)
    err = ((got - want).square().mean(-1).sqrt()
           / centred.square().mean(-1).sqrt())
    return {"gap": float(gap.max()), "logit_err": float(err.max())}


def worst(readings) -> dict:
    """The largest of each number over requests."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def sample(n: int, k: int, seed: int) -> list:
    """``k`` of ``n`` request indices, drawn from the seed."""
    rng = np.random.default_rng(harness.derive_seed(seed, "sample"))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
