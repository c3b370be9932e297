"""Mamba2 (SSD — state-space duality) block (port of
``repro.models.ssm``). [arXiv:2405.21060]

Train/prefill uses the chunked SSD algorithm (quadratic intra-chunk
attention form + linear inter-chunk state passing); decode is the
O(1)-state recurrence. B and C come in ``cfg.n_ssm_groups`` groups (head
h reads group h // (H / G)) and the gated RMSNorm is taken per group, as
Mamba2's; at one group every path is the one-group code it always was.
``impl="kernel"`` routes the scan through K7
(``kernels/ssd_scan``), the counterpart of the reference's
``impl="pallas"``; ``impl="xla"`` runs the plain chunked form. Over a
mesh of ranks the ``ssm_shard`` variant's constraint (``_ssm_shard``)
is the reference's ``REPRO_SSM_SHARD``; a prefill runs head-parallel and
a decode on the cache's own blocks (``sharding/serve.py``), with one
group only.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding import serve as _serve
from repro_torch.sharding.specs import P, constrain, place_cache


def _d_xbc(cfg) -> int:
    """Channels of the conv'd x|B|C: x, then each group's B, then C."""
    return cfg.d_inner_ssm + 2 * cfg.n_ssm_groups * cfg.ssm.d_state


def ssm_init(gen: torch.Generator, cfg) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    d_inner = cfg.d_inner_ssm
    H = cfg.n_ssm_heads
    d_xbc = _d_xbc(cfg)
    dev = gen.device
    lin = torch.linspace(1e-3, 1e-1, H, dtype=torch.float32, device=dev)
    return {
        # z (gate), xBC (conv'd), dt — one fused input projection
        "in_proj": dense_init(gen, (D, d_inner + d_xbc + H)),
        "conv_w": dense_init(gen, (s.d_conv, d_xbc), in_axis=0),
        "conv_b": torch.zeros(d_xbc, dtype=torch.float32, device=dev),
        # softplus^-1 of uniform [1e-3, 1e-1]
        "dt_bias": torch.log(torch.expm1(lin)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones(H, dtype=torch.float32, device=dev),
        "norm_w": torch.zeros(d_inner, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, D)),
    }


def _split_proj(cfg, proj: torch.Tensor):
    d_inner = cfg.d_inner_ssm
    d_xbc = _d_xbc(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_xbc]
    dt = proj[..., d_inner + d_xbc:]
    if dt.shape[-1] != cfg.n_ssm_heads:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt heads, expected "
                         f"{cfg.n_ssm_heads}")
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B,S,C) with kernel (K,C)."""
    K = conv_w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * conv_w[i].to(xbc.dtype) for i in range(K))
    return F.silu(out + conv_b.to(xbc.dtype))


def _groups_bc(cfg, xbc: torch.Tensor):
    """B and C of the conv'd x|B|C (..., d_xbc): (..., N) each at one
    group, else (..., G, N), as views."""
    d_inner, G, N = cfg.d_inner_ssm, cfg.n_ssm_groups, cfg.ssm.d_state
    B = xbc[..., d_inner:d_inner + G * N]
    C = xbc[..., d_inner + G * N:]
    if G == 1:
        return B, C
    return (B.unflatten(-1, (G, N)), C.unflatten(-1, (G, N)))


def _scan_inputs(p: dict, cfg, x: torch.Tensor):
    """in_proj, conv and discretisation shared by forward and prefill:
    (z, raw xBC, head inputs xh, B, C, dt, A)."""
    s = cfg.ssm
    H, P = cfg.n_ssm_heads, s.d_head
    b, S, _ = x.shape
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc_raw, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    d_inner = cfg.d_inner_ssm
    xh = xbc[..., :d_inner].reshape(b, S, H, P)
    B, C = _groups_bc(cfg, xbc)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    # A in the params' dtype, as the reference computes it, then widened
    A = (-torch.exp(p["A_log"])).to(torch.float32)
    return z, xbc_raw, xh, B, C, dt, A


def _scan(cfg, xh, dt, A, B, C, impl: str):
    if impl == "kernel":
        return ssd_ops.ssd_scan(xh, dt, A, B, C, chunk=cfg.ssm.chunk)
    if impl != "xla":
        raise ValueError(f"impl must be 'xla' or 'kernel', got {impl!r}")
    return ssd_chunked(xh, dt, A, B, C, chunk=cfg.ssm.chunk)


def _gated_norm(cfg, y, z, w) -> torch.Tensor:
    """The gated RMSNorm of ``y * silu(z)`` (..., d_inner): over all
    channels at one group, else over each group's d_inner / G."""
    u = y * F.silu(z)
    G = cfg.n_ssm_groups
    if G == 1:
        return rms_norm(u, w, cfg.norm_eps)
    # ``rms_norm``'s f32 arithmetic, its mean square over each group
    v = u.to(torch.float32).unflatten(-1, (G, u.shape[-1] // G))
    v = v * torch.rsqrt(torch.mean(torch.square(v), dim=-1, keepdim=True)
                        + cfg.norm_eps)
    return (v.flatten(-2) * (1.0 + w.to(torch.float32))).to(u.dtype)


def _scan_output(p: dict, cfg, y, xh, z, dtype) -> torch.Tensor:
    b, S = xh.shape[:2]
    y = y + p["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    y = y.reshape(b, S, cfg.d_inner_ssm).to(dtype)
    y = _gated_norm(cfg, y, z, p["norm_w"])
    return y @ p["out_proj"].to(dtype)


def _ssm_shard(xh, B, C, z):
    """ssm_shard variant (``REPRO_SSM_SHARD=1``): the heads over "model",
    B and C (the small state projections) replicated, on the mesh in
    scope; the identity otherwise. The reference takes it in the forward
    only, not in the prefill."""
    if os.environ.get("REPRO_SSM_SHARD") != "1":
        return xh, B, C, z
    return (constrain(xh, P("data", None, "model", None)),
            constrain(B, P("data", None, None)),
            constrain(C, P("data", None, None)),
            constrain(z, P("data", None, "model")))


def ssm_forward(p: dict, cfg, x: torch.Tensor, *,
                impl: str = "xla") -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (B,S,D) -> (B,S,D)."""
    z, _, xh, B, C, dt, A = _scan_inputs(p, cfg, x)
    xh, B, C, z = _ssm_shard(xh, B, C, z)
    y, _ = _scan(cfg, xh, dt, A, B, C, impl)
    return _scan_output(p, cfg, y, xh, z, x.dtype)


def ssm_prefill(p: dict, cfg, x: torch.Tensor, *, impl: str = "xla"):
    """Like ``ssm_forward`` but also returns the decode cache;
    head-parallel over ranks (``_ssm_prefill_over_ranks``)."""
    if _serve.over_ranks(x):
        _one_group(cfg)
        return _ssm_prefill_over_ranks(p, cfg, x, impl=impl)
    S = x.shape[1]
    z, xbc_raw, xh, B, C, dt, A = _scan_inputs(p, cfg, x)
    y, state = _scan(cfg, xh, dt, A, B, C, impl)
    out = _scan_output(p, cfg, y, xh, z, x.dtype)
    # conv state = last (d_conv-1) *pre-activation* xBC rows
    tail = xbc_raw[:, S - (cfg.ssm.d_conv - 1):, :].contiguous()
    return out, {"conv": tail, "state": state}


def _one_group(cfg) -> None:
    if cfg.n_ssm_groups != 1:
        raise ValueError(f"{cfg.name}: B/C groups over ranks are not "
                         f"supported")


def _ssm_prefill_over_ranks(p: dict, cfg, x, *, impl: str):
    """A serve program's SSM prefill over ranks, head-parallel over "model"
    (``sharding/serve.py``): this rank's z, x and dt columns of
    ``in_proj`` for its heads and the B and C columns every head shares
    (the weight gathered once), the conv and the scan (K7 on the card
    for ``impl="kernel"``) on its heads, the gated norm's mean square
    summed over "model", its rows of ``out_proj``. The conv tail and the
    state come back placed as the cache places them."""
    s = cfg.ssm
    H, Pd, N = cfg.n_ssm_heads, s.d_head, s.d_state
    d_inner = cfg.d_inner_ssm
    x = _serve.batch_only(x)
    xl = x.to_local()
    b, S, _ = xl.shape
    dt_ = xl.dtype
    lo, hi = _serve.span(H, x)
    n = hi - lo
    xs = (d_inner + lo * Pd, d_inner + hi * Pd)
    bc = (2 * d_inner, 2 * d_inner + 2 * N)
    w_z, w_x, w_bc, w_dt = _serve.sections(p["in_proj"].to(dt_), 1, [
        (lo * Pd, hi * Pd), xs, bc,
        (2 * d_inner + 2 * N + lo, 2 * d_inner + 2 * N + hi)])
    conv_ranges = [(lo * Pd, hi * Pd), (d_inner, d_inner + 2 * N)]
    cw = torch.cat(_serve.sections(p["conv_w"], 1, conv_ranges), dim=1)
    cb = torch.cat(_serve.sections(p["conv_b"], 0, conv_ranges), dim=0)
    z = xl @ w_z
    xbc_raw = torch.cat([xl @ w_x, xl @ w_bc], dim=-1)
    dt = F.softplus((xl @ w_dt).to(torch.float32)
                    + _serve.full(p["dt_bias"])[lo:hi])
    xbc = _causal_conv(xbc_raw, cw, cb)
    xh = xbc[..., :n * Pd].reshape(b, S, n, Pd)
    B = xbc[..., n * Pd:n * Pd + N]
    C = xbc[..., n * Pd + N:]
    A = (-torch.exp(_serve.full(p["A_log"])[lo:hi])).to(torch.float32)
    if n:
        y, state = _scan(cfg, xh, dt, A, B, C, impl)
    else:
        y = torch.zeros((b, S, 0, Pd), dtype=torch.float32,
                        device=xl.device)
        state = torch.zeros((b, 0, Pd, N), dtype=torch.float32,
                            device=xl.device)
    y = y + _serve.full(p["D"]).to(torch.float32)[lo:hi, None] \
        * xh.to(torch.float32)
    u = (y.reshape(b, S, n * Pd).to(dt_) * F.silu(z)).to(torch.float32)
    # the gated RMSNorm over all d_inner channels: its mean square summed
    # over "model", then each rank scales its own channels
    var = _serve.reduced(torch.sum(torch.square(u), dim=-1), x) / d_inner
    w = _serve.full(p["norm_w"]).to(torch.float32)[lo * Pd:hi * Pd]
    u = (u * torch.rsqrt(var[..., None] + cfg.norm_eps) * (1.0 + w)).to(dt_)
    out = u @ _serve.head_block(p["out_proj"], 0, H, Pd, x).to(dt_)
    # conv state = last (d_conv-1) *pre-activation* xBC rows, every channel
    K1 = s.d_conv - 1
    tail_x = _serve.whole(_serve.heads(
        xbc_raw[:, S - K1:, :n * Pd].reshape(b, K1, n, Pd).contiguous(), x,
        2, H)).reshape(b, K1, d_inner)
    tail = torch.cat([tail_x, xbc_raw[:, S - K1:, n * Pd:]], dim=-1)
    return _serve.partial(out, x), {
        "conv": place_cache(_serve.replicated(tail.contiguous(), x),
                            batch=x.shape[0]),
        "state": place_cache(_serve.heads(state, x, 1, H),
                             batch=x.shape[0])}


# ---------------------------------------------------------------------------
# Decode: O(1)-state recurrence
# ---------------------------------------------------------------------------
def ssm_cache_init(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d_xbc = _d_xbc(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_xbc), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, cfg.n_ssm_heads, s.d_head, s.d_state),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(p: dict, cfg, x: torch.Tensor, cache: dict):
    """x: (B,1,D). Returns (y (B,1,D), cache), the cache's conv window
    and state updated in place; over ranks each rank updates its own
    blocks of them (``_ssm_decode_over_ranks``)."""
    if _serve.over_ranks(x) and _local_cache(x, cache):
        _one_group(cfg)
        return _ssm_decode_over_ranks(p, cfg, x, cache)
    s = cfg.ssm
    H, P = cfg.n_ssm_heads, s.d_head
    b = x.shape[0]
    dt_ = x.dtype
    proj = x[:, 0] @ p["in_proj"].to(dt_)                      # (B, ...)
    z, xbc, dt = _split_proj(cfg, proj)
    # causal conv over [conv_state ; new]
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(dt_)) \
        + p["conv_b"].to(dt_)
    xbc = F.silu(conv_out)

    d_inner = cfg.d_inner_ssm
    xh = xbc[..., :d_inner].reshape(b, H, P)
    B, C = _groups_bc(cfg, xbc)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])      # (B,H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    if B.dim() == 2:
        h = cache["state"] * dA[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt, xh.to(torch.float32), B.to(torch.float32))
        y = torch.einsum("bhpn,bn->bhp", h, C.to(torch.float32))
    else:       # each head's group's B and C: (B, G, n, ...) over heads
        G = B.shape[1]
        hg = (b, G, H // G)
        h = cache["state"] * dA[:, :, None, None] + torch.einsum(
            "bgj,bgjp,bgn->bgjpn", dt.reshape(hg),
            xh.to(torch.float32).reshape(*hg, P),
            B.to(torch.float32)).flatten(1, 2)
        y = torch.einsum("bgjpn,bgn->bgjp", h.unflatten(1, (G, H // G)),
                         C.to(torch.float32)).flatten(1, 2)
    y = y + p["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    y = y.reshape(b, d_inner).to(dt_)
    y = _gated_norm(cfg, y, z, p["norm_w"])
    y = (y @ p["out_proj"].to(dt_))[:, None, :]
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(h)
    return y, cache


def _local_cache(x, cache: dict) -> bool:
    """Over ranks, the decode runs on the cache's own blocks when both
    leaves are placed and each holds the same rows of the batch as
    ``x``."""
    if not all(isinstance(cache[k], DTensor) for k in ("conv", "state")):
        return False
    shape, off = _serve.local_block(x, _serve.rows_placement(x))
    return all(_serve.local_block(leaf)[0][0] == shape[0]
               and _serve.local_block(leaf)[1][0] == off[0]
               for leaf in (cache["conv"], cache["state"]))


def _ssm_decode_over_ranks(p: dict, cfg, x, cache: dict):
    """``ssm_decode`` on each rank's blocks of the cache, which stay where
    they are (XLA keeps the state local): the input projection gathered
    whole over "model" (a few hundred bytes a row), this rank's channels
    of the conv window, the conv's output gathered, this rank's block of
    the state, its output summed over "model" where the state's d_state
    is split (a partial sum) and gathered where its heads or head dim
    are."""
    s = cfg.ssm
    H, Pd, N = cfg.n_ssm_heads, s.d_head, s.d_state
    d_inner = cfg.d_inner_ssm
    conv, state = cache["conv"], cache["state"]
    mesh = conv.device_mesh
    x = _serve.batch_only(x)
    b = x.to_local().shape[0]
    dt_ = x.dtype
    proj = _serve.whole(x[:, 0] @ p["in_proj"].to(dt_))
    z, xbc, dt = _split_proj(cfg, proj)
    # this rank's channels of the causal conv over [conv_state ; new],
    # the window's positions gathered where they are split
    (_, kn, cn), (_, k0, c0) = _serve.local_block(conv)
    cl = conv.to_local()
    rows = cl if kn == conv.shape[1] else conv.redistribute(mesh, [
        Replicate() if pl.is_shard(1) else pl
        for pl in conv.placements]).to_local()
    window = torch.cat([rows, xbc[:, None, c0:c0 + cn]], dim=1)
    w = _serve.sections(p["conv_w"].to(dt_), 1, [(c0, c0 + cn)])[0]
    bias = _serve.sections(p["conv_b"].to(dt_), 0, [(c0, c0 + cn)])[0]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w) + bias)
    xbc = _serve.whole(DTensor.from_local(
        conv_out, mesh, [Shard(1) if pl.is_shard(2) else
                         (Replicate() if pl.is_shard(1) else pl)
                         for pl in conv.placements], run_check=False,
        shape=(x.shape[0], conv.shape[2]), stride=(conv.shape[2], 1)))
    xh = xbc[..., :d_inner].reshape(b, H, Pd)
    B = xbc[..., d_inner:d_inner + N]
    C = xbc[..., d_inner + N:]
    dt = F.softplus(dt.to(torch.float32) + _serve.full(p["dt_bias"]))
    dA = torch.exp(dt * -torch.exp(_serve.full(p["A_log"])))
    # this rank's block of the state: (b, h, p, n) sliced as it is placed
    (_, hn, pn, nn), (_, h0, p0, n0) = _serve.local_block(state)
    hs, ps, ns = slice(h0, h0 + hn), slice(p0, p0 + pn), slice(n0, n0 + nn)
    sl = state.to_local()
    h = sl * dA[:, hs, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt[:, hs], xh[:, hs, ps].to(torch.float32),
        B[:, ns].to(torch.float32))
    y = torch.einsum("bhpn,bn->bhp", h, C[:, ns].to(torch.float32))
    y = _serve.whole(DTensor.from_local(
        y, mesh, [Partial() if pl.is_shard(3) else
                  (pl if pl.is_shard() else Replicate())
                  for pl in state.placements], run_check=False,
        shape=(x.shape[0], H, Pd), stride=(H * Pd, Pd, 1)))
    y = y + _serve.full(p["D"]).to(torch.float32)[:, None] \
        * xh.to(torch.float32)
    y = y.reshape(b, d_inner).to(dt_)
    y = rms_norm(y * F.silu(z), _serve.full(p["norm_w"]), cfg.norm_eps)
    y = (_serve.replicated(y, x) @ p["out_proj"].to(dt_))[:, None, :]
    cl.copy_(window[:, 1 + k0:1 + k0 + kn])
    sl.copy_(h)
    return y, cache
