"""Mamba2 (SSD — state-space duality) block (port of
``repro.models.ssm``). [arXiv:2405.21060]

Train/prefill uses the chunked SSD algorithm (quadratic intra-chunk
attention form + linear inter-chunk state passing); decode is the
O(1)-state recurrence. ``impl="kernel"`` routes the scan through K7
(``kernels/ssd_scan``), the counterpart of the reference's
``impl="pallas"``; ``impl="xla"`` runs the plain chunked form. The
reference's ``REPRO_SSM_SHARD`` constraint is TPU mesh sharding and has
no counterpart here.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding.specs import P, constrain


def ssm_init(gen: torch.Generator, cfg) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    d_inner = cfg.d_inner_ssm
    H = cfg.n_ssm_heads
    d_xbc = d_inner + 2 * s.d_state
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
    s = cfg.ssm
    d_inner = cfg.d_inner_ssm
    d_xbc = d_inner + 2 * s.d_state
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
    B = xbc[..., d_inner:d_inner + s.d_state]
    C = xbc[..., d_inner + s.d_state:]
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


def _scan_output(p: dict, cfg, y, xh, z, dtype) -> torch.Tensor:
    b, S = xh.shape[:2]
    y = y + p["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    y = y.reshape(b, S, cfg.d_inner_ssm).to(dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
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
    """Like ``ssm_forward`` but also returns the decode cache."""
    S = x.shape[1]
    z, xbc_raw, xh, B, C, dt, A = _scan_inputs(p, cfg, x)
    y, state = _scan(cfg, xh, dt, A, B, C, impl)
    out = _scan_output(p, cfg, y, xh, z, x.dtype)
    # conv state = last (d_conv-1) *pre-activation* xBC rows
    tail = xbc_raw[:, S - (cfg.ssm.d_conv - 1):, :].contiguous()
    return out, {"conv": tail, "state": state}


# ---------------------------------------------------------------------------
# Decode: O(1)-state recurrence
# ---------------------------------------------------------------------------
def ssm_cache_init(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d_xbc = cfg.d_inner_ssm + 2 * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_xbc), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, cfg.n_ssm_heads, s.d_head, s.d_state),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(p: dict, cfg, x: torch.Tensor, cache: dict):
    """x: (B,1,D). Returns (y (B,1,D), cache), the cache's conv window
    and state updated in place."""
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
    B = xbc[..., d_inner:d_inner + s.d_state]
    C = xbc[..., d_inner + s.d_state:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])      # (B,H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    h = cache["state"] * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh.to(torch.float32), B.to(torch.float32))
    y = torch.einsum("bhpn,bn->bhp", h, C.to(torch.float32))
    y = y + p["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    y = y.reshape(b, d_inner).to(dt_)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    y = (y @ p["out_proj"].to(dt_))[:, None, :]
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(h)
    return y, cache
