"""Plain PyTorch versions of the Mamba2 SSD scan (port of
``repro.kernels.ssd_scan.ref`` and ``repro.models.ssm.ssd_chunked``).

``ssd_ref`` is the sequential recurrence, the ground truth

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x_t)^T
    y_t = C_t . h_t

and ``ssd_chunked`` the chunked form that K7 computes and the CPU path
runs. Both widen every input to f32. B and C are (b,S,N), every head's,
or (b,S,G,N) in G groups, head h reading group h // (H // G): the
grouped forms run the one-group form on each group's heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

f32 = torch.float32


def by_group(fn):
    """``fn(x, dt, A, B, C, **kw)`` of one B/C group extended to B, C of
    (b,S,G,N): each group's heads run alone, their y and states joined
    in head order."""
    def grouped(x, dt, A, B, C, **kw):
        if B.dim() == 3:
            return fn(x, dt, A, B, C, **kw)
        G = B.shape[2]
        n = x.shape[2] // G
        outs = [fn(x[:, :, g * n:(g + 1) * n], dt[..., g * n:(g + 1) * n],
                   A[g * n:(g + 1) * n], B[:, :, g], C[:, :, g], **kw)
                for g in range(G)]
        return (torch.cat([y for y, _ in outs], 2),
                torch.cat([h for _, h in outs], 1))
    grouped.__doc__ = fn.__doc__
    return grouped


@by_group
def ssd_ref(x, dt, A, B, C):
    """x: (b,S,H,P); dt: (b,S,H); A: (H,); B,C: (b,S,N).

    Returns y (b,S,H,P) f32 and final state (b,H,P,N) f32."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    x, dt, B, C, A = (t.to(f32) for t in (x, dt, B, C, A))
    h = torch.zeros((b, H, P, N), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A)                          # (b,H)
        h = (h * dA[..., None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]))
    y = torch.stack(ys, 1) if ys else x.new_zeros((b, 0, H, P))
    return y, h


@by_group
def ssd_chunked(x, dt, A, B, C, *, chunk: int):
    """Chunked SSD scan.

    x: (b,S,H,P) head inputs; dt: (b,S,H) discretization (post-softplus);
    A: (H,) negative decay rates; B, C: (b,S,N) (ngroups=1, broadcast to
    heads). Returns y: (b,S,H,P) f32 and final state (b,H,P,N) f32.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad with dt=0 tokens: log-decay 0 and zero input, so padding is a
        # no-op for both outputs and the final state
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    dlog = (dt.to(f32) * A.to(f32)).reshape(b, nc, Q, H)      # log dA (<=0)
    xb = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, nc, Q, H, P)
    Bc = B.to(f32).reshape(b, nc, Q, N)
    Cc = C.to(f32).reshape(b, nc, Q, N)

    L = torch.cumsum(dlog, dim=2)                             # (b,nc,Q,H)
    # --- intra-chunk (quadratic attention form) ---------------------------
    # att[t,s] = (C_t . B_s) * exp(L_t - L_s), s <= t; the exponent is
    # masked before the exp (above the diagonal it is positive)
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)              # (b,nc,Q,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]          # (b,nc,t,s,H)
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    att = cb[..., None] * decay
    y_intra = torch.einsum("bctsh,bcshp->bcthp", att, xb)

    # --- chunk summary states ---------------------------------------------
    # S_c = sum_s exp(L_last - L_s) B_s (x_s dt_s)^T  -> (b,nc,H,N,P)
    last = L[:, :, -1:, :]                                    # (b,nc,1,H)
    w = torch.exp(last - L)                                   # (b,nc,Q,H)
    states = torch.einsum("bcsh,bcsn,bcshp->bchnp", w, Bc, xb)

    # --- inter-chunk recurrence -------------------------------------------
    chunk_decay = torch.exp(last[:, :, 0, :])                 # (b,nc,H)
    h = torch.zeros((b, H, N, P), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, 1)                         # (b,nc,H,N,P)

    # --- inter-chunk contribution ------------------------------------------
    y_inter = torch.einsum("bcth,bctn,bchnp->bcthp", torch.exp(L), Cc,
                           h_prevs)
    y = (y_intra + y_inter).reshape(b, S, H, P)[:, :S_orig]
    return y, h.transpose(-1, -2)                             # (b,H,P,N)


@by_group
def ssd_three_pass(x, dt, A, B, C, *, chunk: int):
    """The chunk-parallel decomposition K7 runs, in plain torch (for the
    tests and ``chip_smoke.py``; the CPU path runs ``ssd_chunked``):

    1. per (batch, chunk): C B^T once for every head; per head L =
       cumsum(dt A) and the chunk's own state S_c = sum_s exp(L_last -
       L_s) B_s xb_s^T;
    2. state passing over the chunks: h_c = exp(L_last,c) h_{c-1} + S_c;
    3. per (batch, chunk, head): y = (C B^T o exp(L_t - L_s) o tril) xb +
       exp(L_t) C h_{c-1}.

    Same arguments and results as ``ssd_chunked``."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S) or 1
    nc = -(-S // Q)
    pad = nc * Q - S                    # dt = 0 rows: a no-op
    x, dt, B, C = (F.pad(t.to(f32), (0, 0) * (t.dim() - 2) + (0, pad))
                   for t in (x, dt, B, C))
    xb = (x * dt[..., None]).reshape(b, nc, Q, H, P)
    Bc, Cc = B.reshape(b, nc, Q, N), C.reshape(b, nc, Q, N)
    # pass 1
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)              # once a chunk
    L = torch.cumsum((dt * A.to(f32)).reshape(b, nc, Q, H), dim=2)
    w = torch.exp(L[:, :, -1:, :] - L)                        # (b,nc,Q,H)
    s_c = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bc, w, xb)
    # pass 2
    h = torch.zeros((b, H, N, P), dtype=f32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * torch.exp(L[:, c, -1, :])[..., None, None] + s_c[:, c]
    entering = torch.stack(entering, 1)                       # (b,nc,H,N,P)
    # pass 3
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]          # (b,nc,t,s,H)
    att = cb[..., None] * torch.exp(
        torch.where(tri[None, None, :, :, None], diff, float("-inf")))
    y = (torch.einsum("bctsh,bcshp->bcthp", att, xb)
         + torch.exp(L)[..., None]
         * torch.einsum("bctn,bchnp->bcthp", Cc, entering))
    return y.reshape(b, nc * Q, H, P)[:, :S], h.transpose(-1, -2)
