"""The plain reference of the benchmark's decoder models, in float32.

A decoder-only model over a dict of parameters: the dense attention block
(fedforecast-100m) and the hybrid block of parallel attention and Mamba2
heads behind learned meta tokens (hymba-1.5b). Written from the block
equations, in plain ``torch`` operations: no kernel, no cache, no batching
trick. It imports nothing of the program under test.

The equations, per layer ``i`` (``x`` the residual stream, ``h`` its
RMSNorm, scaled by ``1 + w``):
  dense:  x += attn_i(h);                     x += mlp(norm(x))
  hybrid: x += (attn_i(h) + ssm(h)) / 2;      x += mlp(norm(x))
attention is grouped-query with rotate-half RoPE over stream positions,
causal, and windowed (keys in ``(q - window, q]``) on the layers that
``layer_window`` names; the MLP is SwiGLU; the SSM is Mamba2's: one input
projection to the gate z, the conv'd x|B|C and dt, a depthwise causal
conv and SiLU, ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the
scan ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T``, ``y_t = s_t C_t + D x_t``,
a gated RMSNorm of ``y * silu(z)`` and the output projection. The scan is
computed in its quadratic form, ``y_t = sum_{s<=t} exp(c_t - c_s) (C_t . B_s)
dt_s x_s`` with ``c`` the running sum of ``dt A`` and its differences
taken in float64 (over thousands of positions a float32 running sum
loses the digits a difference of neighbours needs).

``quant="fp8"`` gives the control: every projection's two inputs rounded
to float8 e4m3 with one scale a tensor (a straight-through gradient), the
precision a lower-precision version of the program would compute in.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # the largest float8 e4m3fn value
Q_BLOCK = 256            # query rows of one attention block
SSM_HEAD_BLOCK = 25      # heads of one block of the quadratic scan


def padded_vocab(cfg: dict) -> int:
    return (cfg["vocab"] + 255) // 256 * 256


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layer_window(cfg: dict, i: int) -> int:
    """Layer ``i``'s attention window; 0 is global."""
    w, period = cfg.get("sliding_window", 0), cfg.get("local_global_period", 0)
    if w <= 0:
        return 0
    if period > 0 and i % period == period - 1:
        return 0
    return w


def check_supported(cfg: dict):
    """The reference covers the dense and hybrid decoder blocks only."""
    for key in ("use_bias", "qk_norm", "is_encoder_decoder"):
        if cfg.get(key):
            raise NotImplementedError(f"the reference has no {key}")
    for key in ("attn_logit_softcap", "final_logit_softcap"):
        if cfg.get(key, 0.0):
            raise NotImplementedError(f"the reference has no {key}")
    if cfg.get("block_kind", "attn") not in ("attn", "hybrid"):
        raise NotImplementedError(f"block {cfg.get('block_kind')}")
    if cfg.get("moe") or cfg.get("mla") or cfg.get("frontend"):
        raise NotImplementedError("the reference has no MoE, MLA or frontend")


# ---------------------------------------------------------------------------
# parameters: shapes and the benchmark's initial distributions
# ---------------------------------------------------------------------------
def param_shapes(cfg: dict) -> Dict:
    """The parameter tree's shapes: layers stacked on a leading (L,) axis."""
    check_supported(cfg)
    L, D, F_ = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    H, Hkv, Dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    V = padded_vocab(cfg)
    block = {"norm_attn": (L, D), "norm_mlp": (L, D),
             "attn": {"wq": (L, D, H * Dh), "wk": (L, D, Hkv * Dh),
                      "wv": (L, D, Hkv * Dh), "wo": (L, H * Dh, D)},
             "mlp": {"w_gate": (L, D, F_), "w_up": (L, D, F_),
                     "w_down": (L, F_, D)}}
    if cfg.get("block_kind") == "hybrid":
        s = cfg["ssm"]
        d_inner = s["expand"] * D
        hs = d_inner // s["d_head"]
        d_xbc = d_inner + 2 * s["d_state"]
        block["ssm"] = {"in_proj": (L, D, d_inner + d_xbc + hs),
                        "conv_w": (L, s["d_conv"], d_xbc),
                        "conv_b": (L, d_xbc), "dt_bias": (L, hs),
                        "A_log": (L, hs), "D": (L, hs),
                        "norm_w": (L, d_inner), "out_proj": (L, d_inner, D)}
    tree = {"embed": (V, D), "final_norm": (D,), "stack": block}
    if not cfg.get("tie_embeddings"):
        tree["unembed"] = (D, V)
    if cfg.get("n_meta_tokens"):
        tree["meta_tokens"] = (cfg["n_meta_tokens"], D)
    return tree


def init_rule(path: str, shape) -> tuple:
    """How the benchmark draws leaf ``path`` (keys joined by '/'):
    ``("normal", std)`` (clipped to two std), ``("zeros",)``, ``("ones",)``
    or a per-layer ramp ``("dt_bias",)`` / ``("A_log",)``."""
    name = path.rsplit("/", 1)[-1]
    if name in ("embed", "meta_tokens"):
        return ("normal", 0.02)
    if "norm" in name or name == "conv_b":
        return ("zeros",)
    if name == "D":
        return ("ones",)
    if name in ("dt_bias", "A_log"):
        return (name,)
    return ("normal", 1.0 / math.sqrt(shape[-2]))       # fan-in of (in, out)


def leaf_paths(tree, prefix=""):
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from leaf_paths(tree[key], path)
        else:
            yield path, tree[key]


def _set(tree: dict, path: str, value):
    *head, last = path.split("/")
    for key in head:
        tree = tree.setdefault(key, {})
    tree[last] = value


def make_params(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The parameters drawn from ``seed`` by a generator on ``device``, one
    draw a leaf in sorted-path order, rounded to ``dtype``. The same seed,
    device and dtype give the same values."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: dict = {}
    for path, shape in leaf_paths(param_shapes(cfg)):
        rule = init_rule(path, shape)
        if rule[0] == "normal":
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            w = w.clamp_(-2.0, 2.0).mul_(rule[1])
        elif rule[0] == "zeros":
            w = torch.zeros(shape, device=device)
        elif rule[0] == "ones":
            w = torch.ones(shape, device=device)
        else:
            n = shape[-1]
            if rule[0] == "dt_bias":       # softplus^-1 of [1e-3, 1e-1]
                ramp = torch.log(torch.expm1(torch.linspace(
                    1e-3, 1e-1, n, device=device)))
            else:
                ramp = torch.log(torch.linspace(1.0, 16.0, n, device=device))
            w = ramp.expand(shape).clone()
        _set(out, path, w.to(dtype))
    return out


def tree_paths(tree) -> Dict[str, tuple]:
    """{path: shape} of a tree of tensors (or of shapes)."""
    return {p: tuple(getattr(v, "shape", v)) for p, v in leaf_paths(tree)}


def tree_leaves(tree) -> list:
    return [v for _, v in leaf_paths(tree)]


def leaf(tree: dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def tree_map2(fn: Callable, *trees) -> dict:
    """``fn`` over the leaves of same-structure trees."""
    out: dict = {}
    for path, _ in leaf_paths(trees[0]):
        _set(out, path, fn(*(leaf(t, path) for t in trees)))
    return out


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
class _RoundFP8(torch.autograd.Function):
    """Round to float8 e4m3 under one scale for the tensor; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def projector(quant: Optional[str]) -> Callable:
    """``mm(a, w) = a @ w``, with both inputs rounded to ``quant`` first."""
    if quant is None:
        return torch.matmul
    if quant != "fp8":
        raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
    return lambda a, w: torch.matmul(_RoundFP8.apply(a), _RoundFP8.apply(w))


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, pos, theta: float):
    """Rotate-half RoPE. x: (B, S, H, D); pos: (S,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = pos.to(torch.float32)[:, None] * inv                  # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: dict, p: dict, h, window: int, mm):
    """Grouped-query self-attention over the whole stream, in q blocks."""
    B, S, _ = h.shape
    H, Hkv, Dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    pos = torch.arange(S, device=h.device)
    q = rope(mm(h, p["wq"]).reshape(B, S, H, Dh), pos, cfg["rope_theta"])
    k = rope(mm(h, p["wk"]).reshape(B, S, Hkv, Dh), pos, cfg["rope_theta"])
    v = mm(h, p["wv"]).reshape(B, S, Hkv, Dh)
    k = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)    # (B,H,S,Dh)
    v = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = []
    for s0 in range(0, S, Q_BLOCK):
        qp = pos[s0:s0 + Q_BLOCK, None]
        visible = pos[None, :] <= qp
        if window > 0:
            visible = visible & (pos[None, :] > qp - window)
        scores = q[:, :, s0:s0 + Q_BLOCK] @ k.transpose(-1, -2) * Dh ** -0.5
        scores = scores.masked_fill(~visible, float("-inf"))
        out.append(torch.softmax(scores, dim=-1) @ v)
    o = torch.cat(out, dim=2).transpose(1, 2).reshape(B, S, H * Dh)
    return mm(o, p["wo"])


def mlp(p: dict, h, mm):
    return mm(F.silu(mm(h, p["w_gate"])) * mm(h, p["w_up"]), p["w_down"])


def ssm(cfg: dict, p: dict, h, mm):
    """Mamba2 over the whole stream, the scan in its quadratic form."""
    s = cfg["ssm"]
    B_, S, D = h.shape
    N, P, K = s["d_state"], s["d_head"], s["d_conv"]
    d_inner = s["expand"] * D
    H = d_inner // P
    proj = mm(h, p["in_proj"])
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * N]
    dt = F.softplus(proj[..., 2 * d_inner + 2 * N:] + p["dt_bias"])  # (B,S,H)
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[:, i:i + S] * p["conv_w"][i] for i in range(K))
    xbc = F.silu(conv + p["conv_b"])
    x = xbc[..., :d_inner].reshape(B_, S, H, P)
    Bm, Cm = xbc[..., d_inner:d_inner + N], xbc[..., d_inner + N:]
    A = -torch.exp(p["A_log"])
    t_idx = torch.arange(S, device=h.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    y = torch.empty_like(x)
    for b in range(B_):
        c = torch.cumsum((dt[b] * A).to(torch.float64), dim=0)      # (S,H)
        G = Cm[b] @ Bm[b].T                                          # (S,S)
        for h0 in range(0, H, SSM_HEAD_BLOCK):
            hs = slice(h0, h0 + SSM_HEAD_BLOCK)
            ch = c[:, hs].T                                          # (h,S)
            seg = (ch[:, :, None] - ch[:, None, :]).to(torch.float32)
            M = torch.exp(seg.masked_fill_(~causal, float("-inf")))
            M *= G
            M *= dt[b, :, hs].T[:, None]
            y[b, :, hs] = torch.bmm(M, x[b, :, hs].transpose(0, 1)
                                    ).transpose(0, 1)
    y = y + p["D"][:, None] * x
    u = rms_norm(y.reshape(B_, S, d_inner) * F.silu(z), p["norm_w"],
                 cfg["norm_eps"])
    return mm(u, p["out_proj"])


def _layer(params: dict, i: int) -> dict:
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["stack"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def hidden_states(cfg: dict, params: dict, tokens, *, quant=None):
    """The final-normed stream (B, S, D): meta tokens, then the token
    embeddings scaled by sqrt(d_model)."""
    mm = projector(quant)
    B = tokens.shape[0]
    x = params["embed"][tokens] * math.sqrt(cfg["d_model"])
    if cfg.get("n_meta_tokens"):
        meta = params["meta_tokens"][None].expand(B, -1, -1)
        x = torch.cat([meta, x], dim=1)
    eps = cfg["norm_eps"]
    for i in range(cfg["n_layers"]):
        p = _layer(params, i)
        h = rms_norm(x, p["norm_attn"], eps)
        a = attention(cfg, p["attn"], h, layer_window(cfg, i), mm)
        if cfg.get("block_kind") == "hybrid":
            x = x + 0.5 * (a + ssm(cfg, p["ssm"], h, mm))
        else:
            x = x + a
        x = x + mlp(p["mlp"], rms_norm(x, p["norm_mlp"], eps), mm)
    return rms_norm(x, params["final_norm"], eps)


def unembed_matrix(cfg: dict, params: dict):
    return params["embed"].T if cfg.get("tie_embeddings") \
        else params["unembed"]


def logits_at(cfg: dict, params: dict, tokens, positions, *, quant=None):
    """(B, len(positions), vocab) logits at stream ``positions``."""
    hid = hidden_states(cfg, params, tokens, quant=quant)[:, positions]
    w = unembed_matrix(cfg, params)
    return projector(quant)(hid, w)[..., :cfg["vocab"]]


def loss(cfg: dict, params: dict, tokens, *, quant=None):
    """Mean next-token cross-entropy over positions 0..T-2 (no meta
    tokens), the logsumexp over every column of the padded vocabulary."""
    hid = hidden_states(cfg, params, tokens, quant=quant)
    logits = projector(quant)(hid[:, :-1], unembed_matrix(cfg, params))
    gold = logits.gather(-1, tokens[:, 1:, None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


# ---------------------------------------------------------------------------
# the inner optimizer
# ---------------------------------------------------------------------------
def adamw_steps(cfg: dict, params: dict, batches, *, lr: float, b1: float,
                b2: float, eps: float, max_grad_norm: float, quant=None):
    """AdamW (no weight decay) from ``params`` over ``batches``, the
    gradient clipped to ``max_grad_norm`` by its global norm first.
    Returns ``(losses, first clipped gradient, params after the last)``,
    the gradient and params as {path: tensor}."""
    names = [p for p, _ in leaf_paths(params)]
    cur = {n: leaf(params, n).detach().clone() for n in names}
    m = {n: torch.zeros_like(v) for n, v in cur.items()}
    v2 = {n: torch.zeros_like(v) for n, v in cur.items()}
    losses, first_grad = [], None
    for count, tokens in enumerate(batches, start=1):
        leaves = {n: t.clone().requires_grad_(True) for n, t in cur.items()}
        tree: dict = {}
        for n, t in leaves.items():
            _set(tree, n, t)
        value = loss(cfg, tree, tokens, quant=quant)
        grads = torch.autograd.grad(value, [leaves[n] for n in names])
        losses.append(float(value.detach()))
        with torch.no_grad():
            gn = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(max_grad_norm / (gn + 1e-9), max=1.0)
            grads = {n: g * scale for n, g in zip(names, grads)}
            if first_grad is None:
                first_grad = grads
            c1, c2 = 1 - b1 ** count, 1 - b2 ** count
            for n in names:
                m[n] = b1 * m[n] + (1 - b1) * grads[n]
                v2[n] = b2 * v2[n] + (1 - b2) * grads[n].square()
                cur[n] = cur[n] - lr * ((m[n] / c1)
                                        / (torch.sqrt(v2[n] / c2) + eps))
    return losses, first_grad, cur
