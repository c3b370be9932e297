"""The plain reference of Nemotron-H's hybrid stack (nemotron-3-nano-30b-a3b),
in float32.

A decoder-only model over a dict of parameters, written from the layer
equations of the ``nemotron_h`` modeling code in plain ``torch``
operations: no kernel, no cache, no batching trick. It imports nothing of
the program under test.

Layer ``i`` of ``hybrid_override_pattern`` is one pre-norm mixer,
``x += mixer(h)`` with ``h`` the RMSNorm of ``x`` (scaled by ``1 + w``):
  M  Mamba2: one input projection to the gate z (d_inner), the conv'd
     x|B|C (d_inner + 2 G N) and dt (heads); a depthwise causal conv with
     bias and SiLU; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
     head h reads group ``h // (heads / G)`` of B and C; the scan
     ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T``, ``y_t = s_t C_t + D x_t``
     in its quadratic form (the running sums of ``dt A`` in float64); the
     gated RMSNorm of ``y * silu(z)`` over each group's d_inner / G
     channels; the output projection.
  E  MoE: sigmoid scores of a float32 router; the top k of scores plus a
     bias pick the experts, the picked scores (not the bias) normalised to
     sum 1 and scaled; each expert ``down(relu(up(h))^2)``; every pick
     computed (dropless); plus one shared expert of the same form.
  *  grouped-query attention, causal over the whole stream, no rotary.
The stream starts at the token embeddings (not scaled) and ends in a final
RMSNorm and an untied output matrix.

Weights: each leaf of each layer is drawn from its own seed, derived from
the run's seed, the leaf's path and the layer (``leaf_seed``), in float32
on the device; the program is given the same numbers rounded to its
dtype (``make_params``), the reference draws them again a layer at a
time, as served (rounded to the program's dtype) and widened to float32
(``layer_params``): the model is those bf16 numbers, as the published
checkpoint is, and the reference computes with them in float32.
``forward_last`` runs the stack layer by layer over every checked request
at once, so that a layer's float32 weights (an E layer is 5.2 GB) are
drawn once and freed.

``quant="fp8"`` gives the control: every projection's two inputs rounded
to float8 e4m3 with one scale a tensor, the precision below the
configuration's bf16.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

KINDS = {"M": "mamba", "E": "moe", "*": "attention"}
# a routed expert's up or down matrix is (B + EXPERT_SPREAD * X_e) /
# sqrt(1 + EXPERT_SPREAD^2) at the leaf's std, B drawn once for the layer's
# experts and X_e for each: experts that differ by a tenth, so a pick that
# rounding flips between two near-tied experts moves the output by a
# tenth of what two independent experts would (PERF.md §2)
EXPERT_SPREAD = 0.1
EXPERT_LEAVES = ("w_up", "w_down")
FP8_MAX = 448.0          # the largest float8 e4m3fn value
Q_BLOCK = 256            # query rows of one attention block


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


def leaf_paths(tree, prefix=""):
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from leaf_paths(tree[key], path)
        else:
            yield path, tree[key]


def kinds(cfg: dict) -> list:
    return list(cfg["layer_pattern"])


def slots(cfg: dict) -> list:
    """Layer i as (kind name, index among its kind's layers)."""
    seen: Dict[str, int] = {}
    out = []
    for k in kinds(cfg):
        name = KINDS[k]
        out.append((name, seen.get(name, 0)))
        seen[name] = seen.get(name, 0) + 1
    return out


def _ssm_sizes(cfg: dict):
    """(heads, head dim, groups, state, d_inner, d_xbc, conv)."""
    s = cfg["ssm"]
    H, P, G, N = cfg["ssm_heads"], s["d_head"], cfg["ssm_groups"], \
        s["d_state"]
    return H, P, G, N, H * P, H * P + 2 * G * N, s["d_conv"]


def layer_shapes(cfg: dict, kind: str) -> Dict[str, tuple]:
    """One layer's leaves and shapes."""
    D = cfg["d_model"]
    if kind == "M":
        H, P, G, N, d_inner, d_xbc, K = _ssm_sizes(cfg)
        return {"norm": (D,), "in_proj": (D, d_inner + d_xbc + H),
                "conv_w": (K, d_xbc), "conv_b": (d_xbc,), "dt_bias": (H,),
                "A_log": (H,), "D": (H,), "norm_w": (d_inner,),
                "out_proj": (d_inner, D)}
    if kind == "E":
        m = cfg["moe"]
        E, Fe, Fs = m["num_experts"], m["d_expert"], m["d_shared"]
        return {"norm": (D,), "router": (D, E), "router_bias": (E,),
                "w_up": (E, D, Fe), "w_down": (E, Fe, D),
                "shared_up": (D, Fs), "shared_down": (Fs, D)}
    H, Hkv, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    return {"norm": (D,), "wq": (D, H * Dh), "wk": (D, Hkv * Dh),
            "wv": (D, Hkv * Dh), "wo": (H * Dh, D)}


def padded_vocab(cfg: dict) -> int:
    return (cfg["vocab"] + 255) // 256 * 256


def param_shapes(cfg: dict) -> dict:
    """The parameter tree's shapes: each kind's layers stacked on a
    leading axis of their count."""
    D, V = cfg["d_model"], padded_vocab(cfg)
    stack = {}
    for k in dict.fromkeys(kinds(cfg)):
        n = kinds(cfg).count(k)
        stack[KINDS[k]] = {name: (n,) + shape for name, shape in
                           layer_shapes(cfg, k).items()}
    return {"embed": (V, D), "final_norm": (D,), "unembed": (D, V),
            "stack": stack}


def init_rule(name: str, shape) -> tuple:
    """How leaf ``name`` of ``shape`` (one layer's) is drawn:
    ``("normal", std)`` (clipped to two std), ``("zeros",)``,
    ``("ones",)`` or a ramp over the heads, ``("dt_bias",)`` /
    ``("A_log",)``."""
    if name == "embed":
        return ("normal", 0.02)
    if name == "router_bias":
        return ("normal", 0.05)
    if name == "conv_b":
        return ("normal", 0.1)
    if "norm" in name:
        return ("zeros",)
    if name == "D":
        return ("ones",)
    if name in ("dt_bias", "A_log"):
        return (name,)
    return ("normal", 1.0 / math.sqrt(shape[-2]))       # fan-in of (in, out)


def leaf_seed(seed: int, path: str, layer: int) -> int:
    """A 63-bit seed for one layer of one leaf (``layer`` -1: a leaf
    outside the stack)."""
    h = hashlib.blake2b(f"{int(seed)}:{path}:{layer}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big") >> 1


def draw(rule: tuple, shape, seed: int, device) -> torch.Tensor:
    """One float32 tensor of ``shape`` by ``rule``."""
    if rule[0] == "normal":
        gen = torch.Generator(device=device).manual_seed(seed)
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.clamp_(-2.0, 2.0).mul_(rule[1])
    if rule[0] == "zeros":
        return torch.zeros(shape, device=device)
    if rule[0] == "ones":
        return torch.ones(shape, device=device)
    n = shape[-1]
    if rule[0] == "dt_bias":                  # softplus^-1 of [1e-3, 1e-1]
        return torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, n,
                                                    device=device)))
    return torch.log(torch.linspace(1.0, 16.0, n, device=device))


def _as_served(w: torch.Tensor, served) -> torch.Tensor:
    """``w`` rounded to the dtype ``served`` and widened back (as it is
    where ``served`` is None)."""
    return w if served is None else w.to(served).float()


def _leaf(seed: int, path: str, j: int, shape, device) -> torch.Tensor:
    """One layer's leaf, float32; a routed expert stack shares a part
    across its experts (``EXPERT_SPREAD``)."""
    name = path.rsplit("/", 1)[-1]
    rule = init_rule(name, shape)
    w = draw(rule, shape, leaf_seed(seed, path, j), device)
    if name in EXPERT_LEAVES:
        shared = draw(rule, shape[1:], leaf_seed(seed, path + "/shared", j),
                      device)
        w.mul_(EXPERT_SPREAD).add_(shared).div_(
            math.sqrt(1.0 + EXPERT_SPREAD ** 2))
    return w


def layer_params(cfg: dict, seed: int, name: str, j: int, device,
                 served=None) -> dict:
    """Layer ``j`` of kind ``name``'s leaves, float32, drawn from ``seed``
    (as ``served``, rounded to that dtype, where it is given)."""
    kind = next(k for k, v in KINDS.items() if v == name)
    return {leaf_name: _as_served(_leaf(seed, f"stack/{name}/{leaf_name}",
                                        j, shape, device), served)
            for leaf_name, shape in layer_shapes(cfg, kind).items()}


def top_params(cfg: dict, seed: int, device, served=None) -> dict:
    """The leaves outside the stack, float32 (as ``served``)."""
    shapes = param_shapes(cfg)
    return {name: _as_served(draw(init_rule(name, shapes[name]),
                                  shapes[name], leaf_seed(seed, name, -1),
                                  device), served)
            for name in ("embed", "final_norm", "unembed")}


def make_params(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The whole tree in ``dtype``: each layer's leaves drawn in float32
    and rounded into their stack, so no float32 copy of more than one
    layer's leaf is held."""
    out = {k: v.to(dtype) for k, v in top_params(cfg, seed, device).items()}
    out["stack"] = {}
    for name, shapes in param_shapes(cfg)["stack"].items():
        out["stack"][name] = {k: torch.empty(shape, dtype=dtype, device=device)
                              for k, shape in shapes.items()}
    for name, j in slots(cfg):
        for k, w in layer_params(cfg, seed, name, j, device).items():
            out["stack"][name][k][j].copy_(w)
    return out


def tree_layer(params: dict, name: str, j: int) -> dict:
    """Layer ``j`` of kind ``name`` of a whole tree, widened to float32."""
    return {k: v[j].float() for k, v in params["stack"][name].items()}


# ---------------------------------------------------------------------------
# the mixers; ``h`` is (B, S, D), the normed stream
# ---------------------------------------------------------------------------
def mamba(cfg: dict, p: dict, h, mm):
    H, P, G, N, d_inner, d_xbc, K = _ssm_sizes(cfg)
    B_, S, _ = h.shape
    proj = mm(h, p["in_proj"])
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_xbc]
    dt = F.softplus(proj[..., d_inner + d_xbc:] + p["dt_bias"])  # (B,S,H)
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[:, i:i + S] * p["conv_w"][i] for i in range(K))
    xbc = F.silu(conv + p["conv_b"])
    x = xbc[..., :d_inner].reshape(B_, S, H, P)
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(B_, S, G, N)
    Cm = xbc[..., d_inner + G * N:].reshape(B_, S, G, N)
    A = -torch.exp(p["A_log"])
    t_idx = torch.arange(S, device=h.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    n = H // G
    y = torch.empty_like(x)
    for b in range(B_):
        c = torch.cumsum((dt[b] * A).to(torch.float64), dim=0)      # (S,H)
        for g in range(G):
            hs = slice(g * n, (g + 1) * n)
            ch = c[:, hs].T                                          # (n,S)
            seg = (ch[:, :, None] - ch[:, None, :]).to(torch.float32)
            M = torch.exp(seg.masked_fill_(~causal, float("-inf")))
            M *= Cm[b, :, g] @ Bm[b, :, g].T                         # (S,S)
            M *= dt[b, :, hs].T[:, None]
            y[b, :, hs] = torch.bmm(M, x[b, :, hs].transpose(0, 1)
                                    ).transpose(0, 1)
    y = y + p["D"][:, None] * x
    u = (y.reshape(B_, S, d_inner) * F.silu(z)).reshape(B_, S, G, -1)
    u = u * torch.rsqrt(u.square().mean(-1, keepdim=True) + cfg["norm_eps"])
    return mm(u.reshape(B_, S, d_inner) * (1.0 + p["norm_w"]), p["out_proj"])


def _relu2(a):
    return torch.square(F.relu(a))


def moe(cfg: dict, p: dict, h, mm):
    m = cfg["moe"]
    B_, S, D = h.shape
    t = h.reshape(B_ * S, D)
    scores = torch.sigmoid(mm(t, p["router"]))
    _, idx = torch.topk(scores + p["router_bias"], m["top_k"], dim=-1)
    w = scores.gather(1, idx)
    w = w / w.sum(-1, keepdim=True) * m["routed_scale"]
    out = torch.zeros_like(t)
    for e in range(m["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = mm(_relu2(mm(t[tok], p["w_up"][e])), p["w_down"][e])
            out.index_add_(0, tok, y * w[tok, slot][:, None])
    out = out + mm(_relu2(mm(t, p["shared_up"])), p["shared_down"])
    return out.reshape(B_, S, D)


def attention(cfg: dict, p: dict, h, mm):
    """Causal grouped-query attention, no rotary, in q blocks."""
    B_, S, _ = h.shape
    H, Hkv, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = mm(h, p["wq"]).reshape(B_, S, H, Dh).transpose(1, 2)
    k = mm(h, p["wk"]).reshape(B_, S, Hkv, Dh)
    v = mm(h, p["wv"]).reshape(B_, S, Hkv, Dh)
    k = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)    # (B,H,S,Dh)
    v = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    pos = torch.arange(S, device=h.device)
    out = []
    for s0 in range(0, S, Q_BLOCK):
        visible = pos[None, :] <= pos[s0:s0 + Q_BLOCK, None]
        scores = q[:, :, s0:s0 + Q_BLOCK] @ k.transpose(-1, -2) * Dh ** -0.5
        scores = scores.masked_fill(~visible, float("-inf"))
        out.append(torch.softmax(scores, dim=-1) @ v)
    o = torch.cat(out, dim=2).transpose(1, 2).reshape(B_, S, H * Dh)
    return mm(o, p["wo"])


MIXERS = {"mamba": mamba, "moe": moe, "attention": attention}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def forward_last(cfg: dict, layer: Callable, top: dict, tokens, positions,
                 *, quant: Optional[str] = None):
    """Logits (B, len(positions), vocab) at stream ``positions`` of
    ``tokens`` (B, S): ``layer(name, j)`` gives layer j of kind ``name``
    (float32), ``top`` the embedding, final norm and output matrix. The
    stream runs one layer at a time over all B rows."""
    mm = projector(quant)
    eps = cfg["norm_eps"]
    x = top["embed"][tokens]
    for name, j in slots(cfg):
        p = layer(name, j)
        x = x + MIXERS[name](cfg, p, rms_norm(x, p["norm"], eps), mm)
        del p
    hid = rms_norm(x[:, positions], top["final_norm"], eps)
    return mm(hid, top["unembed"])[..., :cfg["vocab"]]


def logits_from_seed(cfg: dict, seed: int, tokens, positions, *,
                     quant: Optional[str] = None):
    """``forward_last`` over the weights of ``seed`` as the configuration
    serves them (its ``dtype``), drawn again a layer at a time on
    ``tokens``' device and widened to float32."""
    dev, served = tokens.device, getattr(torch, cfg["dtype"])
    return forward_last(
        cfg, lambda name, j: layer_params(cfg, seed, name, j, dev, served),
        top_params(cfg, seed, dev, served), tokens, positions, quant=quant)


def logits_from_params(cfg: dict, params: dict, tokens, positions, *,
                       quant: Optional[str] = None):
    """``forward_last`` over a whole parameter tree, widened to float32."""
    top = {k: params[k].float() for k in ("embed", "final_norm", "unembed")}
    return forward_last(cfg, lambda name, j: tree_layer(params, name, j),
                        top, tokens, positions, quant=quant)


def tree_paths(tree) -> Dict[str, tuple]:
    return {p: tuple(getattr(v, "shape", v)) for p, v in leaf_paths(tree)}
