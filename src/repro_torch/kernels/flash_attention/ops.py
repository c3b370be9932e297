"""Public flash-attention op K6, in the models' (B,S,H,D) layout.

For a CPU tensor the wrapper runs the plain version (``ref.py``). For a
CUDA tensor it checks the inputs, allocates the output, launches a
hand-written kernel on the current stream and counts the launch in
``LAUNCHES``; it never falls back — it raises on what the kernels do not
take, and on inputs that need a gradient (there is no backward kernel
yet).

The kernel follows the inputs' type, a fixed rule: bfloat16 runs the
tensor-core kernel (wgmma, TMA; counted as ``flash_attention``), float32
the CUDA-core kernel (counted as ``flash_attention_f32``), because bf16
tensor cores cannot hold float32's 2e-5 tolerance. Both take head dims
D in {32, 64, 128, 256}. The bf16 kernel's TMA maps need 16-byte-aligned
bases and (b, s, h) strides.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref

HEAD_DIMS = (32, 64, 128, 256)

# kernel launches since the last reset (plain-version calls on CPU tensors
# do not count)
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_f32": 0}
# the counter of each input type's kernel
VARIANT = {torch.bfloat16: "flash_attention",
           torch.float32: "flash_attention_f32"}
TMA_ALIGN = 16               # bytes: TMA base and stride alignment


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_flash_attention(q, k, v, window):
    """The checks K6's wrapper runs before a launch."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dim() != 4:
            raise ValueError(f"{name} must be (B,S,H,D), got "
                             f"{tuple(a.shape)}")
        if a.dtype not in _k.DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{a.dtype}")
        if a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}, q is "
                             f"{q.dtype} on {q.device}")
        if a.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    B, _, H, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"{H} q heads do not group over {k.shape[2]} kv "
                         "heads")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype == torch.bfloat16:
        for name, a in (("q", q), ("k", k), ("v", v)):
            if a.data_ptr() % TMA_ALIGN:
                raise ValueError(f"{name}'s base is not {TMA_ALIGN}-byte "
                                 "aligned (the bf16 kernel loads by TMA)")
            for dim, n in zip("bsh", _k.bsh_strides(a)):
                if n * a.element_size() % TMA_ALIGN:
                    raise ValueError(
                        f"{name}'s {dim} stride {n} is not a "
                        f"{TMA_ALIGN}-byte multiple (the bf16 kernel loads "
                        "by TMA)")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet: train through the "
            "impl='xla' path")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    scale: float = None) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,S,Hkv,D) -> (B,S,H,D) in q's dtype.
    ``window`` > 0 keeps keys j > i - window; 0 is global attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale, causal=causal, window=int(window),
            softcap=logit_softcap).transpose(1, 2)
    check_flash_attention(q, k, v, window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _k.flash_attention_bshd(q, k, v, out, scale=scale, causal=causal,
                            window=int(window), softcap=logit_softcap)
    LAUNCHES[VARIANT[q.dtype]] += 1
    return out
