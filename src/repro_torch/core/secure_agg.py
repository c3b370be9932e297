"""Secure aggregation via pairwise additive masking: the fp32 and the
integer planes.

Port of ``repro.core.secure_agg``: every pair of clients (i, j) derives a
shared mask stream from a pairwise secret; the lexicographically smaller
endpoint adds it, the other subtracts it, so the cohort sum telescopes to
the true sum while each posted buffer is masked. Masks are a keyed
counter hash (two rounds of the lowbias32 mixer over ``index ^ key``) put
into the f32 mantissa, uniform with standard deviation ``scale``.

The mask stream is bit-exact with the reference's for the same secret and
cohort:

* Pair keys keep 32 bits: the reference builds them with
  ``jax.random.PRNGKey(seed)`` under 32-bit JAX, which yields the words
  ``[0, seed & 0xFFFFFFFF]``. ``pair_keys`` builds the same words.
* The PRG is uint32 arithmetic (wrapping multiply and add, logical
  shift). PyTorch's uint32 lacks add and ``>>`` on the CPU, so the stream
  runs in int64 holding values in [0, 2**32): shifts of non-negative
  values are logical, and each 32x32-bit product is split into 16-bit
  halves so that no intermediate exceeds 2**48 before it is masked back
  to 32 bits.
* Each pair's multiply-add is the single-rounding FMA that XLA compiles
  the reference's expression into (``_apply_masks``), so the masked
  buffers, not only the bit streams, are bitwise equal.

``prg="threefry"`` is the reference's ``jax.random.bits(key, (T,),
uint32)`` stream under jax's partitionable threefry (the default since
jax 0.5): output i is ``b1 ^ b2`` of ``threefry2x32(key, (hi, lo))`` of
the flat index i, written in the same int64-held uint32 arithmetic and
bitwise equal to it (``threefry_bits``).

The mask pass is plain PyTorch on either device; the reference computes
it outside any Pallas kernel too.

Dropout repair: survivors re-derive their summed masks toward the dropped
peers (``repair_correction``) and the server subtracts them in the combine
(K2, ``aggregate_masked_packed(corrections=...)``).

The integer plane (``int_mask_offset``, ``int_repair_correction``) draws
residues mod 2**mbits from the same keyed stream under a domain-separated
secret. Its uint32 arithmetic runs in int64 masked back to 32 bits after
each add; results are returned as ``torch.uint32`` tensors, made by an
exact int64 -> int32 step and a dtype view, so no uint32 arithmetic or
cast kernel is needed on either device.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core import telemetry
from repro_torch.core.packing import (as_f32, as_matrix, pack_many,
                                      pack_pytree, unpack_pytree)
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels.secure_agg.ops import (masked_sum,
                                                masked_sum_corrected)

DEFAULT_SCALE = 1e-2
_M32 = 0xFFFFFFFF
_UNIT_STD = 3.4641016  # sqrt(12): scales uniform [-0.5, 0.5) to unit std


def _pair_seed(secret: bytes, i: str, j: str) -> int:
    lo, hi = sorted([i, j])
    h = hashlib.sha256(secret + f"{lo}|{hi}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def pair_keys(client_id: str, cohort: Sequence[str], pair_secret: bytes):
    """Keys + signs for every pair (client_id, other) in the cohort.

    Returns ``(keys, signs)`` on the CPU: keys is a (P, 2) int64 tensor of
    32-bit words ``[0, seed & 0xFFFFFFFF]`` (what the reference's
    ``PRNGKey`` keeps), signs a (P,) float32 tensor, +1 where
    ``client_id`` is the smaller endpoint and -1 otherwise.
    """
    others = [c for c in cohort if c != client_id]
    keys = torch.tensor(
        [[0, _pair_seed(pair_secret, client_id, o) & _M32] for o in others],
        dtype=torch.int64).reshape(-1, 2)
    signs = torch.tensor([1.0 if client_id < o else -1.0 for o in others],
                         dtype=torch.float32)
    return keys, signs


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer mixer (Wellons) on int64-held uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


# threefry2x32, 20 rounds (Salmon et al., "Parallel random numbers: as
# easy as 1, 2, 3", SC 2011), as jax.random computes it
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 of the counter words ``(x0, x1)`` (int64 tensors
    holding uint32 values) under the key words ``(k0, k1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0, x1


def threefry_bits(idx: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """``jax.random.bits(key, (T,), uint32)[idx]`` for the key words
    ``(k0, k1)``, int64-held: the counter of flat index i is ``(i >> 32,
    i & 0xFFFFFFFF)`` and the output the xor of threefry2x32's two words."""
    b0, b1 = _threefry2x32(k0, k1, idx >> 32, idx & _M32)
    return b0 ^ b1


def _centered_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (held in int64) -> f32 in [-0.5, 0.5): the top 23 bits into
    the mantissa of [1, 2), minus 1.5 (exact)."""
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32)
    return one_to_two - 1.5


def _uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (held in int64) -> f32 uniform, zero mean, unit std."""
    return _centered_from_bits(bits) * torch.tensor(_UNIT_STD,
                                                    dtype=torch.float32)


def _pair_bits(idx: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    return _mix32((_mix32(idx ^ k0) + k1) & _M32)


def _apply_masks(buf: torch.Tensor, keys: torch.Tensor, signs: torch.Tensor,
                 scale: float, *, prg: str = "fast") -> torch.Tensor:
    """buf: (T,) f32; keys: (P, 2); signs: (P,) -> masked (T,) f32.

    One pair at a time: O(T) memory whatever the cohort size. Per pair the
    reference writes ``acc + (sign*scale) * ((b - 1.5) * sqrt(12))``; XLA
    compiles it as one fused multiply-add with the scalar factors folded,
    ``fma((sign*scale)*sqrt(12), b - 1.5, acc)``, in the fast path's
    unrolled loop and in the threefry path's ``lax.scan`` body alike. The
    port evaluates that FMA (the product of two f32 is exact in f64; one
    rounding back to f32) so its masks are bitwise equal to the
    reference's, on either stream.
    """
    if prg not in ("fast", "threefry"):
        raise ValueError(f"unknown prg {prg!r}")
    stream = threefry_bits if prg == "threefry" else _pair_bits
    acc = buf.to(torch.float32)
    idx = torch.arange(buf.shape[0], dtype=torch.int64, device=buf.device)
    scale32 = torch.tensor(scale, dtype=torch.float32)
    std32 = torch.tensor(_UNIT_STD, dtype=torch.float32)
    for (k0, k1), sign in zip(keys.tolist(), signs):
        coef = (sign.to(torch.float32) * scale32) * std32    # f32 scalar
        d = _centered_from_bits(stream(idx, k0, k1))
        acc = (acc.to(torch.float64) + coef.to(torch.float64)
               * d.to(torch.float64)).to(torch.float32)
    return acc


def mask_packed(buf, client_id: str, cohort: Sequence[str],
                pair_secret: bytes, scale: float = DEFAULT_SCALE,
                prg: str = "fast", *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Add all pairwise-cancelling masks to a packed (T,) fp32 buffer
    (a tensor or an array); the result lies on ``device``."""
    dev = resolve(device)
    with telemetry.current().span("secure.mask", cat="secure", device=dev):
        keys, signs = pair_keys(client_id, cohort, pair_secret)
        return _apply_masks(as_f32(buf, dev).reshape(-1), keys, signs,
                            scale, prg=prg)


def aggregate_masked_packed(buffers, weights: Optional[Sequence[float]]
                            = None, *, corrections=None,
                            device=DEFAULT_DEVICE) -> torch.Tensor:
    """Combine (N, T) packed masked buffers into one (T,) tensor.

    ``weights`` defaults to the uniform mean and is NOT normalized, so
    pre-scaled sums stay sums. With ``corrections`` (an (N, T) matrix of
    ``repair_correction`` buffers) the rows are repaired inside the
    combine: K2 instead of K1.
    """
    dev = resolve(device)
    x = as_matrix(buffers, dev)
    n = x.shape[0]
    w = (torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
         if weights is None
         else torch.as_tensor(weights, dtype=torch.float32).to(dev))
    if corrections is not None:
        return masked_sum_corrected(x, as_matrix(corrections, dev), w)
    return masked_sum(x, w)


def repair_correction(size: int, client_id: str, dropped: Sequence[str],
                      pair_secret: bytes, scale: float = DEFAULT_SCALE,
                      prg: str = "fast", *,
                      device=DEFAULT_DEVICE) -> torch.Tensor:
    """This survivor's summed pairwise masks against the dropped peers:
    masking a zero buffer against ``{client_id} U dropped``."""
    dev = resolve(device)
    return mask_packed(torch.zeros(size, dtype=torch.float32, device=dev),
                       client_id, [client_id, *dropped], pair_secret, scale,
                       prg, device=dev)


# ---------------------------------------------------------------------------
# pytree-level entry points (pack -> packed op -> unpack)
# ---------------------------------------------------------------------------
def _tensors_on(tree, dev: torch.device):
    """Every leaf (a tensor or an array) as a tensor on ``dev``."""
    return _tree.tree_map(lambda x: torch.as_tensor(x, device=dev), tree)


def mask_update(update, client_id: str, cohort: Sequence[str],
                pair_secret: bytes, scale: float = DEFAULT_SCALE, *,
                device=DEFAULT_DEVICE):
    """Mask a parameter tree: one pack, one vectorized masking pass, one
    unpack into the leaves' dtypes on ``device``."""
    dev = resolve(device)
    buf, layout = pack_pytree(_tensors_on(update, dev))
    return unpack_pytree(mask_packed(buf, client_id, cohort, pair_secret,
                                     scale, device=dev), layout)


def aggregate_masked(masked_updates: Sequence, *, device=DEFAULT_DEVICE):
    """Uniform mean of masked trees — masks cancel exactly.

    Packs the cohort into one (N, T) matrix, reduces it through K1 on a
    CUDA device (its plain version on the CPU) and unpacks once. The
    reference's ``interpret=`` selects its Pallas interpreter, which the
    port does not have."""
    dev = resolve(device)
    stacked, layout = pack_many([_tensors_on(t, dev)
                                 for t in masked_updates])
    return unpack_pytree(aggregate_masked_packed(stacked, device=dev),
                         layout)


# ---------------------------------------------------------------------------
# integer-domain masking (the composable-privacy plane): residues mod
# M = 2**mbits added to the widened quantized stream cancel bit-exactly
# under the server's uint32 wrap-around sum, because M divides 2**32.
# ---------------------------------------------------------------------------
INT_MASK_DOMAIN = b"/intmask"


def mask_modulus_bits(cohort_size: int, quant_bits: int = 8) -> int:
    """Shared mask-modulus width (16 or 32): centered decoding of the
    cohort's modular sum needs ``M > 4*N*qmax`` (qmax plus an equal DP
    headroom, per client)."""
    qmax = (1 << (int(quant_bits) - 1)) - 1
    span = 4 * max(1, int(cohort_size)) * qmax
    return 16 if span < (1 << 16) else 32


def u32_from_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> a ``torch.uint32`` tensor: an exact
    step to the int32 bit pattern, then a dtype view."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.uint32)


def u32_bits(z, device=None) -> torch.Tensor:
    """A residue stream — a wire array (uint16 or uint32) or a uint32 or
    int32 tensor — as an int32 tensor of its 32-bit pattern on ``device``
    (default: where it lies)."""
    if isinstance(z, np.ndarray):
        # "W": a read-only array (a decoded board message) is copied,
        # torch wants writable memory
        if z.dtype == np.uint16:      # ship 2 bytes a value, widen there
            t = torch.from_numpy(np.require(z, requirements="CW")
                                 .view(np.int16))
            return t.to(device or t.device).to(torch.int32) & 0xFFFF
        z = torch.from_numpy(np.require(z, np.uint32, "CW").view(np.int32))
    if z.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"not a residue stream dtype: {z.dtype}")
    return z.to(device or z.device).view(torch.int32)


def u32_to_i64(bits: torch.Tensor) -> torch.Tensor:
    """32-bit storage (int32 or uint32) -> int64 in [0, 2**32)."""
    return bits.view(torch.int32).to(torch.int64) & _M32


def _int_masks(keys: torch.Tensor, signs: torch.Tensor, *, size: int,
               modulus_bits: int, device: torch.device) -> torch.Tensor:
    """Summed signed pairwise residues mod 2**modulus_bits, int64 holding
    uint32 values. Per pair: the keyed lowbias32 stream masked to
    ``modulus_bits`` bits, added as is (sign +1) or as ``(0 - r) & (M-1)``,
    ``-r mod M`` (sign -1); the sum wraps mod 2**32 after each add."""
    maskval = (1 << int(modulus_bits)) - 1
    idx = torch.arange(size, dtype=torch.int64, device=device)
    acc = torch.zeros(size, dtype=torch.int64, device=device)
    for (k0, k1), sign in zip(keys.tolist(), signs.tolist()):
        bits = _pair_bits(idx, k0, k1) & maskval
        if sign < 0:
            bits = (-bits) & maskval
        acc = (acc + bits) & _M32
    return acc


def int_mask_offset(size: int, client_id: str, cohort: Sequence[str],
                    pair_secret: bytes, modulus_bits: int, *,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """This client's total mask offset for a (size,) integer stream, a
    ``torch.uint32`` tensor on ``device``. Over the full cohort the
    offsets sum to 0 mod 2**modulus_bits."""
    dev = resolve(device)
    keys, signs = pair_keys(client_id, cohort,
                            pair_secret + INT_MASK_DOMAIN)
    acc = _int_masks(keys, signs, size=int(size),
                     modulus_bits=int(modulus_bits), device=dev)
    return u32_from_i64(acc)


def int_repair_correction(size: int, client_id: str,
                          dropped: Sequence[str], pair_secret: bytes,
                          modulus_bits: int, *,
                          device=DEFAULT_DEVICE) -> torch.Tensor:
    """Integer twin of ``repair_correction``: this survivor's summed
    residues against the dropped peers, mod 2**modulus_bits. The server
    subtracts it (mod M) before decoding."""
    return int_mask_offset(size, client_id, [client_id, *dropped],
                           pair_secret, modulus_bits, device=device)
