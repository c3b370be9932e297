"""Message-layer crypto for the Communicator (paper §V "Communicator",
requirement: encrypted, compressed messages; §VII user/server authentication).

stdlib-only (offline container): SHA256-CTR keystream cipher with
encrypt-then-MAC (HMAC-SHA256), plus HKDF-style key derivation. This gives
the architectural properties the paper requires — confidentiality +
authenticity seams living *only* in the Communicator — without an external
crypto dependency. A production deployment would swap in TLS/AES-GCM behind
the same interface.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import secrets
import zlib

import numpy as np


def derive_key(master: bytes, purpose: str) -> bytes:
    return hmac.new(master, purpose.encode(), hashlib.sha256).digest()


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    # SHAKE-256 XOF: arbitrary-length keystream in one C call (streams at
    # memory bandwidth — model updates are hundreds of MB)
    return hashlib.shake_256(key + nonce).digest(n)


def _xor(data: bytes, stream: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8)
    b = np.frombuffer(stream, np.uint8)
    return (a ^ b).tobytes()


# auto-compression probe: payloads above this size get head, middle and
# tail slices sampled and test-compressed; any slice with a ratio worse
# than _PROBE_RATIO means "substantially incompressible" (fp32 weight
# bytes) and compression is skipped entirely
_PROBE_BYTES = 64 * 1024
_PROBE_SLICE = _PROBE_BYTES // 3
_PROBE_RATIO = 0.9


def _compression_pays(plaintext: bytes) -> bool:
    """Predict whether zlib over the whole payload is worth it.

    A head-only probe mispredicts the common adversarial layout: a
    compressible msgpack/control header followed by an incompressible
    fp32 body — the 64KB prefix compresses beautifully, then zlib churns
    through hundreds of megabytes of weight bytes for ~0% saving. So the
    probe samples head, middle AND tail slices, and only predicts a win
    when *every* region looks compressible: large payloads are dominated
    by their bulk, and a single incompressible region already caps the
    overall ratio near 1. (Skipping a marginally-compressible payload is
    cheap; compressing a near-incompressible one used to dominate every
    large post.)
    """
    n = len(plaintext)
    k = _PROBE_SLICE
    mid = (n - k) // 2
    slices = (plaintext[:k], plaintext[mid:mid + k], plaintext[n - k:])
    return all(len(zlib.compress(s, 1)) < _PROBE_RATIO * len(s)
               for s in slices)


def encrypt(key: bytes, plaintext: bytes, *, compress="auto") -> bytes:
    """zlib-compress, encrypt (SHAKE-256 stream), authenticate (HMAC-SHA256).

    ``compress="auto"`` (default) samples head, middle and tail slices of
    a large payload and compresses only when *every* region looks
    compressible (``_compression_pays``): masked fp32 weight buffers are
    near-incompressible, and running zlib over hundreds of MB to save ~1%
    used to dominate every post — even when a compressible control header
    led the buffer. Small payloads (control messages) always compress at
    level 6; large compressible ones at level 1. ``compress=True/False``
    force the old behaviour.
    """
    if compress == "auto":
        compress = (len(plaintext) <= _PROBE_BYTES
                    or _compression_pays(plaintext))
    flags = b"\x01" if compress else b"\x00"
    if compress:
        level = 1 if len(plaintext) > 8 * 2 ** 20 else 6
        plaintext = zlib.compress(plaintext, level=level)
    nonce = secrets.token_bytes(16)
    ct = _xor(plaintext, _keystream(derive_key(key, "enc"), nonce,
                                    len(plaintext)))
    body = flags + nonce + ct
    tag = hmac.new(derive_key(key, "mac"), body, hashlib.sha256).digest()
    return tag + body


def decrypt(key: bytes, blob: bytes) -> bytes:
    tag, body = blob[:32], blob[32:]
    want = hmac.new(derive_key(key, "mac"), body, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, want):
        raise ValueError("message authentication failed")
    flags, nonce, ct = body[:1], body[1:17], body[17:]
    pt = _xor(ct, _keystream(derive_key(key, "enc"), nonce, len(ct)))
    if flags == b"\x01":
        pt = zlib.decompress(pt)
    return pt


def new_device_token() -> str:
    """Per-process device token (paper §VII step 2: rotated every FL run)."""
    return secrets.token_hex(24)


def hash_password(password: str, salt: bytes = None) -> str:
    salt = salt or os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 100_000)
    return salt.hex() + ":" + dk.hex()


def verify_password(password: str, stored: str) -> bool:
    salt_hex, dk_hex = stored.split(":")
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(),
                             bytes.fromhex(salt_hex), 100_000)
    return hmac.compare_digest(dk.hex(), dk_hex)


def server_certificate(server_id: str, master: bytes) -> str:
    """Toy certificate: HMAC of the server identity under a CA master key.

    Clients holding the CA key verify genuineness (paper §VII Server
    Authentication). Stands in for X.509 in the offline container.
    """
    return hmac.new(derive_key(master, "ca"), server_id.encode(),
                    hashlib.sha256).hexdigest()


def verify_certificate(server_id: str, cert: str, master: bytes) -> bool:
    return hmac.compare_digest(server_certificate(server_id, master), cert)
