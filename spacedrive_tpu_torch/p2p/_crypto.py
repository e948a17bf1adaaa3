"""The tunnel's primitives: X25519, Ed25519, HKDF-SHA256 and
ChaCha20-Poly1305.

The JAX package's tunnel takes them from the ``cryptography`` package,
which the machine with the card does not have, so the port carries its
own, with the keys and bytes ``cryptography`` uses (32-byte raw X25519
scalars and u-coordinates, 32-byte raw Ed25519 seeds and public keys,
64-byte signatures, the 16-byte Poly1305 tag after the ciphertext):

- X25519, RFC 7748 §5 (the Montgomery ladder, scalars clamped, the
  u-coordinate's top bit masked); an all-zero shared secret is refused,
  as ``cryptography`` refuses it;
- Ed25519, RFC 8032 §5.1 (pure, no context), verifying ``[S]B = R +
  [k]A`` without the cofactor, with S < L required;
- HKDF-SHA256, RFC 5869, on ``hmac`` and ``hashlib``;
- ChaCha20-Poly1305, RFC 8439 §2.8 (12-byte nonce, 32-bit counter from 1).

The AEAD and the two curves' point arithmetic are C++ (``csrc/p2pcrypto.cpp``,
built by ``g++`` at first use through ``ops/_build.py``; SHA-512 and the
scalar arithmetic mod L stay in Python's ``hashlib`` and integers). Each
has a plain Python twin here (``*_plain``; the ChaCha20 blocks vectorised
with numpy) that the tests hold against the native one, the RFC vectors
and ``cryptography``. There is no fallback: the tunnel calls the native
forms, and where the build fails, the call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac
import struct

import numpy as np

from ..ops import _build


class InvalidSignature(Exception):
    pass


class InvalidTag(Exception):
    """The AEAD tag does not authenticate the ciphertext."""


# -- field and curve constants ----------------------------------------------

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493  # the group order
_D = -121665 * pow(121666, P - 2, P) % P
_SQRT_M1 = pow(2, (P - 1) // 4, P)


def _lib() -> ctypes.CDLL:
    return _build.library("p2pcrypto")


def _buf(b: bytes):
    return ctypes.cast(ctypes.c_char_p(b), ctypes.POINTER(ctypes.c_uint8))


def _out(n: int):
    return (ctypes.c_uint8 * n)()


# -- X25519 (RFC 7748) -------------------------------------------------------

def _clamp(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def x25519_plain(scalar: bytes, u: bytes) -> bytes:
    """RFC 7748 §5: X25519(k, u), the Montgomery ladder over integers."""
    if len(scalar) != 32 or len(u) != 32:
        raise ValueError("X25519 takes a 32-byte scalar and u-coordinate")
    k = _clamp(scalar)
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3, swap = 1, 0, x1, 1, 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a, b = (x2 + z2) % P, (x2 - z2) % P
        aa, bb = a * a % P, b * b % P
        e = (aa - bb) % P
        c, d = (x3 + z3) % P, (x3 - z3) % P
        da, cb = d * a % P, c * b % P
        x3 = (da + cb) ** 2 % P
        z3 = x1 * (da - cb) ** 2 % P
        x2 = aa * bb % P
        z2 = e * (aa + 121665 * e) % P
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, P - 2, P) % P).to_bytes(32, "little")


def x25519(scalar: bytes, u: bytes) -> bytes:
    """X25519(k, u), native."""
    if len(scalar) != 32 or len(u) != 32:
        raise ValueError("X25519 takes a 32-byte scalar and u-coordinate")
    out = _out(32)
    _lib().sd_x25519(out, _buf(scalar), _buf(u))
    return bytes(out)


_BASE_U = (9).to_bytes(32, "little")


def x25519_public(scalar: bytes, native: bool = True) -> bytes:
    return (x25519 if native else x25519_plain)(scalar, _BASE_U)


def x25519_shared(scalar: bytes, peer_public: bytes, native: bool = True) -> bytes:
    """The shared secret; all zeros (a small-order peer key) is refused."""
    out = (x25519 if native else x25519_plain)(scalar, peer_public)
    if out == bytes(32):
        raise ValueError("X25519 shared secret is all zeros (small-order point)")
    return out


# -- Ed25519 (RFC 8032) ------------------------------------------------------

def _sha512_int(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


def _point_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * _D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _point_mul(s: int, p):
    q = (0, 1, 1, 0)
    while s > 0:
        if s & 1:
            q = _point_add(q, p)
        p = _point_add(p, p)
        s >>= 1
    return q


def _encode(p) -> bytes:
    x, y, z, _t = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(_D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * _SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


def _decode(s: bytes):
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


_BY = 4 * pow(5, P - 2, P) % P
_B = (_recover_x(_BY, 0), _BY, 1, _recover_x(_BY, 0) * _BY % P)


def _expand(seed: bytes):
    if len(seed) != 32:
        raise ValueError("an Ed25519 private key is a 32-byte seed")
    h = hashlib.sha512(seed).digest()
    return _clamp(h[:32]), h[32:]


def _base_mul(s: int, native: bool) -> bytes:
    if not native:
        return _encode(_point_mul(s, _B))
    out = _out(32)
    _lib().sd_ed25519_base(out, _buf(s.to_bytes(32, "little")))
    return bytes(out)


def ed25519_public(seed: bytes, native: bool = True) -> bytes:
    a, _prefix = _expand(seed)
    return _base_mul(a, native)


def ed25519_sign(seed: bytes, message: bytes, native: bool = True) -> bytes:
    a, prefix = _expand(seed)
    pub = _base_mul(a, native)
    r = _sha512_int(prefix, message) % L
    big_r = _base_mul(r, native)
    k = _sha512_int(big_r, pub, message) % L
    return big_r + ((r + k * a) % L).to_bytes(32, "little")


def ed25519_verify(public: bytes, message: bytes, signature: bytes,
                   native: bool = True) -> bool:
    if len(public) != 32 or len(signature) != 64:
        return False
    big_r, s = signature[:32], int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = _sha512_int(big_r, public, message) % L
    if native:
        return _lib().sd_ed25519_check(
            _buf(signature[32:]), _buf(k.to_bytes(32, "little")),
            _buf(public), _buf(big_r)) == 1
    a = _decode(public)
    if a is None:
        return False
    neg_a = ((P - a[0]) % P, a[1], a[2], (P - a[3]) % P)
    return _encode(_point_add(_point_mul(s, _B), _point_mul(k, neg_a))) == big_r


# -- HKDF-SHA256 (RFC 5869) --------------------------------------------------

def hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int) -> bytes:
    if length > 255 * 32:
        raise ValueError("HKDF-SHA256 gives at most 8160 bytes")
    prk = hmac.new(salt or bytes(32), ikm, hashlib.sha256).digest()
    okm, block = b"", b""
    for i in range(1, -(-length // 32) + 1):
        block = hmac.new(prk, block + info + bytes([i]), hashlib.sha256).digest()
        okm += block
    return okm[:length]


# -- ChaCha20-Poly1305 (RFC 8439) -------------------------------------------

_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4")


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    return (v << np.uint32(n)) | (v >> np.uint32(32 - n))


def chacha20_blocks_plain(key: bytes, nonce: bytes, counter: int, n: int) -> bytes:
    """n keystream blocks from `counter`, every block a row of a numpy
    array (RFC 8439 §2.3)."""
    state = np.empty((n, 16), dtype=np.uint32)
    state[:, 0:4] = _SIGMA
    state[:, 4:12] = np.frombuffer(key, dtype="<u4")
    state[:, 12] = (counter + np.arange(n, dtype=np.uint64)).astype(np.uint32)
    state[:, 13:16] = np.frombuffer(nonce, dtype="<u4")
    x = [state[:, i].copy() for i in range(16)]

    def qr(a, b, c, d):
        x[a] += x[b]; x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]; x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]; x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]; x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12); qr(1, 5, 9, 13); qr(2, 6, 10, 14); qr(3, 7, 11, 15)
        qr(0, 5, 10, 15); qr(1, 6, 11, 12); qr(2, 7, 8, 13); qr(3, 4, 9, 14)
    out = np.stack(x, axis=1) + state
    return out.astype("<u4").tobytes()


def _chacha20_xor(key: bytes, nonce: bytes, counter: int, data: bytes) -> bytes:
    if not data:
        return b""
    stream = chacha20_blocks_plain(key, nonce, counter, -(-len(data) // 64))
    a = np.frombuffer(data, dtype=np.uint8)
    return (a ^ np.frombuffer(stream, dtype=np.uint8)[:len(data)]).tobytes()


def poly1305_plain(key: bytes, msg: bytes) -> bytes:
    """RFC 8439 §2.5: the one-time authenticator over Python integers."""
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:32], "little")
    p, acc = (1 << 130) - 5, 0
    for i in range(0, len(msg), 16):
        block = msg[i:i + 16] + b"\x01"
        acc = (acc + int.from_bytes(block, "little")) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _mac_data(aad: bytes, ct: bytes) -> bytes:
    pad = lambda b: b"\x00" * (-len(b) % 16)  # noqa: E731
    return aad + pad(aad) + ct + pad(ct) + struct.pack("<QQ", len(aad), len(ct))


def _check_key_nonce(key: bytes, nonce: bytes) -> None:
    if len(key) != 32:
        raise ValueError("ChaCha20-Poly1305 takes a 32-byte key")
    if len(nonce) != 12:
        raise ValueError("ChaCha20-Poly1305 takes a 12-byte nonce")


def seal_plain(key: bytes, nonce: bytes, plain: bytes, aad: bytes = b"") -> bytes:
    _check_key_nonce(key, nonce)
    otk = chacha20_blocks_plain(key, nonce, 0, 1)[:32]
    ct = _chacha20_xor(key, nonce, 1, plain)
    return ct + poly1305_plain(otk, _mac_data(aad, ct))


def open_plain(key: bytes, nonce: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    _check_key_nonce(key, nonce)
    if len(sealed) < 16:
        raise InvalidTag("sealed frame shorter than its tag")
    ct, tag = sealed[:-16], sealed[-16:]
    otk = chacha20_blocks_plain(key, nonce, 0, 1)[:32]
    if not hmac.compare_digest(poly1305_plain(otk, _mac_data(aad, ct)), tag):
        raise InvalidTag("ChaCha20-Poly1305 tag mismatch")
    return _chacha20_xor(key, nonce, 1, ct)


def seal(key: bytes, nonce: bytes, plain: bytes, aad: bytes = b"") -> bytes:
    """ChaCha20-Poly1305 encryption, native: ciphertext ‖ tag."""
    _check_key_nonce(key, nonce)
    out = ctypes.create_string_buffer(len(plain) + 16)
    _lib().sd_aead_seal(_buf(key), _buf(nonce), _buf(aad), len(aad),
                        _buf(plain), len(plain), out)
    return out.raw


def open_(key: bytes, nonce: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    """ChaCha20-Poly1305 decryption, native; a bad tag raises InvalidTag."""
    _check_key_nonce(key, nonce)
    if len(sealed) < 16:
        raise InvalidTag("sealed frame shorter than its tag")
    out = ctypes.create_string_buffer(max(len(sealed) - 16, 1))
    if _lib().sd_aead_open(_buf(key), _buf(nonce), _buf(aad), len(aad),
                           _buf(sealed), len(sealed), out) != 0:
        raise InvalidTag("ChaCha20-Poly1305 tag mismatch")
    return out.raw[:len(sealed) - 16]


class ChaCha20Poly1305:
    """``cryptography``'s AEAD interface over the native form."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20-Poly1305 takes a 32-byte key")
        self._key = bytes(key)

    def encrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        return seal(self._key, nonce, data, aad or b"")

    def decrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        return open_(self._key, nonce, data, aad or b"")
