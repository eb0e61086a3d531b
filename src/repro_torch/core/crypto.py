"""Zero-trust identity layer (paper §3.4.6).

A copy of the reference's ``repro/core/crypto.py``: the same identities
and the same signature bits, since the broker recovers the signer from
them.

Pure-Python ECDSA over secp256k1 with *public-key recovery*: the server
never stores public keys for request verification — it recovers the key
from (signature, message) and derives the caller identity as the
SHA3-256 hash of the recovered public key, exactly as the paper
describes ("the identity of an executor can be calculated simply as the
SHA-3 hash of the recovered signature").

Signatures are deterministic (RFC 6979-style HMAC-SHA256 nonces) so the
protocol stays stateless and replayable in tests.  Wire format is
65 bytes hex: r (32) || s (32) || recovery_id (1).
"""

from __future__ import annotations

import hashlib
import hmac
import os
from dataclasses import dataclass

# --- secp256k1 domain parameters -------------------------------------------
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
A = 0
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_Point = tuple[int, int] | None  # None is the point at infinity


def _inv(x: int, m: int) -> int:
    return pow(x, -1, m)


def _point_add(p: _Point, q: _Point) -> _Point:
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _point_mul(k: int, p: _Point) -> _Point:
    """Double-and-add scalar multiplication."""
    result: _Point = None
    addend = p
    while k:
        if k & 1:
            result = _point_add(result, addend)
        addend = _point_add(addend, addend)
        k >>= 1
    return result


def _lift_x(x: int, odd: bool) -> _Point:
    """Recover the curve point with the given x and y parity."""
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if pow(y, 2, P) != y2:
        raise ValueError("x is not on the curve")
    if (y & 1) != odd:
        y = P - y
    return (x, y)


def _hash_msg(msg: bytes) -> int:
    return int.from_bytes(hashlib.sha3_256(msg).digest(), "big") % N


def _rfc6979_nonce(prvkey: int, msg_hash: int) -> int:
    """Deterministic nonce per RFC 6979 (HMAC-SHA256 construction)."""
    x = prvkey.to_bytes(32, "big")
    h1 = msg_hash.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def _pub_bytes(point: _Point) -> bytes:
    assert point is not None
    x, y = point
    return x.to_bytes(32, "big") + y.to_bytes(32, "big")


from functools import lru_cache


@lru_cache(maxsize=4096)
def _id_cached(prvkey: str) -> str:
    d = int(prvkey, 16)
    pub = _point_mul(d, (GX, GY))
    return hashlib.sha3_256(_pub_bytes(pub)).hexdigest()


@dataclass(frozen=True)
class Signature:
    r: int
    s: int
    v: int  # recovery id (0 or 1; y-parity of the nonce point)

    def hex(self) -> str:
        return (
            self.r.to_bytes(32, "big") + self.s.to_bytes(32, "big") + bytes([self.v])
        ).hex()

    @staticmethod
    def from_hex(h: str) -> "Signature":
        raw = bytes.fromhex(h)
        if len(raw) != 65:
            raise ValueError("signature must be 65 bytes")
        return Signature(
            int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:64], "big"), raw[64]
        )


class Crypto:
    """SDK-facing crypto helper matching the paper's Python SDK surface."""

    @staticmethod
    def prvkey() -> str:
        """Generate a fresh private key (hex)."""
        while True:
            k = int.from_bytes(os.urandom(32), "big")
            if 1 <= k < N:
                return k.to_bytes(32, "big").hex()

    @staticmethod
    def id(prvkey: str) -> str:
        """Identity = SHA3-256 of the uncompressed public key (cached)."""
        return _id_cached(prvkey)

    @staticmethod
    def sign(msg: bytes | str, prvkey: str) -> str:
        if isinstance(msg, str):
            msg = msg.encode()
        d = int(prvkey, 16)
        if not 1 <= d < N:
            raise ValueError("invalid private key")
        z = _hash_msg(msg)
        while True:
            k = _rfc6979_nonce(d, z)
            point = _point_mul(k, (GX, GY))
            assert point is not None
            x1, y1 = point
            r = x1 % N
            if r == 0:
                z = (z + 1) % N  # re-derive with perturbed hash (never in practice)
                continue
            s = (_inv(k, N) * (z + r * d)) % N
            if s == 0:
                z = (z + 1) % N
                continue
            v = y1 & 1
            if s > N // 2:  # low-s normalization flips the recovery bit
                s = N - s
                v ^= 1
            return Signature(r, s, v).hex()

    @staticmethod
    def recover(msg: bytes | str, sig_hex: str) -> str:
        """Recover the signer identity (SHA3-256 of public key) from a signature."""
        if isinstance(msg, str):
            msg = msg.encode()
        sig = Signature.from_hex(sig_hex)
        if not (1 <= sig.r < N and 1 <= sig.s < N and sig.v in (0, 1)):
            raise ValueError("malformed signature")
        z = _hash_msg(msg)
        # R is the nonce point: x = r (r < P for secp256k1 in practice), parity = v
        big_r = _lift_x(sig.r, bool(sig.v))
        r_inv = _inv(sig.r, N)
        # Q = r^-1 (s*R - z*G)
        s_r = _point_mul(sig.s, big_r)
        z_g = _point_mul((N - z) % N, (GX, GY))
        q = _point_mul(r_inv, _point_add(s_r, z_g))
        if q is None:
            raise ValueError("signature recovery failed")
        return hashlib.sha3_256(_pub_bytes(q)).hexdigest()

    @staticmethod
    def verify(msg: bytes | str, sig_hex: str, identity: str) -> bool:
        try:
            return Crypto.recover(msg, sig_hex) == identity
        except (ValueError, AssertionError):
            return False
