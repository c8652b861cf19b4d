"""Pure-Python FarmHash ``Fingerprint64`` (farmhashna::Hash64).

TensorFlow's ``tf.strings.to_hash_bucket_fast`` — the op the reference's
TF-Hub USE text preprocessing uses to bucket out-of-vocabulary tokens —
computes ``Fingerprint64(utf8_bytes) % num_buckets``. Reimplemented here so
the offline USE-DAN encoder (models/use_encoder.py) maps OOV tokens to the
SAME trained embedding rows as the original TF graph, with no TF
dependency. Validated against ``to_hash_bucket_fast`` golden vectors across
all four farmhash length regimes (tests/test_use_encoder.py).

The port's own copy of ``masters_thesis_tpu/utils/farmhash.py``, with the
same names and meaning (``tests/test_torch_use_encoder.py`` holds the two
together on the goldens and on random unicode words). Every product is
masked to 64 bits, since Python integers do not wrap.
"""

from __future__ import annotations

_M = (1 << 64) - 1
_K0 = 0xC3A5C85C97CB3127
_K1 = 0xB492B66FBE98F273
_K2 = 0x9AE16A3B2F90404F


def _rot(v: int, s: int) -> int:
    if s == 0:
        return v
    return ((v >> s) | (v << (64 - s))) & _M


def _shift_mix(v: int) -> int:
    return v ^ (v >> 47)


def _f64(b: bytes, i: int = 0) -> int:
    return int.from_bytes(b[i:i + 8], "little")


def _f32(b: bytes, i: int = 0) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _hash16(u: int, v: int, mul: int) -> int:
    a = ((u ^ v) * mul) & _M
    a ^= a >> 47
    b = ((v ^ a) * mul) & _M
    b ^= b >> 47
    return (b * mul) & _M


def _len0to16(s: bytes) -> int:
    n = len(s)
    if n >= 8:
        mul = (_K2 + n * 2) & _M
        a = (_f64(s) + _K2) & _M
        b = _f64(s, n - 8)
        c = (_rot(b, 37) * mul + a) & _M
        d = ((_rot(a, 25) + b) * mul) & _M
        return _hash16(c, d, mul)
    if n >= 4:
        mul = (_K2 + n * 2) & _M
        a = _f32(s)
        return _hash16((n + (a << 3)) & _M, _f32(s, n - 4), mul)
    if n > 0:
        a, b, c = s[0], s[n >> 1], s[n - 1]
        y = (a + (b << 8)) & _M
        z = (n + (c << 2)) & _M
        return (_shift_mix(((y * _K2) & _M) ^ ((z * _K0) & _M)) * _K2) & _M
    return _K2


def _len17to32(s: bytes) -> int:
    n = len(s)
    mul = (_K2 + n * 2) & _M
    a = (_f64(s) * _K1) & _M
    b = _f64(s, 8)
    c = (_f64(s, n - 8) * mul) & _M
    d = (_f64(s, n - 16) * _K2) & _M
    return _hash16(
        (_rot((a + b) & _M, 43) + _rot(c, 30) + d) & _M,
        (a + _rot((b + _K2) & _M, 18) + c) & _M,
        mul,
    )


def _len33to64(s: bytes) -> int:
    n = len(s)
    mul = (_K2 + n * 2) & _M
    a = (_f64(s) * _K2) & _M
    b = _f64(s, 8)
    c = (_f64(s, n - 8) * mul) & _M
    d = (_f64(s, n - 16) * _K2) & _M
    y = (_rot((a + b) & _M, 43) + _rot(c, 30) + d) & _M
    z = _hash16(y, (a + _rot((b + _K2) & _M, 18) + c) & _M, mul)
    e = (_f64(s, 16) * mul) & _M
    f = _f64(s, 24)
    g = ((y + _f64(s, n - 32)) * mul) & _M
    h = ((z + _f64(s, n - 24)) * mul) & _M
    return _hash16(
        (_rot((e + f) & _M, 43) + _rot(g, 30) + h) & _M,
        (e + _rot((f + a) & _M, 18) + g) & _M,
        mul,
    )


def _weak32(s: bytes, i: int, a: int, b: int):
    w, x, y, z = _f64(s, i), _f64(s, i + 8), _f64(s, i + 16), _f64(s, i + 24)
    a = (a + w) & _M
    b = _rot((b + a + z) & _M, 21)
    c = a
    a = (a + x + y) & _M
    b = (b + _rot(a, 44)) & _M
    return (a + z) & _M, (b + c) & _M


def fingerprint64(s: bytes | str) -> int:
    """farmhashna::Hash64 of the byte string (== TF Fingerprint64)."""
    if isinstance(s, str):
        s = s.encode("utf-8")
    n = len(s)
    if n <= 16:
        return _len0to16(s)
    if n <= 32:
        return _len17to32(s)
    if n <= 64:
        return _len33to64(s)

    seed = 81
    x = seed
    y = (seed * _K1 + 113) & _M
    z = (_shift_mix((y * _K2 + 113) & _M) * _K2) & _M
    v = (0, 0)
    w = (0, 0)
    x = (x * _K2 + _f64(s)) & _M
    end = ((n - 1) // 64) * 64
    last64 = n - 64
    pos = 0
    while True:
        x = (_rot((x + y + v[0] + _f64(s, pos + 8)) & _M, 37) * _K1) & _M
        y = (_rot((y + v[1] + _f64(s, pos + 48)) & _M, 42) * _K1) & _M
        x ^= w[1]
        y = (y + v[0] + _f64(s, pos + 40)) & _M
        z = (_rot((z + w[0]) & _M, 33) * _K1) & _M
        v = _weak32(s, pos, (v[1] * _K1) & _M, (x + w[0]) & _M)
        w = _weak32(s, pos + 32, (z + w[1]) & _M, (y + _f64(s, pos + 16)) & _M)
        z, x = x, z
        pos += 64
        if pos == end:
            break
    mul = (_K1 + ((z & 0xFF) << 1)) & _M
    pos = last64
    w = ((w[0] + ((n - 1) & 63)) & _M, w[1])
    v = ((v[0] + w[0]) & _M, v[1])
    w = ((w[0] + v[0]) & _M, w[1])
    x = (_rot((x + y + v[0] + _f64(s, pos + 8)) & _M, 37) * mul) & _M
    y = (_rot((y + v[1] + _f64(s, pos + 48)) & _M, 42) * mul) & _M
    x ^= (w[1] * 9) & _M
    y = (y + v[0] * 9 + _f64(s, pos + 40)) & _M
    z = (_rot((z + w[0]) & _M, 33) * mul) & _M
    v = _weak32(s, pos, (v[1] * mul) & _M, (x + w[0]) & _M)
    w = _weak32(s, pos + 32, (z + w[1]) & _M, (y + _f64(s, pos + 16)) & _M)
    z, x = x, z
    return _hash16(
        (_hash16(v[0], w[0], mul) + (_shift_mix(y) * _K0) + z) & _M,
        (_hash16(v[1], w[1], mul) + x) & _M,
        mul,
    )


def hash_bucket_fast(s: bytes | str, num_buckets: int) -> int:
    """``tf.strings.to_hash_bucket_fast`` semantics."""
    return fingerprint64(s) % num_buckets
