"""Frozen copy of eitx_torch/core/prng.py as of commit 82a40b4, copied
unchanged but for this note.

The part of ``jax.random`` that eitx draws from, computed on the host.

eitx seeds everything random from ``jax.random.PRNGKey(seed)``: its
``device_batches`` stream (``split``, ``randint``, ``uniform``) and flax's
initial weights (``fold_in`` and ``truncated_normal``). Threefry-2x32 is a
fixed integer hash, so the port draws the same numbers: this module
computes them in numpy ``uint32`` with the semantics of JAX 0.9.0 under
``jax_threefry_partitionable=True`` (its default), in 32-bit mode.

Every draw is threefry of the key on the counter pairs ``(0, i)``, the
64-bit iota of the draw's shape split into high and low words
(``jax/_src/prng.py`` ``iota_2x32_shape``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``): ``split``
keeps both output words of each counter as a key, ``random_bits`` their
xor. ``randint`` and ``uniform`` follow ``jax/_src/random.py``
(``_randint``, ``_uniform``) in wrapping ``uint32`` and float32.

``truncated_normal`` is the one draw with float work beyond a bit cast:
``sqrt(2) * erf_inv(u)``. It computes what XLA:CPU compiles for it, op by
op: the bounds' ``erf`` and the ``erf_inv`` polynomial as XLA expands
them, ``log1p`` as XLA:CPU's own float32 approximation (not a correctly
rounded one: it differs from libm's on ~8 % of inputs), and each multiply
and add that LLVM contracts into a fused multiply-add on an FMA-capable
x86 host as a single rounding (``fma_f32``). The result equals
``jax.random.truncated_normal`` on every bit (``tests/test_torch_prng.py``).

Keys are ``uint32`` arrays whose last axis holds the two words; every
function takes a stack of keys (``(..., 2)``) and draws for each, so a
block of steps or a network's layers is one vectorised call. A draw is a
few numpy passes over the output: host work, the same on every device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

_U32 = np.uint32
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: ``(0, seed mod 2^32)``
    (JAX takes a Python int through int64, then to 32 bits)."""
    s = int(np.int64(seed))  # OverflowError outside int64, as in JAX
    return np.array([0, s & 0xFFFFFFFF], _U32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key words ``(k1, k2)``; all four broadcast, ``uint32``
    arithmetic wraps (``jax/_src/prng.py`` ``_threefry2x32_lowering``)."""
    k1 = np.asarray(k1, _U32)
    k2 = np.asarray(k2, _U32)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        a = np.asarray(x1, _U32) + ks[0]
        b = np.asarray(x2, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def _hash_iota(keys: np.ndarray, shape: Tuple[int, ...]):
    """threefry of each key on the counters ``(0, i)``, i over ``shape``:
    two arrays of shape ``keys.shape[:-1] + shape``."""
    keys = np.asarray(keys, _U32)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("draws of 2^32 or more elements")
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(lead + (1,) * len(shape))
    k2 = keys[..., 1].reshape(lead + (1,) * len(shape))
    lo = np.arange(n, dtype=_U32).reshape(shape)
    return threefry2x32(k1, k2, _U32(0), lo)


def split(keys, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(..., 2)`` -> ``(..., num, 2)``."""
    b1, b2 = _hash_iota(keys, (int(num),))
    return np.stack([b1, b2], axis=-1)


def fold_in(keys, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``, ``data`` taken as uint32."""
    keys = np.asarray(keys, _U32)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], _U32(0),
                          _U32(int(data) & 0xFFFFFFFF))
    return np.stack([b1, b2], axis=-1)


def random_bits(keys, shape: Shape) -> np.ndarray:
    """32 random bits an element (``jax.random.bits(key, shape)``):
    ``keys.shape[:-1] + shape`` uint32."""
    b1, b2 = _hash_iota(keys, _shape(shape))
    return b1 ^ b2


def _uniform_from_bits(bits: np.ndarray, lo, hi) -> np.ndarray:
    """uint32 bits -> float32 in [lo, hi): the top 23 bits as the mantissa
    of f in [1, 2), then ``max(lo, (f - 1) * (hi - lo) + lo)``, the product
    and sum one fused multiply-add (what XLA:CPU compiles; exact for
    [0, 1))."""
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1.0)
    return np.maximum(lo, fma_f32(f, hi - lo, lo))


def uniform(keys, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` (float32)."""
    return _uniform_from_bits(random_bits(keys, shape), _F32(minval),
                              _F32(maxval))


def randint(keys, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` with int32 output: two 32-bit draws (from a
    split of the key) folded into [minval, maxval) by ``uint32`` remainders,
    every product and sum wrapping as in ``jax/_src/random.py`` ``_randint``
    (``multiplier * multiplier`` wraps too)."""
    i32 = np.iinfo(np.int32)
    lo, hi = int(minval), int(maxval)
    if not (i32.min <= lo <= i32.max and i32.min <= hi <= i32.max):
        raise ValueError(f"randint bounds [{lo}, {hi}) outside int32")
    # maxval <= minval draws minval (a span of 1)
    span = _U32(hi - lo if hi > lo else 1)
    ks = split(keys, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        offset = ((higher % span) * mult + lower % span) % span
    return (offset.astype(np.int64) + lo).astype(np.uint32).view(np.int32)


# --- float32 as XLA:CPU computes it -------------------------------------

_LOW29 = np.uint64((1 << 29) - 1)
_HALF29 = np.uint64(1 << 28)
_EXP64 = np.uint64(0x7FF << 52)
_EXP_MIN_NORMAL32 = np.uint64((1023 - 126) << 52)


def fma_f32(a, b, c) -> np.ndarray:
    """``a * b + c`` in float32 with one rounding (a fused multiply-add).

    The product of two float32 numbers is exact in float64, and so is
    rounding the float64 sum to float32 unless that sum lands exactly
    half-way between two float32 numbers (or below float32's normal
    range): only there can rounding twice differ from rounding once, and
    those few elements are redone with the sum's exact remainder (TwoSum)."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c64 = np.asarray(c, np.float64)
    s = np.asarray(p + c64)
    r = s.astype(_F32)
    bits = s.view(np.uint64)
    cand = ((bits & _LOW29) == _HALF29) | ((bits & _EXP64) < _EXP_MIN_NORMAL32)
    if cand.any():
        pi = np.broadcast_to(p, s.shape)[cand]
        ci = np.broadcast_to(c64, s.shape)[cand]
        si = s[cand]
        bp = si - ci
        err = (pi - bp) + (ci - (si - bp))
        ri = r[cand]
        r64 = ri.astype(np.float64)
        with np.errstate(invalid="ignore"):
            toward = np.where(si > r64, np.nextafter(ri, _F32(np.inf)),
                              np.nextafter(ri, _F32(-np.inf)))
            tie = (si != r64) & (si == (r64 + toward.astype(np.float64)) * 0.5)
            fix = tie & (err != 0) & ((err > 0) == (toward > ri))
        r[cand] = np.where(fix, toward, ri)
    return r


def _f32_consts(*hexes: int):
    """float32 constants written as the float64 bit patterns LLVM prints."""
    return tuple(_F32(np.array(h, np.uint64).view(np.float64)) for h in hexes)


# XLA:CPU's float32 erf (x clamped, x * P(x^2) / Q(x^2), each step an fma)
(_ERF_CLAMP,) = _f32_consts(0x400DF38D00000000)
_ERF_P = _f32_consts(0x3F2E05AA20000000, 0x3F6BEBB440000000,
                     0x3FAA16DD60000000, 0x3FC7B4E800000000,
                     0x3FF20DD740000000)
_ERF_Q = _f32_consts(0xBE7FA720C0000000, 0x3EF8B11BE0000000,
                     0x3F50ADA500000000, 0x3F8CD0FA80000000,
                     0x3FBC698420000000, 0x3FDFD68940000000) + (_F32(1.0),)


def erf_f32(x) -> np.ndarray:
    """XLA:CPU's float32 ``erf``."""
    x = np.minimum(np.maximum(np.asarray(x, _F32), -_ERF_CLAMP), _ERF_CLAMP)
    x2 = x * x
    p = fma_f32(x2, _ERF_P[0], _ERF_P[1])
    for c in _ERF_P[2:]:
        p = fma_f32(p, x2, c)
    q = fma_f32(x2, _ERF_Q[0], _ERF_Q[1])
    for c in _ERF_Q[2:]:
        q = fma_f32(q, x2, c)
    return (x * p) / q


# XLA:CPU's float32 log (Cephes' logf: frexp, a degree-8 polynomial in
# three fma chains) and XLA's log1p (a Cephes rational for |x| < sqrt(2)-1)
(_SQRT_HALF, _LOG_Q1, _LOG_Q2, _MIN_NORMAL) = _f32_consts(
    0x3FE6A09E60000000, 0xBF2BD01060000000, 0x3FE6300000000000,
    0x3810000000000000)
_LOG_A = _f32_consts(0x3FB2043760000000, 0xBFBD7A3700000000,
                     0x3FBDE4A340000000)
_LOG_B = _f32_consts(0xBFBFCBA9E0000000, 0x3FC23D37E0000000,
                     0xBFC555CA00000000)
_LOG_C = _f32_consts(0x3FC999D580000000, 0xBFCFFFFF80000000,
                     0x3FD5555540000000)
(_LOG1P_SMALL,) = _f32_consts(0x3FDA8279A0000000)
_LOG1P_DEN = _f32_consts(0x402E2035A0000000, 0x4054C30B60000000,
                         0x406BB865A0000000, 0x4073519460000000,
                         0x406B0DB140000000, 0x404E0F3040000000)
_LOG1P_NUM = _f32_consts(0x3F07BC0960000000, 0x3FDFE818A0000000,
                         0x401A509F40000000, 0x403DE97380000000,
                         0x404E798EC0000000, 0x404C8E75A0000000,
                         0x40340A2020000000)


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA:CPU's float32 ``log``."""
    m_bits = np.maximum(v, _MIN_NORMAL).view(_U32)
    e = ((m_bits >> _U32(23)).astype(np.int32) - 127).astype(_F32) + _F32(1)
    m = ((m_bits & _U32(0x7FFFFF)) | _U32(0x3F000000)).view(_F32)
    low = m < _SQRT_HALF
    x = (m - _F32(1)) + np.where(low, m, _F32(0))
    e = e - np.where(low, _F32(1), _F32(0))
    x2 = x * x
    x3 = x2 * x
    a = fma_f32(fma_f32(x, _LOG_A[0], _LOG_A[1]), x, _LOG_A[2])
    b = fma_f32(fma_f32(x, _LOG_B[0], _LOG_B[1]), x, _LOG_B[2])
    c = fma_f32(fma_f32(x, _LOG_C[0], _LOG_C[1]), x, _LOG_C[2])
    y = fma_f32(fma_f32(fma_f32(a, x3, b), x3, c), x3, e * _LOG_Q1)
    y = fma_f32(e, _LOG_Q2, fma_f32(-x2, _F32(0.5), x) + y)
    y = np.where(v <= 0, _F32(np.nan), y)  # a NaN v stays NaN
    y = np.where(v == 0, _F32(-np.inf), y)
    return np.where(v == np.inf, _F32(np.inf), y)


def log1p_f32(x) -> np.ndarray:
    """XLA:CPU's float32 ``log1p``."""
    x = np.asarray(x, _F32)
    x2 = x * x
    den = np.full_like(x, _F32(1))
    for c in _LOG1P_DEN:
        den = fma_f32(den, x, c)
    num = np.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma_f32(num, x, c)
    small = x + fma_f32(x2, _F32(-0.5), (x * x2) * (num / den))
    with np.errstate(invalid="ignore", divide="ignore"):
        large = _log_f32(x + _F32(1))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, large)


# XLA's float32 erf_inv (Giles): w = -log1p(-x^2), a degree-8 polynomial
# in w - 2.5 (w < 5) or sqrt(w) - 3, times x
_ERFINV_LT5 = tuple(_F32(c) for c in (
    "2.81022636e-08", "3.43273939e-07", "-3.5233877e-06", "-4.39150654e-06",
    "0.00021858087", "-0.00125372503", "-0.00417768164", "0.246640727",
    "1.50140941"))
_ERFINV_GE5 = tuple(_F32(c) for c in (
    "-0.000200214257", "0.000100950558", "0.00134934322", "-0.00367342844",
    "0.00573950773", "-0.0076224613", "0.00943887047", "1.00167406",
    "2.83297682"))


def erf_inv_f32(x) -> np.ndarray:
    """XLA's float32 ``erf_inv`` as XLA:CPU compiles it."""
    x = np.asarray(x, _F32)
    lg = log1p_f32(x * -x)
    near = lg > _F32(-5)  # w = -lg < 5
    with np.errstate(invalid="ignore"):
        z = np.where(near, _F32(-2.5) - lg, np.sqrt(-lg) + _F32(-3))
    coef = [np.where(near, a, b) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = fma_f32(coef[0], z, coef[1])
    for c in coef[2:]:
        p = fma_f32(z, p, c)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1, x * _F32(np.inf), p * x)


_SQRT2 = _F32(math.sqrt(2))
_INV_SQRT2 = _F32("0.707106769")  # XLA rewrites x / sqrt(2) as x * this
_CHUNK = 1 << 14  # elements a pass works on: its temporaries stay in cache


def truncated_normal(keys, lower: float, upper: float,
                     shape: Shape) -> np.ndarray:
    """``jax.random.truncated_normal`` (float32): a uniform draw between the
    bounds' ``erf``, mapped through ``sqrt(2) * erf_inv``, clipped to the
    open interval. One key's large draw is computed in chunks of its
    counters."""
    shape = _shape(shape)
    keys = np.asarray(keys, _U32)
    lo, hi = _F32(lower), _F32(upper)
    a = erf_f32(lo * _INV_SQRT2)
    b = erf_f32(hi * _INV_SQRT2)
    clip_lo = np.nextafter(lo, _F32(np.inf))
    clip_hi = np.nextafter(hi, _F32(-np.inf))

    def from_bits(bits):
        out = erf_inv_f32(_uniform_from_bits(bits, a, b)) * _SQRT2
        return np.minimum(clip_hi, np.maximum(clip_lo, out))

    n = math.prod(shape)
    if keys.ndim > 1 or n <= _CHUNK:
        return from_bits(random_bits(keys, shape))
    out = np.empty(n, _F32)
    for i in range(0, n, _CHUNK):
        j = min(n, i + _CHUNK)
        b1, b2 = threefry2x32(keys[0], keys[1], _U32(0),
                              np.arange(i, j, dtype=_U32))
        out[i:j] = from_bits(b1 ^ b2)
    return out.reshape(shape)
