"""The hash encoder's Gaussian feature table, drawn as JAX draws it.

The JAX package's ``HashEncoder`` takes its table from
``jax.random.normal(PRNGKey(seed), (rows, dim), float32)``.  The port
imports no JAX, so it reproduces that draw bit for bit:

1. bits: threefry-2x32 (20 rounds) keyed by ``PRNGKey(seed)`` = (seed >> 32,
   seed & 0xffffffff), over the counter pair (hi, lo) of each element's flat
   index, the two output words XORed (JAX's layout under
   ``jax_threefry_partitionable=True``);
2. uniform on (nextafter(-1, 0), 1): the top 23 bits as the mantissa of a
   float in [1, 2), minus 1, times 2, plus the lower end, clamped to it;
3. normal: sqrt(2) * erf_inv(u), with XLA's CPU lowering of ``erf_inv``
   (Giles' single-precision polynomials), of its ``log1p`` (a Cephes
   rational function for |x| < sqrt(2) - 1, else log(1 + x)) and of ``log``
   (the Cephes polynomial), each multiply-add fused as XLA fuses it.

The table is drawn in C++ (``native.normal_table``: ``std::fma`` on all
cores); ``normal_table_np`` here is the same arithmetic in numpy
(round-to-odd f64 sums stand in for f32 fused multiply-adds), the fallback
without a C++ toolchain and the oracle of the tests.
"""

from __future__ import annotations

import numpy as np

__all__ = ["normal_table_np", "threefry_bits"]

_F32 = np.float32

#: Giles' erf_inv polynomials (w < 5 and w >= 5), highest degree first.
_ERFINV_LT5 = [
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
]
_ERFINV_GE5 = [
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
]
#: Cephes log1p rational function, highest degree first (coefficients are
#: rounded to f32 where they are used, as XLA emits them).
_LOG1P_NUM = [
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
]
_LOG1P_DEN = [
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1,
]
#: Cephes logf polynomial p0..p8 and the split ln 2 = q2 - q1.
_LOG_P = [
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1,
]
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry_bits(seed: int, start: int, count: int) -> np.ndarray:
    """32 random bits for flat indices [start, start + count) of a
    ``jax.random.bits(PRNGKey(seed), shape, uint32)`` draw."""
    idx = np.arange(start, start + count, dtype=np.uint64)
    x0 = (idx >> np.uint64(32)).astype(np.uint32)
    x1 = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k0, k1 = np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF)
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0 ^ x1


def _fma(a, b, c) -> np.ndarray:
    """f32 fused multiply-add, rounded once: the exact f64 product plus c
    rounded to odd in f64 (53 >= 24 + 2 bits), then rounded to f32."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(_F32)


def _horner(x: np.ndarray, coeffs: list[float]) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F32(c))
    return p


def _log(x: np.ndarray) -> np.ndarray:
    """XLA CPU's f32 log (Cephes), for positive normal inputs."""
    bits = np.maximum(x, _F32(np.finfo(_F32).tiny)).view(np.int32)
    e = (_F32(1) + ((bits >> 23) - 0x7F).astype(_F32)).astype(_F32)
    m = ((bits & ~0x7F800000) | np.array(0.5, _F32).view(np.int32)).view(_F32)
    low = m < _F32(0.707106781186547524)
    m1 = (m - _F32(1)).astype(_F32)
    e = (e - np.where(low, _F32(1), _F32(0))).astype(_F32)
    t = (m1 + np.where(low, m, _F32(0))).astype(_F32)
    x2 = (t * t).astype(_F32)
    x3 = (x2 * t).astype(_F32)
    p = [_F32(c) for c in _LOG_P]
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, (_F32(_LOG_Q1) * e).astype(_F32))
    t = (t - (_F32(0.5) * x2).astype(_F32)).astype(_F32)
    t = (t + y).astype(_F32)
    return (t + (_F32(_LOG_Q2) * e).astype(_F32)).astype(_F32)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA CPU's f32 log1p: a rational function near 0, else log(1 + x)."""
    x2 = (x * x).astype(_F32)
    small = (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)).astype(_F32)
    small = ((x * x2).astype(_F32) * small).astype(_F32)
    small = _fma(_F32(-0.5), x2, small)
    small = (x + small).astype(_F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log((x + _F32(1)).astype(_F32))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    w = -_log1p((x * -x).astype(_F32))
    lt = w < _F32(5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, (w - _F32(2.5)).astype(_F32), (np.sqrt(w) - _F32(3)).astype(_F32))
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0])).astype(_F32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F32(a), _F32(b)))
    return (p * x).astype(_F32)


def normal_table_np(seed: int, rows: int, dim: int) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), (rows, dim), float32)`` in numpy."""
    n = rows * dim
    out = np.empty(n, _F32)
    lo = np.nextafter(_F32(-1), _F32(0))
    step = 1 << 20
    for start in range(0, n, step):
        bits = threefry_bits(seed, start, min(step, n - start))
        floats = ((bits >> np.uint32(9)) | np.array(1.0, _F32).view(np.uint32)).view(_F32) - _F32(1)
        u = np.maximum(lo, (floats * (_F32(1) - lo) + lo).astype(_F32))
        out[start : start + bits.size] = (_F32(np.sqrt(2)) * _erf_inv(u)).astype(_F32)
    return out.reshape(rows, dim)

