"""Planar-complex FFT built from dense matmuls.

The reference delegates FFTs to FFTW3 (reference: src/fftplan_fftw3.hh) with
a broken native fallback (src/fftplan_native.hh, SURVEY.md 2.3).  Here the
data is planar complex (core/cplx.py), so we implement the DFT as the
Bailey four-step / mixed-radix Cooley-Tukey algorithm over planar complex
data, where every butterfly stage is a dense real matmul:

    n = n1*n2, j = j1 + n1*j2, k = k2 + n2*k1:
    X[k2 + n2*k1] = sum_j1 W_n1^(j1 k1) * W_n^(j1 k2)
                    * sum_j2 x[j1 + n1*j2] * W_n2^(j2 k2)

Each factor's DFT is a direct (f, f) matrix multiply; factors are kept <= 512
so the matrices stay small.  The O(n * sum(factors)) FLOP count exceeds
O(n log n); whether ``jnp.fft`` (cuFFT) is faster on the GPU is not measured
yet.

Accuracy: float32 with HIGHEST precision, ~1e-6 relative error for n <= 8192
(tested against numpy in tests/test_fft.py).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core.cplx import Complex

_MAX_DIRECT = 512


def _factorize(n: int) -> Tuple[int, int]:
    """Split n = n1*n2 with both factors as close to sqrt(n) as possible."""
    best = (1, n)
    for n1 in range(int(np.sqrt(n)), 0, -1):
        if n % n1 == 0:
            best = (n1, n // n1)
            break
    return best


@functools.lru_cache(maxsize=None)
def _dft_matrix(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of the forward DFT matrix W[j,k] = exp(-2i pi j k / n)."""
    j = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(j, j) / n)
    return (np.ascontiguousarray(w.real.astype(np.float32)),
            np.ascontiguousarray(w.imag.astype(np.float32)))


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of W_n^(j1*k2), shape (n2, n1) [axis order (k2, j1)]."""
    n = n1 * n2
    j1 = np.arange(n1)
    k2 = np.arange(n2)
    w = np.exp(-2j * np.pi * np.outer(k2, j1) / n)
    return (np.ascontiguousarray(w.real.astype(np.float32)),
            np.ascontiguousarray(w.imag.astype(np.float32)))


# HIGHEST (bf16x6): 1.3e-7 matmul error vs 1.7e-5 for HIGH on this backend.
# The FFT feeds spectral multiplies (filter banks), so keep full accuracy;
# measured end-to-end difference is within this machine's timing noise.
_PRECISION = jax.lax.Precision.HIGHEST


def _cmatmul(x: Complex, mr: jnp.ndarray, mi: jnp.ndarray) -> Complex:
    """(..., j) complex times (j, k) complex matrix -> (..., k), via 3 real
    matmuls (Karatsuba)."""
    dot = lambda a, b: jnp.matmul(a, b, precision=_PRECISION)  # noqa: E731
    ac = dot(x.re, mr)
    bd = dot(x.im, mi)
    abcd = dot(x.re + x.im, mr + mi)
    return Complex(ac - bd, abcd - ac - bd)




def _fft_nested(x: Complex) -> Complex:
    """Unscaled forward DFT along the last axis (recursive mixed radix)."""
    n = x.shape[-1]
    if n <= _MAX_DIRECT:
        mr, mi = _dft_matrix(n)
        return _cmatmul(x, jnp.asarray(mr), jnp.asarray(mi))
    n1, n2 = _factorize(n)
    if n1 == 1:
        # prime n > _MAX_DIRECT: fall back to a direct (big) matmul
        mr, mi = _dft_matrix(n)
        return _cmatmul(x, jnp.asarray(mr), jnp.asarray(mi))
    lead = x.shape[:-1]
    # x[j1 + n1*j2] -> A[j2, j1]
    a = x.reshape(lead + (n2, n1))
    # inner DFT over j2 (axis -2): move to last, transform, move back
    # (an einsum contracting axis -2 in place was tried and is NOT faster —
    # XLA inserts the same transpose — and its precision= is not honored on
    # this backend, degrading to 1-pass bf16).
    b = _fft_nested(a.map(lambda t: jnp.swapaxes(t, -1, -2)))
    # b axes: (..., j1, k2); twiddle W_n^(j1*k2) has axes (k2, j1) -> transpose
    tr, ti = _twiddle(n1, n2)
    tw = Complex(jnp.asarray(tr).T, jnp.asarray(ti).T)  # (j1, k2)
    c = b * tw
    # outer DFT over j1 (axis -2)
    d = _fft_nested(c.map(lambda t: jnp.swapaxes(t, -1, -2)))
    # d axes: (..., k2, k1); X[k2 + n2*k1] = d[k2, k1] -> swap & flatten
    out = d.map(lambda t: jnp.swapaxes(t, -1, -2))
    return out.reshape(lead + (n,))


def fft(x: Complex, inverse: bool = False) -> Complex:
    """FFT along the trailing axis of a planar-complex array.

    Forward is unscaled; inverse applies the 1/n factor (numpy convention).
    """
    if not isinstance(x, Complex):
        x = Complex(jnp.asarray(x, jnp.float32),
                    jnp.zeros_like(jnp.asarray(x, jnp.float32)))
    if inverse:
        y = _fft_nested(x.conj()).conj()
        return y * (1.0 / x.shape[-1])
    return _fft_nested(x)


def fft_np(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Host-side reference path (numpy) with the same conventions."""
    return np.fft.ifft(x) if inverse else np.fft.fft(x)


def fft_f64(x, inverse: bool = False) -> np.ndarray:
    """Double-precision transform — the capability of the reference's FFTW
    double plans (reference: src/fftplan_fftw3.hh:11-142, which also ran on
    the host CPU).  The device path is float32 (HIGHEST ~1.3e-7, above
    every SDR contract here); when genuine f64 spectra are needed (e.g.
    calibration tooling), this host path computes the same unscaled-forward
    / 1/n-inverse convention in float64 via the mixed-radix matmul
    factorization.

    Accepts numpy complex arrays or planar :class:`Complex`; returns
    numpy complex128.
    """
    if isinstance(x, Complex):
        x = np.asarray(x.re, np.float64) + 1j * np.asarray(x.im, np.float64)
    x = np.asarray(x, np.complex128)
    n = x.shape[-1]

    def rec(a):
        m = a.shape[-1]
        if m <= _MAX_DIRECT:
            j = np.arange(m)
            w = np.exp(-2j * np.pi * np.outer(j, j) / m)
            return a @ w
        n1, n2 = _factorize(m)
        if n1 == 1:
            j = np.arange(m)
            return a @ np.exp(-2j * np.pi * np.outer(j, j) / m)
        lead = a.shape[:-1]
        b = rec(np.swapaxes(a.reshape(lead + (n2, n1)), -1, -2))
        tw = np.exp(-2j * np.pi
                    * np.outer(np.arange(n1), np.arange(n2)) / m)
        d = rec(np.swapaxes(b * tw, -1, -2))
        return np.swapaxes(d, -1, -2).reshape(lead + (m,))

    if inverse:
        return np.conj(rec(np.conj(x))) / n
    return rec(x)
