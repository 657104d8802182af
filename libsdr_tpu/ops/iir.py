"""IIR filtering — frame matmuls, scans as fallback.

The reference's only IIR filters are first-order exponential averages — the
FM de-emphasis (reference: src/demod.hh:342-351) and the AGC envelope
(reference: src/utils.hh:657-793).  A first-order recurrence
``y[n] = a*y[n-1] + b[n]`` is associative under

    (a2, b2) o (a1, b1) = (a1*a2, a2*b1 + b2)

so ``jax.lax.associative_scan`` runs it in O(log B) depth — but each of the
log2(B) sweeps re-reads the whole array from HBM.  For a *constant* scalar
coefficient the recurrence is instead solved in closed form per frame of S
samples with ONE matmul against the lower-triangular impulse-response
matrix L[m, s] = a^(s-m):

    p[f, :]  = (b*x)[f, :] @ L            (GEMM, one pass over the data)
    Y[f]     = a^S * Y[f-1] + p[f, S-1]   (tiny scan over B/S frame carries)
    y[f, s]  = p[f, s] + a^(s+1) * Y[f-1] (fused elementwise epilogue)

Variable coefficients (the AGC's signal-dependent decay) keep the
associative scan.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_FRAME = 128  # frame length S


def _iir_scan(x: jnp.ndarray, a, b, y0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Associative-scan fallback (any broadcastable a/b)."""
    a = jnp.asarray(a, dtype=x.dtype)
    bx = jnp.asarray(b, dtype=x.dtype) * x
    bx = bx.at[..., 0].add(a * y0)
    a_full = jnp.broadcast_to(a, x.shape)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    _, y = jax.lax.associative_scan(combine, (a_full, bx), axis=-1)
    return y, y[..., -1]


def iir_first_order(x: jnp.ndarray, a, b, y0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run ``y[n] = a*y[n-1] + b*x[n]`` along the trailing axis.

    Args:
      x: (..., B) input block.
      a, b: scalar coefficients (or broadcastable to x's leading dims).
      y0: (...,) initial state ``y[-1]``.

    Returns:
      (y, y_last): the full output block and the final state.
    """
    s = _FRAME
    a_arr = jnp.asarray(a, dtype=x.dtype)
    blk = x.shape[-1]
    if a_arr.ndim != 0 or blk % s != 0 or blk < 2 * s:
        return _iir_scan(x, a, b, y0)
    f = blk // s
    lead = x.shape[:-1]
    # Lower-triangular impulse response L[m, s'] = a^(s'-m), m <= s'.
    e = jnp.arange(s)[None, :] - jnp.arange(s)[:, None]
    lmat = jnp.where(e >= 0, a_arr ** e.astype(x.dtype), 0).astype(x.dtype)
    bx = (jnp.asarray(b, dtype=x.dtype) * x).reshape(lead + (f, s))
    p = jax.lax.dot_general(bx, lmat, (((bx.ndim - 1,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST)
    # Frame-carry recurrence Y[f] = a^S Y[f-1] + p[f, -1] (tiny: B/S long).
    ybase, _ = _iir_scan(p[..., -1], a_arr ** s, 1.0, y0)
    y0b = jnp.broadcast_to(jnp.asarray(y0, x.dtype), lead)[..., None]
    yprev = jnp.concatenate([y0b, ybase[..., :-1]], axis=-1)
    apow = a_arr ** jnp.arange(1, s + 1, dtype=x.dtype)
    y = p + yprev[..., None] * apow
    return y.reshape(lead + (blk,)), ybase[..., -1]


def iir_first_order_varcoef(x: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray,
                            y0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Same as :func:`iir_first_order` but with per-sample coefficients
    (needed by the AGC, whose decay depends on the signal)."""
    bx = b * x
    bx = bx.at[..., 0].add(a[..., 0] * y0)
    a = a.at[..., 0].set(jnp.ones_like(a[..., 0]))

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    _, y = jax.lax.associative_scan(combine, (a, bx), axis=-1)
    return y, y[..., -1]
