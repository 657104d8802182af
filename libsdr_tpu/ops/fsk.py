"""FSK/ASK symbol detection (reference: src/fsk.{hh,cc} FSKDetector and
ASKDetector).

The reference's FSKDetector is a per-sample dual tone correlator: it keeps
rings ``markHist[i] = x[n] * markLUT[n mod L]`` and decides
``|sum(markHist)|^2 - |sum(spaceHist)|^2 > 0`` — an O(L) loop per sample
(SURVEY.md 3.4 flags it as the hottest loop in the AX.25 chain).

Block formulation: the ring sum at sample n is a *sliding window sum*
of ``u[k] = x[k] * T[k mod L]`` over the last L samples, so the whole
detector is one elementwise multiply by a tiled tone template plus a length-L
boxcar convolution per tone — O(1) per sample instead of O(L).
The template phase is tied to the absolute sample index mod L (carry), which
reproduces the reference's ring indexing exactly, including the phase jump
where the tone template wraps (src/fsk.cc:40-49).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.cplx import Complex
from libsdr_tpu.core.stream import StreamSpec
from libsdr_tpu.ops.fir import _conv1d_real

_S = 128          # frame width for the banded-matmul sliding sum
_WMAT_CACHE: dict = {}


def _window_mat(L: int) -> np.ndarray:
    """((npv+1)*S, S) 0/1 band matrix for the length-L sliding sum over
    S-sample frames with npv = ceil((L-1)/S) previous frames of context:
    with ``w`` one row of stacked frames [G[f] .. G[f+npv]] (current frame
    LAST), ``w @ M`` gives s[o] = sum of the L samples ending at the
    current frame's offset o.  A length-L boxcar conv computes the same
    sums, but small-feature convs are slow on the CPU; the banded matmul is
    one GEMM."""
    npv = -(-(L - 1) // _S)
    rows = (npv + 1) * _S
    m = np.zeros((rows, _S), np.float32)
    for o in range(_S):
        end = npv * _S + o                 # absolute index of output o
        m[max(0, end - L + 1):end + 1, o] = 1.0
    return m


def sliding_sum(tail: Complex, u: Complex, L: int):
    """Length-L sliding sum over ``concat([tail, u])`` ending at each
    sample of ``u`` (the FSK correlator's ring sum, src/fsk.cc:68-87).
    Returns (sums (..., B) Complex, new_tail (..., L-1) Complex).

    128-aligned blocks take the banded matmul (one GEMM pass over
    S-sample frames with ceil((L-1)/S) frames of context); others fall
    back to the length-L boxcar conv."""
    import jax

    b = u.shape[-1]
    if b % _S == 0:
        from libsdr_tpu.ops.utils import to_device_cached
        mat = to_device_cached(_WMAT_CACHE, L, lambda: _window_mat(L))
        npv = -(-(L - 1) // _S)
        f = b // _S
        prec = jax.lax.Precision.HIGHEST

        def sums(tail_p, up):
            lead = jnp.zeros(
                up.shape[:-1] + (npv * _S - (L - 1),), up.dtype)
            g = jnp.concatenate([lead, tail_p, up], axis=-1)
            # Slice the FLAT stream, then reshape the piece — slicing a
            # reshape materializes the whole reshaped array on this
            # backend (~3 ms per 128 MB, measured).
            w = jnp.concatenate(
                [g[..., i * _S:(i + f) * _S].reshape(
                    up.shape[:-1] + (f, _S))
                 for i in range(npv + 1)],
                axis=-1)                    # (..., F, (npv+1)S)
            s = jnp.matmul(w, mat, precision=prec)
            return s.reshape(up.shape)

        s = Complex(sums(tail.re, u.re), sums(tail.im, u.im))
        full = cplx.concatenate([tail, u], axis=-1)
        # explicit index, not [-(L-1):] — at L == 1 that slice would be
        # [-0:] == the whole array instead of the empty tail
        return s, full[..., full.shape[-1] - (L - 1):]

    ones = jnp.asarray(np.ones(L, np.float32))
    full = cplx.concatenate([tail, u], axis=-1)
    s = Complex(_conv1d_real(full.re, ones, 1),
                _conv1d_real(full.im, ones, 1))
    return s, full[..., full.shape[-1] - (L - 1):]


class FSKDetector(Processor):
    """Mark/space dual correlator -> symbol (sub-bit) stream at input rate.

    Args:
      baud: baud rate (sets correlator length L = floor(fs/baud),
        reference: src/fsk.cc:32).
      f_mark, f_space: tone frequencies in Hz.
    """

    def __init__(self, baud: float, f_mark: float, f_space: float):
        super().__init__()
        self.baud = float(baud)
        self.f_mark = float(f_mark)
        self.f_space = float(f_space)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("FSKDetector")
        fs = in_spec.rate_hz
        L = int(fs / self.baud)
        self.corr_len = L
        b = in_spec.block_size
        i = np.arange(L)
        # Continuous-phase tone templates over one ring period
        # (reference: src/fsk.cc:39-49; positive exponent), pre-tiled to
        # block + L so the per-block template T[(n0 + j) mod L] is ONE
        # dynamic lane slice at the carried phase n0 — not a (B,)-index
        # gather from an (L,) table.
        mark = np.exp(2j * np.pi * self.f_mark * i / fs)
        space = np.exp(2j * np.pi * self.f_space * i / fs)
        reps = -(-(b + L) // L)
        self._mark = cplx.constant(np.tile(mark, reps)[:b + L])
        self._space = cplx.constant(np.tile(space, reps)[:b + L])
        return in_spec.with_(dtype=jnp.uint8)

    def init_carry(self):
        L = self.corr_len
        ch = self.in_spec.channels
        # (phase index n mod L, tail of last L-1 u_mark/u_space values)
        return (jnp.zeros((), jnp.int32),
                cplx.zeros(ch + (L - 1,)),
                cplx.zeros(ch + (L - 1,)))

    def apply(self, carry, x):
        import jax

        n0, tail_m, tail_s = carry
        L = self.corr_len
        b = self.in_spec.block_size
        x = x.astype(jnp.float32)
        # template phase n0: one dynamic slice of the pre-tiled template
        tm = Complex(jax.lax.dynamic_slice(self._mark.re, (n0,), (b,)),
                     jax.lax.dynamic_slice(self._mark.im, (n0,), (b,)))
        ts = Complex(jax.lax.dynamic_slice(self._space.re, (n0,), (b,)),
                     jax.lax.dynamic_slice(self._space.im, (n0,), (b,)))
        u_m = tm * x    # Complex * real array
        u_s = ts * x

        s_m, tail_m = sliding_sum(tail_m, u_m, L)
        s_s, tail_s = sliding_sum(tail_s, u_s, L)
        f = s_m.abs2() - s_s.abs2()  # reference: src/fsk.cc:81-86
        sym = (f > 0).astype(jnp.uint8)
        return ((n0 + b) % L, tail_m, tail_s), sym


class ASKDetector(Processor):
    """Threshold-at-zero symbol detector (for FM-demodulated FSK, e.g.
    POCSAG; reference: src/fsk.hh:69-118): symbol = (x > 0) ^ invert."""

    def __init__(self, invert: bool = False):
        super().__init__()
        self.invert = invert

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("ASKDetector")
        return in_spec.with_(dtype=jnp.uint8)

    def apply(self, carry, x):
        sym = (x > 0)
        if self.invert:
            sym = jnp.logical_not(sym)
        return carry, sym.astype(jnp.uint8)
