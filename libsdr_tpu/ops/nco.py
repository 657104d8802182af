"""NCO frequency shift — the array-native replacement for the reference's
integer LUT mixer (reference: src/freqshift.hh FreqShiftBase).

Two modes:

* ``exact`` (default) — closed-form block ramp.  The per-block mixing vector
  ``exp(-2j pi f arange(B)/fs)`` is a host-computed float64 constant; the
  carry is a single unit phasor advanced by ``exp(-2j pi f B/fs)`` per block
  and renormalized, so phase error does not accumulate.  This replaces the
  reference's per-sample phase accumulator (src/freqshift.hh:58-74) with an
  elementwise multiply that XLA fuses into neighboring ops.

* ``lut`` — bit-faithful model of the reference's quantized NCO: a 128-entry
  complex LUT indexed by an integer 8.8 fixed-point phase accumulator with
  increment ``floor(128*256*|f|/fs)`` (reference: src/freqshift.hh:78-87),
  negative frequencies using the mirrored index ``lut_size-idx-1``
  (src/freqshift.hh:65).  Carry is the int32 accumulator; used for
  reference-parity fixtures.

Complex data is planar (:mod:`libsdr_tpu.core.cplx`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.stream import StreamSpec

_LUT_SIZE = 128  # reference: src/freqshift.hh:103


def nco_ramp(freq: float, fs: float, n: int) -> np.ndarray:
    """exp(-2j pi freq arange(n) / fs) computed in float64 on host."""
    ph = -2.0 * np.pi * freq * np.arange(n, dtype=np.float64) / fs
    return np.exp(1j * ph)


class FreqShift(Processor):
    """Mix a complex stream by ``exp(-2j pi f t)`` (shift frequency f down to DC).

    Args:
      freq: shift frequency in Hz.  Positive f shifts the band at +f to 0,
        matching the reference's convention (negative-exponent LUT,
        src/freqshift.hh:32-35).
      mode: 'exact' or 'lut' (see module docstring).
    """

    def __init__(self, freq: float, mode: str = "exact"):
        super().__init__()
        self.freq = float(freq)
        self.mode = mode

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FreqShift")
        fs = in_spec.rate_hz
        b = in_spec.block_size
        rdt = in_spec.real_dtype
        if self.mode == "exact":
            self._ramp = cplx.constant(nco_ramp(self.freq, fs, b), rdt)
            self._block_step = cplx.constant(
                np.exp(-2j * np.pi * self.freq * b / fs), rdt)
        elif self.mode == "lut":
            # reference: src/freqshift.hh:29-35 — LUT of exp(-2 pi i k/128);
            # float magnitude 1 here (the 1<<shift scaling is fixed-point only).
            k = np.arange(_LUT_SIZE)
            self._lut = cplx.constant(np.exp(-2j * np.pi * k / _LUT_SIZE), rdt)
            # increment per sample in 8.8 fixed point (src/freqshift.hh:85)
            self._lut_inc = int(_LUT_SIZE * 256 * abs(self.freq) / fs)
            self._modulus = _LUT_SIZE << 8
        else:
            raise ValueError(f"unknown FreqShift mode {self.mode!r}")
        return in_spec

    def init_carry(self):
        if self.mode == "exact":
            return cplx.full_like_phasor((), self.in_spec.real_dtype)
        return jnp.asarray(0, dtype=jnp.int32)

    def apply(self, carry, x):
        if self.freq == 0.0:
            return carry, x
        if self.mode == "exact":
            y = x * (carry * self._ramp)
            nxt = carry * self._block_step
            nxt = nxt / nxt.abs()  # keep |phasor| = 1 across blocks
            return nxt, y
        # --- lut mode -----------------------------------------------------
        b = self.in_spec.block_size
        counts = (carry + jnp.arange(b, dtype=jnp.int32) * self._lut_inc) % self._modulus
        idx = counts >> 8
        if self.freq < 0:
            idx = _LUT_SIZE - idx - 1  # reference: src/freqshift.hh:65
        y = x * self._lut[idx]
        nxt = (carry + b * self._lut_inc) % self._modulus
        return nxt.astype(jnp.int32), y
