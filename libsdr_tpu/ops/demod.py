"""Analog demodulators: AM, SSB(USB), FM, FM de-emphasis
(reference: src/demod.hh).

All are elementwise or first-order ops, so XLA fuses them into the
surrounding pipeline; none needs a hand-written kernel.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.stream import StreamSpec, real_dtype_of
from libsdr_tpu.ops.iir import iir_first_order


class AMDemod(Processor):
    """AM envelope: ``|x| = sqrt(re^2 + im^2)``
    (reference: src/demod.hh:73-76)."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("AMDemod")
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype))

    def apply(self, carry, x):
        return carry, x.abs()


class USBDemod(Processor):
    """SSB demod as ``(re + im)/2`` after baseband shift
    (reference: src/demod.hh:156-160).  LSB is obtained by selecting the
    negative band in IQBaseBand (reference: examples/sdr_rec.cc:53-58)."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("USBDemod")
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype))

    def apply(self, carry, x):
        return carry, (x.re + x.im) * 0.5


class FMDemod(Processor):
    """Quadrature FM discriminator.

    mode='quadrature' (default): ``y[n] = angle(x[n] * conj(x[n-1]))`` — the
    standard polar discriminator, output in radians/sample in [-pi, pi).
    Carry is the previous complex sample.

    mode='ref': float model of the reference's integer formula
    (reference: src/demod.hh:242-254): ``phi[n] = atan2(re, im)/2`` and
    ``y[n] = phi[n-1] - phi[n]`` — half-angle differences, no unwrap.  The
    reference's fast_atan2 maps +-pi to +-2^14 in int16
    (reference: src/math.hh:31-40); here angles are radians.

    Args:
      gain: output scale; default 1.0 (radians).  Use
        ``fs/(2*pi*deviation)`` to normalize a given FM deviation to +-1.
    """

    def __init__(self, mode: str = "quadrature", gain: float = 1.0):
        super().__init__()
        self.mode = mode
        self.gain = float(gain)
        # Mixer rotations folded in by the graph fusion pass (core/fuse.py):
        # an upstream NCO e^(-i w n) collapses to the constant e^(-i w) in
        # the x[n]*conj(x[n-1]) product.
        self._pending_rot_freqs: list = []
        self._rot = None

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FMDemod")
        if self._pending_rot_freqs:
            w = 2.0 * np.pi * sum(self._pending_rot_freqs) / in_spec.rate_hz
            self._rot = cplx.constant(np.exp(-1j * w), in_spec.real_dtype)
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype))

    def init_carry(self):
        ch = self.in_spec.channels
        if self.mode == "quadrature":
            phasor = cplx.full_like_phasor(ch, self.in_spec.real_dtype)
            if self._rot is not None:
                # Cancel the folded rotation on the very first sample so the
                # initial transient matches the unfused graph exactly.
                phasor = phasor * self._rot
            return phasor
        return jnp.zeros(ch, self.out_spec.dtype)  # prev half-angle

    def apply(self, carry, x):
        if self.mode == "quadrature":
            prev = cplx.concatenate([carry[..., None], x[..., :-1]], axis=-1)
            z = x * prev.conj()
            if self._rot is not None:
                z = z * self._rot
            y = z.angle() * self.gain
            return x[..., -1], y
        # -- 'ref' mode ------------------------------------------------------
        phi = jnp.arctan2(x.re, x.im) * 0.5
        prev_phi = jnp.concatenate([carry[..., None], phi[..., :-1]], axis=-1)
        y = (prev_phi - phi) * self.gain
        return phi[..., -1], y


class FMDeemph(Processor):
    """FM de-emphasis: 75 us single-pole low-pass
    (reference: src/demod.hh:271-362).

    The reference's integer update ``avg += (x - avg)/alpha`` with
    ``alpha = round(1/(1 - exp(-1/(fs*75e-6))))`` (src/demod.hh:304-306) is the
    Euler form of ``y[n] = (1-1/alpha) y[n-1] + (1/alpha) x[n]``; we run that
    recurrence as an O(log B) associative scan.

    Args:
      tau: time constant in seconds (75e-6 for US/EU FM broadcast).
      enabled: bypass flag (reference: src/demod.hh:287-291).
    """

    def __init__(self, tau: float = 75e-6, enabled: bool = True):
        super().__init__()
        self.tau = float(tau)
        self.enabled = enabled

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("FMDeemph")
        fs = in_spec.rate_hz
        # reference: src/demod.hh:304-306
        alpha = round(1.0 / (1.0 - math.exp(-1.0 / (fs * self.tau))))
        self.alpha = max(1, int(alpha))
        self._a = 1.0 - 1.0 / self.alpha
        self._b = 1.0 / self.alpha
        return in_spec

    def init_carry(self):
        return jnp.zeros(self.in_spec.channels, self.in_spec.dtype)

    def apply(self, carry, x):
        if not self.enabled:
            return carry, x
        y, last = iir_first_order(x, self._a, self._b, carry)
        return last, y
