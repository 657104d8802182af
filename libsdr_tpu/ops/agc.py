"""Automatic gain control (reference: src/utils.hh:657-793 AGC).

The reference tracks an exponential envelope per sample::

    sd[n]   = lambda*sd[n-1] + (1-lambda)*|x[n]|,  lambda = exp(-1/(tau*fs))
    gain[n] = target / (4*sd[n])
    y[n]    = gain[n] * x[n]

The envelope is a first-order linear recurrence, so it runs as an O(log B)
associative scan (see :mod:`libsdr_tpu.ops.iir`); the gain division and
multiply are elementwise.  This is numerically identical to the reference's
float loop, not an approximation.

The reference's per-dtype default targets (64 for 8-bit, 16000 for 16-bit,
0.5 for float — src/utils.hh:668-687) collapse to 0.5 here because the device
pipeline is float-normalized.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.stream import StreamSpec, real_dtype_of
from libsdr_tpu.ops.iir import iir_first_order


class AGC(Processor):
    """Args:
      tau: envelope time constant in seconds (reference default 0.1).
      target: output target level (reference float default 0.5).
      enabled: if False, applies the frozen ``gain`` only
        (reference: src/utils.hh:762-775).
      gain: initial/frozen gain.
    """

    def __init__(self, tau: float = 0.1, target: float = 0.5,
                 enabled: bool = True, gain: float = 1.0):
        super().__init__()
        self.tau = float(tau)
        self.target = float(target)
        self.enabled = enabled
        self.gain = float(gain)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        self._lambda = math.exp(-1.0 / (self.tau * in_spec.rate_hz))
        return in_spec

    def init_carry(self):
        # sd initialized to target (reference: src/utils.hh:692)
        rdt = real_dtype_of(self.in_spec.dtype)
        return jnp.full(self.in_spec.channels, self.target, rdt)

    def apply(self, carry, x):
        if not self.enabled:
            return carry, x * self.gain
        env = x.abs() if cplx.is_complex(x) else jnp.abs(x)
        sd, sd_last = iir_first_order(
            env, self._lambda, 1.0 - self._lambda, carry)
        gain = self.target / (4.0 * sd)
        return sd_last, x * gain
