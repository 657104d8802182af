"""Rate conversion: integer averaging decimator, fractional decimator, and a
polyphase-interpolating rational resampler (reference: src/subsample.hh).

The rational resampler exploits an accelerator-friendly property: with a rational rate
ratio p/q and a block size satisfying ``block*q % p == 0``, the number of
outputs per block AND every (input-index, fractional-phase) pair are
compile-time constants.  The whole resampler becomes one static gather of
(n_out, 8) windows times a constant (n_out, 8) tap matrix — no per-sample
loop, no dynamic shapes.
"""

from __future__ import annotations

from fractions import Fraction
import math

import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.stream import ConfigError, StreamSpec
from libsdr_tpu.ops.interpolate import CENTER, NSTEPS, NTAPS, interpolation_bank


class SubSample(Processor):
    """Averaging decimator: out[j] = mean(x[j*n:(j+1)*n])
    (reference: src/subsample.hh:15-115 SubSample).

    Args:
      n: decimation factor; or
      out_rate: target rate, n = max(1, floor(fs/out_rate))
        (reference: src/subsample.hh:52-54).
    """

    def __init__(self, n: int = None, out_rate: float = None):
        super().__init__()
        if (n is None) == (out_rate is None):
            raise ValueError("SubSample: give exactly one of n / out_rate")
        self.n = None if n is None else max(1, int(n))
        self.out_rate = out_rate

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        if self.out_rate is not None:
            self.n = max(1, int(in_spec.rate_hz / self.out_rate))
        in_spec.require_block_multiple("SubSample", self.n)
        return in_spec.with_(sample_rate=in_spec.sample_rate / self.n,
                             block_size=in_spec.block_size // self.n)

    def apply(self, carry, x):
        if self.n == 1:
            return carry, x
        y = x.reshape(x.shape[:-1] + (-1, self.n)).mean(axis=-1)
        return carry, y


class FracSubSample(SubSample):
    """Fractional decimator with the reference's exact behavior.

    NOTE (behavioral quirk, reproduced deliberately): the reference's
    FracSubSampleBase resets its 16.16 phase accumulator to zero on every
    emission instead of keeping the remainder (reference:
    src/subsample.hh:168-175), so it degenerates to a fixed averaging
    decimator by ``ceil(frac)``.  We mirror that so fixtures match; use
    :class:`Resampler` for true fractional rates.
    """

    def __init__(self, frac: float):
        if frac < 1:
            raise ConfigError(
                f"FracSubSample: can not sub-sample with fraction < 1: {frac}")
        period = int(frac * (1 << 16))  # reference: src/subsample.hh:137
        super().__init__(n=math.ceil(period / (1 << 16)))
        self.frac = frac


class Resampler(Processor):
    """Polyphase-interpolating rational resampler
    (reference: src/subsample.hh:194-288 InpolSubSampler, generalized to
    up- and down-sampling).

    Produces output at rate ``fs*q/p`` using the 8-tap fractional-delay bank
    of :mod:`libsdr_tpu.ops.interpolate`.  Requires ``block*q % p == 0`` so
    each block yields a static ``block*q/p`` outputs; then all gather indices
    and tap rows are compile-time constants.

    Output o at time ``t = (T0 + o*p)/q`` input samples (T0 = 3q fixed
    pipeline latency) interpolates window ``x[n-3 .. n+4]``, n = floor(t).
    Like the reference, do not downsample by more than ~8 without prior
    low-pass filtering (src/subsample.hh:188-192).
    """

    def __init__(self, frac=None, p: int = None, q: int = None):
        super().__init__()
        if frac is not None:
            f = Fraction(frac).limit_denominator(1 << 16)
            p, q = f.numerator, f.denominator
        if not p or not q:
            raise ValueError("Resampler: give frac or p and q")
        g = math.gcd(p, q)
        self.p, self.q = p // g, q // g

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        b = in_spec.block_size
        p, q = self.p, self.q
        if (b * q) % p:
            raise ConfigError(
                f"Resampler: block_size*q ({b}*{q}) must be divisible by p "
                f"({p}); pick a block size that is a multiple of "
                f"{p // math.gcd(p, q * b // math.gcd(b, p))}")
        n_out = b * q // p
        t0 = 3 * q  # fixed latency keeps every window inside concat(tail, x)
        times = t0 + np.arange(n_out, dtype=np.int64) * p
        n = times // q                       # floor input index per output
        mu = (times % q) / q                 # fractional part in [0,1)
        rows = np.round((1.0 - mu) * NSTEPS).astype(np.int64)
        bank = interpolation_bank()          # (NSTEPS+1, NTAPS)
        self._weights = jnp.asarray(bank[rows])          # (n_out, 8) constant
        idx = (n[:, None] - (CENTER - 1)) + np.arange(NTAPS)[None, :]
        assert idx.min() >= 0 and idx.max() <= b + NTAPS - 2, "window bounds"
        self._idx = jnp.asarray(idx)                      # (n_out, 8) constant
        self._n_out = n_out
        return in_spec.with_(sample_rate=in_spec.sample_rate * q / p,
                             block_size=n_out)

    def init_carry(self):
        shape = self.in_spec.channels + (NTAPS - 1,)
        if self.in_spec.is_complex:
            return cplx.zeros(shape, self.in_spec.real_dtype)
        return jnp.zeros(shape, self.in_spec.dtype)

    def apply(self, carry, x):
        xc = cplx.concatenate([carry, x], axis=-1)       # (..., B+7)
        win = xc[..., self._idx]                          # (..., n_out, 8)
        w = self._weights.astype(self.in_spec.real_dtype)
        y = (win * w).sum(axis=-1)
        return xc[..., xc.shape[-1] - (NTAPS - 1):], y


class InpolSubSampler(Resampler):
    """Reference-named alias: sub-sample by ``frac`` (output rate = fs/frac)
    (reference: src/subsample.hh:194-288)."""

    def __init__(self, frac: float):
        if frac <= 0:
            raise ConfigError(
                "InpolSubSampler: sample rate fraction must be > 0, "
                f"got {frac}")
        f = Fraction(frac).limit_denominator(1 << 16)
        super().__init__(p=f.numerator, q=f.denominator)
