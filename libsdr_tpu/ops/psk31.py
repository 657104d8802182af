"""BPSK31 demodulator (reference: src/psk31.hh BPSK31<Scalar>).

Structure (reference: src/psk31.hh:114-233): a fractional resampler to 64
samples/symbol driven by a Mueller&Muller-style timing error detector, a
2nd-order carrier PLL (damping sqrt(2)/2, bandwidth pi/100), and differential
decode over the sign of the per-symbol phase-constellation sum (transition ->
0, none -> 1) with early symbol cut on zero crossings.

Inherently sequential per channel -> one ``lax.scan`` over input samples with
all state vectorized over leading channel dims.  Instead of the reference's
64-deep phase history ring we carry the running sum, previous value, and
index — the only quantities the decisions actually use.

Output: Ragged bit stream at 31.25 baud nominal.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.cplx import Complex
from libsdr_tpu.core.ragged import Ragged
from libsdr_tpu.core.stream import ConfigError, StreamSpec
from libsdr_tpu.ops.interpolate import NSTEPS, interpolation_bank

_SUPER = 64  # phase samples per symbol (reference: src/psk31.hh:61)


class BPSK31(Processor):
    """Args:
      df: carrier PLL frequency range (rad/sample), reference default 0.1.
    """

    def __init__(self, df: float = 0.1):
        super().__init__()
        self.df = float(df)
        # Carrier PLL gains (reference: src/psk31.hh:39-44).
        damping = math.sqrt(2) / 2
        bw = math.pi / 100
        tmp = 1.0 + 2 * damping * bw + bw * bw
        self.alpha = 4 * damping * bw / tmp
        self.beta = 4 * bw * bw / tmp
        self.gain_mu = 0.01      # src/psk31.hh:49
        self.gain_omega = 0.001  # src/psk31.hh:56
        self.omega_rel = 0.001

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("BPSK31")
        fs = in_spec.rate_hz
        if fs < 2000:
            raise ConfigError(
                "Can not configure BPSK31: input sample rate too low, "
                f"need >= 2000 Hz, got {fs} (reference: src/psk31.hh:86-92)")
        self._omega0 = fs / (_SUPER * 31.25)  # src/psk31.hh:95
        self._omega_min = self._omega0 * (1 - self.omega_rel)
        self._omega_max = self._omega0 * (1 + self.omega_rel)
        self._bank = jnp.asarray(interpolation_bank())  # (129, 8)
        return in_spec.with_(dtype=jnp.uint8, sample_rate=31.25, ragged=True)

    def init_carry(self):
        ch = self.in_spec.channels
        f32 = jnp.float32
        z = lambda: jnp.zeros(ch, f32)
        return dict(
            P=z(), F=z(),
            mu=jnp.full(ch, 0.25, f32),      # src/psk31.hh:49
            omega=jnp.full(ch, self._omega0, f32),
            dl=cplx.zeros(ch + (8,), f32),
            dl_idx=jnp.zeros((), jnp.int32),
            p0=cplx.zeros(ch, f32), p1=cplx.zeros(ch, f32),
            p2=cplx.zeros(ch, f32),
            c0=z(), c1=z(), c2=z(),
            hist_sum=z(), hist_prev=z(),
            hist_idx=jnp.zeros(ch, jnp.int32),
            last_const=jnp.ones(ch, jnp.int32),  # src/psk31.hh:103
        )

    def apply(self, carry, x):
        bank = self._bank
        alpha, beta = self.alpha, self.beta
        fmin, fmax = -self.df, self.df
        omin, omax = self._omega_min, self._omega_max
        gmu, gom = self.gain_mu, self.gain_omega
        two_pi = 2 * math.pi
        eye8 = jnp.eye(8, dtype=jnp.float32)

        def wrap(p):
            p = jnp.where(p > two_pi, p - two_pi, p)
            return jnp.where(p < -two_pi, p + two_pi, p)

        def step(s, xin):
            xr, xi = xin
            xs = Complex(xr, xi)
            # ---- consume one input sample (src/psk31.hh:197-213)
            mu = s["mu"] - 1.0
            P = wrap(s["P"] + s["F"])
            fac = cplx.exp_i(P)
            samp = fac * xs
            oh = eye8[s["dl_idx"]]
            dl = Complex(s["dl"].re * (1 - oh) + samp.re[..., None] * oh,
                         s["dl"].im * (1 - oh) + samp.im[..., None] * oh)
            dl_idx = (s["dl_idx"] + 1) % 8

            # ---- maybe produce a phase sample (src/psk31.hh:122-155)
            produce = mu <= 1.0
            # win[j] = dl[(dl_idx + j) % 8] (oldest -> newest), applied as
            # a roll of the TAPS by the scalar ring index instead of a
            # per-step gather of the window: sum_j win[j]*taps[j] ==
            # sum_k dl[k]*taps[(k - dl_idx) % 8].  A scalar-shift roll
            # lowers to two dynamic slices instead of an (..., order)
            # gather.
            row = jnp.clip(jnp.round(mu * NSTEPS), 0, NSTEPS).astype(jnp.int32)
            # Per-channel interpolation taps via one-hot matmul rather
            # than a row gather from the (129, 8) bank — exact (one 1.0
            # per row) and gather-free inside the scan body.
            taps = jax.nn.one_hot(row, NSTEPS + 1, dtype=bank.dtype) @ bank
            taps = jnp.roll(taps, dl_idx, axis=-1)
            y = Complex((dl.re * taps).sum(-1), (dl.im * taps).sum(-1))

            # error tracking (src/psk31.hh:216-233)
            p0, p1, p2 = y, s["p0"], s["p1"]
            c0 = jnp.where(y.re > 0, -1.0, 1.0)
            c1, c2 = s["c0"], s["c1"]
            xerr = (Complex(c0 - c2, jnp.zeros_like(c0))) * p1.conj()
            yerr = (p0 - p2) * Complex(c1, jnp.zeros_like(c1)).conj()
            err = jnp.clip(yerr.re - xerr.re, -1.0, 1.0)
            omega = jnp.clip(s["omega"] + gom * err, omin, omax)
            mu_new = mu + omega + gmu * err

            # carrier PLL (src/psk31.hh:186-194)
            nrm2 = y.abs2()
            phi = jnp.where(nrm2 == 0, 0.0, -y.re * y.im / jnp.where(nrm2 == 0, 1.0, nrm2))
            F = jnp.clip(s["F"] + beta * phi, fmin, fmax)
            P2 = wrap(P + F + alpha * phi)

            # phase history / bit decision (src/psk31.hh:131-155)
            hist_idx = s["hist_idx"]
            hprev = s["hist_prev"]
            hsum = s["hist_sum"] + y.re
            transition = ((hprev >= 0) & (y.re <= 0)) | ((hprev <= 0) & (y.re >= 0))
            early = (hist_idx > 1) & transition
            drop = early & (hist_idx < (_SUPER // 2))
            cut = (early & ~drop) | (hist_idx == (_SUPER - 1))
            cconst = jnp.where(hsum > 0, 1, -1)
            bit = (s["last_const"] == cconst).astype(jnp.uint8)
            emit = cut & produce
            last_const = jnp.where(emit, cconst, s["last_const"])
            reset = (drop | cut) & produce
            hist_idx = jnp.where(~produce, hist_idx,
                                 jnp.where(reset, 0, hist_idx + 1))
            hsum = jnp.where(~produce, s["hist_sum"],
                             jnp.where(reset, 0.0, hsum))
            hprev = jnp.where(produce, y.re, hprev)

            ns = dict(
                P=jnp.where(produce, P2, P),
                F=jnp.where(produce, F, s["F"]),
                mu=jnp.where(produce, mu_new, mu),
                omega=jnp.where(produce, omega, s["omega"]),
                dl=dl, dl_idx=dl_idx,
                p0=cplx.where(produce, p0, s["p0"]),
                p1=cplx.where(produce, p1, s["p1"]),
                p2=cplx.where(produce, p2, s["p2"]),
                c0=jnp.where(produce, c0, s["c0"]),
                c1=jnp.where(produce, c1, s["c1"]),
                c2=jnp.where(produce, c2, s["c2"]),
                hist_sum=hsum, hist_prev=hprev, hist_idx=hist_idx,
                last_const=last_const,
            )
            return ns, (bit, emit)

        xr = jnp.moveaxis(x.re, -1, 0)
        xi = jnp.moveaxis(x.im, -1, 0)
        # unroll=8: sequential-loop overhead dominates this scan (see
        # ops/bitsync.py); the body is register-light after the one-hot
        # matmul/taps-roll rewrite, so the deeper unroll amortizes more.
        carry, (bits, valid) = jax.lax.scan(step, carry, (xr, xi), unroll=8)
        return carry, Ragged(jnp.moveaxis(bits, 0, -1),
                             jnp.moveaxis(valid, 0, -1))
