"""Baseband selection — fused band-pass filter + NCO shift + averaging
decimator (reference: src/baseband.hh IQBaseBand / BaseBand).

The reference computes, per input sample n (src/baseband.hh:198-223):

    filt[n]  = sum_i k[i] * x[n-N+1+i]          (complex band-pass at Ff)
    shift[n] = filt[n] * exp(-i w n)             (w = 2 pi Fc / fs)
    out[j]   = mean(shift[j*D : (j+1)*D])        (averaging decimator)

Fusion (exactly equal in exact arithmetic): commute the NCO in
front of the filter with a phase-corrected kernel, and fold the boxcar
average into the kernel —

    x~[m]  = x[m] * exp(-i w m)                  (one elementwise multiply)
    k'[i]  = k[i] * exp(-i w (N-1-i))            (host-side constant)
    g      = full_conv(k', ones(D)/D)            (length N+D-1 taps)
    out[j] = sum_m g[m] * x~[j*D - (N-1) + m]    (ONE strided convolution)

and then commute the NCO all the way through to the *decimated* side — the
chain is bandwidth-bound, so the full-rate mixed intermediate x~ (one HBM
write + one read of the whole stream) is the single biggest cost.  With
g2[i] = g[i] * exp(-i w (i - (T-1) + offset)) (another host-side constant):

    out[j] = exp(-i w D j) * sum_i g2[i] * x[j*D + offset - (T-1) + i]

i.e. ONE strided convolution over the RAW input followed by an NCO running
at the output rate (D times fewer phasor evaluations, no full-rate
intermediate).  Exactly equal in exact arithmetic.
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.graph import Pipeline
from libsdr_tpu.core.stream import ConfigError, StreamSpec
from libsdr_tpu.ops import firdesign
from libsdr_tpu.ops.fir import FIRFilter
from libsdr_tpu.ops.nco import FreqShift
from libsdr_tpu.ops.utils import ToComplex


def fused_baseband_taps(kernel: np.ndarray, fc: float, fs: float,
                        decim: int) -> np.ndarray:
    """Fold the post-filter NCO phase and the boxcar decimator into the
    band-pass kernel (see module docstring)."""
    n = kernel.shape[0]
    i = np.arange(n)
    w = 2 * np.pi * fc / fs
    kp = kernel.astype(np.complex128) * np.exp(-1j * w * (n - 1 - i))
    if decim > 1:
        box = np.full(decim, 1.0 / decim)
        kp = np.convolve(kp, box, mode="full")
    return kp


class IQBaseBand(Processor):
    """Select a band around Fc from a complex IQ stream, shift it to DC and
    decimate (reference: src/baseband.hh:21-294 IQBaseBand).

    Args:
      fc: center frequency to shift to DC.
      ff: band-pass filter center (defaults to fc, matching the reference's
        two constructors, src/baseband.hh:35-56).
      width: filter bandwidth in Hz.
      order: FIR order N.
      decim: integer decimation D (``sub_sample``); mutually exclusive with
        ``out_rate``.
      out_rate: target output rate; D = floor(fs/out_rate), mirroring
        src/baseband.hh:158-162.
      design: 'ref' uses the reference's exact kernel math
        (src/baseband.hh:239-262) — default, for parity; 'textbook' uses the
        clean complex band-pass designer.
    """

    def __init__(self, fc: float, width: float, order: int, decim: int = 1,
                 ff: float = None, out_rate: float = None,
                 design: str = "ref"):
        super().__init__()
        self.fc = float(fc)
        self.ff = float(fc if ff is None else ff)
        self.width = float(width)
        self.order = max(1, int(order))
        self.decim = int(decim)
        self.out_rate = out_rate
        self.design = design
        # Set by the graph fusion pass (core/fuse.py) when the immediate
        # consumer is rotation-invariant (AMDemod) or folds the rotation
        # into its conjugate product (quadrature FMDemod): skip the
        # output-rate NCO entirely and emit the unrotated FIR output.
        self.fold_nco = False
        self._inner: Pipeline | None = None

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("IQBaseBand")
        fs = in_spec.rate_hz
        if self.out_rate is not None:
            self.decim = max(1, int(fs / self.out_rate))  # src/baseband.hh:158-162
        if self.decim < 1:
            raise ConfigError("IQBaseBand: decim must be >= 1")
        in_spec.require_block_multiple("IQBaseBand", self.decim)
        if self.design == "ref":
            k = firdesign.ref_complex_bandpass(self.order, self.ff, self.width, fs)
        else:
            k = firdesign.complex_bandpass(self.order, self.ff, self.width, fs)
        g = fused_baseband_taps(k, self.fc, fs, self.decim)
        # Commute the NCO through the convolution to the decimated side (see
        # module docstring): conv taps pick up the per-tap phase, the output
        # is mixed by exp(-i w D j) — which is exactly FreqShift(fc) bound at
        # the OUTPUT rate fs/D (2 pi fc / (fs/D) = w D), whose phasor carry
        # tracks the global output index.
        t = len(g)
        w = 2 * np.pi * self.fc / fs
        offset = self.decim - 1  # FIRFilter's first-output offset
        g2 = g * np.exp(-1j * w * (np.arange(t) - (t - 1) + offset))
        stages = [FIRFilter(order=t, kind="custom", taps=g2, decim=self.decim)]
        if not self.fold_nco:
            stages.append(FreqShift(self.fc))
        self._inner = Pipeline(stages, name="IQBaseBand")
        return self._inner.bind(in_spec)

    def init_carry(self):
        return self._inner.init_carry()

    def apply(self, carry, x):
        return self._inner.apply(carry, x)


class BaseBand(IQBaseBand):
    """Real-input variant (reference: src/baseband.hh:304-529 BaseBand):
    band-pass filter a real stream, shift the band at Fc down to DC, and
    decimate; output is complex baseband."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("BaseBand")
        cplx = ToComplex()
        cspec = cplx.bind(in_spec)
        out = super()._bind(cspec)
        self._inner.stages.insert(0, cplx)
        # Rebind to refresh stage bookkeeping with the ToComplex included.
        self._inner = Pipeline(self._inner.stages, name="BaseBand")
        return self._inner.bind(in_spec)
