"""Float64 numpy model of the analog receive chains — the plain reference
that device output is compared with (``chip_smoke.py``,
``tests/test_chains64.py``).

Each stage's math is restated from the stage's bound parameters in float64,
in the reference's unfused order: band-pass filter, NCO mix and averaging
decimator (src/baseband.hh:198-223); quadrature discriminator; de-emphasis
(src/demod.hh:304-351); AGC (src/utils.hh:762-775); the FSK dual correlator
(src/fsk.cc:68-87).  It runs on one channel's samples starting at absolute
sample index ``start`` (the NCO and correlator phases are global); the
model's own state starts at zero there, so with ``start > 0`` the caller
discards a warm-up before comparing.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def _fir(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """y[n] = sum_i taps[i] * x[n-(N-1)+i] (src/firfilter.hh:231-248)."""
    return np.convolve(x, np.asarray(taps)[::-1])[:len(x)]


def _iq_baseband(st, x, start):
    from libsdr_tpu.ops import firdesign

    fs, d = st.in_spec.rate_hz, st.decim
    design = (firdesign.ref_complex_bandpass if st.design == "ref"
              else firdesign.complex_bandpass)
    k = design(st.order, st.ff, st.width, fs)
    n = np.arange(start, start + len(x))
    shifted = _fir(x, k) * np.exp(-2j * np.pi * st.fc / fs * n)
    m = len(x) // d
    return shifted[:m * d].reshape(m, d).mean(axis=1), start // d


def _stage(st, x, start):
    from libsdr_tpu.ops import (AGC, AMDemod, ASKDetector, FIRFilter,
                                FMDemod, FMDeemph, FSKDetector, IQBaseBand,
                                USBDemod)

    if isinstance(st, IQBaseBand):
        return _iq_baseband(st, x, start)
    if isinstance(st, FIRFilter):
        d = st.decim
        return _fir(x, st.taps)[d - 1::d], start // d
    if isinstance(st, FMDemod) and st.mode == "quadrature":
        prev = np.concatenate([[1.0 + 0.0j], x[:-1]])
        return st.gain * np.angle(x * np.conj(prev)), start
    if isinstance(st, FMDeemph):
        if not st.enabled:
            return x, start
        a = 1.0 - 1.0 / st.alpha
        return lfilter([1.0 / st.alpha], [1.0, -a], x), start
    if isinstance(st, AMDemod):
        return np.abs(x), start
    if isinstance(st, USBDemod):
        return (x.real + x.imag) * 0.5, start
    if isinstance(st, AGC):
        if not st.enabled:
            return x * st.gain, start
        lam = st._lambda
        sd = lfilter([1.0 - lam], [1.0, -lam], np.abs(x),
                     zi=[lam * st.target])[0]
        return x * (st.target / (4.0 * sd)), start
    if isinstance(st, FSKDetector):
        fs, L = st.in_spec.rate_hz, st.corr_len
        ph = 2j * np.pi * ((np.arange(start, start + len(x)) % L) / fs)

        def ring(f):
            c = np.cumsum(x * np.exp(ph * f))
            return c - np.concatenate([np.zeros(L), c[:-L]])[:len(c)]

        f = np.abs(ring(st.f_mark)) ** 2 - np.abs(ring(st.f_space)) ** 2
        return (f > 0).astype(np.uint8), start
    if isinstance(st, ASKDetector):
        return ((x > 0) ^ bool(st.invert)).astype(np.uint8), start
    raise TypeError(f"model64: no float64 model of {type(st).__name__}")


def model_chain(stages, x: np.ndarray, start: int = 0) -> np.ndarray:
    """Run one channel's samples ``x`` (absolute indices ``start`` ..)
    through the float64 model of the bound ``stages``."""
    y = np.asarray(x)
    y = y.astype(np.complex128 if np.iscomplexobj(y) else np.float64)
    for st in stages:
        y, start = _stage(st, y, start)
    return y


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio of ``test`` against ``ref`` in dB."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    p_err = np.sum(err ** 2)
    return float("inf") if p_err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / p_err))
