"""Per-sample numpy simulators of the reference algorithms, used as golden
oracles.  These re-state the reference's *math* (with file:line citations) in
plain numpy — sample-by-sample, exactly as the C++ loops do in float — so the
block-streaming device ops can be tested for equivalence without compiling the
reference.
"""

from __future__ import annotations

import numpy as np


def fir_ring(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Reference FIR ring-buffer loop (src/firfilter.hh:231-248): ring starts
    zeroed; y[n] = sum_i taps[i] * x[n-(N-1)+i]."""
    n_taps = len(taps)
    dtype = np.result_type(x.dtype, taps.dtype, np.float64)
    xp = np.concatenate([np.zeros(n_taps - 1, dtype=dtype), x.astype(dtype)])
    y = np.zeros(len(x), dtype=dtype)
    for n in range(len(x)):
        y[n] = np.dot(taps, xp[n:n + n_taps])
    return y


def iq_baseband(x: np.ndarray, kernel: np.ndarray, fc: float, fs: float,
                decim: int) -> np.ndarray:
    """Reference IQBaseBand per-sample loop in float
    (src/baseband.hh:198-223): band-pass filter on ring buffer, exact NCO
    shift by -fc, average every `decim` samples."""
    n_taps = len(kernel)
    xp = np.concatenate([np.zeros(n_taps - 1, dtype=np.complex128),
                         x.astype(np.complex128)])
    out = []
    acc = 0.0 + 0.0j
    w = 2 * np.pi * fc / fs
    for n in range(len(x)):
        filt = np.dot(kernel, xp[n:n + n_taps])
        acc += filt * np.exp(-1j * w * n)
        if (n + 1) % decim == 0:
            out.append(acc / decim)
            acc = 0.0 + 0.0j
    return np.asarray(out, dtype=np.complex128)


def fm_demod_quadrature(x: np.ndarray, prev=1.0 + 0.0j) -> np.ndarray:
    """Polar discriminator: y[n] = angle(x[n] * conj(x[n-1]))."""
    xp = np.concatenate([[prev], x.astype(np.complex128)])
    return np.angle(xp[1:] * np.conj(xp[:-1]))


def fm_deemph(x: np.ndarray, fs: float, tau: float = 75e-6) -> np.ndarray:
    """Reference FMDeemph in float (src/demod.hh:304-351):
    alpha = round(1/(1-exp(-1/(fs*tau)))); avg += (x-avg)/alpha."""
    alpha = max(1, round(1.0 / (1.0 - np.exp(-1.0 / (fs * tau)))))
    y = np.zeros_like(x, dtype=np.float64)
    avg = 0.0
    for n in range(len(x)):
        avg += (x[n] - avg) / alpha
        y[n] = avg
    return y


def agc(x: np.ndarray, fs: float, tau: float = 0.1,
        target: float = 0.5) -> np.ndarray:
    """Reference AGC loop (src/utils.hh:762-775)."""
    lam = np.exp(-1.0 / (tau * fs))
    sd = target
    y = np.zeros_like(x, dtype=np.complex128 if np.iscomplexobj(x) else np.float64)
    for n in range(len(x)):
        sd = lam * sd + (1 - lam) * abs(x[n])
        gain = target / (4 * sd)
        y[n] = gain * x[n]
    return y


def subsample_avg(x: np.ndarray, n: int) -> np.ndarray:
    """Reference SubSample loop (src/subsample.hh:92-101)."""
    m = len(x) // n
    return x[:m * n].reshape(m, n).mean(axis=1)


def freq_shift_lut(x: np.ndarray, freq: float, fs: float,
                   lut_size: int = 128) -> np.ndarray:
    """Reference quantized-LUT NCO in float (src/freqshift.hh:58-87)."""
    lut = np.exp(-2j * np.pi * np.arange(lut_size) / lut_size)
    inc = int(lut_size * 256 * abs(freq) / fs)
    count = 0
    y = np.zeros_like(x, dtype=np.complex128)
    for n in range(len(x)):
        if inc == 0:
            y[n] = x[n]
            continue
        idx = count >> 8
        if freq < 0:
            idx = lut_size - idx - 1
        y[n] = x[n] * lut[idx]
        count = (count + inc) % (lut_size << 8)
    return y
