"""Test-signal generation (reference: src/siggen.hh SigGen/IQSigGen and
src/utils.hh:906-980 GWNSource).

These are host-side numpy generators (fixtures are produced once, then
streamed), plus a jittable white-noise source for on-device benchmarks.
"""

from __future__ import annotations

import numpy as np


def sine(fs: float, n: int, freqs, amps=None, phases=None,
         dtype=np.float32) -> np.ndarray:
    """Sum of real sines (reference: src/siggen.hh SigGen)."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    amps = np.ones_like(freqs) if amps is None else np.atleast_1d(amps)
    phases = np.zeros_like(freqs) if phases is None else np.atleast_1d(phases)
    t = np.arange(n, dtype=np.float64) / fs
    out = sum(a * np.sin(2 * np.pi * f * t + p)
              for f, a, p in zip(freqs, amps, phases))
    return out.astype(dtype)


def iq_carrier(fs: float, n: int, freq: float, amp: float = 1.0,
               phase: float = 0.0, dtype=np.complex64) -> np.ndarray:
    """Complex exponential carrier (reference: src/siggen.hh IQSigGen)."""
    t = np.arange(n, dtype=np.float64) / fs
    return (amp * np.exp(1j * (2 * np.pi * freq * t + phase))).astype(dtype)


def gaussian_noise(n, std: float = 1.0, complex_: bool = False,
                   seed: int = 0, dtype=None) -> np.ndarray:
    """Gaussian white noise (reference: src/utils.hh:957-969 GWNSource uses a
    Box-Muller polar method; any exact-distribution generator is equivalent)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if np.isscalar(n) else tuple(n)
    if complex_:
        z = rng.normal(0, std / np.sqrt(2), shape + (2,))
        out = (z[..., 0] + 1j * z[..., 1]).astype(dtype or np.complex64)
    else:
        out = rng.normal(0, std, shape).astype(dtype or np.float32)
    return out


def fm_modulate(fs: float, audio: np.ndarray, deviation: float,
                carrier: float = 0.0, dtype=np.complex64) -> np.ndarray:
    """FM-modulate an audio signal onto an IQ baseband carrier (fixture
    helper; the reference has no modulator — its fixtures are live radio)."""
    phase = 2 * np.pi * np.cumsum(
        carrier + deviation * audio.astype(np.float64)) / fs
    return np.exp(1j * phase).astype(dtype)


def fsk_modulate(fs: float, bits: np.ndarray, baud: float, f_mark: float,
                 f_space: float, dtype=np.complex64) -> np.ndarray:
    """Generate an FSK tone sequence (audio-band, real or complex) from a bit
    vector — fixture helper for the FSK/AX.25/RTTY decode tests."""
    spb = fs / baud
    n = int(round(len(bits) * spb))
    idx = np.minimum((np.arange(n) / spb).astype(np.int64), len(bits) - 1)
    freqs = np.where(np.asarray(bits)[idx] > 0, f_mark, f_space)
    phase = 2 * np.pi * np.cumsum(freqs) / fs
    return np.exp(1j * phase).astype(dtype)


def nrzi(bits: np.ndarray) -> np.ndarray:
    """NRZI line coding as AX.25 sends it: a 0 bit toggles the line."""
    return (np.cumsum(np.asarray(bits) == 0) & 1).astype(np.uint8)


def pocsag_iq(fs: float, text: str, address: int, carrier: float = 0.0,
              n: int = None, start: int = 0,
              deviation: float = 4500.0) -> np.ndarray:
    """A POCSAG page as FM IQ at rate ``fs``: 1200 baud NRZ, mark = -
    ``deviation`` (the reference's POCSAG FSK sense).  ``n`` samples in all
    (default: just the page), the page starting at sample ``start`` on an
    unmodulated ``carrier``."""
    from libsdr_tpu.decode import pocsag_encode_batch

    bits = pocsag_encode_batch(address=address, function=1, text=text)
    spb = fs / 1200.0
    n_page = int(len(bits) * spb)
    n = n_page + start if n is None else int(n)
    k = np.arange(n) - start
    idx = np.clip((k / spb).astype(np.int64), 0, len(bits) - 1)
    audio = np.where(bits[idx] > 0, -1.0, 1.0)
    audio[(k < 0) | (k >= n_page)] = 0.0
    return fm_modulate(fs, audio, deviation, carrier)


# Canonical per-mode payloads of :func:`mixed_band`.
MIXED_BAND_PAYLOADS = {
    "pocsag": ("MIXED BAND", 99),
    "ax25": ("K3MM", "APRS", b"!4903.50N/07201.75W-multimode"),
    "rtty": "RY MULTI",
    "psk31": "cq sdr",
}


def mixed_band(active: "dict[int, str]", m: int,
               ch_bw: float = 24_000.0) -> np.ndarray:
    """Synthesize a wideband capture (rate ``m * ch_bw``) with the
    canonical signal of each mode (:data:`MIXED_BAND_PAYLOADS`) on the
    given {channel: mode} slots: each narrowband signal is made at
    ``ch_bw``, held up to the wideband rate and shifted to its channel
    center."""
    from libsdr_tpu.decode import (ax25_frame_bits, baudot_encode_bits,
                                   varicode_encode_bits)

    fs = m * ch_bw

    def narrow_for(mode):
        p = MIXED_BAND_PAYLOADS[mode]
        if mode == "pocsag":
            return pocsag_iq(ch_bw, text=p[0], address=p[1])
        if mode == "ax25":
            frame = ax25_frame_bits(*p, n_flags=50)
            afsk_audio = fsk_modulate(ch_bw, nrzi(frame), 1200.0 * 1.0017,
                                      1200.0, 2200.0).real
            return fm_modulate(ch_bw, 0.8 * afsk_audio, deviation=3000.0)
        if mode == "rtty":
            half_bits = baudot_encode_bits(p, stop_bits="1.5")
            return fsk_modulate(ch_bw, half_bits, 2 * 45.45, 930.0, 1100.0)
        if mode != "psk31":
            raise ValueError(f"mixed_band: unknown mode {mode!r}")
        vbits = np.concatenate([np.ones(24, np.uint8),
                                varicode_encode_bits(p),
                                np.ones(24, np.uint8)])
        spb = int(round(ch_bw / 31.25))
        phases = np.pi * np.cumsum(vbits == 0)
        return np.exp(1j * np.repeat(phases, spb)).astype(np.complex64)

    narrows = {ch: narrow_for(mode) for ch, mode in active.items()}
    n = int(fs * (max(len(s) for s in narrows.values()) / ch_bw + 0.3))
    t = np.arange(n) / fs
    hold = (np.arange(n) / m).astype(np.int64)
    wide = np.zeros(n, np.complex64)
    for ch, narrow in narrows.items():
        idx = np.minimum(hold, len(narrow) - 1)
        pad = np.asarray(narrow, np.complex64)[idx]
        # silence past the end of the source signal
        pad[idx >= len(narrow) - 1] = 0
        f_c = ch * fs / m if ch <= m // 2 else ch * fs / m - fs
        wide += (0.5 * pad * np.exp(2j * np.pi * f_c * t)
                 ).astype(np.complex64)
    return wide
