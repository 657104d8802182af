"""Spectrum analyzer CLI — Welch PSD + waterfall on the matmul FFT.

The reference's spectrum display lives in its separate GUI (sdr-rx, which
uses the L4 FFT layer); this is the batch equivalent: average periodograms
of a capture, print the strongest peaks as JSON, optionally render a
PSD + waterfall PNG.

Usage:
  python -m libsdr_tpu.apps.spectrum --file cap.wav --nfft 4096
  python -m libsdr_tpu.apps.spectrum --raw rtl.bin --rate 2.4e6 --png s.png
"""

from __future__ import annotations

import json

import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.utils import logging as sdrlog
from libsdr_tpu.utils.options import add_source_args, common_parser, load_source


def welch_psd(iq: np.ndarray, fs: float, nfft: int = 4096,
              overlap: float = 0.5):
    """Averaged-periodogram PSD via the planar matmul FFT.

    Returns (freqs_hz, psd_db) with freqs centered (negative..positive) for
    complex input, 0..fs/2 for real input.
    """
    import jax
    import jax.numpy as jnp

    from libsdr_tpu.ops.fft import fft

    hop = max(1, int(nfft * (1 - overlap)))
    n_seg = max(1, (len(iq) - nfft) // hop + 1)
    idx = np.arange(nfft)[None, :] + hop * np.arange(n_seg)[:, None]
    segs = np.asarray(iq)[idx]
    win = np.hanning(nfft).astype(np.float32)
    scale = 1.0 / (fs * np.sum(win ** 2))
    x = cplx.as_block((segs * win).astype(
        np.complex64 if np.iscomplexobj(iq) else np.float32))

    @jax.jit
    def psd_fn(x):
        spec = fft(x)
        return jnp.mean(spec.abs2(), axis=0) * scale

    psd = np.asarray(psd_fn(x))
    if np.iscomplexobj(iq):
        psd = np.fft.fftshift(psd)
        freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1 / fs))
    else:
        freqs = np.fft.fftfreq(nfft, 1 / fs)[:nfft // 2]
        psd = psd[:nfft // 2]
    return freqs, 10 * np.log10(psd + 1e-30)


def find_peaks(freqs: np.ndarray, psd_db: np.ndarray, n_peaks: int = 8,
               min_prominence_db: float = 10.0):
    """Strongest local maxima at least ``min_prominence_db`` above the
    median floor."""
    floor = np.median(psd_db)
    order = np.argsort(psd_db)[::-1]
    peaks, used = [], np.zeros(len(psd_db), bool)
    for i in order:
        if len(peaks) >= n_peaks or psd_db[i] < floor + min_prominence_db:
            break
        if used[max(0, i - 8):i + 9].any():
            continue
        used[max(0, i - 8):i + 9] = True
        peaks.append({"freq_hz": float(freqs[i]),
                      "power_db": round(float(psd_db[i]), 2),
                      "above_floor_db": round(float(psd_db[i] - floor), 2)})
    return peaks


def main(argv=None):
    p = common_parser("Spectrum analyzer (Welch PSD on the matmul FFT)")
    add_source_args(p)
    p.add_argument("--nfft", type=int, default=4096)
    p.add_argument("--peaks", type=int, default=8)
    p.add_argument("--png", help="write a PSD + waterfall PNG")
    args = p.parse_args(argv)
    sdrlog.set_level(args.log_level)

    iq, fs = load_source(args)
    freqs, psd_db = welch_psd(iq, fs, nfft=args.nfft)
    peaks = find_peaks(freqs, psd_db, n_peaks=args.peaks)
    out = {"fs": fs, "nfft": args.nfft,
           "floor_db": round(float(np.median(psd_db)), 2), "peaks": peaks}
    print(json.dumps(out))

    if args.png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # waterfall: per-segment periodograms over time
        nfft, hop = args.nfft, args.nfft // 2
        n_seg = max(1, (len(iq) - nfft) // hop + 1)
        idx = np.arange(nfft)[None, :] + hop * np.arange(n_seg)[:, None]
        segs = np.asarray(iq)[idx] * np.hanning(nfft)
        wf = np.abs(np.fft.fftshift(np.fft.fft(segs, axis=-1), axes=-1)) ** 2
        wf_db = 10 * np.log10(wf + 1e-30)
        fig, (a1, a2) = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
        a1.plot(freqs / 1e3, psd_db, lw=0.7)
        a1.set_ylabel("PSD [dB/Hz]")
        a1.grid(alpha=0.3)
        a2.imshow(wf_db, aspect="auto", origin="lower",
                  extent=[freqs[0] / 1e3, freqs[-1] / 1e3,
                          0, n_seg * hop / fs])
        a2.set_xlabel("frequency [kHz]")
        a2.set_ylabel("time [s]")
        fig.tight_layout()
        fig.savefig(args.png, dpi=120)
        print(f"wrote {args.png}")
    return out


if __name__ == "__main__":
    main()
