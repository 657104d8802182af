"""FFT fast-convolution filter bank (reference: src/filternode.hh FilterSink/
FilterSource/FilterNode) — overlap-add filtering of N selectable bands that
share one forward FFT.

Reference structure (src/filternode.hh:231-283): a BufferNode re-blocks input
to B samples; FilterSink computes one zero-padded 2B forward FFT per block;
each FilterSource multiplies the spectrum with the FFT of its zero-padded
band kernel, inverse-transforms, and overlap-adds the halves
(src/filternode.hh:163-181).

Here the whole bank is one Processor: the band dimension is a batch axis of
the (planar, matmul-based) FFT, so one forward transform feeds an (n_bands,
2B) spectrum multiply + one batched inverse transform — all matmul work.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.cplx import Complex
from libsdr_tpu.core.stream import ConfigError, StreamSpec
from libsdr_tpu.ops.fft import fft


def ref_band_kernel(block_size: int, fmin: float, fmax: float,
                    fs: float) -> np.ndarray:
    """The reference's band kernel: sinc_flt_kernel evaluated over B points,
    zero-padded to 2B, FFT'd and L2-normalized
    (reference: src/filternode.hh:16-28, 186-203)."""
    n = block_size
    fmin = max(fmin, -fs / 2)
    fmax = min(fmax, fs / 2)
    bw = fmax - fmin
    fc = fmin + bw / 2
    i = np.arange(n)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.sin(np.pi * (bw / fs) * (i - n // 2)) / (i - n // 2)
    v[i == n // 2] = np.pi * bw / fs
    v = v.astype(np.complex128)
    v *= np.exp(2j * np.pi * fc * i / fs)
    v *= 0.42 - 0.5 * np.cos(2 * np.pi * i / n) + 0.08 * np.cos(4 * np.pi * i / n)
    kern = np.concatenate([v, np.zeros(n, np.complex128)])
    kf = np.fft.fft(kern)
    return kf / np.linalg.norm(kf)


class FFTFilterBank(Processor):
    """Overlap-add FFT filter bank.

    Args:
      bands: list of (fmin, fmax) tuples, one output band each
        (reference: FilterNode::addFilter, src/filternode.hh:262-270).

    Input (..., B) complex; output (..., n_bands, B) complex at the same
    rate, one retuned band per slot.  Carry: the saved second half of each
    band's previous inverse transform (src/filternode.hh:163-181).
    """

    def __init__(self, bands: Sequence[Tuple[float, float]]):
        super().__init__()
        self.bands: List[Tuple[float, float]] = [
            (min(f), max(f)) for f in bands]
        if not self.bands:
            raise ValueError("FFTFilterBank needs at least one band")

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FFTFilterBank")
        self._make_kernels(in_spec)
        return in_spec.with_(channels=in_spec.channels + (len(self.bands),))

    def _make_kernels(self, in_spec: StreamSpec) -> None:
        b = in_spec.block_size
        fs = in_spec.rate_hz
        kf = np.stack([ref_band_kernel(b, lo, hi, fs) for lo, hi in self.bands])
        self._kern = cplx.constant(kf)  # (n_bands, 2B)

    def set_band(self, idx: int, lo: float, hi: float) -> None:
        """Retune band ``idx`` (reference: FilterSource::setFreq,
        src/filternode.hh:116-124).  In the compiled model the band kernel is
        a baked constant: eager ``apply`` picks the new band up immediately;
        a previously jit-compiled step must be rebuilt (``Pipeline.compile``
        after re-binding) — the analog of the reference recomputing its
        kernel FFT inside ``config()``."""
        self.bands[idx] = (min(lo, hi), max(lo, hi))
        if self.is_bound:
            self._make_kernels(self.in_spec)

    def init_carry(self):
        b = self.in_spec.block_size
        shape = self.in_spec.channels + (len(self.bands), b)
        return cplx.zeros(shape, self.in_spec.real_dtype)

    def apply(self, carry, x):
        b = self.in_spec.block_size
        # Zero-padded forward FFT shared by all bands
        # (reference: src/filternode.hh:81-88).
        xp = cplx.concatenate(
            [x, cplx.zeros(x.shape[:-1] + (b,), x.real_dtype)], axis=-1)
        spec = fft(xp)                                  # (..., 2B)
        prod = spec[..., None, :] * self._kern          # (..., n_bands, 2B)
        y = fft(prod, inverse=True)
        # The reference's backward FFTW transform is unscaled and it divides
        # by 2B itself (src/filternode.hh:176-177); fft(inverse=True) already
        # applies 1/(2B), so the halves combine directly.
        out = carry + y[..., :b]
        new_carry = y[..., b:]
        return new_carry, out
