"""Streaming FIR filtering via overlap-save — the block-parallel replacement
for the reference's per-sample ring-buffer FIR (reference: src/firfilter.hh:231-248).

The reference keeps the last ``order`` samples in a ring buffer and computes an
O(order) MAC per sample.  Here the ring buffer becomes an explicit
``tail`` carry of the last ``order-1`` input samples; each block is processed
as one batched convolution ``y[n] = sum_i k[i] * xc[n+i]`` over
``xc = concat(tail, x)`` — which XLA lowers to a GEMM or convolution.  The initial
zero tail reproduces the reference's zero-initialized ring exactly
(reference: src/firfilter.hh:194).

Complex streams are planar (:mod:`libsdr_tpu.core.cplx`); complex*complex
convolutions use the 3-multiply Karatsuba decomposition into real convs.

Tap alignment matches the reference (src/firfilter.hh:238-243): ``k[N-1]``
multiplies the newest sample, so ``y[n] = sum_i k[i] * x[n-(N-1)+i]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.cplx import Complex
from libsdr_tpu.core.stream import ConfigError, StreamSpec
from libsdr_tpu.ops import firdesign


# Precision of the FIR's dots.  On the GPU an f32 HIGH dot runs in TF32
# (cuBLAS; a 512-deep random GEMM holds 70.6 dB against float64, HIGHEST
# 127.9 dB).  The contract is >= 90 dB of FM audio against the float64
# model (utils/model64.py), about the fidelity of 16-bit audio.  Measured on
# an NVIDIA H100 80GB HBM3 at 700 W, fm_bank (64 ch x 2^24 samples,
# chip_smoke.py): HIGH 108.4 dB at 15.2 ms per block, HIGHEST 127.1 dB at
# 38.5 ms — HIGH is the cheaper one that holds the contract.
CONV_PRECISION = jax.lax.Precision.HIGH


def _conv1d_real(x: jnp.ndarray, k: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    """Batched real 1-D cross-correlation: y[..., j] = sum_i k[i] x[..., j*stride+i].

    x: (..., L) real; k: (T,) real; output (..., (L-T)//stride + 1).
    """
    lead = x.shape[:-1]
    xb = x.reshape((-1, 1, x.shape[-1]))  # (batch, feature=1, spatial)
    kb = k.reshape((1, 1, k.shape[0])).astype(x.dtype)  # (out_f, in_f, spatial)
    y = jax.lax.conv_general_dilated(
        xb, kb,
        window_strides=(stride,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=CONV_PRECISION,
    )
    return y.reshape(lead + (y.shape[-1],))


def _conv1d_multi(x2: jnp.ndarray, kmat: jnp.ndarray,
                  stride: int) -> jnp.ndarray:
    """Multi-feature conv: x2 (..., F_in, L) with kernel (F_out, F_in, T)
    -> (..., F_out, L').  One pass over the input (HBM-bandwidth optimal)."""
    lead = x2.shape[:-2]
    f_in, L = x2.shape[-2], x2.shape[-1]
    xb = x2.reshape((-1, f_in, L))
    y = jax.lax.conv_general_dilated(
        xb, kmat.astype(x2.dtype),
        window_strides=(stride,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=CONV_PRECISION,
    )
    return y.reshape(lead + y.shape[-2:])


def _conv1d(x, k, stride: int = 1):
    """Cross-correlation for any real/planar-complex combination of x and k.

    The op is memory-bandwidth-bound, so the planar re/im planes are
    NEVER stacked into one buffer (conv operands must be materialized — a
    stack would re-write the whole full-rate stream).  Each plane streams
    from HBM exactly once through its own conv; cross terms combine in the
    (decimated) elementwise epilogue, which XLA fuses.
    """
    k = np.asarray(k) if not isinstance(k, jnp.ndarray) else k
    k_c = np.iscomplexobj(k)
    x_c = isinstance(x, Complex)
    if not x_c and not k_c:
        return _conv1d_real(x, jnp.asarray(k, dtype=x.dtype), stride)
    if x_c and not k_c:
        # Real taps on a complex stream: one conv per plane.
        kr = jnp.asarray(k, dtype=x.re.dtype)
        return Complex(_conv1d_real(x.re, kr, stride),
                       _conv1d_real(x.im, kr, stride))
    if not x_c and k_c:
        kmat = jnp.stack([jnp.asarray(k.real), jnp.asarray(k.imag)]
                         )[:, None, :]  # (2, 1, T)
        y = _conv1d_multi(x[..., None, :], kmat, stride)
        return Complex(y[..., 0, :], y[..., 1, :])
    # complex * complex: (re', im') = ((kr, -ki), (ki, kr)) . (re, im) as one
    # 2->2-feature conv, which reads each plane once; the stack is elided entirely when the planes are adjacent slices of one
    # packed buffer (see cplx.Complex.packed / the runtime's packed ingest).
    kr = np.asarray(k.real, np.float32)
    ki = np.asarray(k.imag, np.float32)
    kmat = jnp.asarray(np.stack([np.stack([kr, -ki]),
                                 np.stack([ki, kr])]))  # (2, 2, T)
    x2 = cplx.pack_planes(x)                            # (..., 2, L)
    y = _conv1d_multi(x2, kmat, stride)
    return Complex(y[..., 0, :], y[..., 1, :])


# --------------------------------------------------------------------------
# Matmul FIR (block-Toeplitz): the decimating FIR is cast as ONE dense
# matmul per input plane over non-overlapping frames — a reshape-only
# framing (no gather/stack/copy of the full-rate stream):
#
#   X = x.reshape(..., F, S*D)                     (free)
#   P = X @ [A | C]                                (GEMM)
#   y[f, s] = P[f, s] + P[f+1, spill_s]            (decimated-rate epilogue)
#
# where A[m, s] = g[m - sD] (window of output s inside its frame) and the
# slim spill matrix C holds the tap tails of the last ceil((T-1)/D) outputs
# per frame, whose windows extend into the next frame.  Complex taps double
# the columns ([Ar|Cr|Ai|Ci]); complex input runs one matmul per plane and
# combines in the epilogue (never stacking the planes).
# --------------------------------------------------------------------------

def _fir_matmul_build(taps: np.ndarray, stride: int, s_out: int,
                      offset: int = 0):
    """Host-side constants for the block-Toeplitz FIR matmul.

    Output s of frame f is the window starting at input ``offset + (f*S+s) *
    stride`` (frame-relative start ``offset + s*stride``).  Returns
    (M, nsp, s_first): M is (S*stride, ncols) float32 with column layout
    [A | C] (real taps) or [Ar | Cr | Ai | Ci] (complex taps); the last
    ``nsp`` outputs per frame take their tap tail from the next frame."""
    t = taps.shape[0]
    sd = s_out * stride
    assert offset + t <= sd + stride, "window may span at most two frames"
    spill = [s for s in range(s_out) if offset + s * stride + t > sd]
    nsp = max(len(spill), 1)  # keep >=1 (zero) column so the epilogue is uniform
    s_first = s_out - nsp
    a = np.zeros((sd, s_out), np.complex128 if np.iscomplexobj(taps) else np.float64)
    c = np.zeros((sd, nsp), a.dtype)
    for s in range(s_out):
        lo = offset + s * stride
        n_in = min(t, sd - lo)
        a[lo:lo + n_in, s] = taps[:n_in]
        if n_in < t:
            c[:t - n_in, s - s_first] = taps[n_in:]
    if np.iscomplexobj(taps):
        m = np.concatenate([a.real, c.real, a.imag, c.imag], axis=1)
    else:
        m = np.concatenate([a, c], axis=1)
    return jnp.asarray(m.astype(np.float32)), nsp, s_first


def _fir_matmul_plane(x: jnp.ndarray, m: jnp.ndarray, s_out: int,
                      stride: int) -> jnp.ndarray:
    """One plane through the Toeplitz matmul: x (..., F*S*stride) real ->
    P (..., F, ncols)."""
    lead = x.shape[:-1]
    sd = s_out * stride
    f = x.shape[-1] // sd
    xf = x.reshape(lead + (f, sd))
    return jax.lax.dot_general(
        xf, m, (((xf.ndim - 1,), (0,)), ((), ())),
        precision=CONV_PRECISION)


def _fir_matmul_epilogue(p_main, p_spill, s_first: int):
    """y[f] = main[f] + spill-from-frame-f+1, zero-padded to column s_first."""
    nsp = p_spill.shape[-1]
    zero = jnp.zeros(p_spill.shape[:-2] + (1, nsp), p_spill.dtype)
    sp = jnp.concatenate([p_spill[..., 1:, :], zero], axis=-2)
    pad = [(0, 0)] * (p_main.ndim - 1) + [(s_first, 0)]
    y = p_main + jnp.pad(sp, pad)
    return y.reshape(y.shape[:-2] + (-1,))


def _fir_matmul(x, k: np.ndarray, stride: int, s_out: int, offset: int = 0):
    """Decimating FIR over frames via one matmul per plane.  x trailing length must be
    a multiple of S*stride; returns all F*S outputs, of which the final
    ``nsp`` (whose windows need the next block) are garbage — the caller
    keeps only the valid count."""
    m, nsp, s_first = _fir_matmul_build(np.asarray(k), stride, s_out, offset)
    s = s_out
    k_c = np.iscomplexobj(k)
    x_c = isinstance(x, Complex)
    if not k_c:
        if not x_c:
            p = _fir_matmul_plane(x, m, s, stride)
            return _fir_matmul_epilogue(p[..., :s], p[..., s:], s_first), nsp
        return Complex(
            *[_fir_matmul_epilogue(p[..., :s], p[..., s:], s_first)
              for p in (_fir_matmul_plane(x.re, m, s, stride),
                        _fir_matmul_plane(x.im, m, s, stride))]), nsp
    a, b, c0 = s, s + nsp, 2 * s + nsp
    if not x_c:
        p = _fir_matmul_plane(x, m, s, stride)
        return Complex(
            _fir_matmul_epilogue(p[..., :a], p[..., a:b], s_first),
            _fir_matmul_epilogue(p[..., b:c0], p[..., c0:], s_first)), nsp
    pr = _fir_matmul_plane(x.re, m, s, stride)
    pi = _fir_matmul_plane(x.im, m, s, stride)
    yr = _fir_matmul_epilogue(pr[..., :a] - pi[..., b:c0],
                              pr[..., a:b] - pi[..., c0:], s_first)
    yi = _fir_matmul_epilogue(pi[..., :a] + pr[..., b:c0],
                              pi[..., a:b] + pr[..., c0:], s_first)
    return Complex(yr, yi), nsp


def fir_overlap_save(taps, x, tail, stride: int = 1, offset: int = 0):
    """One overlap-save FIR block step.

    Args:
      taps: (T,) filter taps (numpy real or complex).
      x: (..., B) input block (real array or planar Complex).
      tail: (..., T-1) last samples of the previous block (zeros initially).
      stride: output decimation (output j is the window ending at input
        sample ``offset + j*stride``).
      offset: index of the first input sample that produces an output.

    Returns:
      (y, new_tail): y has trailing length ``(B - offset - 1)//stride + 1``;
      new_tail is the last T-1 samples of ``concat(tail, x)``.

    The chain is HBM-bandwidth-bound, so materializing ``concat(tail, x)``
    (a full extra write + read of the stream) would dominate.  Instead the
    few outputs whose window straddles the block boundary come from a tiny
    concat of the tail and the head of ``x``; the main convolution reads
    ``x`` from HBM directly, exactly once.
    """
    t = int(np.asarray(taps).shape[0])
    if t <= 1:
        return _conv1d(x[..., offset:], taps, stride), tail
    b = x.shape[-1] if not isinstance(x, Complex) else x.re.shape[-1]
    # Output j's window covers input samples [offset + j*stride - (t-1),
    # offset + j*stride] in tail-concatenated coordinates shifted by t-1:
    # global window start s(j) = offset + j*stride - (t-1) relative to x[0].
    n_lead = -(-(t - 1 - offset) // stride) if t - 1 > offset else 0
    s0 = offset + n_lead * stride - (t - 1)  # first in-x-only window start
    if b < t - 1 + max(s0, 0) or n_lead <= 0:
        # Small blocks (or no boundary outputs): fall back to the dense path.
        xc = cplx.concatenate([tail, x], axis=-1)
        y = _conv1d(xc[..., offset:], taps, stride)
        new_tail = xc[..., xc.shape[-1] - (t - 1):]
        return y, new_tail
    # Boundary outputs: windows end at offset + j*stride for j < n_lead;
    # the last one needs x up to index offset + (n_lead-1)*stride (inclusive).
    head_len = offset + (n_lead - 1) * stride + 1
    xc_head = cplx.concatenate([tail, x[..., :head_len]], axis=-1)
    y_lead = _conv1d(xc_head[..., offset:], taps, stride)
    y_main = _fir_main(x, taps, stride, s0)
    y = cplx.concatenate([y_lead, y_main], axis=-1)
    new_tail = x[..., b - (t - 1):]
    return y, new_tail


def _fir_main(x, taps, stride: int, s0: int):
    """In-block FIR outputs (window start s0 + j*stride, fully inside x).

    Decimating filters on large blocks take the XLA block-Toeplitz matmul
    (one dense product per input plane); others the XLA conv.  The matmul
    path reads the whole unsliced block (the offset is baked into the
    Toeplitz matrices) so no full-rate copy is ever made; the last few
    outputs whose windows spill past the final frame come from a small conv
    on the block tail.  Which of the two is faster on the GPU is not
    measured yet."""
    b = x.shape[-1] if not isinstance(x, Complex) else x.re.shape[-1]
    t = int(np.asarray(taps).shape[0])
    n_main = (b - s0 - t) // stride + 1
    s_out = max(-(-t // stride), 512 // stride, 1)
    sd = s_out * stride
    use_mm = (stride > 1 and t > 8 and b % sd == 0 and b // sd >= 2
              and s0 + t <= sd + stride)
    if not use_mm:
        return _conv1d(x[..., s0:], taps, stride)
    f_full = b // sd
    y_mm, nsp = _fir_matmul(x, taps, stride, s_out, offset=s0)
    n_valid = min(f_full * s_out - nsp, n_main)
    y_mm = y_mm[..., :n_valid]
    if n_valid == n_main:
        return y_mm
    rem_start = s0 + n_valid * stride
    y_rest = _conv1d(x[..., rem_start:], taps, stride)
    return cplx.concatenate([y_mm, y_rest], axis=-1)


class FIRFilter(Processor):
    """Streaming FIR filter node (reference: src/firfilter.hh FIRFilter +
    FIRLowPass/FIRHighPass/FIRBandPass/FIRBandStop specializations).

    Args:
      order: number of taps.
      kind: 'lowpass' | 'highpass' | 'bandpass' | 'bandstop' | 'custom'.
      fl, fu: band edges in Hz (lowpass uses fu, highpass uses fl, matching
        the reference's constructor conventions, src/firfilter.hh:276-305).
      taps: explicit taps for kind='custom'.
      design: 'textbook' (default) or 'ref' (reference-parity math; only
        lowpass has a working reference designer).
      decim: integer output decimation (keep-one-in-D after filtering).
      enabled: bypass flag (reference: src/firfilter.hh:134-137).
    """

    def __init__(self, order: int, kind: str = "lowpass", fl: float = 0.0,
                 fu: float = 0.0, taps: Optional[Sequence] = None,
                 design: str = "textbook", decim: int = 1,
                 enabled: bool = True):
        super().__init__()
        self.order = max(1, int(order))
        self.kind = kind
        self.fl, self.fu = float(fl), float(fu)
        self.design = design
        self.decim = int(decim)
        self.enabled = enabled
        self._custom_taps = None if taps is None else np.asarray(taps)
        self.taps: Optional[np.ndarray] = None

    def _design_taps(self, fs: float) -> np.ndarray:
        if self.kind == "custom":
            return self._custom_taps
        if self.design == "ref":
            if self.kind != "lowpass":
                raise ConfigError(
                    "reference-parity designer exists only for lowpass "
                    "(the reference's other designers are broken, "
                    "src/firfilter.hh:42-110)")
            return firdesign.ref_lowpass(self.order, self.fu, fs)
        d = {
            "lowpass": lambda: firdesign.lowpass(self.order, self.fu, fs),
            "highpass": lambda: firdesign.highpass(self.order, self.fl, fs),
            "bandpass": lambda: firdesign.bandpass(self.order, self.fl, self.fu, fs),
            "bandstop": lambda: firdesign.bandstop(self.order, self.fl, self.fu, fs),
        }
        if self.kind not in d:
            raise ConfigError(f"Unknown FIR kind {self.kind!r}")
        return d[self.kind]()

    def set_freq(self, fl: float = None, fu: float = None) -> None:
        """Retune the band edges (reference: FIRFilter::setFreq,
        src/firfilter.hh:150-160).  Taps are baked constants: eager apply
        sees the retune immediately; a jit-compiled step must be rebuilt
        (re-bind the Pipeline, then compile) — the analog of the reference
        re-running its coefficient designer."""
        if self.kind == "custom":
            raise ConfigError("set_freq: a custom-taps filter has no "
                              "designer to retune")
        if fl is not None:
            self.fl = float(fl)
        if fu is not None:
            self.fu = float(fu)
        if self.is_bound:
            self.taps = np.asarray(self._design_taps(self.in_spec.rate_hz))

    def set_order(self, order: int) -> None:
        """Change the tap count (reference: FIRFilter::setOrder,
        src/firfilter.hh:140-148).  Changes the carry-tail length, so the
        stream must be re-bound (init_carry) afterwards."""
        if self.kind == "custom":
            raise ConfigError("set_order: a custom-taps filter has no "
                              "designer to re-run")
        self.order = max(1, int(order))
        if self.is_bound:
            self.taps = np.asarray(self._design_taps(self.in_spec.rate_hz))

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        if self.decim > 1:
            in_spec.require_block_multiple("FIRFilter", self.decim)
        self.taps = np.asarray(self._design_taps(in_spec.rate_hz))
        out_dtype = in_spec.dtype
        if np.iscomplexobj(self.taps) and not in_spec.is_complex:
            out_dtype = jnp.complex64
        # A narrow input plane dtype (bf16 ingest) does NOT propagate: the
        # filter's matmul path accumulates in f32 and the output is normalized
        # to the full dtype (filtering gains precision beyond the source's).
        return in_spec.with_(
            dtype=out_dtype,
            plane_dtype=None,
            sample_rate=in_spec.sample_rate / self.decim,
            block_size=in_spec.block_size // self.decim)

    def init_carry(self):
        t = self.taps.shape[0]
        shape = self.in_spec.channels + (t - 1,)
        if self.in_spec.is_complex:
            return cplx.zeros(shape, self.in_spec.real_dtype)
        return jnp.zeros(shape, self.in_spec.dtype)

    def apply(self, carry, x):
        if not self.enabled:
            return carry, x
        y, tail = fir_overlap_save(
            self.taps, x, carry, stride=self.decim, offset=self.decim - 1)
        # Normalize narrow-plane outputs (bf16 ingest through the conv path)
        # to the declared full-precision output dtype.
        want = self.out_spec.real_dtype
        if isinstance(y, Complex):
            if y.re.dtype != want:
                y = Complex(y.re.astype(want), y.im.astype(want))
        elif y.dtype != want and jnp.issubdtype(y.dtype, jnp.floating):
            y = y.astype(want)
        return tail, y
