"""Fixed-point parity ops (reference: src/math.hh, src/operators.hh).

The reference computes in Q-format integers throughout (SURVEY.md section 7
"hard parts": bit-exact POCSAG/AX.25 needs either int emulation or proof that
the float pipeline crosses the same decision thresholds).  The float pipeline
is the default; this module provides the integer kernels for parity gates —
int32 runs natively on the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.cplx import Complex
from libsdr_tpu.core.stream import ConfigError, StreamSpec


def _div_trunc(a, b):
    """C-style integer division (truncate toward zero), which jnp's
    floor-divide is not for negative operands."""
    q = jnp.abs(a) // jnp.abs(b)
    return jnp.sign(a) * jnp.sign(b) * q


def fast_atan2_i16(a, b):
    """The reference's integer atan2 approximation
    (reference: src/math.hh:31-40, fast_atan2<int16_t,int16_t>):
    maps angle to int16 with pi == 1<<14 (pi/4 == 1<<12).

    Args:
      a, b: int32 arrays (int16 range); returns int32 angles.
    """
    a = a.astype(jnp.int32)
    b = b.astype(jnp.int32)
    pi4 = jnp.int32(1 << 12)
    pi34 = jnp.int32(3 * (1 << 12))
    aabs = jnp.abs(a)
    angle_pos = pi4 - _div_trunc(pi4 * (b - aabs), b + aabs)
    angle_neg = pi34 - _div_trunc(pi4 * (b + aabs), aabs - b)
    angle = jnp.where(b >= 0, angle_pos, angle_neg)
    angle = jnp.where(a >= 0, angle, -angle)
    return jnp.where((a == 0) & (b == 0), jnp.int32(0), angle)


def _wrap16(a):
    """int32 -> int16 wraparound (the C++ int32->int16 conversion)."""
    return ((a + (1 << 15)) & 0xFFFF) - (1 << 15)


def ref_q14_kernel(order: int, ff: float, width: float, fs: float
                   ) -> np.ndarray:
    """The reference's Q14 integer band-pass kernel, bit-exact
    (reference: src/baseband.hh:239-262 _update_filter_kernel): Blackman-
    windowed sinc shifted to -Ff, normalized by sum(|alpha|), scaled by
    2^14 and TRUNCATED toward zero per component (the C++ double ->
    int32 conversion)."""
    w = (np.pi * width) / fs
    m = order / 2.0
    i = np.arange(order, dtype=np.float64)
    alpha = np.where(order == 2 * i, 4 * (w / np.pi),
                     np.sin(w * (i - m)) / (w * (i - m)))
    alpha = alpha.astype(np.complex128)
    alpha *= np.exp(-2j * np.pi * ff * i / fs)
    alpha *= (0.42 - 0.5 * np.cos(2 * np.pi * i / order)
              + 0.08 * np.cos(4 * np.pi * i / order))
    norm = np.abs(alpha).sum()
    k = (float(1 << 14) * alpha) / norm
    return (np.trunc(k.real).astype(np.int64)
            + 1j * np.trunc(k.imag).astype(np.int64)).astype(np.complex128)


def ref_nco_lut(shift: int = 16, size: int = 128) -> np.ndarray:
    """The reference's integer NCO LUT, bit-exact (reference:
    src/freqshift.hh:27-36): 2^shift * exp(-2 pi i k/size), truncated per
    component (C++ double -> int32)."""
    k = np.arange(size)
    v = float(1 << shift) * np.exp(-2j * np.pi * k / size)
    return np.trunc(v.real) + 1j * np.trunc(v.imag)


class IQBaseBandInt(Processor):
    """Bit-exact integer IQBaseBand<int16_t> (reference:
    src/baseband.hh:198-236 _process + _filter_ring, src/freqshift.hh:58-87
    applyFrequencyShift): Q14 ring FIR with arithmetic >>14, the 128-entry
    Q16 LUT NCO with the 8.8 fixed-point phase counter, and the averaging
    decimator — including the reference's off-by-one quirk where the FIRST
    group ever averaged absorbs ``decim+1`` samples (the ``_sample_count``
    check runs before the for-increment), so the first block emits
    ``B/decim - 1`` samples and every later block ``B/decim``.

    Input: planar complex int32 planes holding int16-range samples (use
    ``from_float(x)`` / scale at the caller for float captures).
    Output: planar complex int32 planes holding int16-range values (the
    CScalar = complex<int16> stream), ``block/decim`` slots per block of
    which the first block's LAST slot is padding — the op emits exactly the
    reference's sample stream shifted into fixed-size blocks.

    All arithmetic wraps in int32 exactly like the C++ (XLA int32 ops are
    two's-complement).
    """

    def __init__(self, fc: float, width: float, order: int, decim: int,
                 ff: float = None):
        super().__init__()
        self.fc = float(fc)
        self.ff = self.fc if ff is None else float(ff)
        self.width = float(width)
        self.order = max(1, int(order))
        self.decim = max(1, int(decim))

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("IQBaseBandInt")
        in_spec.require_block_multiple("IQBaseBandInt", self.decim)
        fs = in_spec.rate_hz
        k = ref_q14_kernel(self.order, self.ff, self.width, fs)
        # Reference tap order: kernel[order-1] multiplies the NEWEST sample.
        self._kr = jnp.asarray(k.real.astype(np.int32))
        self._ki = jnp.asarray(k.imag.astype(np.int32))
        lut = ref_nco_lut()
        self._lut_r = jnp.asarray(lut.real.astype(np.int32))
        self._lut_i = jnp.asarray(lut.imag.astype(np.int32))
        # 8.8 phase increment, truncated (src/freqshift.hh:85).
        self._lut_inc = int(128 * 256 * abs(self.fc) / fs)
        self._neg = self.fc < 0
        return in_spec.with_(
            dtype=jnp.int32,  # planar int32 planes, int16-range values
            sample_rate=in_spec.sample_rate / self.decim,
            block_size=in_spec.block_size // self.decim)

    def init_carry(self):
        ch = self.in_spec.channels
        t = self.order
        return dict(
            tail=cplx.zeros(ch + (t - 1,), jnp.int32),
            lut_count=jnp.zeros((), jnp.int32),
            acc=cplx.zeros(ch, jnp.int32),   # partial _last since last emit
            emitted=jnp.zeros((), jnp.int32),  # 0 until the first emission
        )

    def apply(self, carry, x):
        d = self.decim
        order = self.order
        b = x.re.shape[-1]
        xr = x.re.astype(jnp.int32)
        xi = x.im.astype(jnp.int32)
        tr = carry["tail"].re
        ti = carry["tail"].im
        xcr = jnp.concatenate([tr, xr], axis=-1)
        xci = jnp.concatenate([ti, xi], axis=-1)
        # FIR: y[n] = (sum_i k[i] * xc[n+i]) >> 14, int32 wraparound MACs.
        accr = jnp.zeros_like(xr)
        acci = jnp.zeros_like(xi)
        for i in range(order):
            sr = jax.lax.dynamic_slice_in_dim(xcr, i, b, axis=-1)
            si = jax.lax.dynamic_slice_in_dim(xci, i, b, axis=-1)
            kr = self._kr[i]
            ki = self._ki[i]
            accr = accr + kr * sr - ki * si
            acci = acci + kr * si + ki * sr
        yr = accr >> 14
        yi = acci >> 14
        # NCO (skipped entirely when the increment is 0, like the C++).
        if self._lut_inc:
            # int32 wraparound is harmless here: 2^15 divides 2^32, so
            # (a mod 2^32) mod (128*256) == a mod (128*256); but Python-int
            # scalars fed to jnp must be pre-reduced or they overflow at
            # argument parsing (b * inc easily exceeds 2^31).
            counts = (carry["lut_count"]
                      + jnp.arange(b, dtype=jnp.int32)
                      * jnp.int32(self._lut_inc % (128 * 256))) \
                % (128 * 256)
            idx = counts >> 8
            if self._neg:
                idx = 127 - idx
            lr = self._lut_r[idx]
            li = self._lut_i[idx]
            zr = (lr * yr - li * yi) >> 16
            zi = (lr * yi + li * yr) >> 16
            new_count = (carry["lut_count"]
                         + (b * self._lut_inc) % (128 * 256)) % (128 * 256)
        else:
            zr, zi = yr, yi
            new_count = carry["lut_count"]
        if d == 1:
            out = Complex(_wrap16(zr), _wrap16(zi))
            new_tail = Complex(xcr[..., b:], xci[..., b:])
            return dict(tail=new_tail, lut_count=new_count,
                        acc=carry["acc"], emitted=jnp.ones((), jnp.int32)
                        ), out
        # Averaging decimator with the reference's group phase: after the
        # first (decim+1)-sample group, emissions land every ``decim``
        # samples.  With block % decim == 0 the emission points are at local
        # indices 0, d, 2d, ... except in the first-ever block, where the
        # local-0 emission does not exist (its samples joined group one).
        csr = jnp.cumsum(zr, axis=-1)
        csi = jnp.cumsum(zi, axis=-1)
        n_out = b // d
        if n_out < 2:
            raise ConfigError("IQBaseBandInt: block must hold >= 2 output "
                              "groups (block >= 2*decim)")
        # cs is inclusive: sum z[a..e] = cs[e] - cs[a-1].
        # emission at local e in {0, d, 2d, ...}: group = acc + cs[e] (e=0)
        # or cs[e] - cs[e-d].
        em = jnp.arange(1, n_out, dtype=jnp.int32) * d        # d, 2d, ...
        gr_rest = csr[..., em] - csr[..., em - d]
        gi_rest = csi[..., em] - csi[..., em - d]
        gr0 = carry["acc"].re + csr[..., 0]
        gi0 = carry["acc"].im + csi[..., 0]
        first = carry["emitted"] == 0
        # First-ever block: no emission at local 0; group one = cs[d]
        # (samples 0..d inclusive) lands in slot 0, later groups shift one
        # slot left, and the final slot is padding.
        gr_first = jnp.concatenate(
            [csr[..., d:d + 1], gr_rest[..., 1:],
             jnp.zeros_like(gr_rest[..., :1])], axis=-1)
        gi_first = jnp.concatenate(
            [csi[..., d:d + 1], gi_rest[..., 1:],
             jnp.zeros_like(gi_rest[..., :1])], axis=-1)
        gr_norm = jnp.concatenate([gr0[..., None], gr_rest], axis=-1)
        gi_norm = jnp.concatenate([gi0[..., None], gi_rest], axis=-1)
        sr = jnp.where(first, gr_first, gr_norm)
        si = jnp.where(first, gi_first, gi_norm)
        out = Complex(_wrap16(_div_trunc(sr, jnp.int32(d))),
                      _wrap16(_div_trunc(si, jnp.int32(d))))
        # carried partial: samples after the last emission (local b-d),
        # i.e. z[b-d+1 .. b-1] = cs[b-1] - cs[b-d].
        new_acc = Complex(csr[..., b - 1] - csr[..., b - d],
                          csi[..., b - 1] - csi[..., b - d])
        new_tail = Complex(xcr[..., b:], xci[..., b:])
        new_carry = dict(tail=new_tail, lut_count=new_count, acc=new_acc,
                         emitted=jnp.ones((), jnp.int32))
        return new_carry, out

    @property
    def first_block_pad(self) -> int:
        """The first block's final output slot is padding (the reference's
        first group absorbs decim+1 samples)."""
        return 1


class FMDemodInt(Processor):
    """Bit-faithful integer FM discriminator
    (reference: src/demod.hh:242-254 FMDemod<int16_t> _process):
    ``phi[n] = fast_atan2(re, im) / 2; y[n] = phi[n-1] - phi[n]`` with int16
    wraparound semantics.

    Input: planar complex whose planes hold int16-range values — integer
    planes are used directly (the IQBaseBandInt chain); float planes are
    scaled by ``scale`` onto the reference's integer grid.
    Output: int32 stream (int16-range values).

    ``ref_block_quirk=True`` reproduces the reference's per-buffer behavior
    bit-for-bit (src/demod.hh:242-254): the _process loop starts at i=1, so
    sample 0 of EVERY buffer never enters the discriminator chain, and with
    the usual in-place direct connect out[0] is the reinterpreted REAL part
    of the first complex input sample.  Required for exact audio parity
    with the compiled reference.
    """

    def __init__(self, scale: float = 32767.0, ref_block_quirk: bool = False):
        super().__init__()
        self.scale = float(scale)
        self.ref_block_quirk = bool(ref_block_quirk)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FMDemodInt")
        return in_spec.with_(dtype=jnp.int32)

    def init_carry(self):
        return jnp.zeros(self.in_spec.channels, jnp.int32)

    def apply(self, carry, x):
        if jnp.issubdtype(x.re.dtype, jnp.integer):
            re = x.re.astype(jnp.int32)
            im = x.im.astype(jnp.int32)
        else:
            re = jnp.clip(jnp.round(x.re * self.scale), -32768, 32767
                          ).astype(jnp.int32)
            im = jnp.clip(jnp.round(x.im * self.scale), -32768, 32767
                          ).astype(jnp.int32)
        phi = _div_trunc(fast_atan2_i16(re, im), jnp.int32(2))
        prev = jnp.concatenate([carry[..., None], phi[..., :-1]], axis=-1)
        # int16 wraparound of (prev - phi), as the C++ int16 subtraction does
        y = _wrap16(prev - phi)
        if self.ref_block_quirk:
            # sample 0 never demodulated: out[0] = in[0].real (in-place
            # reinterpret), and phi[0] does not enter the chain — out[1]
            # uses the PREVIOUS block's final phi.
            prev_q = jnp.concatenate(
                [carry[..., None], phi[..., 1:-1]], axis=-1)
            y_q = _wrap16(prev_q - phi[..., 1:])
            y = jnp.concatenate([_wrap16(re[..., :1]), y_q], axis=-1)
        return phi[..., -1], y


class FMDeemphInt(Processor):
    """Bit-exact integer FM de-emphasis (reference: src/demod.hh:304-351
    FMDeemph<int16_t>): ``alpha = round(1/(1 - exp(-1/(Fs*75e-6))))``;
    per sample ``diff = x - avg`` (int16 wrap), then
    ``avg += (diff ± alpha/2) / alpha`` with C-truncating division.
    Sequential per channel -> lax.scan over time, vectorized over channels.
    """

    def __init__(self, tau: float = 75e-6):
        super().__init__()
        self.tau = float(tau)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        import math
        fs = in_spec.rate_hz
        self._alpha = int(round(1.0 / (1.0 - math.exp(-1.0 / (fs * self.tau)))))
        return in_spec.with_(dtype=jnp.int32)

    def init_carry(self):
        return jnp.zeros(self.in_spec.channels, jnp.int32)

    def apply(self, carry, x):
        alpha = jnp.int32(self._alpha)
        half = jnp.int32(self._alpha // 2)

        def step(avg, xi):
            diff = _wrap16(xi - avg)
            upd = jnp.where(diff > 0,
                            _div_trunc(diff + half, alpha),
                            _div_trunc(diff - half, alpha))
            avg = _wrap16(avg + upd)
            return avg, avg

        x_t = jnp.moveaxis(x.astype(jnp.int32), -1, 0)
        avg, y = jax.lax.scan(step, carry, x_t, unroll=8)
        return avg, jnp.moveaxis(y, 0, -1)
