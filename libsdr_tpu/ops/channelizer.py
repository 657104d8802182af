"""Polyphase filterbank channelizer — the flagship wideband op.

Generalizes the reference's FilterNode (src/filternode.hh:231-283, its
closest thing to a channelizer — N retunable overlap-add bands) to the
standard maximally-decimated uniform PFB: one wideband complex stream in,
M critically-sampled channel streams out, each at fs/M, centered at
ch * fs / M.

Device mapping: the input is framed into (n_frames, M) by the commutator;
the polyphase branch filters are a (P, M) tap matrix applied over P
consecutive frames (an elementwise multiply-accumulate the XLA compiler
fuses), and the channel synthesis is an M-point IFFT across branches —
which is the planar matmul FFT of :mod:`libsdr_tpu.ops.fft`.  Everything batches over leading channel dims.

Polyphase identity used (channel c = decimate(h * (x e^{-2i pi c n/M}))):

    u_p[t]  = sum_k h[kM + p] * x[(t-k)M - p]      (reverse commutator!)
    y_c[t]  = sum_p u_p[t] * exp(+2i pi p c / M)   (= M * IFFT over p)

so channel c contains the band around +c*fs/M shifted to DC (negative
bands appear at index M-c).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.stream import ConfigError, StreamSpec
from libsdr_tpu.ops import firdesign


def prototype_lowpass(n_channels: int, taps_per_branch: int,
                      cutoff_scale: float = 1.0) -> np.ndarray:
    """Prototype low-pass for an M-channel PFB: length M*P windowed sinc with
    cutoff fs/(2M), unity DC gain."""
    m, p = n_channels, taps_per_branch
    n = m * p
    # cutoff at (fs/2)/M scaled; firdesign.lowpass expects Hz with fs=1.
    return firdesign.lowpass(n, cutoff_scale * 0.5 / m, 1.0)


def fold_commutator(proto: np.ndarray, m: int, p: int) -> np.ndarray:
    """Fold the PFB reverse commutator into the tap matrix (see module
    docstring): returns taps3 (P+1, M) such that

        u'[t, q'] = sum_k taps3[k, q'] * histf[t + P - k, q']

    on UNREVERSED frame lanes equals the commutated branch signals on
    reversed lanes, and channel synthesis becomes the unscaled FORWARD DFT
    over q'."""
    taps = np.asarray(proto, np.float64).reshape(p, m)
    t3 = np.zeros((p + 1, m), np.float64)
    t3[:p, 0] = taps[:, 0]          # branch 0: frames t+1 .. t+P
    t3[1:, 1:] = taps[:, :0:-1]     # branch q' = M-q: frames t .. t+P-1
    return t3.astype(np.float32)


class Channelizer(Processor):
    """Maximally-decimated uniform polyphase channelizer.

    Args:
      n_channels: number of uniform channels M (output rate = fs/M).
      taps_per_branch: polyphase taps P per branch (prototype length M*P).
      prototype: optional custom prototype filter (length M*P).

    Input (..., B) complex, B % M == 0; output (..., M, B/M) complex —
    channel c at center frequency c*fs/M (negative bands at M-c).
    """

    def __init__(self, n_channels: int, taps_per_branch: int = 8,
                 prototype: np.ndarray = None):
        super().__init__()
        self.m = int(n_channels)
        self.p = int(taps_per_branch)
        self._proto = prototype

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("Channelizer")
        m, p = self.m, self.p
        in_spec.require_block_multiple("Channelizer", m)
        proto = (np.asarray(self._proto) if self._proto is not None
                 else prototype_lowpass(m, p))
        if len(proto) != m * p:
            raise ConfigError(
                f"Channelizer: prototype length {len(proto)} != M*P = {m * p}")
        # The reverse commutator (branch q reads x[sM - q]) is folded
        # ENTIRELY into host-side constants: lane reversal q -> -q mod M
        # becomes column-reversed taps + a forward (instead of inverse) DFT,
        # and branch 0's one-frame shift becomes an extra tap row — so the
        # device never reverses or re-stacks the stream.
        self._taps = jnp.asarray(fold_commutator(proto, m, p))
        return in_spec.with_(
            channels=in_spec.channels + (m,),
            plane_dtype=None,  # synthesis DFT accumulates in f32
            sample_rate=in_spec.sample_rate / m,
            block_size=in_spec.block_size // m)

    def init_carry(self):
        # P previous raw frames (the reverse commutator needs one frame of
        # look-back on top of the P-1 filter history).
        shape = self.in_spec.channels + (self.p, self.m)
        return cplx.zeros(shape, self.in_spec.real_dtype)

    def apply(self, carry, x):
        # One body, shared with the multi-chip shard_map bodies.
        from libsdr_tpu.parallel.wideband import channelize_segment

        m, p = self.m, self.p
        lead = x.shape[:-1]
        t = x.shape[-1] // m
        y = channelize_segment(x, carry, self._taps, m, p)
        if t >= p:
            # Slice the 1-D stream, then reshape: slicing the (t, m)
            # reshape would materialize the whole reshaped block.
            new_carry = x[..., (t - p) * m:].reshape(lead + (p, m))
        else:
            frames = x.reshape(lead + (t, m))
            new_carry = cplx.concatenate([carry, frames], axis=-2)[..., t:, :]
        return new_carry, y
