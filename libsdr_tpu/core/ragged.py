"""Ragged block outputs.

Decoders emit a variable number of items per fixed-size input block (bits from
the bit-sync PLL, chars from Varicode...).  The reference handles this with
variable-length ``Buffer::head(o)`` views (e.g. src/fsk.cc:201); under XLA
shapes must be static, so a ragged stream is a fixed-capacity ``data`` array
plus a boolean ``valid`` mask, compacted on the host with :func:`compact`.
"""

from __future__ import annotations

import jax
import numpy as np


@jax.tree_util.register_pytree_node_class
class Ragged:
    """Fixed-capacity block with a validity mask (time = trailing axis)."""

    __slots__ = ("data", "valid")

    def __init__(self, data, valid):
        self.data = data
        self.valid = valid

    def tree_flatten(self):
        return (self.data, self.valid), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.data.shape

    def __repr__(self):
        return f"Ragged(capacity={self.data.shape}, dtype={self.data.dtype})"


def compact(r):
    """Host-side: extract the valid items of a (possibly multi-block
    concatenated) ragged stream.  1-D streams return a dense np.ndarray;
    channel banks return a list of per-channel vectors (flattened over any
    leading channel dims)."""
    data = np.asarray(r.data)
    valid = np.asarray(r.valid).astype(bool)
    if data.ndim == 1:
        return data[valid]
    # leading channel dims: return an object array of per-channel vectors
    flat_d = data.reshape(-1, data.shape[-1])
    flat_v = valid.reshape(-1, valid.shape[-1])
    return [d[v] for d, v in zip(flat_d, flat_v)]


def compact_device(r, capacity: int):
    """On-device compaction: scatter the valid items of each channel's row
    to the front of a fixed ``capacity`` buffer.  Returns (data (..., cap),
    counts (...)).

    Use before reading decoder bit streams back to the host: a bit-sync PLL
    emits ~baud/fs valid slots (e.g. 5%), so compacting on-device cuts the
    device->host transfer by ~1/valid_fraction.  Items beyond
    ``capacity`` are dropped (size generously: cap >= expected + margin).

    ``counts`` is the UNCLAMPED valid count, so overflow is detectable:
    ``counts > capacity`` means items were dropped (the first ``capacity``
    are kept).  Host-side slicing ``data[..., :count]`` clips naturally.
    """
    import jax.numpy as jnp

    data, valid = r.data, r.valid.astype(bool)
    pos = jnp.cumsum(valid.astype(jnp.int32), axis=-1) - 1
    idx = jnp.where(valid, pos, capacity)          # invalid -> dropped slot
    out = jnp.zeros(data.shape[:-1] + (capacity + 1,), data.dtype)
    if data.ndim == 1:
        out = out.at[idx].set(data, mode="drop")
    else:
        out = jax.vmap(lambda o, i, d: o.at[i].set(d, mode="drop"))(
            out.reshape(-1, capacity + 1),
            idx.reshape(-1, idx.shape[-1]),
            data.reshape(-1, data.shape[-1])
        ).reshape(data.shape[:-1] + (capacity + 1,))
    return out[..., :capacity], valid.sum(axis=-1)


def compact_windows(r: "Ragged", window: int) -> "Ragged":
    """LOSSLESS on-device decimation of a ragged stream whose valid slots
    are guaranteed > ``window - 1`` samples apart (``window`` <=
    :func:`min_valid_gap`): fold the LAST axis into (T/window, window) and
    reduce each window to its (at most one) valid item.  Returns a Ragged
    with T/window slots — the readback and host-side compaction shrink by
    the same factor.  Used by the multimode decoder bank; the scanner's
    time-major twin lives in parallel/wideband.py::build_scanner_step."""
    import jax.numpy as jnp

    data, valid = r.data, r.valid.astype(bool)
    t = data.shape[-1]
    if t % window:
        raise ValueError(f"compact_windows: T={t} not divisible by "
                         f"window={window}")
    shape = data.shape[:-1] + (t // window, window)
    # <= 1 valid item per window, so a masked sum IS that item (exact for
    # any dtype, not just 0/1 bits).
    dw = jnp.sum(jnp.where(valid.reshape(shape), data.reshape(shape), 0),
                 axis=-1).astype(data.dtype)
    vw = jnp.any(valid.reshape(shape), axis=-1)
    return Ragged(dw, vw)


def min_valid_gap(bitstream_or_omega) -> int:
    """Guaranteed minimum sample gap between valid bits of a bit-sync PLL
    (a bound BitStream, or its omega_max as a float).

    The PLL advances phase by omega <= omega_max per step and emits when
    phase wraps 1.0; after an emission the residual phase is STRICTLY
    below omega_max, so m further steps can emit only when
    m*omega_max > 1 - omega_max, i.e. consecutive emissions are
    >= floor(1/omega_max) steps apart (exactly 1/omega_max when it is an
    integer).  NOT ceil: with residual just under omega_max the next bit
    lands one sample earlier than ceil would suggest, so sizing a
    compaction window by ceil can merge two valid bits.

    A window of w samples is lossless iff two bits can never share one
    window, i.e. w <= this gap (max in-window separation is w - 1)."""
    import math

    om = (float(bitstream_or_omega)
          if isinstance(bitstream_or_omega, (int, float))
          else float(bitstream_or_omega._omega_max))
    return int(math.floor(1.0 / om))


def pick_window(gap: int, t_full: int, cap: int = 64) -> int:
    """Largest power-of-two compaction window that divides ``t_full`` and
    respects the PLL's guaranteed bit gap (:func:`min_valid_gap`) — the
    single place the lossless-window sizing policy lives (scanner and
    multimode bank both use it).  Returns 0 when no window >= 2 fits."""
    w = 1
    while w * 2 <= min(gap, cap) and t_full % (w * 2) == 0:
        w *= 2
    return w if w > 1 else 0


def concat_host(blocks) -> "Ragged":
    """Concatenate host-side ragged blocks along time."""
    return Ragged(np.concatenate([np.asarray(b.data) for b in blocks], axis=-1),
                  np.concatenate([np.asarray(b.valid) for b in blocks], axis=-1))
