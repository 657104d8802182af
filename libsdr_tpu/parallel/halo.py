"""Explicit overlap-save halo exchange for time-sharded streams.

The reference streams state across block boundaries inside one process (FIR
ring buffers, src/firfilter.hh:264-267; FFT overlap-add carries,
src/filternode.hh:163-181).  When the time axis is sharded over a mesh, that
carried state becomes a *halo*: shard i needs the last ``T-1`` samples of
shard i-1.  These helpers run inside ``shard_map`` and move halos with
``jax.lax.ppermute`` over the interconnect (SURVEY.md sections 2.9, 5).

All helpers accept planar-complex pytrees (tree-mapped collectives).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from libsdr_tpu.core import cplx
from libsdr_tpu.core.cplx import Complex


def _tree_ppermute(x, axis_name: str, perm):
    return jax.tree_util.tree_map(
        lambda a: jax.lax.ppermute(a, axis_name, perm), x)


def _tree_where(cond, a, b):
    return jax.tree_util.tree_map(lambda u, v: jnp.where(cond, u, v), a, b)


def pass_right(x, axis_name: str):
    """Send each shard's value to its right neighbor (shard i -> i+1);
    shard 0 receives zeros.  This is the overlap-save halo move."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return _tree_ppermute(x, axis_name, perm)


def last_shard_tail(tail_local, axis_name: str):
    """Return the last shard's local value on every shard (used to carry the
    global stream tail into the next block step)."""
    n = jax.lax.axis_size(axis_name)

    def pick(a):
        g = jax.lax.all_gather(a, axis_name)  # (n, ...)
        return g[n - 1]

    return jax.tree_util.tree_map(pick, tail_local)


def fir_overlap_save_sharded(taps, x_local, tail_global, axis_name: str,
                             stride: int = 1, offset: int = 0):
    """Time-sharded version of :func:`libsdr_tpu.ops.fir.fir_overlap_save`.

    Runs inside ``shard_map``: each shard holds ``x_local`` (..., B/n) of a
    global block; the T-1-sample halo comes from the left neighbor via
    ppermute, with shard 0 consuming ``tail_global`` (the carry from the
    previous global block).  Returns (y_local, new_tail_global).
    """
    from libsdr_tpu.ops.fir import fir_overlap_save

    t = int(jnp.asarray(taps).shape[0]) if hasattr(taps, "shape") else len(taps)
    idx = jax.lax.axis_index(axis_name)
    tail_local = x_local[..., x_local.shape[-1] - (t - 1):]
    halo = pass_right(tail_local, axis_name)
    prev = _tree_where(idx == 0, tail_global, halo)
    y, _ = fir_overlap_save(taps, x_local, prev, stride=stride, offset=offset)
    new_tail = last_shard_tail(tail_local, axis_name)
    return y, new_tail
