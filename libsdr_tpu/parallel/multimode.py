"""Multi-chip multi-mode decoder bank: time-sharded channelizer +
channel-sharded per-mode demod/decode chains (the scale-out form of
BASELINE.json config 4, generalizing the reference's shared forward FFT
feeding N selectable bands, /root/reference/src/filternode.hh:231-283).

Stage layout over an n-device 1-D mesh ('d',), mirroring
parallel/wideband.py:

1. **Channelize, time-sharded**: each device runs the polyphase
   channelizer (:func:`parallel.wideband.channelize_segment`) on its B/n
   segment of the wideband block; the P-frame filter history arrives as a
   ppermute halo.  Unlike the FM scanner, the COMPLEX channel bank is kept
   (the mode chains need it: USB for RTTY, PSK31's own baseband select).
2. **Reshard**: one all_to_all turns (M channels, t/n local time) into
   (M/n local channels, t full time) — the complex channel bank crosses
   the interconnect once.
3. **Per-mode decode, channel-sharded**: each device owns M/n channels
   over the full block and runs ALL four mode chains on its local channel
   groups.  For this to be one SPMD program, the channel->mode assignment
   must look the same on every device: modes are assigned by a repeating
   ``mode_pattern`` over the global channel index (channel ch gets
   ``mode_pattern[ch % len(mode_pattern)]``), with the pattern length
   dividing the per-device group M/n.  Sequential per-channel state (PLL,
   FSK correlator tails, PSK31 costas loop) stays device-local; outputs
   are windowed-compacted bit streams (~kbit/s/channel readback).

n == 1 degenerates to the single-chip bank (collectives skipped
statically; bit-identical to the n-device run — asserted by
tests/test_parallel.py).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from libsdr_tpu.core import cplx
from libsdr_tpu.core.ragged import Ragged, compact_windows, min_valid_gap, \
    pick_window
from libsdr_tpu.parallel.halo import _tree_where, last_shard_tail, pass_right
from libsdr_tpu.parallel.wideband import _taps, _validate, channelize_segment


def build_multimode_step(mesh: Mesh, n_channels: int, block: int,
                         fs_hz: float, mode_pattern: Sequence[str],
                         taps_per_branch: int = 8, axis: str = "d",
                         plane_dtype=None):
    """Build (step, init_carry, place_input, groups) for the sharded
    multi-mode bank.

    ``step(carry, x)`` consumes a global (B,) complex wideband block and
    returns ``{mode: Ragged bits}`` — rows ordered like ``groups[mode]``
    (ascending global channel indices of that mode), each row that mode's
    windowed bit stream (compacted T/window slots; PSK31 unwindowed).
    Feed the compacted rows to the host decoders exactly as
    apps/multimode.py does.

    ``mode_pattern``: repeating channel->mode assignment, e.g.
    ``("pocsag", "ax25", "rtty", "psk31")`` gives channel ch the mode
    ``mode_pattern[ch % 4]``.  Its length must divide M / n_devices.

    ``plane_dtype``: input plane dtype (e.g. ``jnp.bfloat16`` for blocks
    straight off the u8 wire via io.ingest.stream_raw_iq_bf16 — lossless
    for 8-bit sources, halves ingest and device-memory traffic; the
    channelizer consumes bf16 planes directly and the mode chains see the
    f32 channel bank).
    """
    from libsdr_tpu import Pipeline, StreamSpec
    from libsdr_tpu.apps.multimode import _mode_stages
    from libsdr_tpu.ops import BitStream
    from libsdr_tpu.parallel.distributed import place_global

    n = int(mesh.devices.size)
    m, p = int(n_channels), int(taps_per_branch)
    _validate(block, m, n, p)
    taps = _taps(m, p)
    t_full = block // m
    ch_rate = fs_hz / m
    g = m // n                        # channels per device after reshard
    pat = list(mode_pattern)
    if g % len(pat):
        raise ValueError(f"mode_pattern length {len(pat)} must divide the "
                         f"per-device channel group M/n = {g}")

    # Local mode groups — identical on every device because the pattern
    # repeats within each contiguous g-channel shard (g % len(pat) == 0).
    modes = sorted(set(pat))
    loc_groups = {mode: np.asarray(
        [i for i in range(g) if pat[i % len(pat)] == mode], np.int32)
        for mode in modes}
    groups = {mode: np.asarray(
        [d * g + i for d in range(n) for i in loc_groups[mode]], np.int32)
        for mode in modes}

    # Per-mode chains: LOCAL pipelines (the shard_map body's program, bound
    # to that mode's device-local group size) + GLOBAL ones (carry building
    # and shard specs) — the scanner's make_chain pattern.
    def make(mode: str, nch: int) -> Pipeline:
        pl = Pipeline(_mode_stages(mode), name=f"bank_{mode}")
        pl.bind(StreamSpec(np.complex64, ch_rate, t_full, channels=(nch,)))
        return pl

    sub_l = {mode: make(mode, len(loc_groups[mode])) for mode in modes}
    sub_g = {mode: make(mode, len(groups[mode])) for mode in modes}

    windows = {}
    for mode in modes:
        bs = sub_l[mode].stages[-1]
        windows[mode] = (pick_window(min_valid_gap(bs), t_full, cap=256)
                         if isinstance(bs, BitStream) else 0)

    def step_local(carry, x_local):
        hist_g, carries = carry
        t_loc = x_local.shape[-1] // m
        # Slice the 1-D stream first (reshape-then-slice would materialize
        # the whole block).
        tail = x_local[..., (t_loc - p) * m:].reshape((p, m))
        if n == 1:
            hist = hist_g
            new_hist = tail
        else:
            idx = jax.lax.axis_index(axis)
            halo = pass_right(tail, axis)
            hist = _tree_where(idx == 0, hist_g, halo)
            new_hist = last_shard_tail(tail, axis)
        y = channelize_segment(x_local, hist, taps, m, p)  # (M, t_loc)
        if n > 1:
            # (M, t/n) time-sharded -> (M/n, t_full) channel-sharded: the
            # complex bank crosses the interconnect once.
            y = y.map(lambda a: jax.lax.all_to_all(
                a, axis, split_axis=0, concat_axis=1, tiled=True))
        # Per-mode chains with all BitStream PLLs merged into ONE PLL
        # per device (ops/bitsync.apply_mode_chains).
        from libsdr_tpu.ops.bitsync import apply_mode_chains
        outs, new_c = apply_mode_chains(sub_l, carries, y, loc_groups,
                                        windows)
        return (new_hist, new_c), outs

    def leaf_spec(v):
        return P() if np.ndim(v) == 0 else P(
            axis, *([None] * (np.ndim(v) - 1)))

    in_dtype = plane_dtype if plane_dtype is not None else jnp.float32
    hist_spec = jax.tree_util.tree_map(lambda _: P(),
                                       cplx.zeros((p, m)))
    carries_spec = {mode: jax.tree_util.tree_map(
        leaf_spec, sub_g[mode].init_carry()) for mode in modes}
    out_spec = {mode: Ragged(P(axis, None), P(axis, None))
                for mode in modes}

    if n == 1:
        step = jax.jit(step_local)
    else:
        step = jax.jit(jax.shard_map(
            step_local, mesh=mesh,
            in_specs=((hist_spec, carries_spec), P(axis)),
            out_specs=((hist_spec, carries_spec), out_spec),
            check_vma=False,
        ))

    def init_carry():
        hist = jax.tree_util.tree_map(
            lambda a: place_global(a, mesh, P()), cplx.zeros((p, m),
                                                             in_dtype))
        carries = {}
        for mode in modes:
            cg = sub_g[mode].init_carry()
            carries[mode] = jax.tree_util.tree_map(
                lambda a, s: place_global(a, mesh, s), cg,
                jax.tree_util.tree_map(leaf_spec, cg))
        return (hist, carries)

    def place_input(x):
        xb = cplx.as_block(x)
        return jax.tree_util.tree_map(
            lambda a: place_global(a, mesh, P(axis)), xb)

    return step, init_carry, place_input, groups
