"""Multi-chip wideband receiver: time-sharded channelizer + channel-sharded
demod bank — the flagship scale-out pipeline (BASELINE.json config 5).

Stage layout over an n-device 1-D mesh ('d',):

1. **Channelize + demodulate, time-sharded**: the wideband block (B,) is
   split along time; each device runs the polyphase channelizer and the
   quadrature FM discriminator on its B/n segment.  The P-frame filter
   history arrives as a ppermute halo (the distributed form of the
   channelizer carry).  The discriminator's y[-1] seed is the LEFT
   neighbor's last channelizer output: each shard recomputes its own last
   frame's y with the in-path op sequence (:func:`_seed_from_frames`) and
   hands it right in a second tiny (1, M) ppermute, so only f32 audio
   crosses the interconnect in bulk.
2. **Reshard**: one all_to_all turns (t/n local time, M channels) into
   (t full time, M/n local channels) — the decimated AUDIO crosses the
   interconnect once (half the bytes of the complex channel bank).
3. **Per-channel decode, channel-sharded**: each device owns M/n channels
   over the full block; sequential per-channel state (bit-sync PLL) stays
   device-local.

This is the moral equivalent of sequence parallelism (stage 1) feeding data
parallelism (stage 3) with a single collective between them.  n == 1
degenerates to the single-device program (collectives skipped statically).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from libsdr_tpu.core import cplx
from libsdr_tpu.core.cplx import Complex
from libsdr_tpu.ops.channelizer import fold_commutator, prototype_lowpass
from libsdr_tpu.ops.fft import fft
from libsdr_tpu.parallel.halo import _tree_where, last_shard_tail, pass_right


def _channelize_tm(x_local: Complex, hist: Complex, taps3: jnp.ndarray,
                   m: int, p: int) -> Complex:
    """Channelizer body on a time segment given the P-frame history, in
    TIME-major layout: returns the (..., t, M) complex bank."""
    lead = x_local.shape[:-1]
    t = x_local.shape[-1] // m
    frames = x_local.reshape(lead + (t, m))
    histf = cplx.concatenate([hist, frames], axis=-2)
    acc = None
    for k in range(p + 1):
        seg = histf[..., (p - k):(p - k) + t, :]
        term = seg * taps3[k]
        acc = term if acc is None else acc + term
    return fft(acc)


def channelize_segment(x_local: Complex, hist: Complex, taps3: jnp.ndarray,
                       m: int, p: int) -> Complex:
    """Channelizer body on a time segment given the P-frame history (the
    math of ops/channelizer.py Channelizer.apply: commutator folded into
    ``taps3 = fold_commutator(...)`` + forward DFT).  Returns the
    (..., M, t) channel-major complex bank; shared by the single-device
    Channelizer and the sharded bodies."""
    y = _channelize_tm(x_local, hist, taps3, m, p)
    return y.map(lambda a: jnp.swapaxes(a, -1, -2))


def _seed_from_frames(framesp1: Complex, taps3: jnp.ndarray, m: int,
                      p: int) -> Complex:
    """y (1, M) of the single frame ``framesp1[p]`` given its own P-frame
    history ``framesp1[:p]`` — a device's OWN last channelizer output, which
    rides a (1, M) ppermute to the right neighbor as its discriminator
    seed.  Same op sequence as :func:`_channelize_tm` on a one-frame
    segment."""
    acc = None
    for k in range(p + 1):
        seg = framesp1[..., (p - k):(p - k) + 1, :]
        term = seg * taps3[k]
        acc = term if acc is None else acc + term
    # Tile the single frame to 8 rows before the DFT: a 1-row fft lowers to
    # a matvec whose reduction order differs from the multi-row matmul
    # (measured: 8.6e-7 divergence on CPU), while any >=2-row shape is
    # bitwise row-deterministic on the CPU.
    acc = acc.map(lambda a: jnp.broadcast_to(
        a, a.shape[:-2] + (8, a.shape[-1])))
    return fft(acc)[..., 0:1, :]


def wideband_fm_local(x, hist, prev, taps3, m: int, p: int,
                      gain: float = 1.0):
    """Channelize + quadrature FM demod of one device-local segment.

    Args:
      x: (..., B_local) planar complex 1-D segment (B_local % m == 0).
      hist: (..., P, M) planar carry/halo frames preceding the segment.
      prev: (..., 1, M) planar y[-1] per channel (discriminator seed).
      taps3: folded-commutator taps.

    Returns (audio (..., F, M) f32 time-major, y_last (..., 1, M) planar —
    the next segment's ``prev``)."""
    y = _channelize_tm(x, hist, taps3, m, p)                 # (..., F, M)
    f_total = x.shape[-1] // m
    shifted = cplx.concatenate([prev, y[..., :-1, :]], axis=-2)
    audio = (y * shifted.conj()).angle() * gain
    return audio, y[..., f_total - 1:f_total, :]


def build_wideband_step(mesh: Mesh, n_channels: int, block: int,
                        taps_per_branch: int = 8, axis: str = "d",
                        gain: float = 1.0, plane_dtype=None):
    """Build (step, init_carry, place_input) for the sharded wideband RX.

    ``step(carry, x)`` consumes a global (B,) complex block and returns the
    FM-demodulated (M, B/M) float32 channel bank, jit-compiled over the mesh
    with shard_map (see module docstring).
    """
    n = int(mesh.devices.size)
    m, p = n_channels, taps_per_branch
    _validate(block, m, n, p)
    taps = _taps(m, p)

    def step_local(carry, x_local):
        return _wideband_body(carry, x_local, taps, m, p, n, axis, gain)

    if n == 1:
        body = step_local
    else:
        body = jax.shard_map(
            step_local, mesh=mesh,
            in_specs=(_carry_specs(), P(axis)),
            out_specs=(_carry_specs(), P(None, axis)),
            check_vma=False,
        )

    def step(carry, x):
        carry, audio_cols = body(carry, x)        # (t_full, M or M/n local)
        return carry, jnp.swapaxes(audio_cols, -1, -2)

    init_carry, place_input = _wideband_carry_and_place(
        mesh, m, p, axis, plane_dtype)
    return jax.jit(step), init_carry, place_input


def _validate(block: int, m: int, n: int, p: int) -> None:
    if block % (m * n):
        raise ValueError("block must divide by M * n_devices")
    if m % n:
        raise ValueError("channels must divide by n_devices")
    if block // (m * n) < p + 1:
        raise ValueError(
            "each device's segment must hold >= taps_per_branch + 1 frames "
            f"(block // (M*n) = {block // (m * n)} < P + 1 = {p + 1})")


def _taps(m: int, p: int):
    return jnp.asarray(fold_commutator(prototype_lowpass(m, p), m, p))


def _carry_specs():
    # P-frame history + y[-1] lane seed, both replicated (they describe
    # the GLOBAL stream boundary; shard 0 consumes them).
    return (P(), P())


def _wideband_body(carry, x_local, taps, m: int, p: int, n: int,
                   axis: str, gain: float = 1.0):
    """The unified per-device wideband stages:

    1. ppermute P-frame halo (the channelizer history),
    2. channelize + FM demod of the segment (:func:`wideband_fm_local`),
       seeded at the shard boundary with the left neighbor's own last
       channelizer output (a second (1, M) ppermute),
    3. all_to_all reshard of the f32 audio: time-sharded ->
       channel-sharded.

    carry = (hist (P, M) raw frames, prev (1, M) y seed), both
    global-stream state.  Returns (new_carry, audio): (t_full, M/n)
    time-major, channel-ordered columns."""
    hist_g, prev_g = carry
    t_seg = x_local.shape[-1] // m
    # Slice the 1-D stream FIRST, then reshape the small piece: slicing a
    # reshape of the full block would materialize the whole reshaped array.
    tail = x_local[..., (t_seg - p) * m:].reshape((p, m))
    prev = prev_g
    if n == 1:
        # Collectives on a 1-device mesh are identities: skip them
        # statically.
        hist = hist_g
        new_hist = tail
    else:
        idx = jax.lax.axis_index(axis)
        hist = _tree_where(idx == 0, hist_g, pass_right(tail, axis))
        new_hist = last_shard_tail(tail, axis)
        # Shard-boundary discriminator seed: each shard computes its OWN
        # last frame's y and hands it right; shard 0 uses the carried
        # global seed.
        tailp1 = x_local[..., (t_seg - (p + 1)) * m:].reshape((p + 1, m))
        my_last = _seed_from_frames(tailp1, taps, m, p)
        prev = _tree_where(idx == 0, prev_g, pass_right(my_last, axis))
    audio, y_last = wideband_fm_local(x_local, hist, prev, taps, m, p,
                                      gain=gain)
    new_prev = y_last if n == 1 else last_shard_tail(y_last, axis)
    if n > 1:
        audio = jax.lax.all_to_all(audio, axis, split_axis=1,
                                   concat_axis=0, tiled=True)
    return (new_hist, new_prev), audio                  # (t_full, M/n)


def _wideband_carry_and_place(mesh: Mesh, m: int, p: int, axis: str,
                              plane_dtype=None):
    """(init_carry, place_input) shared by the wideband/scanner builders.

    Placement goes through :func:`parallel.distributed.place_global`, so the
    same builders run unchanged in multi-process (DCN) deployments — each
    host then materializes only its own shards (host-sharded ingest)."""
    from libsdr_tpu.parallel.distributed import place_global

    dtype = plane_dtype if plane_dtype is not None else jnp.float32

    def init_carry():
        hist = jax.tree_util.tree_map(
            lambda a: place_global(a, mesh, P()),
            cplx.zeros((p, m), dtype))
        prev = jax.tree_util.tree_map(
            lambda a: place_global(a, mesh, P()),
            cplx.full_like_phasor((1, m)))
        return (hist, prev)

    def place_input(x):
        xb = cplx.as_block(x)
        return jax.tree_util.tree_map(
            lambda a: place_global(a, mesh, P(axis)), xb)

    return init_carry, place_input


def build_scanner_step(mesh: Mesh, n_channels: int, block: int,
                       fs_hz: float, taps_per_branch: int = 8,
                       baud: float = 1200.0, axis: str = "d",
                       compact_window: int = 0, plane_dtype=None,
                       packed: bool = False):
    """Sharded whole-band pager scanner: the unified wideband stages
    (time-sharded channelize+FM -> all_to_all audio reshard) extended with
    the ASK detector and bit-sync PLL, all in the PLL's TIME-major layout.
    After the reshard each device owns M/n channels over the FULL block, so
    the per-channel sequential PLL runs device-local (the Triton kernel on
    the GPU, ops/pll_triton.py).

    ``step(carry, x)`` consumes a global (B,) complex block and returns a
    Ragged (M, T') uint8 bit stream (rows = channels, channel-major) —
    compact each channel's row and feed it to decode.pocsag_decode_bits.
    T' = B/M, or B/M/compact_window when ``compact_window`` > 0: the PLL
    emits bits >= ~fs_ch/baud samples apart (core/ragged.py
    ``min_valid_gap``), so any window up to that gap losslessly decimates
    the bit stream ON DEVICE with a windowed reduce instead of a scatter
    compaction.  Must divide B/M and not exceed the gap.
    """
    from libsdr_tpu import StreamSpec
    from libsdr_tpu.core.ragged import Ragged, min_valid_gap
    from libsdr_tpu.ops import ASKDetector, BitStream

    n = int(mesh.devices.size)
    m, p = n_channels, taps_per_branch
    _validate(block, m, n, p)
    taps = _taps(m, p)
    t_full = block // m
    ch_rate = fs_hz / m
    g = m // n                       # channels per device after the reshard
    w = int(compact_window)

    # The bit chain runs time-major on the device-local channel group; a
    # GLOBAL binding builds the carry pytree (per-channel leaves sharded).
    def make_chain(nch):
        ask = ASKDetector(invert=True)
        bs = BitStream(baud, mode="normal", time_major=True)
        spec = StreamSpec(np.float32, ch_rate, t_full, channels=(nch,))
        bs.bind(ask.bind(spec))
        return ask, bs

    ask_l, bs_l = make_chain(g)
    _, bs_g = make_chain(m)
    if w:
        if t_full % w:
            raise ValueError(f"compact_window {w} must divide T={t_full}")
        if w > min_valid_gap(bs_g):
            raise ValueError(
                f"compact_window {w} exceeds the PLL's guaranteed bit gap "
                f"{min_valid_gap(bs_g)} — bits could be lost")

    def _window_rows(a, fill):
        # (T, C) time-major -> (T/w, C): <=1 valid per window (see above).
        if not w:
            return a
        t = a.shape[0]
        aw = a.reshape((t // w, w) + a.shape[1:])
        if a.dtype == jnp.bool_:
            return jnp.any(aw, axis=1)
        return jnp.sum(jnp.where(fill.reshape(aw.shape), aw, 0),
                       axis=1).astype(a.dtype)

    def _out(data, vw):
        # (C, T') channel-major: Ragged, or ONE uint8 array with bit 0 =
        # data and bit 1 = valid (``packed``) — halves the device->host
        # readback bytes.
        data = jnp.swapaxes(data, -1, -2)
        vw = jnp.swapaxes(vw, -1, -2)
        if packed:
            return data | (vw.astype(jnp.uint8) << 1)
        return Ragged(data, vw)

    def _bits_out(bits):
        # time-major (T, C) -> windowed -> channel-major contract
        valid = bits.valid
        return _out(_window_rows(bits.data, valid),
                    _window_rows(valid, valid))

    def step_local(carry, x_local):
        wb_carry, bsc = carry
        wb_carry, audio_cols = _wideband_body(
            wb_carry, x_local, taps, m, p, n, axis)
        # audio_cols: (t_full, g) time-major, channel-ordered columns —
        # exactly the bit chain's time_major layout.
        _, sym = ask_l.apply(None, audio_cols)
        bsc, bits = bs_l.apply(bsc, sym)
        return (wb_carry, bsc), _bits_out(bits)

    if n == 1:
        step = jax.jit(step_local)
    else:
        def leaf_spec(v):
            return P() if np.ndim(v) == 0 else P(
                axis, *([None] * (np.ndim(v) - 1)))
        bs_carry_spec = jax.tree_util.tree_map(leaf_spec, bs_g.init_carry())
        step = jax.jit(jax.shard_map(
            step_local, mesh=mesh,
            in_specs=((_carry_specs(), bs_carry_spec), P(axis)),
            out_specs=((_carry_specs(), bs_carry_spec),
                       (P(axis, None) if packed
                        else Ragged(P(axis, None), P(axis, None)))),
            check_vma=False,
        ))

    wb_init, place_input = _wideband_carry_and_place(
        mesh, m, p, axis, plane_dtype)

    def init_carry():
        from libsdr_tpu.parallel.distributed import place_global
        bsc = jax.tree_util.tree_map(
            lambda v: place_global(
                v, mesh, P() if v.ndim == 0 else P(axis)),
            bs_g.init_carry())
        return (wb_init(), bsc)

    return step, init_carry, place_input
