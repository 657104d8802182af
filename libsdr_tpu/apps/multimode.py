"""Multi-mode digital decoder bank sharing ONE wideband front end
(BASELINE.json config 4: "AX.25/APRS + RTTY/PSK31 multi-mode digital
decoder bank sharing one front-end").

One polyphase channelizer pass over the wideband capture (the generalized
form of the reference's shared forward FFT feeding N selectable bands,
/root/reference/src/filternode.hh:231-283) produces all M complex channel
streams at once; a per-channel MODE MAP then routes channel groups into
batched per-mode demod+bit chains — each mode's group runs as ONE pipeline
with a leading channel dim, so 30 POCSAG channels cost one batched chain,
not 30:

  pocsag  FMDemod -> ASK -> BitStream(NORMAL) -> POCSAG FSM
          (reference: examples/sdr_pocsag.cc:110-174)
  ax25    FMDemod -> FSKDetector(1200/2200) -> BitStream(TRANSITION)
          -> HDLC/APRS          (reference: examples/sdr_ax25.cc:109-175)
  rtty    USBDemod -> FSKDetector(930/1100 @ 2x45.45) -> BitStream(NORMAL)
          -> Baudot             (reference: examples/sdr_rtty.cc:37-60)
  psk31   IQBaseBand(200 Hz select, ~2 kHz) -> BPSK31 -> Varicode
          (reference: src/psk31.hh)

Device mapping: the channelizer keeps the complex band so every mode sees
it; the per-mode chains are batched over channels; the bit-sync PLLs of all
modes run as ONE PLL over stacked lanes (the Triton kernel on the GPU); only
the final ~1 kbit/s/channel bit streams reach the host decoders.

Usage:
  python -m libsdr_tpu.apps.multimode --file wide.wav --channels 16 \
      --map "2:pocsag,5:ax25,9:rtty,12:psk31"

Multi-chip: parallel/multimode.py::build_multimode_step runs the same bank
sharded over a device mesh (time-sharded channelizer -> all_to_all ->
channel-sharded mode chains), bit-identical to this single-chip path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from libsdr_tpu import Pipeline, StreamSpec
from libsdr_tpu.core import cplx, stream_blocks
from libsdr_tpu.core.ragged import (Ragged, compact,
                                    compact_windows, min_valid_gap,
                                    pick_window)
from libsdr_tpu.decode import (AX25Decoder, BaudotDecoder,
                               VaricodeDecoder, parse_aprs,
                               pocsag_decode_bits)
from libsdr_tpu.ops import (BPSK31, ASKDetector, BitStream, FMDemod,
                            FSKDetector, IQBaseBand, USBDemod)
from libsdr_tpu.ops.bitsync import apply_mode_chains  # noqa: F401
from libsdr_tpu.ops.channelizer import Channelizer
from libsdr_tpu.utils import logging as sdrlog
from libsdr_tpu.utils.options import add_source_args, common_parser, load_source

MODES = ("pocsag", "ax25", "rtty", "psk31")


def _mode_stages(mode: str):
    if mode == "pocsag":
        return [FMDemod(), ASKDetector(invert=True),
                BitStream(1200.0, mode="normal")]
    if mode == "ax25":
        return [FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0),
                BitStream(1200.0, mode="transition")]
    if mode == "rtty":
        return [USBDemod(), FSKDetector(2 * 45.45, 930.0, 1100.0),
                BitStream(2 * 45.45, mode="normal")]
    if mode == "psk31":
        # Select the 200 Hz PSK31 slot and decimate near the node's 2 kHz
        # operating point (reference: src/psk31.hh:86-92).
        return [IQBaseBand(fc=0.0, width=200.0, order=64,
                           out_rate=2000.0, design="textbook"),
                BPSK31()]
    raise SystemExit(f"unknown mode {mode!r} (use {'/'.join(MODES)})")


def _build_parts(fs: float, block: int, n_channels: int,
                 mode_map: Dict[int, str]):
    """The bank's pieces — (chan, sub, groups, windows)."""
    m = n_channels
    if block % m:
        raise SystemExit("block must divide by the channel count")
    ch_rate = fs / m
    t_full = block // m

    chan = Channelizer(m, taps_per_branch=8)
    chan.bind(StreamSpec(np.complex64, fs, block))

    groups: Dict[str, np.ndarray] = {}
    for ch, mode in sorted(mode_map.items()):
        if not 0 <= ch < m:
            raise SystemExit(f"channel {ch} outside 0..{m - 1}")
        groups.setdefault(mode, []).append(ch)
    groups = {mode: np.asarray(idxs, np.int32)
              for mode, idxs in groups.items()}

    sub, windows = {}, {}
    for mode, idxs in groups.items():
        p = Pipeline(_mode_stages(mode), name=f"bank_{mode}")
        p.bind(StreamSpec(np.complex64, ch_rate, t_full,
                          channels=(len(idxs),)))
        sub[mode] = p
        # Lossless windowed bit compaction (core/ragged.compact_windows):
        # the BitStream PLL's guaranteed bit gap bounds a window that
        # decimates the ragged bit stream on DEVICE — the readback and
        # host compaction shrink w-fold (w=16 for 1200 baud, 256 for
        # RTTY's 45.45).  BPSK31's emission is symbol-clocked, not this
        # PLL — leave it unwindowed.
        bs = p.stages[-1]
        windows[mode] = (pick_window(min_valid_gap(bs), t_full, cap=256)
                         if isinstance(bs, BitStream) else 0)
    return chan, sub, groups, windows


# apply_mode_chains lives in ops/bitsync (library layer) and is
# re-exported here for backward compatibility.


def pack_bank_outputs(outs):
    """Concatenate every mode's Ragged planes into ONE flat u8 buffer.

    A consumer then pays a single device->host fetch per block instead of
    eight (the bank's whole bit output is ~330 KB/block, so a fetch's fixed
    round trip, not its bytes, is what the drain pays).  Order:
    sorted(mode) x (data, valid); invert with
    :func:`unpack_bank_outputs` using :func:`bank_output_layout`."""
    import jax.numpy as jnp

    parts = []
    for mo in sorted(outs):
        r = outs[mo]
        parts.append(r.data.astype(jnp.uint8).reshape(-1))
        parts.append(r.valid.astype(jnp.uint8).reshape(-1))
    return jnp.concatenate(parts)


def bank_output_layout(outs):
    """Static (mode, shape) layout matching :func:`pack_bank_outputs`."""
    return [(mo, tuple(int(s) for s in outs[mo].data.shape))
            for mo in sorted(outs)]


def unpack_bank_outputs(flat: np.ndarray, layout):
    """Host-side inverse of :func:`pack_bank_outputs`:
    returns {mode: (data u8, valid bool)} numpy views."""
    out = {}
    off = 0
    for mo, shape in layout:
        n = int(np.prod(shape))
        data = flat[off:off + n].reshape(shape)
        off += n
        valid = flat[off:off + n].reshape(shape).astype(bool)
        off += n
        out[mo] = (data, valid)
    return out

def build_bank(fs: float, block: int, n_channels: int,
               mode_map: Dict[int, str]):
    """Build the shared-front-end bank.

    Returns (step, init_carry, groups): ``step(carry, x)`` consumes one
    (block,) complex wideband block and returns ``{mode: Ragged bits}``
    with rows ordered like ``groups[mode]`` (the channel indices of that
    mode).  One Channelizer feeds every group; each group is one batched
    pipeline.
    """
    import jax

    chan, sub, groups, windows = _build_parts(fs, block, n_channels,
                                              mode_map)

    def step(carry, x):
        cc, carries = carry
        cc, y = chan.apply(cc, x)                      # (M, T) complex bank
        outs, new = apply_mode_chains(sub, carries, y, groups, windows)
        return (cc, new), outs

    def init_carry():
        return (chan.init_carry(),
                {mode: p.init_carry() for mode, p in sub.items()})

    return jax.jit(step), init_carry, groups


def decode_mode_bits(mode: str, bits: np.ndarray):
    """Host decode of one channel's compacted bit stream, per mode.
    Returns POCSAG message list / AX.25+(APRS) list / RTTY text /
    PSK31 text.  Shared by :func:`scan_multimode` and the sharded bank
    consumers (parallel/multimode.py)."""
    if mode == "pocsag":
        return pocsag_decode_bits(bits)
    if mode == "ax25":
        dec = AX25Decoder()
        dec.process(bits)
        return [(f, parse_aprs(f)) for f in dec.messages]
    if mode == "rtty":
        return BaudotDecoder(stop_bits="1.5").process(bits)
    if mode == "psk31":
        return VaricodeDecoder().process(bits)
    raise SystemExit(f"unknown mode {mode!r} (use {'/'.join(MODES)})")


def _run_bank(blocks, step, carry, place, groups
              ) -> Dict[int, Tuple[str, object]]:
    """Stream ``blocks`` through a bank ``step``, draining each block's
    bits as ONE packed u8 fetch (:func:`pack_bank_outputs`) started
    asynchronously and collected 3 blocks later — device compute, the
    d2h round trip, and the host drain all overlap.  Then
    compact + decode each channel's bit row.  Shared by
    :func:`scan_multimode` and :func:`scan_multimode_sharded` — the only
    difference between them is how the step is built and how a block is
    placed on the device(s)."""
    import jax

    acc = {mode: [] for mode in groups}
    pending = []
    pack_j = layout = None

    def drain(flat):
        for mode, dv in unpack_bank_outputs(np.asarray(flat), layout).items():
            acc[mode].append(dv)

    for blk in blocks:
        carry, outs = step(carry, place(blk))
        if pack_j is None:
            pack_j = jax.jit(pack_bank_outputs)
            layout = bank_output_layout(outs)
        flat = pack_j(outs)
        try:
            flat.copy_to_host_async()
        except Exception:
            pass
        pending.append(flat)
        if len(pending) > 3:
            drain(pending.pop(0))
    for flat in pending:
        drain(flat)

    found: Dict[int, Tuple[str, object]] = {}
    for mode, idxs in groups.items():
        if not acc[mode]:    # empty/short capture: nothing to decode
            continue
        data = np.concatenate([d for d, _ in acc[mode]], axis=-1)
        valid = np.concatenate([v for _, v in acc[mode]], axis=-1)
        for row, ch in enumerate(idxs):
            bits = compact(Ragged(data[row], valid[row]))
            out = decode_mode_bits(mode, bits)
            if (out if not isinstance(out, str) else out.strip()):
                found[int(ch)] = (mode, out)
    return found


def _t_quantum(fs: float, n_channels: int, modes) -> int:
    """Per-block time-step quantum of the mode set: the PSK31 branch
    decimates by D = floor(ch_rate/2000) (the IQBaseBand out_rate
    contract, ops/baseband.py:98-102), so the per-channel step count must
    be a D-multiple; every other mode chain is rate-preserving."""
    if "psk31" not in set(modes):
        return 1
    return max(1, int((fs / n_channels) / 2000.0))


def sharded_bank_block(fs: float, n_channels: int, n_devices: int,
                       mode_pattern, block: int = None, p: int = 8) -> int:
    """Block size of the sharded bank: ~0.5 s by default; the per-channel
    step count must divide by the device count (time shards), hold >=
    n*(P+1) frames, and suit the PSK31 decimator when that mode is in the
    pattern."""
    import math

    m, n = n_channels, n_devices
    req = math.lcm(n, _t_quantum(fs, m, list(mode_pattern)))
    want = int(fs // 2) if block is None else int(block)
    t_full = (want // m) // req * req
    t_full = max(t_full, math.ceil(n * (p + 1) / req) * req)
    return m * t_full


def scan_multimode_sharded(iq: np.ndarray, fs: float, n_channels: int,
                           mode_pattern, block: int = None, devices=None,
                           plane_dtype=None, blocks=None
                           ) -> Dict[int, Tuple[str, object]]:
    """Run the bank SHARDED over a device mesh (all local devices by
    default; n == 1 degenerates to the single-device path).  Channels
    get modes by the repeating ``mode_pattern`` (channel ch ->
    ``mode_pattern[ch % len(pattern)]``); see
    parallel/multimode.build_multimode_step for the stage layout.
    Returns {channel: (mode, decoded)} like :func:`scan_multimode`.

    ``blocks``: optional callable ``block_size -> iterator`` of planar
    blocks replacing the ``iq`` capture (e.g. ``lambda b:
    io.ingest.stream_raw_iq_bf16(path, b)`` with
    ``plane_dtype=jnp.bfloat16`` — the u8 wire streamed as bf16 planes
    straight into the channelizer)."""
    import jax
    from jax.sharding import Mesh
    from libsdr_tpu.parallel.multimode import build_multimode_step

    devs = list(devices) if devices is not None else jax.devices()
    m, n, p = n_channels, len(devs), 8
    pat = list(mode_pattern)
    block = sharded_bank_block(fs, m, n, pat, block)
    mesh = Mesh(np.asarray(devs), ("d",))
    step, init_carry, place, groups = build_multimode_step(
        mesh, m, block, fs, pat, taps_per_branch=p,
        plane_dtype=plane_dtype)
    src = blocks(block) if blocks is not None else stream_blocks(iq, block)
    return _run_bank(src, step, init_carry(), place, groups)


def scan_multimode(iq: np.ndarray, fs: float, n_channels: int,
                   mode_map: Dict[int, str], block: int = None,
                   blocks=None) -> Dict[int, Tuple[str, object]]:
    """Run the bank over a capture; returns {channel: (mode, decoded)}.

    decoded: POCSAG message list / AX.25+APRS message list / RTTY text /
    PSK31 text, per the channel's mode.  ``blocks``: optional callable
    ``block_size -> iterator`` replacing the ``iq`` capture (e.g. a live
    wire via ``io.live.stream_live_iq``)."""
    import math

    from libsdr_tpu.apps.scanner import pick_block
    m = n_channels
    # Scanner sizing (t_full a 16-multiple) + a multiple of the PSK31
    # decimator when that mode is mapped.
    block = pick_block(fs, m, block,
                       quantum=math.lcm(16, _t_quantum(fs, m,
                                                       mode_map.values())))
    step, init_carry, groups = build_bank(fs, block, m, mode_map)
    src = blocks(block) if blocks is not None else stream_blocks(iq, block)
    return _run_bank(src, step, init_carry(), cplx.as_block, groups)


def _parse_map(s: str) -> Dict[int, str]:
    out = {}
    for item in s.split(","):
        if not item.strip():
            continue
        ch, _, mode = item.partition(":")
        out[int(ch)] = mode.strip().lower()
    if not out:
        raise SystemExit("empty --map (want e.g. '2:pocsag,5:ax25')")
    return out


def main(argv=None):
    ap = common_parser(
        "Multi-mode decoder bank: one channelizer front end, per-channel "
        "POCSAG/AX.25/RTTY/PSK31 decode (BASELINE config 4)")
    add_source_args(ap)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--map",
                    help="per-channel modes, e.g. '2:pocsag,5:ax25,9:rtty'")
    ap.add_argument("--pattern",
                    help="repeating channel->mode pattern (e.g. "
                         "'pocsag,ax25,rtty,psk31'): every channel gets a "
                         "mode and the bank runs SHARDED over all local "
                         "devices (parallel/multimode.py)")
    ap.add_argument("--bf16", action="store_true",
                    help="stream the u8 wire format as bfloat16 planes "
                         "straight into the channelizer — lossless for "
                         "8-bit sources, halves ingest traffic "
                         "(--raw uint8 / --live sources)")
    ap.add_argument("--live",
                    help="live u8 IQ wire instead of a file: tcp://host:port "
                         "(rtl_tcp pull), tcp-listen://:port, udp://:port, "
                         "fifo:///path — requires --rate")
    ap.add_argument("--live-timeout", type=float, default=None,
                    help="stop after this many seconds with no wire data")
    args = ap.parse_args(argv)
    sdrlog.set_level(args.log_level)
    if bool(args.map) == bool(args.pattern):
        raise SystemExit("give exactly one of --map / --pattern")
    if args.pattern:
        pat = [p.strip().lower() for p in args.pattern.split(",") if p.strip()]
        bad = [p for p in pat if p not in MODES]
        if bad or not pat:
            raise SystemExit(f"--pattern modes must be in {'/'.join(MODES)}")

    if args.live:
        if not args.rate:
            raise SystemExit("--live requires --rate")
        from libsdr_tpu.io.live import (LiveStats, stream_live_iq,
                                        stream_live_iq_bf16)
        fs = args.rate
        stats = LiveStats()
        if args.bf16:
            import jax.numpy as jnp
            blocks = lambda b: stream_live_iq_bf16(  # noqa: E731
                args.live, b, stats=stats, timeout=args.live_timeout)
            plane_dtype = jnp.bfloat16
        else:
            blocks = lambda b: stream_live_iq(  # noqa: E731
                args.live, b, stats=stats, timeout=args.live_timeout)
            plane_dtype = None
        if args.pattern:
            found = scan_multimode_sharded(None, fs, args.channels, pat,
                                           plane_dtype=plane_dtype,
                                           blocks=blocks)
        else:
            if plane_dtype is not None:
                raise SystemExit("--bf16 --live runs the sharded bank: "
                                 "use --pattern")
            found = scan_multimode(None, fs, args.channels,
                                   _parse_map(args.map), blocks=blocks)
        print(f"live: {stats.bytes_in} bytes in, "
              f"{stats.bytes_dropped} dropped "
              f"({100 * stats.drop_fraction:.2f}%), "
              f"{stats.sustained_msps():.2f} Msps sustained")
    elif args.bf16:
        if not args.pattern:
            raise SystemExit("--bf16 runs the sharded bank: use --pattern")
        if not args.raw or np.dtype(args.raw_dtype) != np.uint8:
            raise SystemExit("--bf16 needs a --raw uint8 (rtl_sdr wire) "
                             "source")
        if not args.rate:
            raise SystemExit("--raw requires --rate")
        import jax.numpy as jnp
        from libsdr_tpu.io.ingest import stream_raw_iq_bf16
        fs = args.rate
        found = scan_multimode_sharded(
            None, fs, args.channels, pat, plane_dtype=jnp.bfloat16,
            blocks=lambda b: stream_raw_iq_bf16(args.raw, b))
    else:
        iq, fs = load_source(args)
        if not np.iscomplexobj(iq):
            raise SystemExit("multimode expects an IQ capture")
        if args.pattern:
            found = scan_multimode_sharded(iq, fs, args.channels, pat)
        else:
            mode_map = _parse_map(args.map)
            found = scan_multimode(iq, fs, args.channels, mode_map)
    m = args.channels
    for ch in sorted(found):
        mode, out = found[ch]
        f_center = ch * fs / m if ch <= m // 2 else ch * fs / m - fs
        hdr = f"ch {ch:4d} ({f_center / 1e3:+9.1f} kHz) [{mode}]"
        if mode == "pocsag":
            for msg in out:
                print(f"{hdr}: POCSAG @{msg.address} '{msg.best_decode()}'")
        elif mode == "ax25":
            for frame, aprs in out:
                print(f"{hdr}: {frame}")
                if aprs is not None:
                    print(f"{hdr}:   {aprs}")
        else:
            print(f"{hdr}: {out.strip()}")
    if not found:
        print("no traffic decoded")
    return found


if __name__ == "__main__":
    main()
