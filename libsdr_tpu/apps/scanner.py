"""Wideband pager scanner — the flagship end-to-end pipeline.

One wideband IQ capture -> polyphase channelizer (M uniform channels) ->
per-channel FM discriminator -> ASK + bit-sync PLL (all channels batched on
the device) -> native C++ POCSAG FSMs per channel (host).  The
reference can only do this one channel at a time (examples/sdr_pocsag.cc
tunes a single channel); here the whole band decodes concurrently.

Usage:
  python -m libsdr_tpu.apps.scanner --file wide.wav --channels 64
  python -m libsdr_tpu.apps.scanner --raw rtl.bin --rate 1.6e6 --channels 64
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu import Pipeline, StreamSpec
from libsdr_tpu.core import stream_blocks
from libsdr_tpu.decode import pocsag_decode_bits
from libsdr_tpu.ops import ASKDetector, BitStream, FMDemod
from libsdr_tpu.ops.channelizer import Channelizer
from libsdr_tpu.utils import logging as sdrlog
from libsdr_tpu.utils.options import add_source_args, common_parser, load_source


def scanner_pipeline(fs: float, block: int, n_channels: int,
                     baud: float = 1200.0) -> Pipeline:
    """Channelizer -> FM -> ASK -> BitStream over all M channels at once."""
    p = Pipeline([
        Channelizer(n_channels, taps_per_branch=8),
        FMDemod(),
        ASKDetector(invert=True),   # POCSAG mark(1) = negative deviation
        BitStream(baud, mode="normal"),
    ], name="wideband_pocsag_scanner")
    p.bind(StreamSpec(np.complex64, fs, block))
    return p


def pick_block(fs: float, n_channels: int, block: int = None,
               quantum: int = 16) -> int:
    """~0.5 s of capture rounded down so the per-channel step count is a
    ``quantum``-multiple (16 suits the bit-chain windows; the multimode
    bank passes lcm(16, its PSK31 decimator))."""
    block = int(fs // 2) if block is None else int(block)
    block -= block % (n_channels * quantum)
    if block <= 0:
        raise SystemExit("block too small for the channel count")
    return block


def scanner_step(fs: float, n_channels: int, block: int,
                 baud: float = 1200.0, plane_dtype=None):
    """The scanner's single-device step: (step, init_carry, place_input)
    of parallel/wideband.build_scanner_step with packed output and the
    lossless on-device bit-compaction window."""
    import jax
    from jax.sharding import Mesh
    from libsdr_tpu.core.ragged import min_valid_gap, pick_window
    from libsdr_tpu.parallel.wideband import build_scanner_step

    m = n_channels
    t_full = block // m
    # Windowed on-device bit compaction: the PLL emits bits at least
    # min_valid_gap samples apart, so a window up to that gap is a LOSSLESS
    # T/w decimation of the bit stream — no scatter, no capacity to size
    # (and no overflow to detect).  Largest power-of-two window that
    # divides T and respects the gap (omega_max = baud/fs_ch * 1.005,
    # the BitStream +0.5% clip).
    gap = min_valid_gap((baud / (fs / m)) * 1.005)
    w = pick_window(gap, t_full)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("d",))
    return build_scanner_step(mesh, m, block, fs, baud=baud,
                              compact_window=w, plane_dtype=plane_dtype,
                              packed=True)


def scan_blocks(blocks, fs: float, n_channels: int, block: int,
                baud: float = 1200.0, plane_dtype=None):
    """Core scanner loop over an iterable of (block,)-sized IQ blocks
    (numpy complex or planar Complex, e.g. bf16 planes straight off the
    u8 wire via io.ingest.stream_raw_iq_bf16).  Returns
    {channel_index: [POCSAGMessage, ...]}."""
    m = n_channels
    sstep, sinit, splace = scanner_step(fs, m, block, baud, plane_dtype)
    carry = sinit()
    # Packed bits (one uint8 per slot, bit 0 = data, bit 1 = valid) halve
    # the readback; a 2-deep pending window keeps the device busy while
    # the host drains the previous block.
    packs, pending = [], []
    for blk in blocks:
        carry, y = sstep(carry, splace(blk))
        pending.append(y)
        if len(pending) > 2:
            packs.append(np.asarray(pending.pop(0)))
    packs.extend(np.asarray(y) for y in pending)
    if not packs:            # empty/short capture: nothing to decode
        return {}
    arr = np.concatenate(packs, axis=-1)
    data, valid = arr & 1, arr >= 2
    found = {}
    for ch in range(m):
        msgs = pocsag_decode_bits(data[ch][valid[ch]])
        if msgs:
            found[ch] = msgs
    return found


def scan(iq: np.ndarray, fs: float, n_channels: int, block: int = None,
         baud: float = 1200.0):
    """Decode every channel of a wideband capture; returns
    {channel_index: [POCSAGMessage, ...]} for channels with traffic.

    Uses the single-device scanner step (channelizer + FM -> time-major
    bit chain -> windowed on-device bit compaction, parallel/wideband.py)."""
    block = pick_block(fs, n_channels, block)
    return scan_blocks(stream_blocks(iq, block), fs, n_channels, block,
                       baud=baud)


def main(argv=None):
    ap = common_parser("Wideband POCSAG scanner (channelizer + decoder bank)")
    add_source_args(ap)
    ap.add_argument("--channels", type=int, default=64,
                    help="uniform channels across the capture bandwidth")
    ap.add_argument("--baud", type=float, default=1200.0)
    ap.add_argument("--bf16", action="store_true",
                    help="stream the u8 wire format as bfloat16 planes "
                         "straight into the channelizer — lossless for "
                         "8-bit sources, halves ingest traffic "
                         "(--raw uint8 sources only)")
    ap.add_argument("--live",
                    help="live u8 IQ wire instead of a file: tcp://host:port "
                         "(rtl_tcp pull), tcp-listen://:port (push), "
                         "udp://:port, fifo:///path — requires --rate")
    ap.add_argument("--live-timeout", type=float, default=None,
                    help="stop after this many seconds with no wire data")
    args = ap.parse_args(argv)
    sdrlog.set_level(args.log_level)

    if args.live:
        if not args.rate:
            raise SystemExit("--live requires --rate")
        from libsdr_tpu.io.live import (LiveStats, stream_live_iq,
                                        stream_live_iq_bf16)
        fs = args.rate
        block = pick_block(fs, args.channels)
        stats = LiveStats()
        if args.bf16:   # u8 wire straight to bf16 planes into the PFB
            import jax.numpy as jnp
            src = stream_live_iq_bf16(args.live, block, stats=stats,
                                      timeout=args.live_timeout)
            plane_dtype = jnp.bfloat16
        else:
            src = stream_live_iq(args.live, block, stats=stats,
                                 timeout=args.live_timeout)
            plane_dtype = None
        found = scan_blocks(src, fs, args.channels, block, baud=args.baud,
                            plane_dtype=plane_dtype)
        print(f"live: {stats.bytes_in} bytes in, "
              f"{stats.bytes_dropped} dropped "
              f"({100 * stats.drop_fraction:.2f}%), "
              f"{stats.sustained_msps():.2f} Msps sustained")
    elif args.bf16:
        if not args.raw or np.dtype(args.raw_dtype) != np.uint8:
            raise SystemExit("--bf16 needs a --raw uint8 (rtl_sdr wire) "
                             "source")
        if not args.rate:
            raise SystemExit("--raw requires --rate")
        from libsdr_tpu.io.ingest import stream_raw_iq_bf16
        import jax.numpy as jnp
        fs = args.rate
        block = pick_block(fs, args.channels)
        found = scan_blocks(stream_raw_iq_bf16(args.raw, block), fs,
                            args.channels, block, baud=args.baud,
                            plane_dtype=jnp.bfloat16)
    else:
        iq, fs = load_source(args)
        if not np.iscomplexobj(iq):
            raise SystemExit("scanner expects an IQ capture")
        found = scan(iq, fs, args.channels, baud=args.baud)
    m = args.channels
    for ch in sorted(found):
        f_center = ch * fs / m
        if ch > m // 2:
            f_center -= fs
        for msg in found[ch]:
            print(f"ch {ch:4d} ({f_center / 1e3:+9.1f} kHz): POCSAG "
                  f"@{msg.address} F={msg.function} '{msg.best_decode()}'")
    if not found:
        print("no POCSAG traffic found")
    return found


if __name__ == "__main__":
    main()
