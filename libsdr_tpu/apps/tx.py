"""Signal generator / transmitter CLI — synthesize captures for every
protocol the receivers decode.

The reference ships no transmitter at all (its examples consume live
hardware); this framework's fixture encoders (protocol framers + modulators)
are packaged here as a CLI so users can generate test captures, loopback-
validate receive chains, or drive the golden-parity harnesses.

Modes:
  fm      --tone 1000 --deviation 75e3 --carrier 120e3     (WBFM IQ)
  pocsag  --address 4242 --text "PAGE ME"                  (FM pager IQ)
  afsk    --from-call N0CALL --to-call APRS --info "!..."  (AX.25 audio)
  rtty    --text "RYRY"                                    (FSK audio)
  psk31   --text "cq cq"                                   (BPSK IQ)

Output: stereo-IQ WAV (complex modes) or mono WAV (audio modes), or raw
interleaved via --raw-out.
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu.decode import (ax25_frame_bits, baudot_encode_bits,
                               pocsag_encode_batch, varicode_encode_bits)
from libsdr_tpu.io import write_wav, write_wav_iq
from libsdr_tpu.ops import siggen
from libsdr_tpu.utils.options import common_parser


def synthesize(mode: str, fs: float, args) -> np.ndarray:
    if mode == "fm":
        n = int(fs * args.seconds)
        audio = siggen.sine(fs, n, args.tone, amps=0.8)
        return siggen.fm_modulate(fs, audio, deviation=args.deviation,
                                  carrier=args.carrier)
    if mode == "pocsag":
        bits = pocsag_encode_batch(address=args.address, function=1,
                                   text=args.text)
        spb = fs / args.baud
        n = int(len(bits) * spb)
        idx = np.minimum((np.arange(n) / spb).astype(np.int64), len(bits) - 1)
        dev = np.where(bits[idx] > 0, -4500.0, 4500.0)
        ph = 2 * np.pi * np.cumsum(dev) / fs
        return np.exp(1j * ph).astype(np.complex64)
    if mode == "afsk":
        frame = ax25_frame_bits(args.from_call, args.to_call,
                                args.info.encode("latin-1"), n_flags=50)
        # 0.17% TX clock offset: real transmitters always have one, and a
        # perfectly synchronous signal parks bit PLLs at their metastable
        # point.
        audio = siggen.fsk_modulate(fs, siggen.nrzi(frame), args.baud * 1.0017,
                                    1200.0, 2200.0).real
        return np.concatenate([audio, np.zeros(int(fs * 0.2), np.float32)])
    if mode == "rtty":
        half_bits = baudot_encode_bits(args.text, stop_bits="1.5")
        audio = siggen.fsk_modulate(fs, half_bits, 2 * 45.45,
                                    930.0, 1100.0).real
        return np.concatenate([audio, np.zeros(int(fs * 0.2), np.float32)])
    if mode == "psk31":
        bits = varicode_encode_bits(args.text)
        bits = np.concatenate([np.ones(24, np.uint8), bits,
                               np.ones(24, np.uint8)])
        spb = int(round(fs / 31.25))
        ph, phases = 0.0, []
        for b in bits:
            if b == 0:
                ph += np.pi
            phases.append(ph)
        return np.exp(1j * np.repeat(phases, spb)).astype(np.complex64)
    raise SystemExit(f"unknown mode {mode}")


def main(argv=None):
    p = common_parser("Signal generator (the transmitter the reference lacks)")
    p.add_argument("mode", choices=["fm", "pocsag", "afsk", "rtty", "psk31"])
    p.add_argument("-o", "--output", help="output WAV path")
    p.add_argument("--wire",
                   help="transmit INTO a live wire instead of a file "
                        "(tcp://host:port, tcp-listen://:port, udp://h:p, "
                        "fifo:///path) — IQ modes send the u8 rtl_sdr "
                        "format, audio modes send s16; pairs with the "
                        "receivers' --live flags for full live loopback")
    p.add_argument("--realtime", action="store_true",
                   help="throttle --wire output to the sample rate")
    p.add_argument("--fs", type=float, default=None,
                   help="sample rate (per-mode default)")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--amplitude", type=float, default=0.8)
    p.add_argument("--tone", type=float, default=1000.0)
    p.add_argument("--deviation", type=float, default=75e3)
    p.add_argument("--carrier", type=float, default=120e3)
    p.add_argument("--baud", type=float, default=1200.0)
    p.add_argument("--address", type=int, default=4242)
    p.add_argument("--text", default="LIBSDR TEST")
    p.add_argument("--from-call", default="N0CALL")
    p.add_argument("--to-call", default="APRS")
    p.add_argument("--info", default="!4903.50N/07201.75W-libsdr_tpu")
    args = p.parse_args(argv)

    if not args.output and not args.wire:
        raise SystemExit("need -o/--output and/or --wire")

    defaults = dict(fm=960_000.0, pocsag=240_000.0, afsk=24_000.0,
                    rtty=8_000.0, psk31=2_000.0)
    fs = args.fs or defaults[args.mode]
    sig = synthesize(args.mode, fs, args)
    sig = args.amplitude * sig
    if args.output:
        if np.iscomplexobj(sig):
            write_wav_iq(args.output, sig.astype(np.complex64), int(fs))
        else:
            write_wav(args.output, sig.astype(np.float32), int(fs))
        print(f"{args.mode}: wrote {len(sig)} samples @ {fs:.0f} Hz "
              f"-> {args.output}")
    if args.wire:
        from libsdr_tpu.io.live import send_live_audio, send_live_iq
        rate = fs if args.realtime else None
        if np.iscomplexobj(sig):
            sent = send_live_iq(args.wire, sig.astype(np.complex64), rate)
        else:
            sent = send_live_audio(args.wire, sig.astype(np.float32), rate)
        print(f"{args.mode}: transmitted {sent} wire bytes @ {fs:.0f} Hz "
              f"-> {args.wire}")
    return args.output or args.wire


if __name__ == "__main__":
    main()
