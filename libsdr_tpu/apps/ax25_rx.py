"""AX.25 / APRS receiver CLI (reference: examples/sdr_ax25.cc).

Input is either demodulated audio (AFSK1200 tones) or an IQ capture (then an
NFM demod front end runs first); FSK detector + bit-sync run on the device, HDLC
deframing and APRS parsing on the host.
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu.apps.chains import afsk_front_end, fm_chain, run_bit_chain
from libsdr_tpu.core import run_pipeline, stream_blocks
from libsdr_tpu.decode.aprs import APRSDecoder
from libsdr_tpu.utils import logging as sdrlog
from libsdr_tpu.utils.options import add_source_args, common_parser, load_source


def main(argv=None):
    p = common_parser("APRS/AX.25 receiver (reference: examples/sdr_ax25.cc)")
    add_source_args(p)
    p.add_argument("-F", "--frequency", type=float, default=0.0)
    p.add_argument("--audio", action="store_true",
                   help="input is demodulated AFSK audio, not IQ")
    args = p.parse_args(argv)
    sdrlog.set_level(args.log_level)

    samples, fs = load_source(args)
    if not args.audio and np.iscomplexobj(samples):
        fm = fm_chain(fs, args.block_size, fc=args.frequency, width=12.5e3,
                      order=32, audio_rate=24e3, deviation=4.5e3,
                      deemph=False)
        _, samples = run_pipeline(fm, stream_blocks(samples, args.block_size))
        fs = fm.out_spec.rate_hz
    fe = afsk_front_end(fs, min(args.block_size, len(samples)))
    bits = run_bit_chain(fe, samples.astype(np.float32))
    dec = APRSDecoder()
    dec.process(bits)
    for m in dec.messages:
        print(f"AX25: {m}")
    for a in dec.aprs_messages:
        print(a)
    if not dec.messages:
        print("no AX.25 frames decoded")
    return dec


if __name__ == "__main__":
    main()
