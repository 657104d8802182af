"""POCSAG pager receiver CLI (reference: examples/sdr_pocsag.cc).

IQ capture -> IQBaseBand -> FM demod -> ASK detector -> bit-sync PLL (device)
-> POCSAG FSM + BCH repair (host) -> printed pages.
"""

from __future__ import annotations

from libsdr_tpu.apps.chains import pocsag_front_end, run_bit_chain
from libsdr_tpu.decode import pocsag_decode_bits
from libsdr_tpu.utils import logging as sdrlog
from libsdr_tpu.utils.options import add_source_args, common_parser, load_source


def main(argv=None):
    p = common_parser("POCSAG receiver (reference: examples/sdr_pocsag.cc)")
    add_source_args(p)
    p.add_argument("-F", "--frequency", type=float, default=0.0,
                   help="channel offset from capture center [Hz]")
    p.add_argument("--baud", type=float, default=1200.0)
    args = p.parse_args(argv)
    sdrlog.set_level(args.log_level)

    iq, fs = load_source(args)
    fe = pocsag_front_end(fs, args.block_size, fc=args.frequency,
                          baud=args.baud)
    print(fe.describe())
    bits = run_bit_chain(fe, iq)
    msgs = pocsag_decode_bits(bits)  # native C++ FSM when available
    # Print like POCSAGDump (reference: src/pocsag.cc:157-173).
    for m in msgs:
        kind = ("alert" if m.bits == 0 else
                "txt" if m.estimate_text() >= m.estimate_numeric() else "num")
        print(f"POCSAG: @{m.address}, F={m.function}, bits={m.bits} ({kind})")
        if m.bits:
            print(" " + (m.as_text() if kind == "txt" else m.as_numeric()))
    if not msgs:
        print("no POCSAG messages decoded")
    return msgs


if __name__ == "__main__":
    main()
