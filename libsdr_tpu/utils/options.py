"""CLI option handling (reference: src/options.{hh,cc} ``sdr::Options``).

The reference rolls a getopt-style parser from Definition tables; Python's
argparse provides the same contract, so this module just hosts shared flag
groups used by the app CLIs (mirroring the reference examples' flags, e.g.
examples/sdr_pocsag.cc:44-60).
"""

from __future__ import annotations

import argparse


class _AppParser(argparse.ArgumentParser):
    """Parser of an app's ``main``: parsing the command line also turns on
    the persistent compile cache (utils/compile_cache.py), so every app
    starts the same way."""

    def parse_args(self, args=None, namespace=None):
        from libsdr_tpu.utils.compile_cache import enable_compile_cache

        parsed = super().parse_args(args, namespace)
        enable_compile_cache()
        return parsed


def common_parser(description: str) -> argparse.ArgumentParser:
    p = _AppParser(description=description)
    p.add_argument("--block-size", type=int, default=1 << 16,
                   help="samples per processing block")
    p.add_argument("--log-level", default="WARNING",
                   help="DEBUG/INFO/WARNING/ERROR")
    return p


def add_source_args(p: argparse.ArgumentParser) -> None:
    """Input source flags (the reference offers rtl/audio/file sources,
    e.g. examples/sdr_pocsag.cc:44-60; accelerator servers have no RTL dongle or
    sound card, so file/raw inputs replace them)."""
    g = p.add_argument_group("source")
    g.add_argument("--file", help="input WAV file (stereo = I/Q)")
    g.add_argument("--raw", help="raw interleaved IQ capture file")
    g.add_argument("--raw-dtype", default="uint8",
                   help="raw sample dtype (uint8 = rtl_sdr wire format)")
    g.add_argument("--rate", type=float, default=None,
                   help="sample rate of --raw input")


def load_source(args):
    """Return (iq_or_audio, sample_rate) from parsed source args."""
    import numpy as np

    from libsdr_tpu.io import read_wav, read_wav_iq
    from libsdr_tpu.io.wav import read_raw_iq

    if args.file:
        try:
            return read_wav_iq(args.file)
        except Exception:
            return read_wav(args.file)
    if args.raw:
        if not args.rate:
            raise SystemExit("--raw requires --rate")
        return read_raw_iq(args.raw, np.dtype(args.raw_dtype)), args.rate
    raise SystemExit("need --file or --raw input")
