"""WAV pass-through (reference: examples/sdr_wavplay.cc WavSource ->
PortSink).  Accelerator servers have no sound card; this validates the WAV source /
runtime path and writes the (optionally gain-adjusted) audio back out."""

from __future__ import annotations

import numpy as np

from libsdr_tpu import Pipeline, StreamSpec
from libsdr_tpu.core import run_pipeline, stream_blocks
from libsdr_tpu.io import read_wav, write_wav
from libsdr_tpu.ops import Scale
from libsdr_tpu.utils.options import common_parser


def main(argv=None):
    p = common_parser("WAV play-through (reference: examples/sdr_wavplay.cc)")
    p.add_argument("file", help="input WAV")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--gain", type=float, default=1.0)
    args = p.parse_args(argv)

    audio, fs = read_wav(args.file)
    if audio.ndim > 1:
        audio = audio[0]
    pipe = Pipeline([Scale(args.gain)], name="wavplay")
    pipe.bind(StreamSpec(np.float32, fs, args.block_size))
    _, out = run_pipeline(pipe, stream_blocks(audio, args.block_size))
    write_wav(args.output, np.clip(out[:len(audio)], -1, 1), fs)
    print(f"played {len(audio)} samples @ {fs} Hz -> {args.output}")


if __name__ == "__main__":
    main()
