"""Per-mode receiver throughput — the apps/rx.py demodulator configurations
plus the AX.25/FSK chain, as multi-channel banks on one GPU.

Usage: python tools/bench_rx_modes.py [--channels 64] [--block 16777216]
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bench(step, carry, x, iters=6, runs=3):
    import jax.numpy as jnp
    from libsdr_tpu.core.cplx import Complex
    from libsdr_tpu.core.ragged import Ragged

    def force(r):
        if isinstance(r, Ragged):
            r = r.data
        if isinstance(r, Complex):
            r = r.re
        return float(jnp.sum(r))

    c, y = step(carry, x)
    force(y)
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        c = carry
        for _ in range(iters):
            c, y = step(c, x)
        force(y)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--block", type=int, default=1 << 24)
    args = ap.parse_args()

    import jax
    from libsdr_tpu import Pipeline, StreamSpec
    from libsdr_tpu.core import cplx
    from libsdr_tpu.ops import (AGC, AMDemod, ASKDetector, BitStream,
                                FMDemod, FMDeemph, FSKDetector, IQBaseBand,
                                USBDemod)

    n_ch, block = args.channels, args.block
    fs = 960_000.0
    key = jax.random.PRNGKey(0)
    x = cplx.Complex(jax.random.normal(key, (n_ch, block), np.float32),
                     jax.random.normal(jax.random.PRNGKey(1),
                                       (n_ch, block), np.float32))

    def modes():
        yield "wfm", [IQBaseBand(fc=fs / 8, width=200e3, order=64, decim=4,
                                 design="textbook"), FMDemod(), FMDeemph()]
        yield "nfm", [IQBaseBand(fc=fs / 8, width=12.5e3, order=64, decim=8,
                                 design="textbook"), FMDemod(), FMDeemph()]
        yield "am", [IQBaseBand(fc=fs / 8, width=10e3, order=64, decim=8,
                                design="textbook"), AMDemod(), AGC()]
        yield "usb", [IQBaseBand(fc=fs / 8, width=3e3, order=64, decim=8,
                                 design="textbook"), USBDemod(), AGC()]

    out = {"channels": n_ch, "block": block}
    for name, stages in modes():
        p = Pipeline(stages)
        p.bind(StreamSpec(np.complex64, fs, block, channels=(n_ch,)))
        t = bench(p.compile(), p.init_carry(), x)
        out[f"{name}_msps"] = round(n_ch * block / t / 1e6, 1)

    # AX.25/AFSK chain (examples/sdr_ax25.cc): baseband -> FM -> FSK
    # correlators -> bit-sync PLL, at the reference's audio rates.
    fs2 = 192_000.0

    def afsk_bank(n, blk):
        xa = cplx.Complex(jax.random.normal(key, (n, blk), np.float32),
                          jax.random.normal(jax.random.PRNGKey(n % 97),
                                            (n, blk), np.float32))
        p = Pipeline([IQBaseBand(fc=24e3, width=12.5e3, order=48,
                                 out_rate=48e3, design="textbook"),
                      FMDemod(),
                      FSKDetector(1200.0, 1200.0, 2200.0),
                      BitStream(1200.0, mode="transition")])
        p.bind(StreamSpec(np.complex64, fs2, blk, channels=(n,)))
        t = bench(p.compile(), p.init_carry(), xa)
        return round(n * blk / t / 1e6, 1)

    blk2 = 1 << 21
    out["ax25_chain_msps"] = afsk_bank(n_ch, blk2)
    # wide bank: same total samples/step but 4x the channels on 1/4 the
    # block — the bit-sync PLL walks time sequentially with all channel
    # lanes in parallel, so the wider/shorter layout shortens that walk 4x
    # at equal work.
    n_wide = 4 * n_ch
    out["ax25_wide_channels"] = n_wide
    out["ax25_wide_msps"] = afsk_bank(n_wide, blk2 // 4)

    out["metric"] = "per-mode receiver bank Msamples/s/chip (apps/rx.py)"
    out["protocol"] = "carry-chained steps, single forced readback ends the timed region, best of runs (BASELINE.md timing protocol)"
    print(json.dumps(out))
    from tools._artifact import write_artifact
    write_artifact("RXMODES", out)


if __name__ == "__main__":
    main()
