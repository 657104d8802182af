"""Channelizer benchmark — BASELINE.md config 3: the 1024-channel polyphase
filterbank on one GPU (channels x Msamples/s).

Measures, on the same block stream (best-of-3 over chained iterations,
synchronized by a forced readback):

  * channelizer:  the public Channelizer op ((M, t) channel-major bank)
  * scanner_e2e:  the whole-band pager scanner step (channelize + FM ->
                  ASK + bit-sync PLL -> windowed on-device bit compaction,
                  parallel/wideband.py), f32 planes and bf16 planes

Usage: python tools/bench_channelizer.py [--channels 1024] [--block 33554432]
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


def bench(step, carry, x, iters=4, runs=3):
    import jax
    import jax.numpy as jnp
    from libsdr_tpu.core.cplx import Complex

    def force(r):
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
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--block", type=int, default=1 << 26)
    ap.add_argument("--taps-per-branch", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from libsdr_tpu import Pipeline, StreamSpec
    from libsdr_tpu.core import cplx
    from libsdr_tpu.ops.channelizer import Channelizer

    m, block, p = args.channels, args.block, args.taps_per_branch
    fs = 1.024e9
    key = jax.random.PRNGKey(0)
    x = cplx.Complex(jax.random.normal(key, (block,), np.float32),
                     jax.random.normal(jax.random.PRNGKey(1), (block,),
                                       np.float32))

    out = {"channels": m, "taps_per_branch": p, "block": block}

    ch = Pipeline([Channelizer(m, p)])
    ch.bind(StreamSpec(np.complex64, fs, block))
    t = bench(ch.compile(), ch.init_carry(), x)
    out["channelizer_ms"] = round(t * 1e3, 3)
    out["channelizer_msps"] = round(block / t / 1e6, 1)

    # Whole-band pager scanner end-to-end (parallel/wideband.py), f32
    # planes and bf16 planes (the u8-wire production format).
    from jax.sharding import Mesh
    from libsdr_tpu.parallel.wideband import build_scanner_step

    fs_scan = m * 24_000.0
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("d",))
    xbf = cplx.Complex(x.re.astype(jnp.bfloat16), x.im.astype(jnp.bfloat16))

    def sbench(xin, pd):
        sstep, sinit, splace = build_scanner_step(
            mesh1, m, block, fs_scan, compact_window=16, plane_dtype=pd)
        c0 = sinit()
        c, y = sstep(c0, xin)
        _ = float(jnp.sum(y.valid.astype(jnp.float32)))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            c = c0
            for _ in range(3):
                c, y = sstep(c, xin)
            _ = float(jnp.sum(y.valid.astype(jnp.float32)))
            best = min(best, (time.perf_counter() - t0) / 3)
        return best

    for name, xin, pd in (("scanner_e2e", x, None),
                          ("scanner_e2e_bf16", xbf, jnp.bfloat16)):
        t = sbench(xin, pd)
        out[f"{name}_ms"] = round(t * 1e3, 3)
        out[f"{name}_msps"] = round(block / t / 1e6, 1)

    out["metric"] = "polyphase channelizer wideband Msamples/s/chip"
    out["protocol"] = "carry-chained steps, single forced readback ends the timed region, best of runs (BASELINE.md timing protocol)"
    out["per_channel_msps"] = round(out["channelizer_msps"] / m, 4)
    print(json.dumps(out))
    from tools._artifact import write_artifact
    write_artifact("CHANNELIZER", out)


if __name__ == "__main__":
    main()
