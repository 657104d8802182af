"""Multi-mode decoder bank throughput — BASELINE.json config 4: one
channelizer front end feeding a per-channel POCSAG / AFSK-AX.25 / RTTY /
PSK31 mode map (apps/multimode.py), as one jitted step on one GPU.

Timing protocol: carry-chained steps; every number in this artifact says
what it forces.  Three rows:

- ``step_ms`` / ``msps`` (headline): the production protocol of
  apps/multimode._run_bank — chained steps, each block's bits drained as
  ONE packed u8 fetch (pack_bank_outputs) started async and collected 3
  blocks later.  Includes all device->host traffic a real consumer pays.
- ``batched_step_ms`` / ``batched_msps``: same, but K=4 blocks' packed
  outputs stacked on device and fetched together — amortizes the
  per-fetch round trip 4-fold at a 4-block latency cost.
- ``compute_step_ms``: chained steps forced once at the end by a single
  fused scalar (device compute ceiling; no bit readback).

Prints one JSON object and writes MULTIMODE_r*.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--frames", type=int, default=12288,
                    help="frames per block (time samples per channel; "
                         "must divide by the PSK31 decimator)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from libsdr_tpu.apps.multimode import build_bank, pack_bank_outputs
    from libsdr_tpu.core import cplx

    m = args.channels
    fs = m * 24_000.0
    block = m * args.frames
    # Even per-channel split across the four modes.
    modes = ("pocsag", "ax25", "rtty", "psk31")
    mode_map = {ch: modes[ch % 4] for ch in range(m)}
    step, init_carry, groups = build_bank(fs, block, m, mode_map)

    key = jax.random.PRNGKey(0)
    x = cplx.Complex(jax.random.normal(key, (block,), np.float32),
                     jax.random.normal(jax.random.PRNGKey(1), (block,),
                                       np.float32))
    carry0 = init_carry()

    pack_j = jax.jit(pack_bank_outputs)
    stack_j = jax.jit(lambda ps: jnp.stack(ps))
    fused = jax.jit(lambda outs: sum(jnp.sum(r.valid.astype(jnp.float32))
                                     for r in outs.values()))

    # Warmup / compile every protocol's program.
    c, outs = step(carry0, x)
    np.asarray(pack_j(outs))
    float(fused(outs))
    np.asarray(stack_j([pack_j(outs)] * 4))

    def best_of(body, iters, runs=3):
        best = float("inf")
        for _ in range(runs):
            t0 = time.perf_counter()
            body(iters)
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    def production(iters):
        c, pending = carry0, []
        for _ in range(iters):
            c, outs = step(c, x)
            p = pack_j(outs)
            try:
                p.copy_to_host_async()
            except Exception:
                pass
            pending.append(p)
            if len(pending) > 3:
                np.asarray(pending.pop(0))
        for p in pending:
            np.asarray(p)

    def batched(iters, K=4):
        c, batch, pending = carry0, [], []
        for _ in range(iters):
            c, outs = step(c, x)
            batch.append(pack_j(outs))
            if len(batch) == K:
                s = stack_j(batch)
                try:
                    s.copy_to_host_async()
                except Exception:
                    pass
                pending.append(s)
                batch = []
                if len(pending) > 1:
                    np.asarray(pending.pop(0))
        for s in pending:
            np.asarray(s)
        for p in batch:
            np.asarray(p)

    def compute_only(iters):
        c = carry0
        for _ in range(iters):
            c, outs = step(c, x)
        float(fused(outs))

    t_prod = best_of(production, iters=8)
    t_batched = best_of(batched, iters=8)
    t_compute = best_of(compute_only, iters=8)

    out = {
        "channels": m,
        "block": block,
        "mode_split": {mo: int(len(ix)) for mo, ix in groups.items()},
        "step_ms": round(t_prod * 1e3, 2),
        "msps": round(block / t_prod / 1e6, 1),
        "batched_step_ms": round(t_batched * 1e3, 2),
        "batched_msps": round(block / t_batched / 1e6, 1),
        "compute_step_ms": round(t_compute * 1e3, 2),
        "compute_msps": round(block / t_compute / 1e6, 1),
        "bandwidth_mhz": round(fs / 1e6, 3),
        "realtime_multiple": round(block / t_prod / fs, 1),
        "protocol": "carry-chained; step_ms = _run_bank drain (one packed "
                    "async u8 fetch per block, window 3); batched = one "
                    "fetch per 4 blocks; compute = single fused scalar "
                    "force at loop end.",
        "metric": "multi-mode decoder bank (1 channelizer front end -> "
                  "per-channel POCSAG/AX.25/RTTY/PSK31) Msps/chip, "
                  "drain included",
    }
    print(json.dumps(out))
    from tools._artifact import write_artifact
    write_artifact("MULTIMODE", out)


if __name__ == "__main__":
    main()
