"""Scaling-efficiency harness (BASELINE.json target: >= 0.9 from 1 chip to
N).  Measures weak scaling of the sharded wideband pipeline
(parallel/wideband.py): per-device work is held constant while devices are
added, so ideal scaling keeps time/step flat.

On real multi-card hardware this measures halo + all_to_all overhead over
the interconnect; on virtual CPU devices
(--xla_force_host_platform_device_count) it validates the harness and the
collective structure rather than interconnect bandwidth.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/bench_scaling.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    import jax
    if len(jax.devices()) < 2:
        jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from libsdr_tpu.parallel.wideband import build_wideband_step

    devices = jax.devices()
    m = 16                       # channels
    per_dev_block = m * 2048     # constant per-device work
    results = {}
    for n in [1, 2, 4, 8]:
        if n > len(devices):
            break
        mesh = Mesh(np.asarray(devices[:n]), ("d",))
        block = per_dev_block * n
        step, init_carry, place = build_wideband_step(mesh, m, block)
        rng = np.random.default_rng(0)
        x = (rng.normal(size=block) + 1j * rng.normal(size=block)
             ).astype(np.complex64)
        carry = init_carry()
        carry, y = step(carry, place(x))
        _ = np.asarray(y).sum()  # force
        iters = 5
        t0 = time.perf_counter()
        c = carry
        for _ in range(iters):
            c, y = step(c, place(x))
        _ = np.asarray(y).sum()
        dt = (time.perf_counter() - t0) / iters
        results[n] = dict(ms_per_step=dt * 1e3,
                          msps=block / dt / 1e6)
    base = results[1]["ms_per_step"]
    for n, r in results.items():
        r["weak_scaling_efficiency"] = round(base / r["ms_per_step"], 3)
    out = {"wideband_weak_scaling": results,
           "backend": jax.default_backend(),
           "note": ("virtual CPU devices share one host's cores, so "
                    "compute does NOT scale with n here — this run "
                    "validates the sharded program + collective structure; "
                    "the >=0.9 weak-scaling target is meaningful only on "
                    "real multi-card hardware"
                    if jax.default_backend() == "cpu" else
                    "real accelerator mesh")}
    print(json.dumps(out, indent=2))
    from tools._artifact import write_artifact
    write_artifact("SCALING", out)


if __name__ == "__main__":
    main()
