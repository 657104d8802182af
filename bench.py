"""Headline benchmark: complex Msamples/s through the FIR+FM chain on one GPU
(BASELINE.json metric; reference chain = SURVEY.md 3.2).

Runs the chain of the measured C++ reference baseline (IQBaseBand order=64
decim=4 -> FMDemod -> FMDeemph, apps/chains.fm_bank) as a 64-channel bank
of 2^24-sample blocks, carry-chained, once with f32 input planes and once
with bf16 planes (the u8-wire storage format).  Refuses to run without a
GPU.

Prints ONE JSON line: the card (name, power limit, JAX device kind and
count), ``f32_msps`` and ``bf16_msps`` (aggregate complex input samples per
second, median of the timed blocks), and ``vs_baseline`` for the f32 row.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_CHANNELS, BLOCK, ITERS = 64, 1 << 24, 10


def _msps(plane_dtype, x) -> float:
    import jax

    from libsdr_tpu.apps.chains import fm_bank

    rx = fm_bank(N_CHANNELS, BLOCK, plane_dtype=plane_dtype)
    step = rx.compile()
    carry, y = step(rx.init_carry(), x)          # compile + warm up
    jax.block_until_ready(y)
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        carry, y = step(carry, x)                # carry chaining serializes
        jax.block_until_ready(y)
        times.append(time.perf_counter() - t0)
    return N_CHANNELS * BLOCK / float(np.median(times)) / 1e6


def main() -> int:
    from libsdr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from libsdr_tpu.core import cplx

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    key = jax.random.PRNGKey(0)
    shape = (N_CHANNELS, BLOCK)
    x32 = cplx.Complex(jax.random.normal(key, shape, jnp.float32),
                       jax.random.normal(key, shape, jnp.float32))
    msps_f32 = _msps(None, x32)
    x16 = x32.map(lambda a: a.astype(jnp.bfloat16))
    del x32
    msps_bf16 = _msps(jnp.bfloat16, x16)
    with open("BASELINE_MEASURED.json") as f:
        baseline = json.load(f)["reference_value_msps"]
    print(json.dumps({
        "metric": "complex Msamples/s through FIR+FM chain "
                  f"({N_CHANNELS} channels x {BLOCK} samples, order=64, "
                  "decim=4)",
        "card": card, "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
        "f32_msps": msps_f32, "bf16_msps": msps_bf16, "unit": "Msps",
        "vs_baseline": msps_f32 / baseline,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
