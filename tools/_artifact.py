"""Per-round bench artifact writer: every tools/bench_* run records its
JSON at the repository root so non-headline numbers are regression-visible
between rounds."""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_artifact(prefix: str, payload: dict) -> str:
    rnd = os.environ.get("LIBSDR_ROUND", "05")
    path = os.path.join(ROOT, f"{prefix}_r{rnd}.json")
    import sys
    # Record the platform ONLY if a backend is already initialized
    # (jax-free host benches have no platform to record).
    xb = sys.modules.get("jax._src.xla_bridge")
    if xb is not None and getattr(xb, "_backends", None):
        try:
            payload = dict(payload,
                           platform=sys.modules["jax"].default_backend())
        except Exception:
            pass
    if payload.get("platform") == "cpu" and not os.environ.get(
            "LIBSDR_ALLOW_CPU_ARTIFACT"):
        # A CPU sanity run must never clobber a hardware artifact.
        print(f"[artifact] skipping {path}: CPU backend "
              "(set LIBSDR_ALLOW_CPU_ARTIFACT=1 to force)")
        return path
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path
