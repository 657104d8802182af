"""Live-wire ingest capacity — the host-side feed path in isolation.

Measures how fast the native live path terminates a u8 IQ wire: localhost
TCP blast -> LivePump driver thread -> SPSC ring -> block take -> LUT
conversion (u8 -> f32 planes and u8 -> bf16 planes).  This is the
accelerator-host analog of the reference's implied realtime design point — an RTL2832
sustains <= 2.4 Msps cu8 through its driver thread (reference:
src/rtlsource.cc:78-89) — and bounds how many dongle-equivalents one host
can terminate.  No device involved: the number is valid on any backend (the
device side is covered by DECODERBANK's pump_fed capacity).

Prints one JSON object and writes LIVEINGEST_r*.json.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=512,
                    help="wire megabytes to stream")
    ap.add_argument("--block", type=int, default=1 << 20,
                    help="samples per consumer block")
    args = ap.parse_args()

    from libsdr_tpu.native import (LivePump, RingBuffer, available,
                                   u8_iq_to_planar, u8_iq_to_planar_bf16)

    n_bytes = args.mb << 20
    block = args.block
    chunk = np.arange(1 << 20, dtype=np.uint32).astype(np.uint8)  # 1 MB

    def run(convert, label):
        ring = RingBuffer(1 << 26)
        pump = LivePump.tcp_listen(0, ring, frame=2, chunk=1 << 18)
        port = pump.port

        def blaster():
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=10) as s:
                sent = 0
                while sent < n_bytes:
                    s.sendall(chunk.tobytes())
                    sent += len(chunk)

        t = threading.Thread(target=blaster)
        bytes_per_block = 2 * block
        t0 = time.perf_counter()
        t.start()
        taken = 0
        while taken < n_bytes - bytes_per_block:
            raw = ring.take(bytes_per_block)
            if raw is None:
                if ring.eos:
                    break
                continue
            convert(raw)
            taken += bytes_per_block
        dt = time.perf_counter() - t0
        t.join()
        dropped = pump.bytes_dropped
        pump.stop()
        ring.close()
        return {
            f"{label}_msps": round(taken / 2 / dt / 1e6, 1),
            f"{label}_wire_mb_s": round(taken / dt / 1e6, 1),
            f"{label}_drop_fraction": round(
                dropped / max(taken + dropped, 1), 4),
        }

    out = {"native": available(), "wire_mb": args.mb,
           "block_samples": block}
    # wire -> ring -> take only (no conversion): the transport ceiling
    out.update(run(lambda raw: None, "transport"))
    # + u8 -> f32 planes (the complex64 consumer path)
    out.update(run(lambda raw: u8_iq_to_planar(raw), "f32"))
    # + u8 -> bf16 planes (the production device ingest format)
    out.update(run(lambda raw: u8_iq_to_planar_bf16(raw), "bf16"))
    out["metric"] = ("live u8 IQ wire termination capacity, complex "
                     "Msamples/s sustained (localhost TCP -> native pump "
                     "-> SPSC ring -> LUT conversion; host path only)")
    out["note"] = ("drop_fraction > 0 means the unthrottled localhost "
                   "blast outran the single-thread converting consumer — "
                   "the msps value IS that consumer's sustained capacity; "
                   "the drop accounting working as designed, not a loss "
                   "at a real wire rate")
    out["reference_design_point_msps"] = 2.4  # rtlsource.cc:78-89
    print(json.dumps(out))
    from tools._artifact import write_artifact
    write_artifact("LIVEINGEST", out)


if __name__ == "__main__":
    main()
