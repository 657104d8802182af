"""Decoder-bank capacity benchmark — the BASELINE.json "concurrent channels
decoded per host" metric, split in two:

- **device-resident capacity**: input already in device memory; measures
  the device front end (IQBaseBand -> FMDemod -> ASK -> BitStream PLL)
  with double-buffered compacted readback overlapping the host, plus the
  native POCSAG FSM.  This is the card's compute ceiling.
- **pump-fed end-to-end capacity**: the same bank fed from the native
  ingest path — u8 wire file -> SPSC ring + pump thread -> LUT conversion
  to bf16 planes -> host->device upload -> device -> compacted readback
  -> native FSM.  This includes the host->device link.

Per channel: IQBaseBand(12.5 kHz, -> 24 kHz) -> FMDemod -> ASKDetector ->
BitStream PLL (device, channel axis = batch) -> POCSAG FSM + BCH repair
(host, ~10 ns/bit native).  Every channel must decode its message.

Usage: python tools/bench_decoder_bank.py [--channels 256] [--seconds 2.0]
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


def synth_channel(fs: float, n: int, address: int, text: str) -> np.ndarray:
    """One POCSAG transmission, zero-padded per channel."""
    from libsdr_tpu.decode import pocsag_encode_batch

    bits = pocsag_encode_batch(address=address, function=1, text=text)
    spb = fs / 1200.0
    nsig = int(len(bits) * spb)
    idx = np.minimum((np.arange(nsig) / spb).astype(np.int64), len(bits) - 1)
    dev = np.where(bits[idx] > 0, -4500.0, 4500.0)
    ph = 2 * np.pi * np.cumsum(dev) / fs
    sig = 0.9 * np.exp(1j * ph).astype(np.complex64)
    if nsig >= n:
        return sig[:n]
    return np.concatenate([sig, np.zeros(n - nsig, np.complex64)])


def build_bank(n_ch, fs, block, plane_dtype=None, wire=None):
    import jax

    from libsdr_tpu import Pipeline, StreamSpec
    from libsdr_tpu.core.ragged import compact_device
    from libsdr_tpu.ops import ASKDetector, BitStream, FMDemod, IQBaseBand

    fe = Pipeline([
        IQBaseBand(fc=0.0, width=12.5e3, order=32, out_rate=24e3,
                   design="textbook"),
        FMDemod(),
        ASKDetector(invert=True),
        BitStream(1200.0, mode="normal"),
    ], name="pocsag_bank")
    fe.bind(StreamSpec(np.complex64, fs, block, channels=(n_ch,),
                       plane_dtype=plane_dtype))
    # Fuse the on-device bit compaction into the jitted step: the PLL emits
    # ~baud/fs (5%) valid slots, so compacting before readback cuts the
    # device->host transfer ~20x.
    cap = int(block / fs * 1200.0 * 1.3)
    inner = fe.compile()

    def step_fn(c, v):
        if wire == "u8":
            # ON-DEVICE wire-format conversion: v is the raw interleaved
            # u8 wire (n_ch, 2*block) — 2 B/sample over the host->device
            # link, converted to bf16 planes on the device (bit-identical to
            # the host LUT; io/ingest.u8_wire_to_planes).
            from libsdr_tpu.io.ingest import u8_wire_to_planes
            import jax.numpy as jnp
            v = u8_wire_to_planes(v, plane_dtype or jnp.bfloat16)
        c, y = inner(c, v)
        return c, compact_device(y, cap)

    return fe, jax.jit(step_fn)


def decode_all(n_ch, datas, counts):
    from libsdr_tpu.decode import pocsag_decode_bits

    decoded = 0
    for ch in range(n_ch):
        bits = np.concatenate([d[ch, :k[ch]]
                               for d, k in zip(datas, counts)])
        msgs = pocsag_decode_bits(bits)
        if msgs and msgs[0].address == 1234:
            decoded += 1
    return decoded


def run_device_resident(n_ch, fs, block, n, one, gains, out):
    """Input pre-staged in HBM: compute ceiling + overlapped readback."""
    import jax
    import jax.numpy as jnp

    from libsdr_tpu.core import cplx as _cplx

    one_d = _cplx.as_block(one)
    gains_d = jnp.asarray(gains)

    @jax.jit
    def synth_block(sl_re, sl_im, key):
        nz = 0.02 * jax.random.normal(key, (2, n_ch, sl_re.shape[-1]),
                                      np.float32)
        return _cplx.Complex(sl_re[None, :] * gains_d + nz[0],
                             sl_im[None, :] * gains_d + nz[1])

    fe, step = build_bank(n_ch, fs, block)
    carry = fe.init_carry()
    dev_blocks = [
        synth_block(one_d.re[i:i + block], one_d.im[i:i + block],
                    jax.random.PRNGKey(i))
        for i in range(0, n, block)]
    jax.block_until_ready(dev_blocks[-1].re)
    c, (d0, n0) = step(carry, dev_blocks[0])  # warmup / compile
    _ = float(jnp.sum(n0))

    # (1) pure device front-end wall (carry-chained, forced once at the end)
    t0 = time.perf_counter()
    c = carry
    for blk in dev_blocks:
        c, (d, k) = step(c, blk)
    _ = float(jnp.sum(k))
    t_dev = time.perf_counter() - t0

    # (2) overlapped pipeline: double-buffered readback — keep one step in
    # flight while draining the previous block's compacted bits, then run
    # the native FSM.  Wall covers dispatch + readback + FSM.
    t0 = time.perf_counter()
    c = carry
    datas, counts, pending = [], [], []
    for blk in dev_blocks:
        c, y = step(c, blk)
        pending.append(y)
        if len(pending) > 1:
            d, k = pending.pop(0)
            datas.append(np.asarray(d))
            counts.append(np.asarray(k))
    for d, k in pending:
        datas.append(np.asarray(d))
        counts.append(np.asarray(k))
    t_pipeline = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = decode_all(n_ch, datas, counts)
    t_host = time.perf_counter() - t0

    seconds = n / fs
    out["decode_success_device"] = decoded
    out["device_front_end_s"] = round(t_dev, 4)
    out["overlapped_pipeline_s"] = round(t_pipeline, 4)
    out["host_fsm_s"] = round(t_host, 4)
    out["realtime_channel_capacity_device_resident"] = int(
        n_ch * seconds / (t_pipeline + t_host))


def write_wire_file(n_ch, block, n, one, gains, tmpdir="/tmp"):
    """Wire file: per step, the whole bank's u8 IQ (channel-major) — the
    byte stream a wideband front end would push at n_ch * fs * 2 B/s."""
    path = os.path.join(tmpdir, f"decoder_bank_wire_{n_ch}.u8")
    rng = np.random.default_rng(7)
    with open(path, "wb") as f:
        for i in range(0, n, block):
            blk = one[i:i + block]
            bank = gains * blk[None, :] + (
                0.02 * (rng.standard_normal((n_ch, block))
                        + 1j * rng.standard_normal((n_ch, block)))
            ).astype(np.complex64)
            inter = np.empty((n_ch, 2 * block), np.float32)
            inter[:, 0::2], inter[:, 1::2] = bank.real, bank.imag
            u8 = np.clip(np.round(inter * 128.0 + 128.0), 0,
                         255).astype(np.uint8)
            f.write(u8.tobytes())
    return path


def run_pump_fed(n_ch, fs, block, n, one, gains, out, tmpdir="/tmp"):
    """End-to-end from a u8 wire file through the native ingest path."""
    import jax
    import jax.numpy as jnp

    from libsdr_tpu.core import cplx as _cplx
    from libsdr_tpu.native import (FilePump, RingBuffer,
                                   u8_iq_to_planar_bf16)

    path = write_wire_file(n_ch, block, n, one, gains, tmpdir)

    fe, step = build_bank(n_ch, fs, block, plane_dtype=jnp.bfloat16)
    carry = fe.init_carry()
    step_bytes = n_ch * block * 2

    def take_block(ring):
        while True:
            raw = ring.take(step_bytes)
            if raw is not None:
                return raw
            if ring.eos and ring.available < step_bytes:
                return None
            time.sleep(0.0005)

    def convert(raw):
        re, im = u8_iq_to_planar_bf16(raw)
        return (np.asarray(re).view(jnp.bfloat16).reshape(n_ch, block),
                np.asarray(im).view(jnp.bfloat16).reshape(n_ch, block))

    def to_device(planes):
        return _cplx.Complex(jnp.asarray(planes[0]), jnp.asarray(planes[1]))

    def converted_blocks(ring):
        """Prefetch thread: ring take + LUT conversion overlap the device
        step (the production ingest topology; JAX stays on the main
        thread)."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=2)

        def work():
            while True:
                raw = take_block(ring)
                if raw is None:
                    q.put(None)
                    return
                q.put(convert(raw))

        threading.Thread(target=work, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    # warmup / compile on the first wire block (excluded from the timed
    # region like the device-resident path's warmup)
    ring = RingBuffer(max(1 << 26, 2 * step_bytes))
    pump = FilePump(path, ring)
    first = to_device(convert(take_block(ring)))
    c, (d0, k0) = step(carry, first)
    _ = float(jnp.sum(k0))
    pump.stop()
    ring.close()

    ring = RingBuffer(max(1 << 26, 2 * step_bytes))
    pump = FilePump(path, ring)
    t0 = time.perf_counter()
    c = carry
    datas, counts, pending = [], [], []
    for planes in converted_blocks(ring):
        c, y = step(c, to_device(planes))
        pending.append(y)
        if len(pending) > 1:
            d, k = pending.pop(0)
            datas.append(np.asarray(d))
            counts.append(np.asarray(k))
    for d, k in pending:
        datas.append(np.asarray(d))
        counts.append(np.asarray(k))
    decoded = decode_all(n_ch, datas, counts)
    t_e2e = time.perf_counter() - t0
    pump.stop()
    ring.close()
    os.unlink(path)

    seconds = n / fs
    out["decode_success_pump"] = decoded
    out["pump_fed_e2e_s"] = round(t_e2e, 4)
    out["wire_mb_per_s"] = round(n_ch * 2 * n / t_e2e / 1e6, 1)
    out["realtime_channel_capacity_pump_fed"] = int(
        n_ch * seconds / t_e2e)


def run_pump_fed_u8(n_ch, fs, block, n, one, gains, out, tmpdir="/tmp"):
    """Pump-fed with ON-DEVICE wire conversion: upload the RAW u8 bytes
    (2 B/sample — half the bf16-plane traffic) and convert to planes on
    the device (io/ingest.u8_wire_to_planes).  On a link-bound ingest
    the host does zero format work and the host->device link carries the
    wire format itself, exactly the byte
    stream the reference's driver delivers
    (/root/reference/src/rtlsource.cc:141-145)."""
    import jax
    import jax.numpy as jnp

    from libsdr_tpu.native import FilePump, RingBuffer

    path = write_wire_file(n_ch, block, n, one, gains, tmpdir)

    fe, step = build_bank(n_ch, fs, block, plane_dtype=jnp.bfloat16,
                          wire="u8")
    carry = fe.init_carry()
    step_bytes = n_ch * block * 2

    def take_block(ring):
        while True:
            raw = ring.take(step_bytes)
            if raw is not None:
                return np.frombuffer(raw, np.uint8).reshape(n_ch, 2 * block)
            if ring.eos and ring.available < step_bytes:
                return None
            time.sleep(0.0005)

    def raw_blocks(ring):
        """Prefetch thread: ring take overlaps the device step (no host
        conversion at all on this path)."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=2)

        def work():
            while True:
                raw = take_block(ring)
                q.put(raw)
                if raw is None:
                    return

        threading.Thread(target=work, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    # warmup / compile on the first wire block
    ring = RingBuffer(max(1 << 26, 2 * step_bytes))
    pump = FilePump(path, ring)
    c, (d0, k0) = step(carry, jnp.asarray(take_block(ring)))
    _ = float(jnp.sum(k0))
    pump.stop()
    ring.close()

    ring = RingBuffer(max(1 << 26, 2 * step_bytes))
    pump = FilePump(path, ring)
    t0 = time.perf_counter()
    c = carry
    datas, counts, pending = [], [], []
    for raw in raw_blocks(ring):
        c, y = step(c, jnp.asarray(raw))
        pending.append(y)
        if len(pending) > 1:
            d, k = pending.pop(0)
            datas.append(np.asarray(d))
            counts.append(np.asarray(k))
    for d, k in pending:
        datas.append(np.asarray(d))
        counts.append(np.asarray(k))
    decoded = decode_all(n_ch, datas, counts)
    t_e2e = time.perf_counter() - t0
    pump.stop()
    ring.close()
    os.unlink(path)

    seconds = n / fs
    out["decode_success_pump_u8"] = decoded
    out["pump_fed_u8_e2e_s"] = round(t_e2e, 4)
    out["wire_u8_mb_per_s"] = round(n_ch * 2 * n / t_e2e / 1e6, 1)
    out["realtime_channel_capacity_pump_fed_u8"] = int(
        n_ch * seconds / t_e2e)
    # PCIe projection: projected capacity = n_ch * seconds /
    # max(compute_s, wire_bytes / pcie_bw) at ~12 GB/s effective.
    pcie_bw = 12e9
    wire_bytes = n_ch * 2 * n
    t_compute = out.get("device_front_end_s", t_e2e)
    t_proj = max(t_compute, wire_bytes / pcie_bw)
    out["pcie_projection"] = {
        "formula": "n_ch * seconds / max(device_front_end_s, "
                   "wire_bytes / pcie_bw)",
        "pcie_bw_GBps": 12.0,
        "wire_bytes": wire_bytes,
        "projected_capacity": int(n_ch * seconds / t_proj),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fs", type=float, default=240e3)
    ap.add_argument("--skip-pump", action="store_true")
    args = ap.parse_args()

    n_ch = args.channels
    fs = args.fs
    # ~0.5 s blocks, rounded to a whole number of 1280-sample frames
    # (decim 10 x the 128-output Toeplitz frame of ops/fir.py).
    block = int(fs * 0.5)
    block -= block % (1280 * 4)
    n = int(fs * args.seconds)
    n -= n % block

    rng = np.random.default_rng(0)
    one = synth_channel(fs, n, 1234, "CAPACITY BENCH")
    gains = rng.uniform(0.5, 1.0, (n_ch, 1)).astype(np.float32)

    out = {
        "metric": "concurrent POCSAG channels decoded per host (1 chip)",
        "channels_run": n_ch,
        "signal_seconds": args.seconds,
        "note": "device_resident = compute ceiling (input in device "
                "memory); pump_fed = end-to-end incl. the host->device link",
    }
    run_device_resident(n_ch, fs, block, n, one, gains, out)
    if not args.skip_pump:
        run_pump_fed(n_ch, fs, block, n, one, gains, out)
        run_pump_fed_u8(n_ch, fs, block, n, one, gains, out)
    # headline field stays the honest end-to-end number when measured:
    # the u8-wire upload (2 B/sample, on-device conversion) is the
    # production ingest path, so it wins when present.
    out["realtime_channel_capacity"] = out.get(
        "realtime_channel_capacity_pump_fed_u8",
        out.get("realtime_channel_capacity_pump_fed",
                out["realtime_channel_capacity_device_resident"]))
    print(json.dumps(out))
    from tools._artifact import write_artifact
    write_artifact("DECODERBANK", out)


if __name__ == "__main__":
    main()
