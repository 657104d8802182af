"""Streaming ingest: blocks from a capture file through the native ring
buffer + pump thread (the host-side analog of the reference's Queue-fed
sources; reference: src/queue.cc, src/rtlsource.cc)."""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np

from libsdr_tpu.native import (FilePump, RingBuffer, u8_iq_to_planar,
                               u8_iq_to_planar_bf16, s16_iq_to_planar)


def stream_raw_iq(path: str, block_size: int, dtype=np.uint8,
                  ring_bytes: int = 1 << 24) -> Iterator[np.ndarray]:
    """Yield complex64 IQ blocks from a raw interleaved capture file, with a
    native ingest thread double-buffering the reads (rtl_sdr wire format by
    default, reference: src/rtlsource.cc:141-145).

    The final partial block is zero-padded.
    """
    dt = np.dtype(dtype)
    if dt == np.uint8:
        convert = u8_iq_to_planar
    elif dt == np.int16:
        convert = s16_iq_to_planar
    else:
        raise ValueError(
            f"stream_raw_iq: unsupported sample dtype {dt} "
            "(uint8 and int16 captures only)")
    itemsize = dt.itemsize
    bytes_per_block = block_size * 2 * itemsize
    ring = RingBuffer(max(ring_bytes, 4 * bytes_per_block))
    pump = FilePump(path, ring)
    try:
        while True:
            raw = ring.take(bytes_per_block)
            if raw is None:
                if ring.eos:
                    n = ring.available
                    if n == 0:
                        break
                    raw = ring.take((n // (2 * itemsize)) * 2 * itemsize)
                    if raw is None or len(raw) == 0:
                        break
                    re, im = convert(raw.view(dtype))
                    blk = np.zeros(block_size, np.complex64)
                    blk[:len(re)] = re + 1j * im
                    yield blk
                    break
                time.sleep(0.0005)
                continue
            re, im = convert(raw.view(dtype))
            yield (re + 1j * im).astype(np.complex64)
    finally:
        pump.stop()
        ring.close()


def u8_wire_to_planes(raw, plane_dtype=None):
    """ON-DEVICE wire-format conversion: interleaved u8 IQ ``(..., 2*N)``
    -> planar :class:`~libsdr_tpu.core.cplx.Complex` ``(..., N)``.

    Jit-traceable — upload the RAW u8 wire bytes (2 B/sample: half the
    host->device traffic of bf16 planes, a quarter of f32) and convert on
    the device.  ``(u8 - 128)/128`` is exact in bf16, so the result is
    bit-identical to the host LUT path (``native.u8_iq_to_planar_bf16``);
    the wire format is the reference driver's
    (/root/reference/src/rtlsource.cc:141-145).  On a link-bound ingest
    (pump-fed decoder bank, tools/bench_decoder_bank.py) this doubles
    capacity vs uploading bf16 planes."""
    import jax.numpy as jnp

    from libsdr_tpu.core.cplx import Complex

    dt = plane_dtype if plane_dtype is not None else jnp.float32
    v = raw.reshape(raw.shape[:-1] + (raw.shape[-1] // 2, 2))
    f = (v.astype(jnp.float32) - 128.0) * (1.0 / 128.0)
    return Complex(f[..., 0].astype(dt), f[..., 1].astype(dt))


def stream_raw_iq_u8(path: str, block_size: int,
                     ring_bytes: int = 1 << 24) -> Iterator[np.ndarray]:
    """Yield RAW interleaved u8 wire blocks (shape ``(2*block_size,)``)
    from a capture file via the native pump — the host does no format
    conversion at all; feed :func:`u8_wire_to_planes` on-device.  Final
    partial block is padded with 128 (the wire's zero)."""
    bytes_per_block = block_size * 2
    ring = RingBuffer(max(ring_bytes, 4 * bytes_per_block))
    pump = FilePump(path, ring)
    try:
        while True:
            raw = ring.take(bytes_per_block)
            if raw is None:
                if ring.eos:
                    n = ring.available
                    if n == 0:
                        break
                    raw = ring.take((n // 2) * 2)
                    if raw is None or len(raw) == 0:
                        break
                    blk = np.full(bytes_per_block, 128, np.uint8)
                    blk[:len(raw)] = np.frombuffer(raw, np.uint8)
                    yield blk
                    break
                time.sleep(0.0005)
                continue
            yield np.frombuffer(raw, np.uint8)
    finally:
        pump.stop()
        ring.close()


def stream_raw_iq_bf16(path: str, block_size: int,
                       ring_bytes: int = 1 << 24) -> Iterator:
    """Like :func:`stream_raw_iq` for u8 captures, but the native converter
    emits bfloat16 PLANES directly (lossless for 8-bit sources, half the
    host->device and HBM traffic): yields planar
    :class:`~libsdr_tpu.core.cplx.Complex` blocks with bf16 planes — feed a
    pipeline bound with ``plane_dtype=jnp.bfloat16`` (or behind
    ``AutoCast(compute='bfloat16')`` semantics).  Final partial block is
    zero-padded."""
    import jax.numpy as jnp

    from libsdr_tpu.core.cplx import Complex

    def to_block(re_u16, im_u16, pad_to=None):
        re = np.asarray(re_u16).view(jnp.bfloat16)
        im = np.asarray(im_u16).view(jnp.bfloat16)
        if pad_to is not None and len(re) < pad_to:
            z = np.zeros(pad_to, dtype=re.dtype)
            z[:len(re)] = re
            re, z2 = z, np.zeros(pad_to, dtype=im.dtype)
            z2[:len(im)] = im
            im = z2
        return Complex(jnp.asarray(re), jnp.asarray(im))

    bytes_per_block = block_size * 2
    ring = RingBuffer(max(ring_bytes, 4 * bytes_per_block))
    pump = FilePump(path, ring)
    try:
        while True:
            raw = ring.take(bytes_per_block)
            if raw is None:
                if ring.eos:
                    n = ring.available
                    if n == 0:
                        break
                    raw = ring.take((n // 2) * 2)
                    if raw is None or len(raw) == 0:
                        break
                    re, im = u8_iq_to_planar_bf16(raw)
                    yield to_block(re, im, pad_to=block_size)
                    break
                time.sleep(0.0005)
                continue
            re, im = u8_iq_to_planar_bf16(raw)
            yield to_block(re, im)
    finally:
        pump.stop()
        ring.close()
