"""Host streaming driver — the array-native analog of the reference's ``Queue``.

The reference runs a singleton message loop in one pthread: sources enqueue
buffers, the loop dispatches each to its sink, and idle callbacks re-prime
file sources (reference: src/queue.cc:83-125).  Here the device is the
worker: the host driver streams fixed-size blocks from a source iterator into
one jitted step function and hands results to a sink callback.  JAX dispatch
is asynchronous, so while the device computes block *i* the host is already
reading and transferring block *i+1* — the double-buffering that replaces the
reference's producer/consumer queue (reference: src/queue.cc:35-43).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.graph import Pipeline
from libsdr_tpu.core.stream import StreamSpec
from libsdr_tpu.utils.logging import get_logger

_log = get_logger(__name__)


def stream_blocks(samples: np.ndarray, block_size: int,
                  pad_value=0) -> Iterator[np.ndarray]:
    """Yield fixed-size blocks from a sample array along the trailing axis,
    zero-padding the final partial block (the analog of WavSource reading
    ``buffer_size`` frames per Queue-idle, reference: src/wavfile.cc:198-237)."""
    n = samples.shape[-1]
    for start in range(0, n, block_size):
        blk = samples[..., start:start + block_size]
        if blk.shape[-1] < block_size:
            pad = block_size - blk.shape[-1]
            widths = [(0, 0)] * (blk.ndim - 1) + [(0, pad)]
            blk = np.pad(blk, widths, constant_values=pad_value)
        yield blk


def run_pipeline(pipeline: Pipeline,
                 blocks: Iterable[Any],
                 sink: Optional[Callable[[np.ndarray], None]] = None,
                 carry: Any = None,
                 collect: bool = True,
                 device=None,
                 chunks_per_dispatch: int = 1):
    """Drive ``pipeline`` over an iterable of input blocks.

    Args:
      pipeline: a bound Pipeline.
      blocks: iterable of input blocks (numpy or jax arrays) matching
        ``pipeline.in_spec.shape``.
      sink: optional callback receiving each output block as numpy.
      carry: initial carry; defaults to ``pipeline.init_carry()``.
      collect: if True, concatenate and return all outputs along time.
      device: optional jax device for explicit placement.
      chunks_per_dispatch: group K consecutive blocks into ONE device
        dispatch (the unrolled chunked step: each block stays its own XLA
        buffer, no staging copies) — amortizes the fixed per-dispatch
        launch cost for small/streaming blocks at a latency budget of K
        blocks (see Pipeline.compile_chunked).  A trailing group of fewer
        than K blocks runs through the regular step.

    Returns:
      (carry, outputs) where outputs is the concatenated output array if
      ``collect`` else None.
    """
    k = int(chunks_per_dispatch)
    step = pipeline.compile()
    stepk = pipeline.compile_chunked() if k > 1 else None
    if carry is None:
        carry = pipeline.init_carry()
    ragged = pipeline.out_spec.ragged if pipeline.is_bound else False
    outs = []
    pending = []  # keep a small window of in-flight device results

    def drain(y, chunked=False):
        # A chunked dispatch returns a length-K tuple of output blocks.
        for p in (y if chunked else (y,)):
            if ragged:
                # Variable-rate decoder streams (bit-sync output): hand the
                # host-side Ragged block through; the collected result is
                # compacted once at the end (per-channel for channel banks).
                from libsdr_tpu.core.ragged import Ragged
                p = Ragged(np.asarray(p.data), np.asarray(p.valid))
            else:
                p = cplx.to_numpy(p)  # complex streams come back planar
            if sink is not None:
                sink(p)
            if collect:
                outs.append(p)

    def dispatch(x, use_k):
        nonlocal carry
        if device is not None:
            x = jax.device_put(x, device)
        carry, y = (stepk if use_k else step)(carry, x)
        pending.append((y, use_k))
        # Bound host-side queue depth to 2 in-flight dispatches.
        if len(pending) > 2:
            drain(*pending.pop(0))

    group = []
    for blk in blocks:
        x = cplx.as_block(blk)
        if k > 1:
            group.append(x)
            if len(group) == k:
                dispatch(tuple(group), True)
                group = []
        else:
            dispatch(x, False)
    for x in group:                    # trailing partial group
        dispatch(x, False)
    for y, chunked in pending:
        drain(y, chunked)
    if not (collect and outs):
        return carry, None
    if ragged:
        from libsdr_tpu.core.ragged import compact, concat_host
        return carry, compact(concat_host(outs))
    return carry, np.concatenate(outs, axis=-1)


def reblock(blocks: Iterable[np.ndarray], out_size: int) -> Iterator[np.ndarray]:
    """Host-side re-blocker: accumulate arbitrary-size blocks and emit
    fixed-size ones (the analog of ``sdr::BufferNode``, reference:
    src/buffernode.hh:17-102 — needed in front of FFT stages whose block
    size is part of the transform).  The trailing remainder is dropped,
    matching the reference's accumulate-until-full behavior."""
    buf = None
    for blk in blocks:
        blk = np.asarray(blk)
        buf = blk if buf is None else np.concatenate([buf, blk], axis=-1)
        while buf.shape[-1] >= out_size:
            yield buf[..., :out_size]
            buf = buf[..., out_size:]


class Throughput:
    """Throughput + drop meter for the host driver (the observability the
    reference's overflow printouts gesture at — src/portaudio.cc:129-155,
    src/firfilter.hh:219-226 — made a real counter; SURVEY.md section 5).

    ``add`` counts samples processed; ``add_dropped`` counts samples a live
    source discarded because the pipeline fell behind the wire
    (back-pressure-by-drop).  The realtime design point: a healthy live
    deployment shows ``drop_fraction == 0`` with ``msps`` >= the wire
    rate."""

    def __init__(self) -> None:
        self.samples = 0
        self.dropped = 0
        self.t0 = time.perf_counter()

    def add(self, n: int) -> None:
        self.samples += n

    def add_dropped(self, n: int) -> None:
        self.dropped += n

    def update_from(self, stats, bytes_per_sample: int = 2) -> None:
        """Absorb a live source's :class:`libsdr_tpu.io.live.LiveStats`
        (drops are totals there, not increments).  ``bytes_per_sample``:
        wire bytes per sample — 2 for u8 IQ, 4 for s16 IQ, 2 for s16
        mono audio."""
        self.dropped = stats.bytes_dropped // bytes_per_sample

    @property
    def msps(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.samples / dt / 1e6 if dt > 0 else float("inf")

    @property
    def drop_fraction(self) -> float:
        total = self.samples + self.dropped
        return self.dropped / total if total else 0.0

    def report(self) -> str:
        sustained = self.samples / max(
            time.perf_counter() - self.t0, 1e-9) / 1e6
        return (f"{sustained:.2f} Msps sustained, "
                f"{self.dropped} samples dropped "
                f"({100 * self.drop_fraction:.2f}%)")
