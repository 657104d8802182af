"""Live streaming ingest: IQ blocks from a network socket or FIFO, feeding
the device pipeline from a live wire through the native SPSC ring + pump
thread.

This is the production analog of the reference's *live* sources — the
rtl_sdr driver thread (reference: src/rtlsource.cc:133-145) and the
PortAudio callback (reference: src/portaudio.cc:129-155): an accelerator server has no
USB dongle or sound card, so the radio front end lives across a wire
(classically an ``rtl_tcp`` server next to the antenna) and this module
terminates that wire.  Live sources cannot block the sender, so overflow is
dropped in whole IQ frames and *accounted* — the reference's
back-pressure-by-drop contract (reference: src/firfilter.hh:219-226).

URL forms accepted by :func:`stream_live_iq`:

- ``tcp://host:port``   — connect and pull (the rtl_tcp topology)
- ``tcp-listen://:port``— accept one pushing client (port 0 = ephemeral)
- ``udp://:port``       — datagram sink
- ``fifo:///path``      — named local pipe (``fifo:///dev/stdin`` reads a
  shell pipeline — the reference's StreamSource-on-istream contract,
  reference: src/utils.hh:524-588)

:class:`RTLTCPSource` speaks the actual rtl_tcp protocol (12-byte ``RTL0``
header, big-endian ``(cmd:u8, value:u32)`` control messages) so a stock
``rtl_tcp`` server is a drop-in live front end — the closest possible
analog of the reference's RTLSource tuning API (reference:
src/rtlsource.cc:36-76 setFrequency/setSampleRate/enableAGC).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from libsdr_tpu.native import (LivePump, RingBuffer, s16_iq_to_planar,
                               u8_iq_to_planar, u8_iq_to_planar_bf16)


@dataclass
class LiveStats:
    """Drop/throughput accounting for a live source (the observability the
    reference's overflow printouts gesture at, src/portaudio.cc:129-155)."""

    bytes_in: int = 0
    bytes_dropped: int = 0
    blocks: int = 0
    t0: float = 0.0
    port: int = -1   # bound port for listen/udp sources (resolves :0)

    @property
    def drop_fraction(self) -> float:
        return self.bytes_dropped / self.bytes_in if self.bytes_in else 0.0

    def sustained_msps(self, bytes_per_sample: int = 2) -> float:
        """Average delivered complex-sample rate since the stream started."""
        dt = time.perf_counter() - self.t0
        kept = self.bytes_in - self.bytes_dropped
        return kept / bytes_per_sample / dt / 1e6 if dt > 0 else 0.0


def _parse_url(url: str):
    kind, _, rest = url.partition("://")
    if kind == "fifo":
        return "fifo", rest, None
    host, _, port = rest.rpartition(":")
    if not port:
        raise ValueError(f"live url needs a port: {url!r}")
    return kind, host or "0.0.0.0", int(port)


def open_live_pump(url: str, ring: RingBuffer, frame: int = 2,
                   chunk: int = 1 << 18) -> LivePump:
    """Start the ingest thread for a live URL (see module docstring)."""
    kind, host, port = _parse_url(url)
    if kind == "tcp":
        return LivePump.tcp_connect(host, port, ring, chunk=chunk,
                                    frame=frame)
    if kind == "tcp-listen":
        return LivePump.tcp_listen(port, ring, chunk=chunk, frame=frame)
    if kind == "udp":
        return LivePump.udp(port, ring, chunk=chunk, frame=frame)
    if kind == "fifo":
        return LivePump.fifo(host, ring, chunk=chunk, frame=frame)
    raise ValueError(f"unknown live source kind {kind!r} in {url!r}")


def _pad_tail(blk: np.ndarray, pad_to: int) -> np.ndarray:
    """Zero-pad a 1-D final partial block to the pipeline's block size."""
    if len(blk) >= pad_to:
        return blk
    z = np.zeros(pad_to, blk.dtype)
    z[:len(blk)] = blk
    return z


def _u8_block_to_c64(raw: np.ndarray) -> np.ndarray:
    """Interleaved u8 wire bytes -> one complex64 block."""
    re, im = u8_iq_to_planar(raw.view(np.uint8))
    return (re + 1j * im).astype(np.complex64)


def _block_loop(ring: RingBuffer, pump: LivePump, block_size: int,
                itemsize: int, convert, stats: Optional[LiveStats],
                timeout: Optional[float], to_block,
                items_per_frame: int = 2, own: bool = True):
    """Shared take-and-convert loop (mirrors io.ingest.stream_raw_iq's EOS
    handling, plus idle-timeout and live drop stats).

    ``items_per_frame``: wire items per output sample — 2 for interleaved
    IQ, 1 for mono audio.  ``timeout`` is seconds with NO WIRE BYTES (it
    watches the pump's bytes_in counter, so a healthy low-rate wire that
    takes longer than ``timeout`` to fill one block is NOT killed).
    ``own``: when False the pump/ring belong to the caller (e.g. a
    reusable RTLTCPSource) and survive this generator — the loop only
    stops yielding."""
    frame = items_per_frame * itemsize
    bytes_per_block = block_size * frame

    def drain():
        """End of stream (EOS or idle timeout): hand out what's buffered —
        whole blocks first, never more than block_size per yield (the
        downstream step is compiled for exactly that shape), then one
        zero-padded partial."""
        while True:
            n = min(ring.available, bytes_per_block)
            n -= n % frame
            if n == 0:
                return
            raw = ring.take(n)
            if raw is None or len(raw) == 0:
                return
            yield to_block(convert(raw), pad_to=block_size)

    if stats is not None:
        stats.t0 = time.perf_counter()
    last_progress = time.perf_counter()
    last_bytes_in = pump.bytes_in
    try:
        while True:
            raw = ring.take(bytes_per_block)
            if raw is None:
                if ring.eos:
                    yield from drain()
                    break
                if timeout is not None:
                    got = pump.bytes_in
                    if got != last_bytes_in:
                        last_bytes_in = got
                        last_progress = time.perf_counter()
                    elif time.perf_counter() - last_progress > timeout:
                        # idle stream: the buffered tail still decodes
                        yield from drain()
                        break
                time.sleep(0.0005)
                continue
            if stats is not None:
                stats.bytes_in = pump.bytes_in
                stats.bytes_dropped = pump.bytes_dropped
                stats.blocks += 1
            yield to_block(convert(raw))
    finally:
        if stats is not None:
            stats.bytes_in = pump.bytes_in
            stats.bytes_dropped = pump.bytes_dropped
        if own:
            pump.stop()
            if stats is not None:
                stats.bytes_in = pump.bytes_in
                stats.bytes_dropped = pump.bytes_dropped
            ring.close()


def stream_live_iq(url: str, block_size: int, dtype=np.uint8,
                   ring_bytes: int = 1 << 24,
                   stats: Optional[LiveStats] = None,
                   timeout: Optional[float] = None) -> Iterator[np.ndarray]:
    """Yield complex64 IQ blocks from a live wire (see module docstring for
    URL forms).  ``stats`` (a :class:`LiveStats`) is updated in place with
    the pump's drop accounting; ``timeout`` (seconds with no data) ends an
    idle stream instead of blocking forever."""
    dt = np.dtype(dtype)
    if dt == np.uint8:
        conv = u8_iq_to_planar
    elif dt == np.int16:
        conv = s16_iq_to_planar
    else:
        raise ValueError(f"stream_live_iq: unsupported sample dtype {dt}")
    itemsize = dt.itemsize
    frame = 2 * itemsize

    if dt == np.uint8:
        convert = _u8_block_to_c64
    else:
        def convert(raw):
            re, im = conv(raw.view(dt))
            return (re + 1j * im).astype(np.complex64)

    def to_block(blk, pad_to=None):
        return blk if pad_to is None else _pad_tail(blk, pad_to)

    ring = RingBuffer(max(ring_bytes, 4 * block_size * frame))
    pump = open_live_pump(url, ring, frame=frame)
    if stats is not None:
        stats.port = pump.port
    return _block_loop(ring, pump, block_size, itemsize, convert, stats,
                       timeout, to_block)


def stream_live_iq_bf16(url: str, block_size: int,
                        ring_bytes: int = 1 << 24,
                        stats: Optional[LiveStats] = None,
                        timeout: Optional[float] = None) -> Iterator:
    """Like :func:`stream_live_iq` for u8 wires, but emits planar
    :class:`~libsdr_tpu.core.cplx.Complex` blocks with bfloat16 planes —
    lossless for 8-bit sources and half the host->device traffic; feed a
    pipeline bound with ``plane_dtype=jnp.bfloat16``."""
    import jax.numpy as jnp

    from libsdr_tpu.core.cplx import Complex

    def convert(raw):
        re, im = u8_iq_to_planar_bf16(raw)
        return (np.asarray(re).view(jnp.bfloat16),
                np.asarray(im).view(jnp.bfloat16))

    def to_block(planes, pad_to=None):
        re, im = planes
        if pad_to is not None and len(re) < pad_to:
            zr = np.zeros(pad_to, re.dtype)
            zi = np.zeros(pad_to, im.dtype)
            zr[:len(re)], zi[:len(im)] = re, im
            re, im = zr, zi
        return Complex(jnp.asarray(re), jnp.asarray(im))

    ring = RingBuffer(max(ring_bytes, 8 * block_size))
    pump = open_live_pump(url, ring, frame=2)
    if stats is not None:
        stats.port = pump.port
    return _block_loop(ring, pump, block_size, 1, convert, stats, timeout,
                       to_block)


def stream_live_audio(url: str, block_size: int, dtype=np.int16,
                      ring_bytes: int = 1 << 22,
                      stats: Optional[LiveStats] = None,
                      timeout: Optional[float] = None) -> Iterator[np.ndarray]:
    """Yield float32 MONO audio blocks from a live wire (s16 or u8
    samples) — the PortAudio-source analog for demodulated-audio consumers
    like the APRS service (reference: src/portaudio.cc PortSource)."""
    dt = np.dtype(dtype)
    if dt == np.int16:
        def conv(raw):
            from libsdr_tpu.native import get_lib
            a = raw.view(np.int16)
            lib = get_lib()
            if lib is not None:
                out = np.empty(len(a), np.float32)
                import ctypes
                lib.s16_to_f32(a.ctypes.data_as(ctypes.c_void_p), len(a),
                               out.ctypes.data_as(ctypes.c_void_p))
                return out
            return a.astype(np.float32) / 32768.0
    elif dt == np.uint8:
        def conv(raw):
            return (raw.astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"stream_live_audio: unsupported dtype {dt}")
    itemsize = dt.itemsize
    ring = RingBuffer(max(ring_bytes, 4 * block_size * itemsize))
    pump = open_live_pump(url, ring, frame=itemsize)
    if stats is not None:
        stats.port = pump.port

    def to_block(blk, pad_to=None):
        return blk if pad_to is None else _pad_tail(blk, pad_to)

    return _block_loop(ring, pump, block_size, itemsize, conv, stats,
                       timeout, to_block, items_per_frame=1)


# ---------------------------------------------------------------------------
# TX side: push samples INTO a wire (the ostream StreamSink analog,
# reference: src/utils.hh:524-588 — here a socket/FIFO, completing the
# live loopback: `tx --wire tcp://host:port` feeds `scanner --live
# tcp-listen://:port` on another host/process)
# ---------------------------------------------------------------------------

def _open_wire_writer(url: str):
    """Returns (send(bytes), close()) for a live URL (sender side)."""
    import socket as _socket

    kind, host, port = _parse_url(url)
    if kind == "tcp":
        s = _socket.create_connection((host, port), timeout=10)
        return s.sendall, s.close
    if kind == "tcp-listen":
        ls = _socket.socket()
        ls.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        ls.bind(("", port))
        ls.listen(1)
        c, _ = ls.accept()
        ls.close()
        return c.sendall, c.close
    if kind == "udp":
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        dest = (host if host != "0.0.0.0" else "127.0.0.1", port)

        def send(data, _mtu=32768):
            for off in range(0, len(data), _mtu):
                s.sendto(data[off:off + _mtu], dest)
        return send, s.close
    if kind == "fifo":
        f = open(host, "wb")

        def send(data):
            f.write(data)
            f.flush()
        return send, f.close
    raise ValueError(f"unknown live sink kind {kind!r} in {url!r}")


def send_live_iq(url: str, iq: np.ndarray, rate: Optional[float] = None,
                 chunk: int = 1 << 16) -> int:
    """Push a complex IQ array to a live wire as the u8 rtl_sdr format
    (x*128+128 interleaved).  ``rate``: throttle to that many complex
    samples/s (realtime pacing for live demos); None = blast.  Returns
    bytes sent."""
    iq = np.asarray(iq)
    inter = np.empty(2 * len(iq), np.float32)
    inter[0::2], inter[1::2] = iq.real, iq.imag
    u8 = np.clip(np.round(inter * 128.0 + 128.0), 0, 255).astype(np.uint8)
    return _send_wire(url, u8.tobytes(), rate, 2, chunk)


def send_live_audio(url: str, audio: np.ndarray,
                    rate: Optional[float] = None,
                    chunk: int = 1 << 16) -> int:
    """Push mono float audio to a live wire as s16 samples."""
    s16 = np.clip(np.asarray(audio, np.float32) * 32767.0,
                  -32768, 32767).astype(np.int16)
    return _send_wire(url, s16.tobytes(), rate, 2, chunk)


def _send_wire(url: str, data: bytes, rate: Optional[float],
               bytes_per_sample: int, chunk: int) -> int:
    send, close = _open_wire_writer(url)
    try:
        t0 = time.perf_counter()
        sent = 0
        for off in range(0, len(data), chunk):
            send(data[off:off + chunk])
            sent += min(chunk, len(data) - off)
            if rate is not None:
                ahead = (sent / bytes_per_sample / rate
                         - (time.perf_counter() - t0))
                if ahead > 0:
                    time.sleep(ahead)
        return sent
    finally:
        close()


# ---------------------------------------------------------------------------
# rtl_tcp client — the real-world remote-RTL front end
# ---------------------------------------------------------------------------

class RTLTCPSource:
    """Client for a stock ``rtl_tcp`` server: tunable live RTL2832 front end
    over TCP (the network mirror of the reference's RTLSource API,
    src/rtlsource.cc:36-76).

    Protocol: on connect the server sends a 12-byte header ``b"RTL0"`` +
    tuner type (u32be) + gain-count (u32be), then an endless u8 interleaved
    IQ stream; the client sends 5-byte big-endian ``(cmd:u8, value:u32)``
    control messages.  Command numbers are the rtl_tcp dongle protocol
    (0x01 set_freq, 0x02 set_sample_rate, 0x03 set_gain_mode,
    0x04 set_gain, 0x08 set_agc_mode).
    """

    CMD_FREQ = 0x01
    CMD_RATE = 0x02
    CMD_GAIN_MODE = 0x03
    CMD_GAIN = 0x04
    CMD_AGC = 0x08

    def __init__(self, host: str, port: int = 1234,
                 sample_rate: float = 2.4e6, frequency: float = 100e6,
                 ring_bytes: int = 1 << 24, timeout: float = 5.0):
        import socket

        self.stats = LiveStats()
        self._ctrl = socket.create_connection((host, port), timeout=timeout)
        self._ctrl.settimeout(timeout)
        header = b""
        while len(header) < 12:
            got = self._ctrl.recv(12 - len(header))
            if not got:
                raise ConnectionError("rtl_tcp: server closed during header")
            header += got
        if header[:4] != b"RTL0":
            raise ConnectionError(
                f"rtl_tcp: bad magic {header[:4]!r} (not an rtl_tcp server)")
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", header[4:12])
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.set_sample_rate(sample_rate)
        self.set_frequency(frequency)
        # Hand the connected fd's remaining stream to the native pump via a
        # second data path: the pump owns its own socket in tcp_connect
        # mode, so instead keep THIS socket and drain it with a
        # Python-fallback-style pump bound to the already-open fd.
        self._ring = RingBuffer(ring_bytes)
        self._pump = LivePump()
        self._pump.ring = self._ring
        self._pump._frame = 2
        self._ctrl.settimeout(0.1)
        self._pump._sock = self._ctrl
        self._pump._start_py(
            lambda buf: self._pump._recv_stream(self._ctrl, buf), 1 << 18)

    def _cmd(self, cmd: int, value: int) -> None:
        self._ctrl.sendall(struct.pack(">BI", cmd, int(value) & 0xFFFFFFFF))

    def set_frequency(self, hz: float) -> None:
        """reference: src/rtlsource.cc:36-47 setFrequency."""
        self.frequency = float(hz)
        self._cmd(self.CMD_FREQ, int(hz))

    def set_sample_rate(self, hz: float) -> None:
        """reference: src/rtlsource.cc:58-69 setSampleRate."""
        self.sample_rate = float(hz)
        self._cmd(self.CMD_RATE, int(hz))

    def set_gain(self, tenths_db: int) -> None:
        self._cmd(self.CMD_GAIN_MODE, 1)
        self._cmd(self.CMD_GAIN, tenths_db)

    def enable_agc(self, on: bool = True) -> None:
        """reference: src/rtlsource.cc:71-76 enableAGC."""
        self._cmd(self.CMD_GAIN_MODE, 0 if on else 1)
        self._cmd(self.CMD_AGC, 1 if on else 0)

    def blocks(self, block_size: int,
               timeout: Optional[float] = None) -> Iterator[np.ndarray]:
        """Yield complex64 blocks from the live stream.

        The pump and ring belong to THIS source (``own=False``): the
        generator ending — timeout, break, garbage collection — leaves the
        connection, ring, and tuner usable, so retune-then-restream works
        (``for b in src.blocks(N, timeout=1): ...; src.set_frequency(f2);
        src.blocks(N)``).  Only :meth:`close` tears the source down."""
        def to_block(blk, pad_to=None):
            return blk if pad_to is None else _pad_tail(blk, pad_to)

        return _block_loop(self._ring, self._pump, block_size, 1,
                           _u8_block_to_c64, self.stats, timeout, to_block,
                           own=False)

    def close(self) -> None:
        self._pump.stop()
        self._ring.close()
