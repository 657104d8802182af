"""Native host runtime (C++ via ctypes) with numpy fallbacks.

Builds ``src/sdr_native.cc`` on first use (g++ is in the image; pybind11 is
not, so the ABI is plain C + ctypes).  Everything here has a pure-numpy
fallback so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src", "sdr_native.cc")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    out = os.path.join(_HERE, "_sdr_native.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             _SRC, "-o", out, "-lpthread"],
            check=True, capture_output=True, timeout=120)
        return out
    except Exception:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    c_i64, c_p = ctypes.c_int64, ctypes.c_void_p
    lib.u8_iq_to_planar_f32.argtypes = [c_p, c_i64, c_p, c_p]
    lib.s16_iq_to_planar_f32.argtypes = [c_p, c_i64, c_p, c_p]
    lib.s16_to_f32.argtypes = [c_p, c_i64, c_p]
    lib.f32_planar_to_s16_interleaved.argtypes = [c_p, c_p, c_i64, c_p]
    lib.ring_create.argtypes = [c_i64]
    lib.ring_create.restype = c_p
    lib.ring_destroy.argtypes = [c_p]
    lib.ring_available.argtypes = [c_p]
    lib.ring_available.restype = c_i64
    lib.ring_space.argtypes = [c_p]
    lib.ring_space.restype = c_i64
    lib.ring_put.argtypes = [c_p, c_p, c_i64]
    lib.ring_put.restype = c_i64
    lib.ring_take.argtypes = [c_p, c_p, c_i64]
    lib.ring_take.restype = c_i64
    lib.ring_eos.argtypes = [c_p]
    lib.ring_eos.restype = ctypes.c_int
    lib.ring_set_eos.argtypes = [c_p]
    lib.pump_start.argtypes = [ctypes.c_char_p, c_p, c_i64]
    lib.pump_start.restype = c_p
    lib.pump_stop.argtypes = [c_p]
    c_int = ctypes.c_int
    lib.live_pump_tcp_connect.argtypes = [ctypes.c_char_p, c_int, c_p,
                                          c_i64, c_i64, c_int]
    lib.live_pump_tcp_connect.restype = c_p
    lib.live_pump_tcp_listen.argtypes = [c_int, c_p, c_i64, c_i64]
    lib.live_pump_tcp_listen.restype = c_p
    lib.live_pump_udp.argtypes = [c_int, c_p, c_i64, c_i64]
    lib.live_pump_udp.restype = c_p
    lib.live_pump_fifo.argtypes = [ctypes.c_char_p, c_p, c_i64, c_i64]
    lib.live_pump_fifo.restype = c_p
    lib.live_pump_port.argtypes = [c_p]
    lib.live_pump_port.restype = c_int
    lib.live_pump_bytes_in.argtypes = [c_p]
    lib.live_pump_bytes_in.restype = c_i64
    lib.live_pump_bytes_dropped.argtypes = [c_p]
    lib.live_pump_bytes_dropped.restype = c_i64
    lib.live_pump_stop.argtypes = [c_p, ctypes.POINTER(c_i64),
                                   ctypes.POINTER(c_i64)]
    lib.pocsag_decode.argtypes = [c_p, c_i64, c_p, c_p, c_i64, c_i64]
    lib.pocsag_decode.restype = c_i64
    lib.ax25_decode.argtypes = [c_p, c_i64, c_p, c_p, c_i64, c_i64]
    lib.ax25_decode.restype = c_i64
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# Converters (numpy fallback mirrors the C++ exactly)
# ---------------------------------------------------------------------------

def u8_iq_to_planar(src: np.ndarray):
    """Interleaved u8 IQ (rtl_sdr wire format, reference:
    src/rtlsource.cc:141-145) -> (re, im) float32 planes."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    n = len(src) // 2
    lib = get_lib()
    if lib is not None:
        re = np.empty(n, np.float32)
        im = np.empty(n, np.float32)
        lib.u8_iq_to_planar_f32(_ptr(src), n, _ptr(re), _ptr(im))
        return re, im
    f = (src.astype(np.float32) - 128.0) / 128.0
    return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])


def u8_iq_to_planar_bf16(src: np.ndarray):
    """Interleaved u8 IQ -> (re, im) bfloat16 planes (as uint16 bit
    patterns; view with ml_dtypes/jnp.bfloat16).  Lossless for 8-bit
    sources and HALF the ingest and device-memory traffic of f32 — a
    storage format the device pipeline consumes directly
    (AutoCast(compute='bfloat16') semantics at the native ingest)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    n = len(src) // 2
    lib = get_lib()
    if lib is not None and hasattr(lib, "u8_iq_to_planar_bf16"):
        re = np.empty(n, np.uint16)
        im = np.empty(n, np.uint16)
        lib.u8_iq_to_planar_bf16(_ptr(src), n, _ptr(re), _ptr(im))
        return re, im
    # numpy fallback: truncate f32 to its upper 16 bits (exact for these
    # values, see the C++ comment)
    f = ((src.astype(np.float32) - 128.0) / 128.0).view(np.uint32)
    h = (f >> 16).astype(np.uint16)
    return np.ascontiguousarray(h[0::2]), np.ascontiguousarray(h[1::2])


def s16_iq_to_planar(src: np.ndarray):
    src = np.ascontiguousarray(src, dtype=np.int16)
    n = len(src) // 2
    lib = get_lib()
    if lib is not None:
        re = np.empty(n, np.float32)
        im = np.empty(n, np.float32)
        lib.s16_iq_to_planar_f32(_ptr(src), n, _ptr(re), _ptr(im))
        return re, im
    f = src.astype(np.float32) / 32768.0
    return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])


# ---------------------------------------------------------------------------
# Ring buffer + file pump
# ---------------------------------------------------------------------------

class RingBuffer:
    """SPSC byte ring (native when available; numpy/deque fallback).
    The analog of the reference's RawRingBuffer (src/buffer.hh:356-541)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.ring_create(self.capacity)
        else:
            self._buf = bytearray()
            self._eos = False

    def put(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        if self._lib is not None:
            if self._h is None:
                return 0
            return int(self._lib.ring_put(self._h, _ptr(data), len(data)))
        if len(self._buf) + len(data) > self.capacity:
            return 0
        self._buf += data.tobytes()
        return len(data)

    def take(self, n: int) -> Optional[np.ndarray]:
        if self._lib is not None:
            # availability check BEFORE allocating: a polling consumer
            # (io/live.py, 0.5 ms period) must not churn a block-sized
            # np.empty per failed poll; the check is conservative under
            # the racing producer (more data can only arrive).  A closed
            # ring (_h None) never hands NULL to the C side.
            if self._h is None or self.available < n:
                return None
            out = np.empty(n, np.uint8)
            got = int(self._lib.ring_take(self._h, _ptr(out), n))
            return out if got == n else None
        if len(self._buf) < n:
            return None
        out = np.frombuffer(bytes(self._buf[:n]), np.uint8)
        del self._buf[:n]
        return out

    @property
    def available(self) -> int:
        if self._lib is not None:
            if self._h is None:
                return 0
            return int(self._lib.ring_available(self._h))
        return len(self._buf)

    @property
    def eos(self) -> bool:
        if self._lib is not None:
            if self._h is None:
                return True
            return bool(self._lib.ring_eos(self._h))
        return self._eos

    def set_eos(self) -> None:
        if self._lib is not None:
            if self._h is not None:
                self._lib.ring_set_eos(self._h)
        else:
            self._eos = True

    def close(self) -> None:
        if self._lib is not None and self._h:
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FilePump:
    """Ingest thread streaming a capture file into a RingBuffer — the analog
    of BlockingSource's thread (reference: src/node.cc:154-176).  Native
    std::thread when available, Python thread otherwise."""

    def __init__(self, path: str, ring: RingBuffer, chunk: int = 1 << 18):
        self.ring = ring
        self._lib = get_lib()
        if self._lib is not None and ring._lib is not None:
            self._h = self._lib.pump_start(path.encode(), ring._h, chunk)
            if not self._h:
                raise FileNotFoundError(path)
            self._thread = None
        else:
            import threading
            self._h = None
            self._stop = False

            def run():
                with open(path, "rb") as f:
                    while not self._stop:
                        buf = f.read(chunk)
                        if not buf:
                            break
                        arr = np.frombuffer(buf, np.uint8)
                        off = 0
                        while off < len(arr) and not self._stop:
                            put = ring.put(arr[off:])
                            if put == 0:
                                import time
                                time.sleep(0.001)
                            else:
                                off += put
                ring.set_eos()

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        if self._h is not None:
            self._lib.pump_stop(self._h)
            self._h = None
        elif self._thread is not None:
            self._stop = True
            self._thread.join()
            self._thread = None


class LivePump:
    """Live-wire ingest thread (TCP/UDP/FIFO) feeding a RingBuffer, with
    the reference's back-pressure-by-drop contract: a full ring DISCARDS the
    overflow in whole sample frames and counts it (reference:
    src/firfilter.hh:219-226, src/rtlsource.cc:133-145).  Native
    std::thread + poll() when the C++ library is available, Python
    socket thread otherwise.

    Construct via the classmethods: :meth:`tcp_connect` (the rtl_tcp
    topology — server owns the radio, we pull), :meth:`tcp_listen`
    (raw-wire push), :meth:`udp`, :meth:`fifo`.

    ``frame`` is the drop granularity in bytes (2 for u8 IQ, 4 for s16 IQ)
    so interleaved-IQ alignment never shifts across a drop.
    """

    def __init__(self):
        self.ring: Optional[RingBuffer] = None
        self._lib = None
        self._h = None
        self._thread = None
        self._stop = False
        self._frame = 1
        self._bytes_in = 0
        self._bytes_dropped = 0
        self._sock = None
        self._listen_sock = None
        self._fifo_fd = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def tcp_connect(cls, host: str, port: int, ring: RingBuffer,
                    chunk: int = 1 << 18, frame: int = 2,
                    timeout_ms: int = 5000) -> "LivePump":
        p = cls()
        p.ring, p._frame = ring, frame
        lib = get_lib()
        if lib is not None and ring._lib is not None:
            p._lib = lib
            p._h = lib.live_pump_tcp_connect(host.encode(), port, ring._h,
                                             chunk, frame, timeout_ms)
            if not p._h:
                raise ConnectionError(f"live tcp connect {host}:{port}")
            return p
        import socket
        s = socket.create_connection((host, port), timeout=timeout_ms / 1e3)
        s.settimeout(0.1)
        p._sock = s
        p._start_py(lambda buf: p._recv_stream(s, buf), chunk)
        return p

    @classmethod
    def tcp_listen(cls, port: int, ring: RingBuffer, chunk: int = 1 << 18,
                   frame: int = 2) -> "LivePump":
        p = cls()
        p.ring, p._frame = ring, frame
        lib = get_lib()
        if lib is not None and ring._lib is not None:
            p._lib = lib
            p._h = lib.live_pump_tcp_listen(port, ring._h, chunk, frame)
            if not p._h:
                raise OSError(f"live tcp listen :{port}")
            return p
        import socket
        ls = socket.socket()
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind(("", port))
        ls.listen(1)
        ls.settimeout(0.1)
        p._listen_sock = ls

        def read(buf):
            if p._sock is None:
                try:
                    c, _ = ls.accept()
                except TimeoutError:
                    return -2  # keep waiting
                c.settimeout(0.1)
                p._sock = c
            return p._recv_stream(p._sock, buf)

        p._start_py(read, chunk)
        return p

    @classmethod
    def udp(cls, port: int, ring: RingBuffer, chunk: int = 1 << 18,
            frame: int = 2) -> "LivePump":
        p = cls()
        p.ring, p._frame = ring, frame
        lib = get_lib()
        if lib is not None and ring._lib is not None:
            p._lib = lib
            p._h = lib.live_pump_udp(port, ring._h, chunk, frame)
            if not p._h:
                raise OSError(f"live udp bind :{port}")
            return p
        import socket
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", port))
        s.settimeout(0.1)
        p._sock = s

        def read(buf):
            try:
                n = s.recv_into(buf)
            except TimeoutError:
                return -2
            return n if n > 0 else -2  # UDP never signals EOS
        p._start_py(read, chunk)
        return p

    @classmethod
    def fifo(cls, path: str, ring: RingBuffer, chunk: int = 1 << 18,
             frame: int = 2) -> "LivePump":
        p = cls()
        p.ring, p._frame = ring, frame
        lib = get_lib()
        if lib is not None and ring._lib is not None:
            p._lib = lib
            p._h = lib.live_pump_fifo(path.encode(), ring._h, chunk, frame)
            if not p._h:
                raise FileNotFoundError(path)
            return p
        fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        p._fifo_fd = fd
        seen = [False]

        def read(buf):
            import time as _t
            try:
                data = os.read(fd, len(buf))
            except BlockingIOError:
                _t.sleep(0.01)
                return -2
            if not data:
                if seen[0]:
                    return 0  # writer closed after data: EOS
                _t.sleep(0.01)
                return -2
            seen[0] = True
            buf[:len(data)] = data
            return len(data)
        p._start_py(read, chunk)
        return p

    # -- python-fallback machinery ------------------------------------------

    def _recv_stream(self, sock, buf) -> int:
        try:
            n = sock.recv_into(buf)
        except TimeoutError:
            return -2
        except OSError:
            return 0
        return n  # 0 = peer closed = EOS

    def _start_py(self, read_fn, chunk: int) -> None:
        import threading

        def run():
            # set_eos in a finally: if read_fn dies on an unexpected
            # OSError the consumer must see end-of-stream, not spin.
            try:
                buf = bytearray(chunk + self._frame)
                mv = memoryview(buf)
                rem = 0
                while not self._stop:
                    try:
                        got = read_fn(mv[rem:rem + chunk])
                    except OSError:
                        break
                    if got == -2:
                        continue
                    if got == 0:
                        break
                    have = rem + got
                    whole = (have // self._frame) * self._frame
                    if whole:
                        self._py_put(mv[:whole])
                    rem = have - whole
                    if rem:
                        mv[:rem] = mv[whole:have]
            finally:
                self.ring.set_eos()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _py_put(self, mv) -> None:
        n = len(mv)
        self._bytes_in += n
        data = np.frombuffer(mv, np.uint8)
        space = self.capacity_space()
        fit = n if n <= space else (space // self._frame) * self._frame
        if fit > 0:
            self.ring.put(data[:fit])
        if fit < n:
            self._bytes_dropped += n - fit

    def capacity_space(self) -> int:
        return self.ring.capacity - self.ring.available

    # -- common API ----------------------------------------------------------

    @property
    def port(self) -> int:
        """Bound port (listen/udp modes; resolves port=0 ephemeral binds)."""
        if self._h is not None:
            return int(self._lib.live_pump_port(self._h))
        s = self._listen_sock or self._sock
        return s.getsockname()[1] if s is not None else -1

    @property
    def bytes_in(self) -> int:
        if self._h is not None:
            return int(self._lib.live_pump_bytes_in(self._h))
        return self._bytes_in

    @property
    def bytes_dropped(self) -> int:
        """Overflow discarded because the ring was full — the reference's
        accounted-drop contract (src/portaudio.cc:129-155)."""
        if self._h is not None:
            return int(self._lib.live_pump_bytes_dropped(self._h))
        return self._bytes_dropped

    def stop(self) -> None:
        if self._h is not None:
            # The native stop joins the thread, then hands back the FINAL
            # counters so bytes_in / bytes_dropped stay readable (and
            # include the trailing put) after the pump is freed.
            fin = ctypes.c_int64(0)
            fdr = ctypes.c_int64(0)
            h, self._h = self._h, None
            self._lib.live_pump_stop(h, ctypes.byref(fin), ctypes.byref(fdr))
            self._bytes_in = int(fin.value)
            self._bytes_dropped = int(fdr.value)
        elif self._thread is not None:
            self._stop = True
            self._thread.join()
            self._thread = None
            for s in (self._sock, self._listen_sock):
                if s is not None:
                    s.close()
            if self._fifo_fd is not None:
                os.close(self._fifo_fd)
                self._fifo_fd = None
