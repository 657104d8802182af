// Native host runtime for libsdr_tpu.
//
// The reference's runtime core is C++: a mutex+condvar message queue driving
// one worker thread (reference: src/queue.cc), refcounted buffer pools and
// ring buffers (reference: src/buffer.hh), and per-source ingest threads
// (reference: src/node.cc:154-176 BlockingSource, src/rtlsource.cc:133-145).
// On an accelerator host the device does the DSP, so the native layer's job is the
// *feed path*: lock-free SPSC block framing between an ingest thread and the
// Python driver, and branch-free wire-format -> planar-float conversion
// (u8/s16 interleaved IQ -> separate re/im float32 planes, the layout the
// device pipeline consumes).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Sample-format converters (the AutoCast analog, reference: src/autocast.hh)
// ---------------------------------------------------------------------------

// rtl_sdr wire format: interleaved unsigned bytes, zero at 127.5.
void u8_iq_to_planar_f32(const uint8_t *src, int64_t n_pairs,
                         float *re, float *im) {
  const float scale = 1.0f / 128.0f;
  for (int64_t i = 0; i < n_pairs; ++i) {
    re[i] = ((float)src[2 * i] - 128.0f) * scale;
    im[i] = ((float)src[2 * i + 1] - 128.0f) * scale;
  }
}

void s16_iq_to_planar_f32(const int16_t *src, int64_t n_pairs,
                          float *re, float *im) {
  const float scale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n_pairs; ++i) {
    re[i] = (float)src[2 * i] * scale;
    im[i] = (float)src[2 * i + 1] * scale;
  }
}

void s16_to_f32(const int16_t *src, int64_t n, float *dst) {
  const float scale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) dst[i] = (float)src[i] * scale;
}

// u8 wire format straight to bfloat16 planes: HALF the host->device and
// HBM traffic of f32, and LOSSLESS for 8-bit sources (bf16's 8 significand
// bits hold every value of (u8 - 128)/128 exactly).  bf16 is the upper 16
// bits of the f32 representation; all these values are exact in bf16, so
// truncation == round-to-nearest here and a 256-entry LUT suffices.
void u8_iq_to_planar_bf16(const uint8_t *src, int64_t n_pairs,
                          uint16_t *re, uint16_t *im) {
  uint16_t lut[256];
  const float scale = 1.0f / 128.0f;
  for (int v = 0; v < 256; ++v) {
    float f = ((float)v - 128.0f) * scale;
    uint32_t bits;
    __builtin_memcpy(&bits, &f, 4);
    lut[v] = (uint16_t)(bits >> 16);
  }
  for (int64_t i = 0; i < n_pairs; ++i) {
    re[i] = lut[src[2 * i]];
    im[i] = lut[src[2 * i + 1]];
  }
}

void f32_planar_to_s16_interleaved(const float *re, const float *im,
                                   int64_t n_pairs, int16_t *dst) {
  for (int64_t i = 0; i < n_pairs; ++i) {
    float r = re[i] * 32767.0f, q = im[i] * 32767.0f;
    if (r > 32767.f) r = 32767.f;
    if (r < -32768.f) r = -32768.f;
    if (q > 32767.f) q = 32767.f;
    if (q < -32768.f) q = -32768.f;
    dst[2 * i] = (int16_t)r;
    dst[2 * i + 1] = (int16_t)q;
  }
}

// ---------------------------------------------------------------------------
// Lock-free SPSC byte ring (reference: src/buffer.hh:356-541 RawRingBuffer,
// made thread-safe; the reference's refcount is a bare int and relies on the
// single queue thread — here acquire/release atomics carry the handoff).
// ---------------------------------------------------------------------------

struct Ring {
  uint8_t *data;
  int64_t capacity;                 // bytes, power-of-two not required
  std::atomic<int64_t> head;        // write position (producer)
  std::atomic<int64_t> tail;        // read position (consumer)
  std::atomic<int> eos;             // producer signaled end-of-stream
};

Ring *ring_create(int64_t capacity) {
  Ring *r = new Ring();
  r->data = (uint8_t *)malloc(capacity);
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  r->eos.store(0);
  return r;
}

void ring_destroy(Ring *r) {
  if (!r) return;
  free(r->data);
  delete r;
}

int64_t ring_available(Ring *r) {  // bytes readable
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_relaxed);
}

int64_t ring_space(Ring *r) {  // bytes writable
  return r->capacity - (r->head.load(std::memory_order_relaxed) -
                        r->tail.load(std::memory_order_acquire));
}

// Producer: copy n bytes in (returns n, or 0 if not enough space).
int64_t ring_put(Ring *r, const uint8_t *src, int64_t n) {
  if (ring_space(r) < n) return 0;
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t pos = head % r->capacity;
  int64_t first = (pos + n <= r->capacity) ? n : (r->capacity - pos);
  memcpy(r->data + pos, src, first);
  if (first < n) memcpy(r->data, src + first, n - first);
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Consumer: copy exactly n bytes out (returns n, or 0 if not enough data).
int64_t ring_take(Ring *r, uint8_t *dst, int64_t n) {
  if (ring_available(r) < n) return 0;
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t pos = tail % r->capacity;
  int64_t first = (pos + n <= r->capacity) ? n : (r->capacity - pos);
  memcpy(dst, r->data + pos, first);
  if (first < n) memcpy(dst + first, r->data, n - first);
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

int ring_eos(Ring *r) { return r->eos.load(std::memory_order_acquire); }
void ring_set_eos(Ring *r) { r->eos.store(1, std::memory_order_release); }

// ---------------------------------------------------------------------------
// File pump: ingest thread streaming a capture file into a ring — the
// analog of BlockingSource's per-source thread (reference: src/node.cc:154-176)
// and RTLSource's driver thread (reference: src/rtlsource.cc:133-145).
// ---------------------------------------------------------------------------

struct Pump {
  Ring *ring;
  FILE *f;
  int64_t chunk;
  std::atomic<int> stop;
  std::thread thread;
};

static void pump_main(Pump *p) {
  uint8_t *buf = (uint8_t *)malloc(p->chunk);
  while (!p->stop.load(std::memory_order_relaxed)) {
    size_t got = fread(buf, 1, (size_t)p->chunk, p->f);
    if (got == 0) break;  // EOF
    int64_t off = 0;
    while (off < (int64_t)got && !p->stop.load(std::memory_order_relaxed)) {
      int64_t put = ring_put(p->ring, buf + off, (int64_t)got - off);
      if (put == 0) {
        std::this_thread::yield();  // backpressure: ring full
      } else {
        off += put;
      }
    }
  }
  ring_set_eos(p->ring);
  free(buf);
}

Pump *pump_start(const char *path, Ring *ring, int64_t chunk) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  Pump *p = new Pump();
  p->ring = ring;
  p->f = f;
  p->chunk = chunk;
  p->stop.store(0);
  p->thread = std::thread(pump_main, p);
  return p;
}

void pump_stop(Pump *p) {
  if (!p) return;
  p->stop.store(1);
  p->thread.join();
  fclose(p->f);
  delete p;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Live pump: socket/FIFO ingest threads feeding the same SPSC ring — the
// production analog of the reference's *live* driver-thread sources
// (reference: src/rtlsource.cc:133-145 rtl_sdr async callback thread,
// src/portaudio.cc:129-155 PortAudio callback).  Live sources cannot block
// the wire, so a full ring DISCARDS the overflow and accounts it — the
// reference's back-pressure-by-drop contract (reference:
// src/firfilter.hh:219-226 "RX buffer overflow", src/portaudio.cc drop
// accounting).  Drops happen only in whole sample frames so the
// interleaved-IQ alignment downstream never shifts.
// ---------------------------------------------------------------------------

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

struct LivePump {
  Ring *ring;
  int fd;                 // data fd (socket or fifo), -1 until connected
  int listen_fd;          // tcp-listen mode only, else -1
  int is_udp;
  int is_fifo;
  int64_t chunk;
  int64_t frame;          // drop granularity in bytes (e.g. 2 for u8 IQ)
  std::atomic<int64_t> bytes_in;       // everything read off the wire
  std::atomic<int64_t> bytes_dropped;  // overflow discarded (ring full)
  std::atomic<int> stop;
  std::thread thread;
};

// Frame-aligned put-or-drop: insert the largest frame multiple that fits,
// discard (and count) the rest.  `n` is always a frame multiple (the reader
// carries any sub-frame remainder between reads), so alignment is global.
static void live_put(LivePump *p, const uint8_t *buf, int64_t n) {
  p->bytes_in.fetch_add(n, std::memory_order_relaxed);
  int64_t space = ring_space(p->ring);
  int64_t fit = (n <= space) ? n : (space / p->frame) * p->frame;
  if (fit > 0) ring_put(p->ring, buf, fit);
  if (fit < n)
    p->bytes_dropped.fetch_add(n - fit, std::memory_order_relaxed);
}

static void live_pump_main(LivePump *p) {
  uint8_t *buf = (uint8_t *)malloc(p->chunk + p->frame);
  int64_t rem = 0;  // sub-frame remainder carried between reads
  bool seen_data = false;
  while (!p->stop.load(std::memory_order_relaxed)) {
    if (p->fd < 0) {  // tcp-listen: wait for the one client
      struct pollfd pf = {p->listen_fd, POLLIN, 0};
      if (poll(&pf, 1, 100) <= 0) continue;
      int c = accept(p->listen_fd, nullptr, nullptr);
      if (c < 0) continue;
      p->fd = c;
    }
    struct pollfd pf = {p->fd, POLLIN, 0};
    int pr = poll(&pf, 1, 100);
    if (pr < 0) break;
    if (pr == 0) continue;
    ssize_t got;
    if (p->is_udp) {
      got = recv(p->fd, buf + rem, (size_t)p->chunk, 0);
      if (got < 0) continue;           // transient (e.g. ECONNREFUSED tick)
      if (got == 0) continue;          // empty datagram
    } else {
      got = read(p->fd, buf + rem, (size_t)p->chunk);
      if (got < 0) {
        if (errno == EAGAIN || errno == EINTR) continue;
        break;                          // hard error: end of stream
      }
      if (got == 0) {
        // TCP: peer closed.  FIFO opened O_NONBLOCK reads EOF while no
        // writer exists yet — only treat it as end after data flowed.
        if (!p->is_fifo || seen_data) break;
        struct timespec ts = {0, 10 * 1000 * 1000};
        nanosleep(&ts, nullptr);
        continue;
      }
    }
    seen_data = true;
    int64_t have = rem + (int64_t)got;
    int64_t whole = (have / p->frame) * p->frame;
    if (whole > 0) live_put(p, buf, whole);
    rem = have - whole;
    if (rem > 0) memmove(buf, buf + whole, (size_t)rem);
  }
  if (rem > 0) live_put(p, buf, rem);  // trailing partial frame (stream cut)
  ring_set_eos(p->ring);
  free(buf);
}

static LivePump *live_pump_new(Ring *ring, int64_t chunk, int64_t frame) {
  LivePump *p = new LivePump();
  p->ring = ring;
  p->fd = -1;
  p->listen_fd = -1;
  p->is_udp = 0;
  p->is_fifo = 0;
  p->chunk = chunk > 0 ? chunk : (1 << 18);
  p->frame = frame > 0 ? frame : 1;
  p->bytes_in.store(0);
  p->bytes_dropped.store(0);
  p->stop.store(0);
  return p;
}

// TCP client (the rtl_tcp topology: the SDR host runs the server, we
// connect and read the sample stream).  Resolves hostnames via
// getaddrinfo (IPv4 and IPv6); blocks up to timeout_ms per address for
// the connect.  Returns nullptr on failure.
LivePump *live_pump_tcp_connect(const char *host, int port, Ring *ring,
                                int64_t chunk, int64_t frame,
                                int timeout_ms) {
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", port);
  struct addrinfo hints;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo *res = nullptr;
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) return nullptr;
  int fd = -1;
  for (struct addrinfo *ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    fcntl(fd, F_SETFL, O_NONBLOCK);
    int rc = connect(fd, ai->ai_addr, ai->ai_addrlen);
    if (rc == 0) break;
    if (rc < 0 && errno == EINPROGRESS) {
      struct pollfd pf = {fd, POLLOUT, 0};
      if (poll(&pf, 1, timeout_ms > 0 ? timeout_ms : 5000) > 0) {
        int err = 0; socklen_t len = sizeof(err);
        getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
        if (err == 0) break;
      }
    }
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return nullptr;
  LivePump *p = live_pump_new(ring, chunk, frame);
  p->fd = fd;
  p->thread = std::thread(live_pump_main, p);
  return p;
}

// TCP server accepting ONE client (raw-wire push topology).  port 0 picks
// an ephemeral port; read it back with live_pump_port().
LivePump *live_pump_tcp_listen(int port, Ring *ring, int64_t chunk,
                               int64_t frame) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in a;
  memset(&a, 0, sizeof(a));
  a.sin_family = AF_INET;
  a.sin_addr.s_addr = htonl(INADDR_ANY);
  a.sin_port = htons((uint16_t)port);
  if (bind(fd, (struct sockaddr *)&a, sizeof(a)) < 0 || listen(fd, 1) < 0) {
    close(fd);
    return nullptr;
  }
  LivePump *p = live_pump_new(ring, chunk, frame);
  p->listen_fd = fd;
  p->thread = std::thread(live_pump_main, p);
  return p;
}

// UDP datagram sink (one datagram = one wire chunk; a full ring drops the
// frame-aligned tail exactly like the other modes).
LivePump *live_pump_udp(int port, Ring *ring, int64_t chunk, int64_t frame) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  int rcvbuf = 4 << 20;  // absorb wire bursts before the ring even sees them
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  struct sockaddr_in a;
  memset(&a, 0, sizeof(a));
  a.sin_family = AF_INET;
  a.sin_addr.s_addr = htonl(INADDR_ANY);
  a.sin_port = htons((uint16_t)port);
  if (bind(fd, (struct sockaddr *)&a, sizeof(a)) < 0) { close(fd); return nullptr; }
  LivePump *p = live_pump_new(ring, chunk, frame);
  p->fd = fd;
  p->is_udp = 1;
  p->thread = std::thread(live_pump_main, p);
  return p;
}

// Named pipe / FIFO reader (local live wire with no network stack).
LivePump *live_pump_fifo(const char *path, Ring *ring, int64_t chunk,
                         int64_t frame) {
  int fd = open(path, O_RDONLY | O_NONBLOCK);
  if (fd < 0) return nullptr;
  LivePump *p = live_pump_new(ring, chunk, frame);
  p->fd = fd;
  p->is_fifo = 1;
  p->thread = std::thread(live_pump_main, p);
  return p;
}

int live_pump_port(LivePump *p) {  // bound port (listen/udp modes)
  int fd = p->listen_fd >= 0 ? p->listen_fd : p->fd;
  struct sockaddr_in a;
  socklen_t len = sizeof(a);
  if (getsockname(fd, (struct sockaddr *)&a, &len) < 0) return -1;
  return (int)ntohs(a.sin_port);
}

int64_t live_pump_bytes_in(LivePump *p) {
  return p->bytes_in.load(std::memory_order_relaxed);
}

int64_t live_pump_bytes_dropped(LivePump *p) {
  return p->bytes_dropped.load(std::memory_order_relaxed);
}

// Joins the ingest thread, then (optionally) reports the FINAL counters —
// reading them after the join means the trailing put is included.
void live_pump_stop(LivePump *p, int64_t *final_in, int64_t *final_dropped) {
  if (!p) return;
  p->stop.store(1);
  p->thread.join();
  if (final_in) *final_in = p->bytes_in.load();
  if (final_dropped) *final_dropped = p->bytes_dropped.load();
  if (p->fd >= 0) close(p->fd);
  if (p->listen_fd >= 0) close(p->listen_fd);
  delete p;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// POCSAG batch decoder (the host FSM of decode/pocsag.py, in C++: at fleet
// scale — hundreds of channels — the Python per-bit loop dominates the whole
// receive bank; this runs the identical WAIT -> RECEIVE -> CHECK_CONTINUE
// machine (reference behavior: src/pocsag.cc:40-95) with BCH(31,21)
// syndrome-table repair (same outputs as the reference brute force,
// src/bch31_21.cc:123-212) at ~10 ns/bit.
// ---------------------------------------------------------------------------

#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kSync = 0x7CD215D8u;
constexpr uint32_t kIdle = 0x7A89C197u;

inline int parity32(uint32_t x) {
  x ^= x >> 16; x ^= x >> 8; x ^= x >> 4; x ^= x >> 2; x ^= x >> 1;
  return (int)(x & 1);
}

uint32_t bch_syndrome(uint32_t word) {
  uint32_t shreg = word >> 1;  // drop parity bit
  uint32_t mask = 1u << 30;
  uint32_t coeff = 03551u << 20;
  for (int i = 0; i < 21; ++i) {
    if (shreg & mask) shreg ^= coeff;
    mask >>= 1;
    coeff >>= 1;
  }
  if (parity32(word)) shreg |= 1u << 10;
  return shreg;
}

const std::unordered_map<uint32_t, uint32_t> &bch_table() {
  static const std::unordered_map<uint32_t, uint32_t> *table = [] {
    auto *t = new std::unordered_map<uint32_t, uint32_t>();
    for (int i = 0; i < 32; ++i)
      t->emplace(bch_syndrome(1u << i), 1u << i);
    for (int i = 0; i < 32; ++i) {
      uint32_t si = bch_syndrome(1u << i);
      for (int j = i + 1; j < 32; ++j)
        t->emplace(si ^ bch_syndrome(1u << j), (1u << i) | (1u << j));
    }
    return t;
  }();
  return *table;
}

// returns 0 = ok/repaired, 1 = unrepairable (same contract as bch.py).
int bch_repair(uint32_t word, uint32_t *out) {
  uint32_t s = bch_syndrome(word);
  if (s == 0) { *out = word; return 0; }
  const auto &t = bch_table();
  auto it = t.find(s);
  if (it == t.end()) { *out = word; return 1; }
  *out = word ^ it->second;
  return 0;
}

}  // namespace

extern "C" {

// One-shot decode of a dense bit vector.  Per message, meta gets
// [address, function, payload_bytes, payload_bits]; payload bytes are
// appended to `payload`.  Returns the number of messages (clamped to caps).
// Semantics identical to decode/pocsag.py POCSAGDecoder.process on a fresh
// decoder (no end-of-stream flush of a partial message).
int64_t pocsag_decode(const uint8_t *bits, int64_t n, int64_t *meta,
                      uint8_t *payload, int64_t cap_msgs,
                      int64_t cap_payload) {
  uint64_t sh = 0;
  int state = 0, bitcount = 0, slot = 0;
  bool have_msg = false;
  int64_t addr = 0, func = 0, plbits = 0;
  std::vector<uint8_t> pl;
  int64_t n_msgs = 0, pl_off = 0;

  auto finish = [&]() {
    if (!have_msg) return;
    if (n_msgs < cap_msgs &&
        pl_off + (int64_t)pl.size() <= cap_payload) {
      meta[n_msgs * 4 + 0] = addr;
      meta[n_msgs * 4 + 1] = func;
      meta[n_msgs * 4 + 2] = (int64_t)pl.size();
      meta[n_msgs * 4 + 3] = plbits;
      if (!pl.empty()) memcpy(payload + pl_off, pl.data(), pl.size());
      pl_off += (int64_t)pl.size();
      n_msgs++;
    }
    have_msg = false;
    pl.clear();
    plbits = 0;
  };
  auto add_payload = [&](uint32_t word) {
    for (int i = 19; i >= 0; --i) {
      if (plbits % 8 == 0) pl.push_back(0);
      int bit = (int)((word >> (i + 11)) & 1u);
      pl.back() = (uint8_t)(((pl.back() << 1) | bit) & 0xFF);
      plbits++;
    }
  };
  auto process_word = [&](uint32_t word) {
    if (word == kIdle) {
      finish();
    } else if ((word & 0x80000000u) == 0) {  // address word
      finish();
      addr = (int64_t)(((word >> 13) & 0x3FFFFu) << 3) + slot;
      func = (int64_t)((word >> 11) & 3u);
      have_msg = true;
    } else if (have_msg) {
      add_payload(word);
    }
  };

  for (int64_t k = 0; k < n; ++k) {
    sh = (sh << 1) | (uint64_t)(bits[k] & 1);
    if (state == 0) {  // WAIT
      uint32_t w;
      if (bch_repair((uint32_t)sh, &w) == 0 && w == kSync) {
        have_msg = false;  // matches Python: partial message discarded
        pl.clear();
        plbits = 0;
        state = 1;
        bitcount = 0;
        slot = 0;
      }
    } else if (state == 1) {  // RECEIVE
      if (++bitcount == 64) {
        bitcount = 0;
        uint32_t w;
        if (bch_repair((uint32_t)(sh >> 32), &w) == 0) process_word(w);
        if (bch_repair((uint32_t)sh, &w) == 0) process_word(w);
        if (++slot == 8) {
          state = 2;
          bitcount = 0;
        }
      }
    } else {  // CHECK_CONTINUE
      if (++bitcount == 32) {
        uint32_t w;
        if (bch_repair((uint32_t)sh, &w) == 0 && w == kSync) {
          state = 1;
          slot = 0;
          bitcount = 0;
        } else {
          finish();
          state = 0;
        }
      }
    }
  }
  return n_msgs;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// AX.25 / HDLC batch deframer (the host FSM of decode/ax25.py in C++, for
// fleet-scale channel counts; reference behavior: src/ax25.cc:100-161).
// Emits raw CRC-valid frames (FCS stripped); address/payload parsing stays
// in Python.
// ---------------------------------------------------------------------------

namespace {

uint16_t crc_ccitt_tab(int i) {
  static uint16_t table[256];
  static bool init = false;
  if (!init) {
    for (int byte = 0; byte < 256; ++byte) {
      uint16_t crc = (uint16_t)byte;
      for (int k = 0; k < 8; ++k)
        crc = (crc & 1) ? (uint16_t)((crc >> 1) ^ 0x8408) : (uint16_t)(crc >> 1);
      table[byte] = crc;
    }
    init = true;
  }
  return table[i];
}

bool crc_ok(const uint8_t *frame, int64_t n) {
  uint16_t crc = 0xFFFF;
  for (int64_t i = 0; i < n; ++i)
    crc = (uint16_t)((crc >> 8) ^ crc_ccitt_tab((crc ^ frame[i]) & 0xFF));
  return crc == 0xF0B8;  // HDLC "good" residual (reference: src/ax25.cc:45-52)
}

}  // namespace

extern "C" {

// One-shot deframe of a dense bit vector.  Per frame, meta gets
// [byte_offset_into_frames, length]; frame bytes (FCS stripped) are
// appended to `frames`.  Returns the frame count (clamped to caps).
// Semantics identical to decode/ax25.py AX25Decoder.process on a fresh
// decoder.
int64_t ax25_decode(const uint8_t *bits, int64_t n, int64_t *meta,
                    uint8_t *frames, int64_t cap_frames,
                    int64_t cap_bytes) {
  constexpr int kMaxFrame = 512;  // reference: src/ax25.cc:144
  uint32_t bitstream = 0;
  uint32_t bitbuffer = 0x80;
  int state = 0;
  std::vector<uint8_t> rx;
  rx.reserve(kMaxFrame);
  int64_t n_frames = 0, off = 0;

  for (int64_t k = 0; k < n; ++k) {
    bitstream = ((bitstream << 1) | (uint32_t)(bits[k] & 1));
    if ((bitstream & 0xFF) == 0x7E) {  // flag
      if (state == 1 && (int64_t)rx.size() > 2 &&
          crc_ok(rx.data(), (int64_t)rx.size())) {
        int64_t len = (int64_t)rx.size() - 2;  // strip FCS
        if (n_frames < cap_frames && off + len <= cap_bytes) {
          meta[n_frames * 2 + 0] = off;
          meta[n_frames * 2 + 1] = len;
          memcpy(frames + off, rx.data(), (size_t)len);
          off += len;
          n_frames++;
        }
      }
      state = 1;
      rx.clear();
      bitbuffer = 0x80;
      continue;
    }
    if ((bitstream & 0x7F) == 0x7F) {  // abort: seven ones
      state = 0;
      continue;
    }
    if (!state) continue;
    if ((bitstream & 0x3F) == 0x3E) continue;  // stuffed bit
    bitbuffer |= (bitstream & 0x01u) << 8;
    if (bitbuffer & 0x01u) {  // 8 bits assembled
      if ((int64_t)rx.size() >= kMaxFrame) {
        state = 0;
        continue;
      }
      rx.push_back((uint8_t)((bitbuffer >> 1) & 0xFF));
      bitbuffer = 0x80;
      continue;
    }
    bitbuffer >>= 1;
  }
  return n_frames;
}

}  // extern "C"
