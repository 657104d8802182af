"""Digital decode stack tests: BCH(31,21), POCSAG, AX.25/APRS, Baudot,
Varicode, bit-sync PLL, FSK detector, BPSK31 — end-to-end bit-exact checks
(the fixtures the reference lacks; SURVEY.md section 4)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from libsdr_tpu import StreamSpec
from libsdr_tpu.core import cplx
from libsdr_tpu.core.ragged import compact
from libsdr_tpu.decode import (AX25Decoder, BaudotDecoder, POCSAGDecoder,
                               VaricodeDecoder, ax25_frame_bits,
                               baudot_encode_bits, bch_encode, bch_repair,
                               bch_syndrome, parse_aprs, pocsag_encode_batch,
                               varicode_encode_bits)
from libsdr_tpu.decode.bch import _error_table
from libsdr_tpu.ops.bitsync import BitStream
from libsdr_tpu.ops.fsk import ASKDetector, FSKDetector
from libsdr_tpu.ops.psk31 import BPSK31


# ------------------------------------------------------------------ BCH ----

def test_bch_encode_valid():
    rng = np.random.default_rng(7)
    for _ in range(50):
        data = int(rng.integers(0, 1 << 21))
        word = bch_encode(data)
        assert bch_syndrome(word) == 0
        assert (word >> 11) == data


def test_bch_repairs_up_to_two_errors():
    rng = np.random.default_rng(8)
    for _ in range(30):
        data = int(rng.integers(0, 1 << 21))
        word = bch_encode(data)
        # single-bit errors: all positions
        for i in range(32):
            st, fixed = bch_repair(word ^ (1 << i))
            assert st == 0 and fixed == word, f"1-bit repair failed at {i}"
        # a sample of 2-bit errors
        for i, j in [(0, 31), (5, 17), (30, 31), (2, 3), (11, 21)]:
            st, fixed = bch_repair(word ^ (1 << i) ^ (1 << j))
            assert st == 0 and fixed == word, f"2-bit repair failed {i},{j}"


def test_bch_error_syndromes_unique():
    """All 1- and 2-bit error syndromes are distinct -> the table lookup is
    exactly equivalent to the reference's brute force
    (reference: src/bch31_21.cc:123-212)."""
    seen = {}
    for i in range(32):
        s = bch_syndrome(1 << i)
        assert s not in seen
        seen[s] = (i,)
    for i, j in itertools.combinations(range(32), 2):
        s = bch_syndrome(1 << i) ^ bch_syndrome(1 << j)
        assert s != 0 and s not in seen, (i, j)
        seen[s] = (i, j)
    assert len(_error_table()) == 32 + 496


def test_bch_detects_unrepairable():
    word = bch_encode(0x155555)
    st, _ = bch_repair(word ^ 0b10101010101)  # >2 bit corruption
    # Either repaired to *some* codeword or flagged; must not return the
    # original broken word with st == 0 and nonzero syndrome.
    if st == 0:
        _, w = bch_repair(word ^ 0b10101010101)
        assert bch_syndrome(w) == 0


# --------------------------------------------------------------- POCSAG ----

def test_pocsag_roundtrip_text():
    bits = pocsag_encode_batch(address=0x12345, function=2, text="HELLO WORLD")
    dec = POCSAGDecoder()
    msgs = dec.process(bits)
    assert len(msgs) == 1
    m = msgs[0]
    assert m.address == 0x12345
    assert m.function == 2
    assert m.as_text().startswith("HELLO WORLD")
    # Faithful reference quirk: the numeric heuristic's +5/digit bonus for
    # short messages (src/pocsag.cc:248-249) beats the text weight for an
    # 11-char page, so the reference would print this one as numeric.
    assert m.estimate_text() == 11
    assert m.estimate_numeric() > m.estimate_text()


def test_pocsag_bit_errors_repaired():
    bits = pocsag_encode_batch(address=777, function=1, text="PAGE 42")
    # Flip 2 bits in each 32-bit word region after the preamble+sync.
    bad = bits.copy()
    start = 600 + 32  # preamble rounded up to 600? locate sync: preamble=600
    rng = np.random.default_rng(5)
    for w in range(4):
        base = 600 + 32 + 32 * w
        for k in rng.choice(32, size=2, replace=False):
            bad[base + k] ^= 1
    msgs = POCSAGDecoder().process(bad)
    assert len(msgs) == 1 and msgs[0].as_text().startswith("PAGE 42")


def test_pocsag_multibatch_long_message():
    text = "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789 " * 2
    bits = pocsag_encode_batch(address=8, function=0, text=text)
    msgs = POCSAGDecoder().process(bits)
    assert len(msgs) == 1
    assert msgs[0].as_text().startswith(text.rstrip())


# ----------------------------------------------------------------- AX25 ----

def test_ax25_roundtrip():
    info = b"!4903.50N/07201.75W-Test 001234"
    payload = bytes([0x03, 0xF0]) + info
    bits = ax25_frame_bits("N0CALL", "APRS", info, via=["WIDE1"])
    dec = AX25Decoder()
    msgs = dec.process(bits)
    assert len(msgs) == 1
    m = msgs[0]
    assert m.frm.call == "N0CALL" and m.to.call == "APRS"
    assert [v.call for v in m.via] == ["WIDE1"]
    assert m.payload == payload


def test_ax25_rejects_corrupt_crc():
    bits = ax25_frame_bits("AB1CDE", "CQ", b"hello")
    bits[40] ^= 1  # corrupt one payload bit
    assert POCSAGDecoder  # silence lint
    assert AX25Decoder().process(bits) == []


def test_ax25_stuffing_roundtrip():
    # 0xFF bytes force bit stuffing
    info = bytes([0xFF] * 8) + b"end"
    payload = bytes([0x03, 0xF0]) + info
    bits = ax25_frame_bits("XX9XX", "YY8YY", info)
    msgs = AX25Decoder().process(bits)
    assert len(msgs) == 1 and msgs[0].payload == payload


# ----------------------------------------------------------------- APRS ----

def test_aprs_position_parse():
    bits = ax25_frame_bits("N0CALL", "APRS", b"!4903.50N/07201.75W-Test comment")
    m = AX25Decoder().process(bits)[0]
    a = parse_aprs(m)
    assert a is not None and a.has_location
    assert abs(a.latitude - (49 + 3.50 / 60)) < 1e-6
    assert abs(a.longitude - (-(72 + 1.75 / 60))) < 1e-6
    assert a.symbol == "HOUSE"
    assert a.comment == "Test comment"


def test_aprs_timestamped():
    bits = ax25_frame_bits("N0CALL", "APRS", b"@092345z4903.50N/07201.75W>comment")
    m = AX25Decoder().process(bits)[0]
    a = parse_aprs(m)
    assert a.has_time and a.time.day == 9 and a.time.hour == 23
    assert a.has_location and a.symbol == "CAR"


def test_aprs_rejects_non_ui():
    bits = ax25_frame_bits("N0CALL", "APRS", b"!4903.50N/07201.75W-", ctrl=0x13)
    m = AX25Decoder().process(bits)[0]
    assert parse_aprs(m) is None


# --------------------------------------------------------------- Baudot ----

def test_baudot_roundtrip():
    for stop in ("1", "1.5", "2"):
        hb = baudot_encode_bits("HELLO 123 WORLD", stop_bits=stop)
        dec = BaudotDecoder(stop_bits=stop)
        out = dec.process(hb)
        assert out == "HELLO 123 WORLD", (stop, out)


# ------------------------------------------------------------- Varicode ----

def test_varicode_roundtrip():
    text = "Hello PSK31 World 73!"
    bits = varicode_encode_bits(text)
    assert VaricodeDecoder().process(bits) == text


# ------------------------------------------------------- BitStream PLL -----

def _upsample_bits(bits, spb, jitter=0.0, rng=None):
    """NRZ upsample bit vector to symbols at spb samples/bit."""
    n = int(round(len(bits) * spb))
    t = np.arange(n) / spb
    if jitter and rng is not None:
        t = t + rng.normal(0, jitter, n) / spb
    idx = np.clip(t.astype(np.int64), 0, len(bits) - 1)
    return np.asarray(bits)[idx].astype(np.uint8)


def _run_ragged(proc, spec, x):
    proc.bind(spec)
    carry = proc.init_carry()
    outs_d, outs_v = [], []
    bs = spec.block_size
    for i in range(x.shape[-1] // bs):
        carry, y = proc.apply(carry, cplx.as_block(x[..., i * bs:(i + 1) * bs]))
        outs_d.append(np.asarray(y.data))
        outs_v.append(np.asarray(y.valid))
    from libsdr_tpu.core.ragged import Ragged
    return Ragged(np.concatenate(outs_d, -1), np.concatenate(outs_v, -1))


def test_bitstream_normal_mode(rng):
    fs, baud = 22050, 1200
    payload = rng.integers(0, 2, 300).astype(np.uint8)
    bits_tx = np.concatenate([np.array([1, 0] * 20, np.uint8), payload])
    sym = _upsample_bits(bits_tx, fs / baud)
    pad = (-len(sym)) % 512
    sym = np.concatenate([sym, np.zeros(pad, np.uint8)])
    bs = BitStream(baud, mode="normal")
    spec = StreamSpec(jnp.uint8, fs, 512)
    out = _run_ragged(bs, spec, sym)
    got = compact(out)
    s = "".join(map(str, got))
    want = "".join(map(str, payload))
    assert want in s, "payload bits not recovered by PLL"


def test_bitstream_transition_mode(rng):
    fs, baud = 22050, 1200
    payload = rng.integers(0, 2, 200).astype(np.uint8)
    # NRZI encode: transition -> 0, none -> 1
    line = [0]
    for b in payload:
        line.append(line[-1] if b else 1 - line[-1])
    line = np.asarray(line[1:], np.uint8)
    bits_tx = np.concatenate([np.array([1, 0] * 20, np.uint8), line])
    sym = _upsample_bits(bits_tx, fs / baud)
    pad = (-len(sym)) % 512
    sym = np.concatenate([sym, np.zeros(pad, np.uint8)])
    bs = BitStream(baud, mode="transition")
    out = _run_ragged(bs, StreamSpec(jnp.uint8, fs, 512), sym)
    got = "".join(map(str, compact(out)))
    want = "".join(map(str, payload))
    assert want in got


# --------------------------------------------------------- FSKDetector -----

def test_fsk_detector_and_bitstream(rng):
    """Full RTTY-style front end: FSK tones -> symbols -> PLL -> bits."""
    from libsdr_tpu.ops import siggen
    fs, baud = 12000, 300
    f_mark, f_space = 1200.0, 2200.0
    payload = rng.integers(0, 2, 120).astype(np.uint8)
    bits_tx = np.concatenate([np.ones(8, np.uint8), payload])
    audio = siggen.fsk_modulate(fs, bits_tx, baud, f_mark, f_space).real
    audio = audio.astype(np.float32)
    pad = (-len(audio)) % 600
    audio = np.concatenate([audio, np.zeros(pad, np.float32)])

    det = FSKDetector(baud, f_mark, f_space)
    spec = StreamSpec(jnp.float32, fs, 600)
    det.bind(spec)
    carry = det.init_carry()
    syms = []
    for i in range(len(audio) // 600):
        carry, y = det.apply(carry, jnp.asarray(audio[i * 600:(i + 1) * 600]))
        syms.append(np.asarray(y))
    syms = np.concatenate(syms)

    bs = BitStream(baud, mode="normal")
    out = _run_ragged(bs, det.out_spec, syms)
    got = "".join(map(str, compact(out)))
    # The first ~10 bits fall in the correlator-fill + PLL-acquisition
    # transient (the reference behaves the same; real links carry a longer
    # preamble).  After acquisition the stream must be recovered exactly.
    want = "".join(map(str, payload[12:]))
    assert want in got


def test_fsk_detector_matmul_path_matches_conv(rng):
    """128-aligned blocks take the banded-matmul sliding sum (GEMM,
    ops/fsk.py::_window_mat); unaligned blocks take the boxcar conv.  Both
    compute the same L-term direct sums in float32, so symbols agree except
    at near-zero discriminator ties (different accumulation order), and the
    matmul path is bit-invariant to the block split.  Covers L > frame
    (RTTY: L=264 needs 3 context frames) and L < frame (AFSK: L=20)."""
    for fs, baud, fm_, fsp in ((24000, 90.90, 930.0, 1100.0),
                               (24000, 1200.0, 1200.0, 2200.0)):
        x = rng.normal(size=(3, 4096)).astype(np.float32)

        def run(blk):
            det = FSKDetector(baud, fm_, fsp)
            det.bind(StreamSpec(jnp.float32, fs, blk, channels=(3,)))
            c = det.init_carry()
            outs = []
            for i in range(4096 // blk):
                c, y = det.apply(
                    c, jnp.asarray(x[:, i * blk:(i + 1) * blk]))
                outs.append(np.asarray(y))
            return np.concatenate(outs, axis=-1)

        a = run(1024)                         # matmul path
        np.testing.assert_array_equal(a, run(512))   # blocking invariance
        # Conv fallback (block % 128 != 0) on the same stream: both paths
        # compute L-term direct sums in f32, so symbols agree except at
        # near-zero ties.
        conv = run(256 + 64)                  # 320 % 128 != 0, divides 4096
        assert (a[:, :3840] == conv[:, :3840]).mean() > 0.995, baud
        # Exact numpy direct-sum oracle (zero tail, the op's init state).
        L = int(fs / baud)
        i_ = np.arange(L)
        reps = -(-4096 // L) + 1
        tm = np.tile(np.exp(2j * np.pi * fm_ * i_ / fs), reps)[:4096]
        ts = np.tile(np.exp(2j * np.pi * fsp * i_ / fs), reps)[:4096]

        def sums(u):
            full = np.concatenate(
                [np.zeros((3, L - 1), np.complex128), u], axis=-1)
            cs = np.cumsum(full, axis=-1)
            return cs[:, L - 1:] - np.concatenate(
                [np.zeros((3, 1), np.complex128), cs[:, :-L]], axis=-1)

        disc = (np.abs(sums(tm * x)) ** 2 - np.abs(sums(ts * x)) ** 2)
        want = (disc > 0).astype(np.uint8)
        assert (a == want).mean() > 0.995, baud


def test_sliding_sum_band_matrix_edges(rng):
    """sliding_sum's band-matrix construction at the frame boundaries:
    L = 127/128/129 (npv 1->2 transition) and 255/256/257 (npv 2->3),
    plus tiny L, against an exact float64 cumsum oracle, including the
    cross-block tail handoff."""
    from libsdr_tpu.core.cplx import Complex as C
    from libsdr_tpu.ops.fsk import sliding_sum

    # 640 > b: the window spans more than a whole block (RTTY's L=264 on
    # small bind blocks), so the carried tail exceeds the block length.
    for L in (2, 3, 127, 128, 129, 255, 256, 257, 384, 640):
        b = 512
        u = rng.normal(size=(2, 2 * b)).astype(np.float32)
        tail = np.zeros((2, L - 1), np.float32)
        outs = []
        t = C(jnp.asarray(tail), jnp.asarray(tail))
        for i in range(2):
            blk = C(jnp.asarray(u[:, i * b:(i + 1) * b]),
                    jnp.asarray(u[:, i * b:(i + 1) * b]))
            s, t = sliding_sum(t, blk, L)
            outs.append(np.asarray(s.re))
        got = np.concatenate(outs, axis=-1)
        full = np.concatenate([np.zeros((2, L - 1)), u.astype(np.float64)],
                              axis=-1)
        cs = np.cumsum(full, axis=-1)
        want = cs[:, L - 1:] - np.concatenate(
            [np.zeros((2, 1)), cs[:, :-L]], axis=-1)
        np.testing.assert_allclose(got, want, atol=1e-3), L


# -------------------------------------------------------------- BPSK31 -----

def test_bpsk31_decodes_varicode():
    text = "cq cq de test"
    bits = varicode_encode_bits(text)
    bits = np.concatenate([np.ones(16, np.uint8), bits,
                           np.ones(16, np.uint8)])
    # Synthesize BPSK31: 2000 Hz, 64 samples/symbol, phase flip on bit 0.
    fs, spb = 2000, 64
    phases = np.zeros(len(bits))
    ph = 0.0
    for k, b in enumerate(bits):
        if b == 0:
            ph += np.pi
        phases[k] = ph
    sig = np.exp(1j * np.repeat(phases, spb)).astype(np.complex64)
    # Smooth transitions slightly (raised-cosine-ish) to help the PLL.
    pad = (-len(sig)) % 1000
    sig = np.concatenate([sig, np.ones(pad, np.complex64)])

    demod = BPSK31()
    spec = StreamSpec(jnp.complex64, fs, 1000)
    out = _run_ragged(demod, spec, sig)
    got_bits = compact(out)
    dec = VaricodeDecoder()
    decoded = dec.process(got_bits)
    assert text in decoded, f"decoded: {decoded!r}"


def test_decoders_robust_to_noise(rng):
    """Pure-noise inputs must never crash any decoder — only produce zero or
    spurious-but-well-formed results (the reference tolerates corrupt input
    the same way: BCH repair, CRC reject, framing resync)."""
    from libsdr_tpu.decode import (AX25Decoder, BaudotDecoder, POCSAGDecoder,
                                   VaricodeDecoder, ax25_decode_bits,
                                   pocsag_decode_bits)

    bits = (rng.random(50_000) > 0.5).astype(np.uint8)
    for m in POCSAGDecoder().process(bits) + pocsag_decode_bits(bits):
        assert 0 <= m.address < (1 << 21 + 3)
        m.best_decode()  # must not raise
    d = AX25Decoder()
    for m in d.process(bits) + ax25_decode_bits(bits):
        str(m)  # parseable frame or skipped — never IndexError
    BaudotDecoder().process(bits)
    VaricodeDecoder().process(bits)

    # all-ones / all-zeros edge streams
    for b in (np.zeros(5000, np.uint8), np.ones(5000, np.uint8)):
        POCSAGDecoder().process(b)
        pocsag_decode_bits(b)
        AX25Decoder().process(b)
        ax25_decode_bits(b)


def test_ragged_run_pipeline(rng):
    """run_pipeline compacts ragged (variable-rate) outputs; matches the
    manual run_bit_chain path."""
    from libsdr_tpu import Pipeline, StreamSpec
    from libsdr_tpu.apps.chains import run_bit_chain
    from libsdr_tpu.core import run_pipeline, stream_blocks
    from libsdr_tpu.ops import ASKDetector, BitStream

    x = rng.normal(size=9600).astype(np.float32)

    def fe():
        p = Pipeline([ASKDetector(), BitStream(1200.0, mode="normal")])
        p.bind(StreamSpec(np.float32, 24000.0, 4800))
        return p

    _, bits = run_pipeline(fe(), stream_blocks(x, 4800))
    ref = run_bit_chain(fe(), x)
    np.testing.assert_array_equal(bits, ref)
