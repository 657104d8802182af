"""End-to-end application tests: each reference example chain, driven from a
synthesized fixture through the real CLI entry points
(reference: examples/*.cc, cmd/)."""

import json
import urllib.request

import numpy as np
import pytest

from libsdr_tpu.decode import (ax25_frame_bits, baudot_encode_bits,
                               pocsag_encode_batch)
from libsdr_tpu.io import read_wav, write_wav, write_wav_iq
from libsdr_tpu.ops import siggen


def _nrzi(bits):
    """NRZI encode: bit 0 -> transition, bit 1 -> hold (AX.25 convention,
    reference: src/fsk.hh:127-131 TRANSITION mode)."""
    return siggen.nrzi(bits)


def test_fm_rx_cli(tmp_path):
    from libsdr_tpu.apps import fm_rx
    fs = 480_000
    audio = siggen.sine(fs, fs, 1000.0, amps=0.7)
    iq = siggen.fm_modulate(fs, audio, deviation=75e3, carrier=60e3)
    cap = tmp_path / "cap.wav"
    out = tmp_path / "audio.wav"
    write_wav_iq(str(cap), iq, fs)
    fm_rx.main(["--file", str(cap), "-F", "60000", "-o", str(out),
                "--block-size", "48000"])
    got, rate = read_wav(str(out))
    assert rate == 48000
    seg = got[4800:-4800].astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / rate)
    assert abs(freqs[np.argmax(spec)] - 1000.0) < 5


@pytest.mark.parametrize("mode,tone", [("AM", 800.0), ("USB", 700.0)])
def test_rx_cli_modes(tmp_path, mode, tone):
    from libsdr_tpu.apps import rx
    fs = 96_000
    n = 4 * fs
    if mode == "AM":
        audio = siggen.sine(fs, n, tone, amps=0.5)
        base = (1.0 + audio) * siggen.iq_carrier(fs, n, 5000.0)
    else:  # USB: single tone appears at carrier + tone
        base = siggen.iq_carrier(fs, n, 5000.0 + tone)
    cap = tmp_path / "cap.wav"
    out = tmp_path / "audio.wav"
    write_wav_iq(str(cap), 0.5 * base, fs)
    rx.main(["--file", str(cap), "-m", mode, "-F", "5000",
             "-o", str(out), "--block-size", "24000"])
    got, rate = read_wav(str(out))
    seg = got[rate // 2:-rate // 2].astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / rate)
    spec[freqs < 100] = 0  # AM keeps its DC envelope term; skip it
    assert abs(freqs[np.argmax(spec)] - tone) < 10, mode


def test_wavplay_cli(tmp_path):
    from libsdr_tpu.apps import wavplay
    fs = 8000
    audio = siggen.sine(fs, fs, 440.0, amps=0.5)
    src = tmp_path / "in.wav"
    dst = tmp_path / "out.wav"
    write_wav(str(src), audio, fs)
    wavplay.main([str(src), "-o", str(dst), "--gain", "0.5",
                  "--block-size", "1000"])
    got, rate = read_wav(str(dst))
    assert rate == fs
    np.testing.assert_allclose(got[:fs], 0.5 * audio, atol=2e-3)


def _pocsag_iq(fs, text="SDR PAGER", address=4242):
    return siggen.pocsag_iq(fs, text, address)


def test_pocsag_rx_cli(tmp_path):
    from libsdr_tpu.apps import pocsag_rx
    fs = 240_000
    iq = _pocsag_iq(fs)
    cap = tmp_path / "pocsag.wav"
    write_wav_iq(str(cap), 0.9 * iq, fs)
    msgs = pocsag_rx.main(["--file", str(cap), "--block-size", "24000"])
    assert msgs and msgs[0].address == 4242
    assert msgs[0].as_text().startswith("SDR PAGER")


def test_ax25_rx_cli(tmp_path):
    from libsdr_tpu.apps import ax25_rx
    fs = 24_000
    frame_bits = ax25_frame_bits(
        "N0CALL", "APRS", b"!4903.50N/07201.75W-SDR", n_flags=50)
    line = _nrzi(frame_bits)
    # 0.17% TX clock offset: a perfectly synchronous synthetic signal parks
    # the reference PLL at its metastable point (transitions exactly at the
    # sampling instants); real transmitters always have crystal offset.
    audio = siggen.fsk_modulate(fs, line, 1202.0, 1200.0, 2200.0).real
    audio = np.concatenate([audio, np.zeros(4000, np.float32)])
    cap = tmp_path / "afsk.wav"
    write_wav(str(cap), 0.8 * audio.astype(np.float32), fs)
    dec = ax25_rx.main(["--file", str(cap), "--audio",
                        "--block-size", "12000"])
    assert dec.messages, "no AX.25 frame decoded"
    assert dec.aprs_messages and dec.aprs_messages[0].has_location


def test_rtty_rx_cli(tmp_path, capsys):
    from libsdr_tpu.apps import rtty_rx
    fs = 8000
    text = "RYRY HELLO RTTY"
    half_bits = baudot_encode_bits(text, stop_bits="1.5")
    audio = siggen.fsk_modulate(fs, half_bits, 2 * 45.45, 930.0, 1100.0).real
    audio = np.concatenate([audio, np.zeros(2000, np.float32)])
    cap = tmp_path / "rtty.wav"
    write_wav(str(cap), 0.8 * audio.astype(np.float32), fs)
    got = rtty_rx.main(["--file", str(cap), "--block-size", "8000"])
    assert "HELLO RTTY" in got


def test_aprs_service(tmp_path):
    from libsdr_tpu.apps import aprs_service
    fs = 24_000
    frame_bits = ax25_frame_bits(
        "N0CALL", "APRS", b"=5230.10N/01323.60E-Berlin", n_flags=50)
    audio = siggen.fsk_modulate(fs, _nrzi(frame_bits), 1202.0,
                                1200.0, 2200.0).real
    audio = np.concatenate([audio, np.zeros(4000, np.float32)])
    cap = tmp_path / "aprs.wav"
    write_wav(str(cap), 0.8 * audio.astype(np.float32), fs)
    store = aprs_service.main(["--file", str(cap), "--oneshot",
                               "--block-size", "12000"])
    spots = store.spots()
    assert spots and abs(spots[0]["latitude"] - (52 + 30.10 / 60)) < 1e-4

    # And the HTTP surface (reference: src/http.cc, cmd/):
    httpd = aprs_service.serve(store, port=0)
    port = httpd.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/spots") as r:
        data = json.loads(r.read())
    assert data == spots

    # /update push (the reference's REST push, cmd/aprsapplication.cc:43-60)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/update", method="POST",
        data=json.dumps({"from": "EXT-1", "comment": "pushed"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        assert r.status == 204
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/spots") as r:
        data = json.loads(r.read())
    httpd.shutdown()
    assert data[-1]["from"] == "EXT-1"


def test_aprs_service_websocket_push():
    """GET /ws upgrades per RFC 6455 (Sec-WebSocket-Accept =
    base64(sha1(key + GUID)) — the handshake the reference's http.hh
    protocol hook + sha1.cc were shipped for, src/http.hh:87-621) and
    pushes stored spots plus each newly POSTed spot as JSON text frames."""
    import base64
    import hashlib
    import socket

    from libsdr_tpu.apps import aprs_service

    store = aprs_service.APRSStore()
    store.add_spot({"from": "PRE-1", "comment": "stored"})
    httpd = aprs_service.serve(store, port=0)
    port = httpd.server_address[1]
    key = base64.b64encode(b"0123456789abcdef").decode()
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall((f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                   "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\n"
                   "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(4096)
        head, _, rest = buf.partition(b"\r\n\r\n")
        assert b"101" in head.splitlines()[0]
        want = base64.b64encode(
            hashlib.sha1((key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11")
                         .encode()).digest())
        assert b"Sec-WebSocket-Accept: " + want in head

        def read_frame(data):
            while len(data) < 2:
                data += s.recv(4096)
            assert data[0] == 0x81          # FIN + text
            n = data[1] & 0x7F
            off = 2
            if n == 126:
                while len(data) < 4:
                    data += s.recv(4096)
                n = int.from_bytes(data[2:4], "big")
                off = 4
            while len(data) < off + n:
                data += s.recv(4096)
            return json.loads(data[off:off + n]), data[off + n:]

        spot1, rest = read_frame(rest)      # pre-loaded stored spot
        assert spot1["from"] == "PRE-1"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/update", method="POST",
            data=json.dumps({"from": "LIVE-1", "comment": "pushed"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            assert r.status == 204
        spot2, rest = read_frame(rest)      # live push
        assert spot2["from"] == "LIVE-1"

        def masked(opcode, payload):
            mask = b"\x11\x22\x33\x44"
            body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            return bytes([0x80 | opcode, 0x80 | len(payload)]) + mask + body

        def read_control(data):
            while len(data) < 2:
                data += s.recv(4096)
            op, n = data[0] & 0x0F, data[1] & 0x7F
            while len(data) < 2 + n:
                data += s.recv(4096)
            return op, data[2:2 + n], data[2 + n:]

        s.sendall(masked(0x9, b"hi"))       # Ping -> Pong, same payload
        op, payload, rest = read_control(rest)
        assert (op, payload) == (0xA, b"hi")

        # Oversized ping (200 B, extended length): the Pong must be clamped
        # to the RFC 6455 §5.5 125-byte control-frame limit, short form.
        big = (b"ping!" * 40)[:200]
        mask = b"\x11\x22\x33\x44"
        body = bytes(b ^ mask[i % 4] for i, b in enumerate(big))
        s.sendall(bytes([0x89, 0x80 | 126]) + (200).to_bytes(2, "big")
                  + mask + body)
        op, payload, rest = read_control(rest)
        assert (op, payload) == (0xA, big[:125])
        s.sendall(masked(0x8, b"\x03\xe8"))  # Close -> echoed Close reply
        op, payload, rest = read_control(rest)
        assert (op, payload) == (0x8, b"\x03\xe8")
        assert s.recv(4096) == b""          # server finished the handshake
    finally:
        s.close()
        httpd.shutdown()


def test_psk31_rx_cli(tmp_path):
    from libsdr_tpu.apps import psk31_rx
    from libsdr_tpu.decode import varicode_encode_bits
    fs, spb = 2000, 64
    text = "cq de sdr"
    bits = varicode_encode_bits(text)
    bits = np.concatenate([np.ones(16, np.uint8), bits, np.ones(16, np.uint8)])
    ph = 0.0
    phases = []
    for b in bits:
        if b == 0:
            ph += np.pi
        phases.append(ph)
    sig = np.exp(1j * np.repeat(phases, spb)).astype(np.complex64)
    sig = np.concatenate([sig, np.ones((-len(sig)) % 2000, np.complex64)])
    cap = tmp_path / "psk.wav"
    write_wav_iq(str(cap), 0.8 * sig, fs)
    got = psk31_rx.main(["--file", str(cap), "--block-size", "2000"])
    assert text in got


def test_wideband_scanner(tmp_path):
    """Channelizer -> FM -> bit-sync -> POCSAG across a whole band: pages on
    three different channels of one wideband capture all decode, mapped to
    the right channel indices."""
    from libsdr_tpu.apps import scanner

    m = 16
    ch_bw = 25_000.0
    fs = m * ch_bw  # 400 kHz wideband
    pages = {2: ("CHANNEL TWO", 222), 7: ("CHANNEL SEVEN", 777),
             13: ("UNLUCKY", 1313)}
    n = int(fs * 1.2)
    wide = np.zeros(n, np.complex64)
    t = np.arange(n) / fs
    for ch, (text, addr) in pages.items():
        narrow = _pocsag_iq(ch_bw, text=text, address=addr)
        up = np.zeros(n, np.complex64)
        # upsample-by-hold to the wideband rate, shift to the channel center
        idx = np.minimum((np.arange(n) / m).astype(np.int64), len(narrow) - 1)
        up = narrow[idx]
        f_c = ch * fs / m if ch <= m // 2 else (ch * fs / m) - fs
        wide += (0.5 * up * np.exp(2j * np.pi * f_c * t)).astype(np.complex64)

    found = scanner.scan(wide, fs, m, block=int(fs * 0.6) // (m * 16) * m * 16)
    for ch, (text, addr) in pages.items():
        assert ch in found, (ch, sorted(found))
        assert found[ch][0].address == addr
        assert found[ch][0].as_text().startswith(text)


def test_scanner_bf16_wire(tmp_path):
    """The u8 wire -> bf16-plane ingest path reaches the scanner's PFB
    front end unconverted (scanner --bf16) and still decodes."""
    from libsdr_tpu.apps import scanner

    m = 16
    ch_bw = 25_000.0
    fs = m * ch_bw
    n = int(fs * 1.0)
    narrow = _pocsag_iq(ch_bw, text="BF16 WIRE", address=321)
    t = np.arange(n) / fs
    idx = np.minimum((np.arange(n) / m).astype(np.int64), len(narrow) - 1)
    wide = (0.6 * narrow[idx] * np.exp(2j * np.pi * (3 * fs / m) * t)
            ).astype(np.complex64)
    # rtl_sdr wire format: u8 = x*128 + 128 (native/__init__.py:101)
    inter = np.empty(2 * n, np.float32)
    inter[0::2] = wide.real
    inter[1::2] = wide.imag
    u8 = np.clip(np.round(inter * 128.0 + 128.0), 0, 255).astype(np.uint8)
    cap = tmp_path / "wire.u8"
    u8.tofile(cap)

    found = scanner.main(["--raw", str(cap), "--rate", str(fs),
                          "--channels", str(m), "--bf16"])
    assert 3 in found
    assert found[3][0].address == 321
    assert found[3][0].as_text().startswith("BF16 WIRE")


def make_mixed_band(active: "dict[int, str]", m: int,
                    ch_bw: float = 24_000.0) -> np.ndarray:
    """The canonical mixed band (ops/siggen.mixed_band) — shared by the
    single-chip and sharded multimode bank tests."""
    return siggen.mixed_band(active, m, ch_bw)


def test_multimode_bank(tmp_path):
    """BASELINE config 4: ONE channelizer front end feeding a per-channel
    mix of POCSAG / AFSK-AX.25 / RTTY / PSK31 decoders — a TX-synthesized
    mixed band decodes all four modes in one run."""
    from libsdr_tpu.apps import multimode

    m = 8
    fs = m * 24_000.0                   # 192 kHz wideband
    mode_map = {2: "pocsag", 3: "ax25", 5: "rtty", 6: "psk31"}
    wide = make_mixed_band(mode_map, m)
    found = multimode.scan_multimode(wide, fs, m, mode_map)

    assert 2 in found and found[2][0] == "pocsag"
    msgs = found[2][1]
    assert msgs[0].address == 99 and msgs[0].as_text().startswith("MIXED")
    assert 3 in found and found[3][0] == "ax25"
    frames = found[3][1]
    assert frames and frames[0][0].frm.call == "K3MM"
    assert frames[0][1] is not None          # APRS position parsed
    assert 5 in found and found[5][0] == "rtty"
    assert "MULTI" in found[5][1]
    assert 6 in found and found[6][0] == "psk31"
    assert "cq sdr" in found[6][1]


def test_multimode_psk31_nonstandard_channel_rate():
    """The PSK31 branch decimates by floor(ch_rate/2000) — only 12 at the
    24 kHz channel spacing.  Block sizing must follow the ACTUAL channel
    rate: at 26 kHz spacing (D=13, coprime to the 16-aligned block sizes)
    the bank must still bind and decode (regression: hardcoded 12)."""
    from libsdr_tpu.apps import multimode

    m, ch_bw = 8, 26_000.0
    fs = m * ch_bw
    assert multimode._t_quantum(fs, m, ["psk31"]) == 13
    assert multimode._t_quantum(fs, m, ["pocsag", "rtty"]) == 1
    wide = make_mixed_band({3: "psk31"}, m, ch_bw=ch_bw)
    found = multimode.scan_multimode(wide, fs, m, {3: "psk31"})
    assert 3 in found and "cq sdr" in found[3][1]


def test_scanner_and_multimode_empty_capture():
    """A capture shorter than one block yields no blocks: both bank apps
    must return empty results, not crash on an empty concatenate."""
    from libsdr_tpu.apps import multimode, scanner

    short = np.zeros(100, np.complex64)
    assert scanner.scan(short, fs=1_000_000.0, n_channels=8) == {}
    assert multimode.scan_multimode(short, 192_000.0, 8,
                                    {2: "pocsag", 3: "ax25"}) == {}


def test_tx_loopback(tmp_path):
    """The transmitter CLI's captures decode through the matching receivers
    (full TX -> RX loopback for every mode)."""
    from libsdr_tpu.apps import tx, pocsag_rx, ax25_rx, rtty_rx, psk31_rx

    f = tx.main(["pocsag", "-o", str(tmp_path / "p.wav"),
                 "--address", "777", "--text", "LOOPBACK"])
    msgs = pocsag_rx.main(["--file", f, "--block-size", "24000"])
    assert msgs and msgs[0].address == 777
    assert msgs[0].as_text().startswith("LOOPBACK")

    f = tx.main(["afsk", "-o", str(tmp_path / "a.wav"),
                 "--from-call", "K2TX", "--info", "!4903.50N/07201.75W-tx"])
    dec = ax25_rx.main(["--file", f, "--audio", "--block-size", "12000"])
    assert dec.messages and dec.messages[0].frm.call == "K2TX"

    f = tx.main(["rtty", "-o", str(tmp_path / "r.wav"),
                 "--text", "RYRY TX LOOP", "--fs", "8000"])
    got = rtty_rx.main(["--file", f, "--block-size", "8000"])
    assert "TX LOOP" in got

    f = tx.main(["psk31", "-o", str(tmp_path / "k.wav"), "--text", "tx ok"])
    got = psk31_rx.main(["--file", f, "--block-size", "2000"])
    assert "tx ok" in got


def test_spectrum_cli(tmp_path):
    """Welch PSD on the matmul FFT finds the tones in a capture (and the
    PNG render path works)."""
    from libsdr_tpu.apps import spectrum

    fs, n = 96_000, 96_000
    iq = (0.8 * siggen.iq_carrier(fs, n, 12_000)
          + 0.2 * siggen.iq_carrier(fs, n, -25_000)
          + 0.01 * (np.random.default_rng(0).normal(size=n)
                    + 1j * np.random.default_rng(1).normal(size=n))
          ).astype(np.complex64)
    cap = tmp_path / "cap.wav"
    write_wav_iq(str(cap), iq, fs)
    out = spectrum.main(["--file", str(cap), "--nfft", "4096",
                         "--png", str(tmp_path / "s.png")])
    got = sorted(p["freq_hz"] for p in out["peaks"][:2])
    assert abs(got[0] - (-25_000)) < 100 and abs(got[1] - 12_000) < 100
    assert (tmp_path / "s.png").stat().st_size > 10_000


def test_aprs_service_map_page():
    """'/' serves the real map page (reference: cmd/aprsapplication.cc:13-16
    serves a static map at '/'), wired to /spots."""
    from libsdr_tpu.apps import aprs_service
    store = aprs_service.APRSStore()
    store.add_spot({"from": "T1", "latitude": 52.5, "longitude": 13.4})
    httpd = aprs_service.serve(store, port=0)
    port = httpd.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as r:
        page = r.read().decode()
        assert r.headers.get_content_type() == "text/html"
    httpd.shutdown()
    # a real map page: svg plot + /spots polling + marker rendering
    assert "<svg" in page and "/spots" in page and "markers" in page
    assert "latitude" in page  # consumes the store's spot schema
    # live push: the page opens the /ws websocket and keeps the 3 s poll
    # only as fallback
    assert "new WebSocket" in page and "/ws" in page


def test_rx_cli_live_mode_switch(tmp_path):
    """rx.py --switch: NFM for the first half, live-switched to AM for the
    second (reference runtime reconfiguration analog) — both halves must
    demodulate their tone."""
    from libsdr_tpu.apps import rx
    fs = 960_000
    n = fs  # 1 s
    t = np.arange(n) / fs
    # first half: NFM at 4.5 kHz deviation; second half: AM
    audio_f = np.sin(2 * np.pi * 800.0 * t[: n // 2])
    ph = 2 * np.pi * 4500.0 * np.cumsum(audio_f) / fs
    fm = np.exp(1j * ph)
    audio_a = np.sin(2 * np.pi * 1100.0 * t[n // 2:])
    am = (0.6 + 0.4 * audio_a) * np.exp(1j * 2 * np.pi * 0.0 * t[n // 2:])
    iq = np.concatenate([fm, am]).astype(np.complex64)
    cap = tmp_path / "switch.wav"
    write_wav_iq(str(cap), 0.5 * iq, fs)
    out = tmp_path / "audio.wav"
    rx.main(["--file", str(cap), "-m", "NFM",
             "--switch", "0.5:AM", "-o", str(out),
             "--block-size", "96000"])
    from libsdr_tpu.io import read_wav
    audio, rate = read_wav(str(out))
    assert rate == 24000
    half = len(audio) // 2

    def peak(seg):
        sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        return np.fft.rfftfreq(len(seg), 1 / rate)[np.argmax(sp[5:]) + 5]

    assert abs(peak(audio[half // 4: half]) - 800.0) < 10
    assert abs(peak(audio[half + half // 4:]) - 1100.0) < 10
