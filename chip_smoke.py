"""On-card smoke run of the main path, at deployment size, on one GPU.

Runs in ONE process (one compile cache, one process on the card):

  gpu_tests  tests/test_gpu.py (the ``gpu``-marked tests) in-process;
  scanner    the whole-band POCSAG scanner (apps/scanner.scan_blocks):
             1024 channels at 24 kHz, 3 blocks, pages on 8 channels, once
             with f32 planes and once with bf16 planes off a u8 wire;
  multimode  the POCSAG/AX.25/RTTY/PSK31 decoder bank (apps/multimode):
             256 channels at 24 kHz, every payload decoded exactly;
  fm_bank    the FM receive bank (apps/chains.fm_bank): 64 channels x 2^24
             samples, 3 carry-chained blocks, audio vs a float64 model.

Each phase prints one JSON findings line (the card, compile seconds, steady
seconds per block, peak device bytes, correctness); the last line is
``{"ok": true, "device": {...}}``.  Any failure raises, and the script
exits non-zero without that line.  It refuses to run without a GPU.

``--four`` runs only the four-card paths on a 4-device mesh, each beside
its 1-device run in the same process: the sharded multimode bank and the
sharded scanner (parallel/wideband.build_scanner_step).

Usage:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Scanner pages: {channel: (text, address)}, spread across the band.
SCAN_M, SCAN_BLOCKS = 1024, 3
SCAN_PAGES = {ch: (f"PAGE CH {ch}", 1000 + 7 * ch)
              for ch in (3, 130, 261, 389, 518, 647, 776, 1020)}
# Multimode: mode_pattern[ch % 4]; four channels per mode, 13 apart.
MM_M = 256
MM_PATTERN = ("pocsag", "ax25", "rtty", "psk31")
MM_ACTIVE = {base + 13 * i: MM_PATTERN[i]
             for base in (8, 72, 136, 200) for i in range(4)}
# FM bank: 8 distinct tones, channel c carries tone c % 8.
FM_CH, FM_BLOCK, FM_BLOCKS, FM_FS = 64, 1 << 24, 3, 960_000.0
FM_TONES = (500.0, 700.0, 900.0, 1100.0, 1300.0, 1700.0, 2300.0, 3100.0)
FM_SNR_MIN_DB = 90.0       # the precision contract (ops/fir.py)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def _peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def _timed_steps(step, carry, blocks):
    """Compile ``step`` for the first block, then run every block with the
    carry chained.  Returns (compile_s, [seconds per block], outputs).
    The PLL's kernel choice is made while tracing, so a step timed under
    ``kernel_mode("off")`` must be built fresh inside that context."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(step).lower(carry, blocks[0]).compile()
    compile_s = time.perf_counter() - t0
    times, outs = [], []
    for x in blocks:
        t0 = time.perf_counter()
        carry, y = compiled(carry, x)
        jax.block_until_ready(y)
        times.append(time.perf_counter() - t0)
        outs.append(y)
    return compile_s, times, outs


# -- scanner ----------------------------------------------------------------

def scanner_signal():
    """(fs, block, complex64 capture): POCSAG pages FM-modulated straight
    at the wideband rate on their channel centers, starts staggered so
    pages cross block boundaries, over a white noise floor 30 dB under
    each page in its channel (an FM discriminator with nothing but the
    channelizer's leakage to listen to decodes the leakage)."""
    from libsdr_tpu.apps.scanner import pick_block
    from libsdr_tpu.ops import siggen

    m = SCAN_M
    fs = m * 24_000.0
    block = pick_block(fs, m)
    n = block * SCAN_BLOCKS
    rng = np.random.default_rng(0)
    sigma = 0.1 * np.sqrt(m / 1000.0 / 2)       # per component
    wide = (sigma * (rng.standard_normal(n, np.float32)
                     + 1j * rng.standard_normal(n, np.float32))
            ).astype(np.complex64)
    for i, (ch, (text, addr)) in enumerate(sorted(SCAN_PAGES.items())):
        f_c = ch * fs / m if ch <= m // 2 else ch * fs / m - fs
        wide += 0.1 * siggen.pocsag_iq(fs, text, addr, carrier=f_c, n=n,
                                       start=int(0.02 * i * fs))
    return fs, block, wide


def _u8_wire(x: np.ndarray, path: str) -> None:
    """Write ``x`` as the rtl_sdr u8 wire format (u8 = x*128 + 128)."""
    inter = np.empty(2 * x.size, np.float32)
    inter[0::2], inter[1::2] = x.real, x.imag
    np.clip(np.round(inter * 128.0 + 128.0), 0, 255).astype(
        np.uint8).tofile(path)


def _page_errors(found) -> list:
    """Channels that decode wrong: a paged channel whose first message is
    not its page, or an idle channel that decodes one of the pages
    (crosstalk).  An idle channel hears only the noise floor, on which the
    POCSAG decoder, like the reference's, can lock on a false sync; those
    are counted by :func:`_noise_decodes`, not failed."""
    sent = {(addr, text) for text, addr in SCAN_PAGES.values()}
    errs = []
    for ch, (text, addr) in SCAN_PAGES.items():
        msgs = found.get(ch, [])
        if not msgs or msgs[0].address != addr or \
                msgs[0].as_text().replace("<NUL>", "") != text:
            errs.append(ch)
    for ch, msgs in found.items():
        if ch not in SCAN_PAGES and any(
                (m.address, m.as_text().replace("<NUL>", "")) in sent
                for m in msgs):
            errs.append(ch)
    return errs


def _noise_decodes(found) -> list:
    return sorted(ch for ch in found if ch not in SCAN_PAGES)


def _decoded(found, channels=None) -> dict:
    return {ch: [(m.address, m.as_text()) for m in msgs]
            for ch, msgs in sorted(found.items())
            if channels is None or ch in channels}


def phase_scanner(dev, card_s):
    import jax.numpy as jnp

    from libsdr_tpu.apps.scanner import scan_blocks, scanner_step
    from libsdr_tpu.core import cplx, stream_blocks
    from libsdr_tpu.io.ingest import stream_raw_iq_bf16
    from libsdr_tpu.ops.bitsync import kernel_mode

    fs, block, wide = scanner_signal()
    m = SCAN_M
    step, init, place = scanner_step(fs, m, block)
    blocks = [place(cplx.as_block(b)) for b in stream_blocks(wide, block)]
    compile_s, times, _ = _timed_steps(step, init(), blocks)
    with kernel_mode("off"):
        step, init, _ = scanner_step(fs, m, block)
        compile_scan_s, times_scan, _ = _timed_steps(step, init(), blocks)
    del blocks

    t0 = time.perf_counter()
    found32 = scan_blocks(stream_blocks(wide, block), fs, m, block)
    e2e32 = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wire.u8")
        _u8_wire(wide, path)
        t0 = time.perf_counter()
        found16 = scan_blocks(stream_raw_iq_bf16(path, block), fs, m, block,
                              plane_dtype=jnp.bfloat16)
        e2e16 = time.perf_counter() - t0
    res = dict(
        phase="scanner", card=card_s, channels=m, block=block,
        blocks=SCAN_BLOCKS, compile_s=compile_s,
        steady_s_per_block=float(np.median(times)), block_s=times,
        scan_pll_compile_s=compile_scan_s,
        scan_pll_steady_s_per_block=float(np.median(times_scan)),
        e2e_s_f32=e2e32, e2e_s_bf16_wire=e2e16,
        peak_bytes_in_use=_peak_bytes(dev),
        pages=len(SCAN_PAGES), wrong_f32=_page_errors(found32),
        wrong_bf16=_page_errors(found16),
        idle_noise_decodes_f32=_noise_decodes(found32),
        idle_noise_decodes_bf16=_noise_decodes(found16),
        f32_equals_bf16=_decoded(found32, SCAN_PAGES) ==
        _decoded(found16, SCAN_PAGES))
    res["ok"] = (not res["wrong_f32"] and not res["wrong_bf16"]
                 and res["f32_equals_bf16"])
    return res


# -- multimode --------------------------------------------------------------

def _mm_errors(found) -> list:
    from libsdr_tpu.ops.siggen import MIXED_BAND_PAYLOADS as P

    errs = []
    for ch, mode in MM_ACTIVE.items():
        got = found.get(ch)
        if got is None or got[0] != mode:
            errs.append(ch)
            continue
        out = got[1]
        if mode == "pocsag":
            good = bool(out) and out[0].address == P[mode][1] and \
                out[0].as_text().replace("<NUL>", "") == P[mode][0]
        elif mode == "ax25":
            good = bool(out) and out[0][0].frm.call == P[mode][0] and \
                out[0][0].to.call == P[mode][1] and \
                out[0][0].payload.endswith(P[mode][2]) and \
                out[0][1] is not None
        else:
            good = P[mode] in out
        if not good:
            errs.append(ch)
    return errs


def _mm_decoded(found) -> dict:
    return {ch: (mode, repr(out)) for ch, (mode, out) in sorted(found.items())}


def phase_multimode(dev, card_s):
    from jax.sharding import Mesh

    from libsdr_tpu.apps.multimode import (scan_multimode_sharded,
                                           sharded_bank_block)
    from libsdr_tpu.core import stream_blocks
    from libsdr_tpu.ops import siggen
    from libsdr_tpu.ops.bitsync import kernel_mode
    from libsdr_tpu.parallel.multimode import build_multimode_step

    m = MM_M
    fs = m * 24_000.0
    wide = siggen.mixed_band(MM_ACTIVE, m)
    block = sharded_bank_block(fs, m, 1, MM_PATTERN)
    mesh = Mesh(np.asarray([dev]), ("d",))
    step, init, place, _ = build_multimode_step(mesh, m, block, fs,
                                                MM_PATTERN)
    blocks = [place(b) for b in stream_blocks(wide, block)]
    compile_s, times, _ = _timed_steps(step, init(), blocks)
    with kernel_mode("off"):
        step, init, _, _ = build_multimode_step(mesh, m, block, fs,
                                                MM_PATTERN)
        compile_scan_s, times_scan, _ = _timed_steps(step, init(), blocks)
    del blocks
    t0 = time.perf_counter()
    found = scan_multimode_sharded(wide, fs, m, MM_PATTERN, devices=[dev])
    e2e = time.perf_counter() - t0
    errs = _mm_errors(found)
    return dict(
        phase="multimode", card=card_s, channels=m, block=block,
        blocks=len(wide) // block, pattern=list(MM_PATTERN),
        compile_s=compile_s, steady_s_per_block=float(np.median(times)),
        block_s=times, scan_pll_compile_s=compile_scan_s,
        scan_pll_steady_s_per_block=float(np.median(times_scan)),
        e2e_s=e2e, peak_bytes_in_use=_peak_bytes(dev),
        payloads=len(MM_ACTIVE), wrong=errs,
        idle_channels_with_output=sorted(
            ch for ch in found if ch not in MM_ACTIVE),
        ok=not errs)


# -- fm_bank ----------------------------------------------------------------

def fm_signals(n: int) -> np.ndarray:
    """(8, n) complex64: FM tones (deviation 75 kHz at fs/8)."""
    from libsdr_tpu.ops import siggen

    return np.stack([siggen.fm_modulate(
        FM_FS, siggen.sine(FM_FS, n, f, amps=0.8), 75_000.0,
        carrier=FM_FS / 8) for f in FM_TONES])


def _tone_db(audio: np.ndarray, rate: float, f: float) -> float:
    """Tone-to-median-bin ratio (dB) of ``audio`` at ``f``; -inf when the
    spectral peak is not at ``f``."""
    sp = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    freqs = np.fft.rfftfreq(len(audio), 1.0 / rate)
    k = int(np.argmax(sp[5:])) + 5
    if abs(freqs[k] - f) > 2 * rate / len(audio):
        return float("-inf")
    return float(20 * np.log10(sp[k] / np.median(sp)))


def phase_fm_bank(dev, card_s):
    import jax
    import jax.numpy as jnp

    from libsdr_tpu.apps.chains import fm_bank
    from libsdr_tpu.core import cplx
    from libsdr_tpu.utils.model64 import model_chain, snr_db

    block, cuts = FM_BLOCK, []
    sig = fm_signals(FM_BLOCK * FM_BLOCKS)
    while True:
        rx = fm_bank(FM_CH, block)

        def make_block(b):
            x8 = sig[:, b * block:(b + 1) * block]
            re = jnp.tile(jnp.asarray(x8.real), (FM_CH // len(FM_TONES), 1))
            im = jnp.tile(jnp.asarray(x8.imag), (FM_CH // len(FM_TONES), 1))
            return jax.block_until_ready(cplx.Complex(re, im))

        try:
            t0 = time.perf_counter()
            compiled = rx.compile().lower(rx.init_carry(),
                                          make_block(0)).compile()
            compile_s = time.perf_counter() - t0
            carry, times, audio = rx.init_carry(), [], []
            for b in range(len(sig[0]) // block):
                x = make_block(b)
                t0 = time.perf_counter()
                carry, y = compiled(carry, x)
                jax.block_until_ready(y)
                times.append(time.perf_counter() - t0)
                audio.append(np.asarray(y[:len(FM_TONES)], np.float64))
                del x, y
            break
        except jax.errors.JaxRuntimeError as e:
            if "RESOURCE_EXHAUSTED" not in str(e) or block <= (1 << 20):
                raise
            cuts.append(f"block {block} out of device memory: halved")
            print(f"fm_bank: {cuts[-1]}", flush=True)
            block //= 2
    mem = compiled.memory_analysis()
    audio = np.concatenate(audio, axis=-1)          # (8, n_total / 4)
    d = 4
    w = min(1 << 20, block // 2)                    # input samples compared
    snrs, tones = [], []
    for s in range(len(FM_TONES)):
        # block 0 head from a cold start; every later block's head from a
        # model started w samples earlier (its warm-up is discarded).
        ref = model_chain(rx.stages, sig[s, :w])
        snrs.append(snr_db(ref, audio[s, :w // d]))
        for b in range(1, len(sig[0]) // block):
            s0 = b * block - w
            ref = model_chain(rx.stages, sig[s, s0:b * block + w],
                              start=s0)[w // d:]
            snrs.append(snr_db(ref, audio[s, b * block // d:
                                          (b * block + w) // d]))
        tones.append(_tone_db(audio[s, -(1 << 18):], FM_FS / d,
                              FM_TONES[s]))
    res = dict(
        phase="fm_bank", card=card_s, channels=FM_CH, block=block,
        blocks=len(times), cuts=cuts, compile_s=compile_s,
        steady_s_per_block=float(np.median(times)), block_s=times,
        msps=FM_CH * block / float(np.median(times)) / 1e6,
        temp_bytes=int(mem.temp_size_in_bytes) if mem else None,
        peak_bytes_in_use=_peak_bytes(dev),
        audio_snr_db_min=float(min(snrs)), snr_bound_db=FM_SNR_MIN_DB,
        tone_db_min=float(min(tones)))
    res["ok"] = bool(res["audio_snr_db_min"] >= FM_SNR_MIN_DB
                     and res["tone_db_min"] >= 60.0)
    return res


# -- gpu tests --------------------------------------------------------------

def phase_gpu_tests(dev, card_s):
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      "--rootdir", HERE,
                      os.path.join(HERE, "tests", "test_gpu.py")])
    return dict(phase="gpu_tests", card=card_s, exit_code=int(rc),
                seconds=time.perf_counter() - t0,
                peak_bytes_in_use=_peak_bytes(dev), ok=int(rc) == 0)


# -- four cards -------------------------------------------------------------

def phase_four_multimode(devs, card_s):
    from jax.sharding import Mesh

    from libsdr_tpu.apps.multimode import (scan_multimode_sharded,
                                           sharded_bank_block)
    from libsdr_tpu.core import stream_blocks
    from libsdr_tpu.ops import siggen
    from libsdr_tpu.parallel.multimode import build_multimode_step

    m = MM_M
    fs = m * 24_000.0
    wide = siggen.mixed_band(MM_ACTIVE, m)
    block = sharded_bank_block(fs, m, len(devs), MM_PATTERN)
    res = dict(phase="four_multimode", card=card_s, channels=m,
               block=block, devices=len(devs))
    bits, found = {}, {}
    for n in (len(devs), 1):
        mesh = Mesh(np.asarray(devs[:n]), ("d",))
        step, init, place, _ = build_multimode_step(mesh, m, block, fs,
                                                    MM_PATTERN)
        blocks = [place(b) for b in stream_blocks(wide, block)]
        compile_s, times, outs = _timed_steps(step, init(), blocks)
        res[f"compile_s_{n}"] = compile_s
        res[f"steady_s_per_block_{n}"] = float(np.median(times))
        bits[n] = [{mo: (np.asarray(r.data) * np.asarray(r.valid),
                         np.asarray(r.valid)) for mo, r in o.items()}
                   for o in outs]
        found[n] = scan_multimode_sharded(wide, fs, m, MM_PATTERN,
                                          block=block, devices=devs[:n])
    n4 = len(devs)
    diff = sum(int(np.sum(a[mo][k] != b[mo][k]))
               for a, b in zip(bits[n4], bits[1]) for mo in a
               for k in (0, 1))
    res.update(bit_slots_differing=diff, bits_identical=diff == 0,
               decodes_identical=_mm_decoded(found[n4]) ==
               _mm_decoded(found[1]),
               wrong_4=_mm_errors(found[n4]), wrong_1=_mm_errors(found[1]))
    res["ok"] = bool(res["decodes_identical"] and not res["wrong_4"]
                     and not res["wrong_1"])
    return res


def phase_four_scanner(devs, card_s):
    from jax.sharding import Mesh

    from libsdr_tpu.core import cplx, stream_blocks
    from libsdr_tpu.decode import pocsag_decode_bits
    from libsdr_tpu.parallel.wideband import build_scanner_step

    fs, block, wide = scanner_signal()
    m = SCAN_M
    res = dict(phase="four_scanner", card=card_s, channels=m, block=block,
               devices=len(devs))
    bits, found = {}, {}
    for n in (len(devs), 1):
        mesh = Mesh(np.asarray(devs[:n]), ("d",))
        step, init, place = build_scanner_step(mesh, m, block, fs,
                                               packed=True)
        blocks = [place(cplx.as_block(b))
                  for b in stream_blocks(wide, block)]
        compile_s, times, outs = _timed_steps(step, init(), blocks)
        res[f"compile_s_{n}"] = compile_s
        res[f"steady_s_per_block_{n}"] = float(np.median(times))
        arr = np.concatenate([np.asarray(o) for o in outs], axis=-1)
        data, valid = arr & 1, arr >= 2
        bits[n] = np.where(valid, data, 0) | (valid.astype(np.uint8) << 1)
        found[n] = {ch: msgs for ch in range(m)
                    if (msgs := pocsag_decode_bits(data[ch][valid[ch]]))}
    n4 = len(devs)
    diff = int(np.sum(bits[n4] != bits[1]))
    res.update(bit_slots_differing=diff, bits_identical=diff == 0,
               decodes_identical=_decoded(found[n4]) == _decoded(found[1]),
               idle_noise_decodes=_noise_decodes(found[1]),
               wrong_4=_page_errors(found[n4]),
               wrong_1=_page_errors(found[1]))
    res["ok"] = bool(res["decodes_identical"] and not res["wrong_4"]
                     and not res["wrong_1"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded paths, each beside "
                         "its 1-card run")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "libsdr_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from libsdr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    card_s = card()
    print(f"card: {card_s}", flush=True)
    if args.four:
        if len(devs) < 4:
            print(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}",
                  file=sys.stderr)
            return 2
        phases = [lambda: phase_four_multimode(devs[:4], card_s),
                  lambda: phase_four_scanner(devs[:4], card_s)]
    else:
        phases = [lambda: phase_gpu_tests(devs[0], card_s),
                  lambda: phase_scanner(devs[0], card_s),
                  lambda: phase_multimode(devs[0], card_s),
                  lambda: phase_fm_bank(devs[0], card_s)]
    ok = True
    for phase in phases:
        res = phase()
        print(json.dumps(res), flush=True)
        ok = ok and res["ok"]
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
