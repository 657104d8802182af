"""Checks that need the GPU: the compiled Triton PLL kernel, the dispatch
that picks it, and the XLA chains as the card computes them.

Marked ``gpu``; each test skips where JAX has no GPU (decided in the
``on_gpu`` fixture, never at import).  ``python chip_smoke.py`` runs this
file on the card, in its own process.
"""

import numpy as np
import pytest

from libsdr_tpu.core import cplx

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("on_gpu")]


@pytest.fixture
def on_gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs the GPU (backend is {jax.default_backend()})")


def _pll_args(m, t, mode, seed=0):
    """Majority codes and carried state for ``m`` lanes of ``t`` symbols of
    jittered 1200 baud NRZ at 24 kHz, through a bound BitStream."""
    import jax.numpy as jnp

    from libsdr_tpu import StreamSpec
    from libsdr_tpu.ops.bitsync import BitStream, majority

    rng = np.random.default_rng(seed)
    spb = 20.0
    bits = rng.integers(0, 2, (m, int(t / spb) + 2)).astype(np.uint8)
    idx = (np.arange(t)[None, :] * (1 + 0.002 * rng.standard_normal((m, 1)))
           / spb).astype(np.int64)
    sym = np.take_along_axis(bits, np.clip(idx, 0, bits.shape[1] - 1), 1)
    sym = sym ^ (rng.random((m, t)) < 0.02)
    bs = BitStream(1200.0, mode=mode)
    bs.bind(StreamSpec(np.uint8, 24_000.0, t, channels=(m,)))
    c = bs.init_carry()
    L = bs.corr_len
    code, _, _ = majority(jnp.zeros((L - 1, m), jnp.int32),
                          jnp.zeros(m, jnp.int32),
                          jnp.asarray(sym.T.astype(np.uint8)), L)
    return (code, c["phase"], c["omega"], c["last_bits"]) + tuple(
        jnp.asarray(p) for p in bs.lane_params(m))


@pytest.mark.parametrize("mode", ["normal", "transition"])
def test_pll_kernel_bit_exact_vs_scan_on_gpu(mode):
    """The compiled kernel equals the GPU scan bit for bit at the
    scanner's width (1024 lanes x 12000 steps)."""
    import jax

    from libsdr_tpu.ops.bitsync import pll_scan
    from libsdr_tpu.ops.pll_triton import pll_triton

    args = _pll_args(1024, 12_000, mode)
    got = pll_triton(*args)
    ref = jax.jit(pll_scan)(*args)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dispatch_uses_kernel_on_gpu():
    """On the GPU a BitStream traces to the kernel; kernel_mode('off')
    traces the scan."""
    import jax
    import jax.numpy as jnp

    from libsdr_tpu import StreamSpec
    from libsdr_tpu.ops.bitsync import BitStream, kernel_mode, use_kernel

    bs = BitStream(1200.0, mode="normal")
    bs.bind(StreamSpec(np.uint8, 24_000.0, 480, channels=(64,)))
    x = jnp.zeros((64, 480), jnp.uint8)
    assert use_kernel()
    assert "pallas_call" in str(jax.make_jaxpr(bs.apply)(bs.init_carry(), x))
    with kernel_mode("off"):
        assert not use_kernel()
        jaxpr = str(jax.make_jaxpr(bs.apply)(bs.init_carry(), x))
    assert "pallas_call" not in jaxpr and "scan" in jaxpr


def test_bank_kernel_matches_per_entry_on_gpu():
    """One banked launch over three differently configured BitStreams
    equals each one's own kernel run."""
    import jax.numpy as jnp

    from libsdr_tpu import StreamSpec
    from libsdr_tpu.ops.bitsync import BitStream, bitstream_bank_apply

    rng = np.random.default_rng(3)
    t = 4800
    entries = []
    for baud, mode, m in ((1200.0, "normal", 64), (1200.0, "transition", 64),
                          (90.9, "normal", 64)):
        bs = BitStream(baud, mode=mode)
        bs.bind(StreamSpec(np.uint8, 24_000.0, t, channels=(m,)))
        spb = 24_000.0 / baud
        x = (np.arange(t)[None, :] // spb + rng.integers(0, 2, (m, 1))) % 2
        entries.append((bs, bs.init_carry(), jnp.asarray(x, jnp.uint8)))
    banked = bitstream_bank_apply(entries)
    for (bs, c, x), (nc, r) in zip(entries, banked):
        nc1, r1 = bs.apply(c, x)
        np.testing.assert_array_equal(np.asarray(r.data), np.asarray(r1.data))
        np.testing.assert_array_equal(np.asarray(r.valid),
                                      np.asarray(r1.valid))
        for k in nc:
            np.testing.assert_array_equal(np.asarray(nc[k]),
                                          np.asarray(nc1[k]))


@pytest.mark.parametrize("mode", ["WFM", "NFM"])
def test_fm_chain_precision_on_gpu(mode):
    """The precision contract of ops/fir.py CONV_PRECISION: FM audio holds
    >= 90 dB against the float64 model on the card."""
    from libsdr_tpu.utils.model64 import snr_db
    from tests.test_chains64 import CASES, N_CH, _run

    fs, block, fc, _, _ = CASES[mode]
    got, ref = _run(mode, fs, block, fc, None)
    s = min(snr_db(ref[c], got[c]) for c in range(N_CH))
    assert s >= 90.0, (mode, s)


def test_matmul_fft_vs_numpy_on_gpu(rng):
    from libsdr_tpu.ops.fft import fft

    for n in (1024, 4096):
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)
             ).astype(np.complex64)
        got = cplx.to_numpy(fft(cplx.as_block(x)))
        ref = np.fft.fft(x)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err < 1e-5, (n, err)


def test_fsk_sliding_sum_on_gpu(rng):
    """The banded-matmul sliding sum (ops/fsk.py) vs a numpy moving sum."""
    from libsdr_tpu.ops.fsk import sliding_sum

    L, b = 20, 4096
    u = rng.normal(size=(4, b)) + 1j * rng.normal(size=(4, b))
    tail = np.zeros((4, L - 1), np.complex128)
    s, _ = sliding_sum(cplx.as_block(tail.astype(np.complex64)),
                       cplx.as_block(u.astype(np.complex64)), L)
    c = np.cumsum(u, axis=-1)
    ref = c - np.concatenate([np.zeros((4, L)), c[:, :-L]], axis=-1)
    got = cplx.to_numpy(s)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_end_to_end_fm_tone_on_gpu():
    """The README's FM receive chain: a 1 kHz tone at >= 60 dB over the
    median bin, block by block with carries."""
    from libsdr_tpu import Pipeline, StreamSpec
    from libsdr_tpu.core import run_pipeline, stream_blocks
    from libsdr_tpu.ops import FMDemod, FMDeemph, IQBaseBand, siggen

    fs = 960_000
    audio = siggen.sine(fs, fs, 1000.0, amps=0.8)
    iq = siggen.fm_modulate(fs, audio, deviation=75_000.0, carrier=120_000.0)
    rx = Pipeline([IQBaseBand(fc=120_000, width=200_000, order=64,
                              out_rate=240_000, design="textbook"),
                   FMDemod(gain=fs / 4 / (2 * np.pi * 75_000.0)),
                   FMDeemph()])
    rx.bind(StreamSpec(np.complex64, fs, block_size=96_000))
    _, out = run_pipeline(rx, stream_blocks(iq, 96_000))
    out = np.asarray(out)
    seg = out[len(out) // 4:]
    sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    fr = np.fft.rfftfreq(len(seg), 1 / 240_000)
    assert abs(fr[np.argmax(sp)] - 1000.0) < 5
    assert 20 * np.log10(sp.max() / np.median(sp)) > 60


def test_scanner_decodes_on_gpu():
    """A 64-channel band with pages on three channels decodes on the card,
    through the Triton PLL."""
    from libsdr_tpu.apps import scanner
    from libsdr_tpu.ops import siggen

    m = 64
    fs = m * 24_000.0
    pages = {5: ("GPU FIVE", 555), 30: ("GPU THIRTY", 3030),
             50: ("GPU FIFTY", 5050)}
    n = int(fs * 1.5)
    wide = np.zeros(n, np.complex64)
    for ch, (text, addr) in pages.items():
        f_c = ch * fs / m if ch <= m // 2 else ch * fs / m - fs
        wide += 0.3 * siggen.pocsag_iq(fs, text, addr, carrier=f_c, n=n)
    found = scanner.scan(wide, fs, m)
    for ch, (text, addr) in pages.items():
        assert found[ch][0].address == addr, (ch, sorted(found))
        assert found[ch][0].as_text().startswith(text)


def test_multimode_bank_decodes_on_gpu():
    """The four-mode decoder bank on a small band decodes every mode."""
    from libsdr_tpu.apps import multimode
    from libsdr_tpu.ops import siggen

    m = 8
    fs = m * 24_000.0
    mode_map = {2: "pocsag", 3: "ax25", 5: "rtty", 6: "psk31"}
    found = multimode.scan_multimode(siggen.mixed_band(mode_map, m), fs, m,
                                     mode_map)
    assert found[2][1][0].address == 99
    assert found[3][1][0][0].frm.call == "K3MM"
    assert "MULTI" in found[5][1]
    assert "cq sdr" in found[6][1]
