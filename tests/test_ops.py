"""Op-level tests against per-sample numpy oracles (tests/reference_model.py)
and scipy, following the reference's drive-one-node idiom
(reference: test/coreutilstest.cc)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from libsdr_tpu import Pipeline, StreamSpec
from libsdr_tpu.ops.agc import AGC
from libsdr_tpu.ops.baseband import IQBaseBand
from libsdr_tpu.ops.demod import AMDemod, FMDemod, FMDeemph, USBDemod
from libsdr_tpu.ops.fir import FIRFilter, fir_overlap_save
from libsdr_tpu.ops import firdesign, siggen
from libsdr_tpu.ops.iir import iir_first_order
from libsdr_tpu.ops.nco import FreqShift
from libsdr_tpu.ops.resample import FracSubSample, Resampler, SubSample

from tests import reference_model as refm
from tests.conftest import snr_db


from libsdr_tpu.core import cplx


def _run_blocks(proc, spec, x):
    proc.bind(spec)
    carry = proc.init_carry()
    outs = []
    bs = spec.block_size
    for i in range(x.shape[-1] // bs):
        carry, y = proc.apply(carry, cplx.as_block(x[..., i * bs:(i + 1) * bs]))
        outs.append(cplx.to_numpy(y))
    return np.concatenate(outs, axis=-1)


# ---------------------------------------------------------------- FIR ------

def test_fir_matches_reference_ring_loop(rng):
    x = rng.normal(size=1024).astype(np.float32)
    taps = firdesign.ref_lowpass(21, 4000, 48000)
    spec = StreamSpec(jnp.float32, 48000, 256)
    f = FIRFilter(order=21, kind="custom", taps=taps)
    y = _run_blocks(f, spec, x)
    ref = refm.fir_ring(x, taps)
    np.testing.assert_allclose(y, ref, atol=1e-5)


def test_fir_complex_kernel(rng):
    x = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)
    taps = firdesign.ref_complex_bandpass(31, 5000, 2000, 48000)
    spec = StreamSpec(jnp.complex64, 48000, 128)
    f = FIRFilter(order=31, kind="custom", taps=taps)
    y = _run_blocks(f, spec, x)
    ref = refm.fir_ring(x, taps)
    assert snr_db(ref, y) > 100


def test_fir_decimating_alignment(rng):
    """Decimating FIR emits the window ending at sample j*D + (D-1)."""
    x = rng.normal(size=512).astype(np.float32)
    taps = firdesign.lowpass(17, 2000, 48000)
    d = 4
    spec = StreamSpec(jnp.float32, 48000, 128)
    f = FIRFilter(order=17, kind="custom", taps=taps, decim=d)
    y = _run_blocks(f, spec, x)
    full = refm.fir_ring(x, taps)
    np.testing.assert_allclose(y, full[d - 1::d], atol=1e-5)


@pytest.mark.parametrize("decim,order,cplx_x,cplx_k", [
    (4, 68, True, True),    # the flagship IQBaseBand shape (matmul path)
    (4, 68, False, True),
    (4, 68, True, False),
    (4, 68, False, False),
    (2, 33, True, True),
    (8, 100, False, False),
])
def test_fir_matmul_path_matches_ring(rng, decim, order, cplx_x, cplx_k):
    """The block-Toeplitz matmul backend (large decimating blocks) must
    equal the per-sample ring oracle for every real/complex combination,
    including across block and frame boundaries."""
    n = 8192  # block 4096 >= 2 frames of S*decim -> matmul path engaged
    x = rng.normal(size=n).astype(np.float32)
    if cplx_x:
        x = (x + 1j * rng.normal(size=n)).astype(np.complex64)
    taps = rng.normal(size=order).astype(np.float64)
    if cplx_k:
        taps = taps + 1j * rng.normal(size=order)
    spec = StreamSpec(jnp.complex64 if cplx_x else jnp.float32, 48000, 4096)
    f = FIRFilter(order=order, kind="custom", taps=taps, decim=decim)
    y = _run_blocks(f, spec, x)
    full = refm.fir_ring(x, taps)
    assert snr_db(full[decim - 1::decim], y) > 90


def test_fir_lowpass_frequency_response():
    """Design sanity: passband ~0 dB, stopband < -40 dB."""
    taps = firdesign.lowpass(101, 4000, 48000)
    w, h = scipy.signal.freqz(taps, fs=48000)
    hdb = 20 * np.log10(np.abs(h) + 1e-12)
    assert np.all(hdb[w < 2000] > -1.0)
    assert np.all(hdb[w > 8000] < -40.0)


def test_fir_highpass_bandpass_response():
    hp = firdesign.highpass(101, 4000, 48000)
    w, h = scipy.signal.freqz(hp, fs=48000)
    hdb = 20 * np.log10(np.abs(h) + 1e-12)
    assert np.all(hdb[w < 2000] < -40.0)
    assert np.all(hdb[(w > 8000)] > -1.0)
    bp = firdesign.bandpass(101, 4000, 8000, 48000)
    w, h = scipy.signal.freqz(bp, fs=48000)
    hdb = 20 * np.log10(np.abs(h) + 1e-12)
    assert np.all(hdb[(w > 5000) & (w < 7000)] > -1.5)
    assert np.all(hdb[(w < 2000) | (w > 12000)] < -35.0)


# ---------------------------------------------------------------- NCO ------

def test_freqshift_exact_streaming(rng):
    fs, f = 48000, 1234.5
    x = (rng.normal(size=2048) + 1j * rng.normal(size=2048)).astype(np.complex64)
    spec = StreamSpec(jnp.complex64, fs, 256)
    shift = FreqShift(f)
    y = _run_blocks(shift, spec, x)
    n = np.arange(2048)
    ref = x * np.exp(-2j * np.pi * f * n / fs)
    assert snr_db(ref, y) > 90


def test_freqshift_lut_matches_reference_model(rng):
    fs, f = 48000, -1200.0
    x = (rng.normal(size=1024) + 1j * rng.normal(size=1024)).astype(np.complex64)
    spec = StreamSpec(jnp.complex64, fs, 128)
    shift = FreqShift(f, mode="lut")
    y = _run_blocks(shift, spec, x)
    ref = refm.freq_shift_lut(x, f, fs)
    assert snr_db(ref, y) > 100


# ------------------------------------------------------------ baseband -----

def test_iqbaseband_matches_reference_loop(rng):
    """The fused shift-filter-decimate must equal the reference's per-sample
    loop (with exact NCO) to float precision."""
    fs, fc, width, order, decim = 96000, 12000.0, 8000.0, 16, 4
    n = 1024
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    spec = StreamSpec(jnp.complex64, fs, 256)
    bb = IQBaseBand(fc=fc, width=width, order=order, decim=decim)
    y = _run_blocks(bb, spec, x)
    kernel = firdesign.ref_complex_bandpass(order, fc, width, fs)
    ref = refm.iq_baseband(x, kernel, fc, fs, decim)
    assert y.shape[-1] == n // decim
    assert snr_db(ref, y) > 80


def test_iqbaseband_selects_band():
    """Functional check: a tone inside the band passes, outside is rejected."""
    fs = 96000
    n = 96000
    inside = siggen.iq_carrier(fs, n, 10000)
    outside = siggen.iq_carrier(fs, n, 30000)
    spec = StreamSpec(jnp.complex64, fs, 8192)
    bb = IQBaseBand(fc=10000, width=12000, order=64, decim=4,
                    design="textbook")
    y_in = _run_blocks(bb, spec, inside)[2048:]
    bb2 = IQBaseBand(fc=10000, width=12000, order=64, decim=4,
                     design="textbook")
    y_out = _run_blocks(bb2, spec, outside)[2048:]
    assert np.mean(np.abs(y_in)) > 10 * np.mean(np.abs(y_out))


# --------------------------------------------------------------- demod -----

def test_am_usb_demod(rng):
    x = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    spec = StreamSpec(jnp.complex64, 8000, 256)
    am = AMDemod()
    am.bind(spec)
    _, y = am.apply(am.init_carry(), cplx.as_block(x))
    np.testing.assert_allclose(np.asarray(y), np.abs(x), atol=1e-5)
    usb = USBDemod()
    usb.bind(spec)
    _, y = usb.apply(usb.init_carry(), cplx.as_block(x))
    np.testing.assert_allclose(np.asarray(y), (x.real + x.imag) / 2, atol=1e-6)


def test_fm_demod_recovers_tone():
    fs, n = 48000, 48000
    audio = siggen.sine(fs, n, 1000.0, amps=0.5)
    iq = siggen.fm_modulate(fs, audio, deviation=5000.0)
    spec = StreamSpec(jnp.complex64, fs, 4800)
    fm = FMDemod(gain=fs / (2 * np.pi * 5000.0))
    y = _run_blocks(fm, spec, iq)
    # Skip transient, compare against the modulating audio.
    assert snr_db(audio[100:-100], y[100:-100]) > 40


def test_fm_demod_streaming_matches_oracle(rng):
    x = (rng.normal(size=1024) + 1j * rng.normal(size=1024)).astype(np.complex64)
    spec = StreamSpec(jnp.complex64, 48000, 128)
    fm = FMDemod()
    y = _run_blocks(fm, spec, x)
    ref = refm.fm_demod_quadrature(x)
    np.testing.assert_allclose(y, ref, atol=1e-4)


def test_fm_deemph_matches_reference_loop(rng):
    fs = 22050
    x = rng.normal(size=1000).astype(np.float32)
    spec = StreamSpec(jnp.float32, fs, 100)
    de = FMDeemph()
    y = _run_blocks(de, spec, x)
    ref = refm.fm_deemph(x, fs)
    np.testing.assert_allclose(y, ref, atol=1e-4)


# ----------------------------------------------------------------- iir -----

def test_iir_first_order_matches_sequential(rng):
    x = rng.normal(size=(3, 257)).astype(np.float32)
    a, b = 0.95, 0.05
    y0 = np.zeros(3, np.float32)
    y, last = iir_first_order(jnp.asarray(x), a, b, jnp.asarray(y0))
    ref = scipy.signal.lfilter([b], [1, -a], x, axis=-1)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4)
    np.testing.assert_allclose(np.asarray(last), ref[:, -1], atol=1e-4)


# ----------------------------------------------------------------- agc -----

def test_agc_matches_reference_loop(rng):
    fs = 8000
    x = (0.01 * rng.normal(size=2000)).astype(np.float32)
    spec = StreamSpec(jnp.float32, fs, 500)
    agc = AGC(tau=0.01)
    y = _run_blocks(agc, spec, x)
    ref = refm.agc(x, fs, tau=0.01)
    np.testing.assert_allclose(y, ref.real, atol=1e-4)


# ------------------------------------------------------------ resample -----

def test_subsample_matches_reference(rng):
    x = rng.normal(size=1024).astype(np.float32)
    spec = StreamSpec(jnp.float32, 48000, 256)
    ss = SubSample(n=4)
    y = _run_blocks(ss, spec, x)
    np.testing.assert_allclose(y, refm.subsample_avg(x, 4), atol=1e-6)


def test_fracsubsample_reference_quirk():
    """FracSubSample(2.5) behaves as fixed /3 (reference resets the phase
    accumulator on emit, src/subsample.hh:168-175)."""
    f = FracSubSample(2.5)
    assert f.n == 3


def test_resampler_tone_fidelity():
    """Resample a tone 3:2 and check SNR after the polyphase interpolator."""
    fs, n = 48000, 9600
    x = siggen.sine(fs, n, 1000.0).astype(np.float32)
    spec = StreamSpec(jnp.float32, fs, 1200)
    rs = Resampler(p=3, q=2)  # out rate 32 kHz
    out_spec = rs.bind(spec)
    assert float(out_spec.sample_rate) == 32000
    carry = rs.init_carry()
    outs = []
    for i in range(n // 1200):
        carry, y = rs.apply(carry, jnp.asarray(x[i * 1200:(i + 1) * 1200]))
        outs.append(np.asarray(y))
    y = np.concatenate(outs)
    # Output o lands at input time o*p/q - 4 (constant 4-sample latency).
    t_out = (np.arange(len(y)) * 3 / 2 - 4) / fs
    ref = np.sin(2 * np.pi * 1000.0 * t_out)
    assert snr_db(ref[50:-50], y[50:-50]) > 45


def test_resampler_upsample():
    fs, n = 8000, 4000
    x = siggen.sine(fs, n, 440.0).astype(np.float32)
    spec = StreamSpec(jnp.float32, fs, 1000)
    rs = Resampler(p=1, q=2)  # 2x upsample
    out_spec = rs.bind(spec)
    assert out_spec.block_size == 2000
    carry = rs.init_carry()
    outs = []
    for i in range(4):
        carry, y = rs.apply(carry, jnp.asarray(x[i * 1000:(i + 1) * 1000]))
        outs.append(np.asarray(y))
    y = np.concatenate(outs)
    t_out = (np.arange(len(y)) * 1 / 2 - 4) / fs
    ref = np.sin(2 * np.pi * 440.0 * t_out)
    assert snr_db(ref[50:-50], y[50:-50]) > 45


def test_complex_bandpass_absolute_passband_gain():
    """Guard against modulation-sign errors: a +f0 tone must pass with ~unity
    gain through the actual FIR evaluation orientation (a -f0 selection bug
    leaks the tone at -80 dB, which relative-power tests miss)."""
    fs, f0, n = 96000, 20000.0, 8192
    tone = siggen.iq_carrier(fs, n, f0)
    taps = firdesign.complex_bandpass(65, f0, 8000.0, fs)
    spec = StreamSpec(jnp.complex64, fs, n)
    f = FIRFilter(order=65, kind="custom", taps=taps)
    y = _run_blocks(f, spec, tone)
    gain = np.abs(y[200:]).mean()
    assert 0.9 < gain < 1.1, f"passband gain {gain}"
    # image rejection at -f0
    tone_neg = siggen.iq_carrier(fs, n, -f0)
    f2 = FIRFilter(order=65, kind="custom", taps=taps)
    y2 = _run_blocks(f2, spec, tone_neg)
    assert np.abs(y2[200:]).mean() < 1e-3


def test_iqbaseband_absolute_passband_gain():
    """Same guard at the IQBaseBand level with the textbook designer."""
    fs, fc = 96000, 20000.0
    n = 8192 * 4
    tone = siggen.iq_carrier(fs, n, fc + 500.0)
    spec = StreamSpec(jnp.complex64, fs, 8192)
    bb = IQBaseBand(fc=fc, width=8000.0, order=64, decim=4, design="textbook")
    y = _run_blocks(bb, spec, tone)
    gain = np.abs(y[200:]).mean()
    assert 0.8 < gain < 1.1, f"passband gain {gain}"


def test_runtime_retune(rng):
    """set_freq / set_band retuning (reference: FIRFilter::setFreq,
    FilterSource::setFreq): eager apply picks up the new design immediately."""
    from libsdr_tpu.ops.fftfilter import FFTFilterBank

    fs, n = 48000, 4096
    tone_lo = siggen.iq_carrier(fs, n, 2000)
    tone_hi = siggen.iq_carrier(fs, n, 15000)
    x = cplx.as_block((tone_lo + tone_hi).astype(np.complex64))
    spec = StreamSpec(jnp.complex64, fs, n)

    f = FIRFilter(order=65, kind="lowpass", fu=5000.0)
    p = Pipeline([f])
    p.bind(spec)
    step1 = p.compile()
    _, y1 = step1(p.init_carry(), x)
    f.set_freq(fu=20000.0)
    p.bind(spec)                     # re-bind invalidates the compiled step
    step2 = p.compile()
    assert step2 is not step1
    _, y2 = step2(p.init_carry(), x)
    # the retuned low-pass now passes the 15 kHz tone
    p1 = np.mean(np.abs(cplx.to_numpy(y1)[n // 2:]) ** 2)
    p2 = np.mean(np.abs(cplx.to_numpy(y2)[n // 2:]) ** 2)
    assert p2 > 1.5 * p1

    bank = FFTFilterBank([(1000.0, 3000.0)])
    bank.bind(spec)
    _, b1 = bank.apply(bank.init_carry(), x)
    bank.set_band(0, 14000.0, 16000.0)
    _, b2 = bank.apply(bank.init_carry(), x)
    a1 = cplx.to_numpy(b1)[0]
    a2 = cplx.to_numpy(b2)[0]
    # band 0 moved from the 2 kHz tone to the 15 kHz tone
    sp1 = np.abs(np.fft.fft(a1[n // 2:]))
    sp2 = np.abs(np.fft.fft(a2[n // 2:]))
    fr = np.fft.fftfreq(n // 2, 1 / fs)
    assert abs(fr[np.argmax(sp1)] - 2000) < 100
    assert abs(fr[np.argmax(sp2)] - 15000) < 100


def test_autocast_bf16_compute(rng):
    """AutoCast(compute='bfloat16') halves front-end HBM traffic and is
    lossless for 8-bit sources: the FM chain output matches the f32 path."""
    from libsdr_tpu.ops.utils import AutoCast

    fs, n, bs = 96000, 8192, 4096
    u8 = rng.integers(0, 256, size=2 * n).astype(np.uint8)
    iq_u8 = (u8[0::2].astype(np.float32) - 128) / 128 + \
        1j * ((u8[1::2].astype(np.float32) - 128) / 128)
    iq_u8 = iq_u8.astype(np.complex64)

    def run(compute):
        p = Pipeline([AutoCast(compute=compute),
                      IQBaseBand(fc=12000, width=8000, order=16, decim=4,
                                 design="textbook"),
                      FMDemod()])
        p.bind(StreamSpec(jnp.complex64, fs, bs))
        carry = p.init_carry()
        outs = []
        for i in range(n // bs):
            carry, y = p.apply(carry, cplx.as_block(iq_u8[i * bs:(i + 1) * bs]))
            outs.append(np.asarray(y, np.float64))
        return np.concatenate(outs)

    y32 = run("float32")
    ybf = run("bfloat16")
    assert snr_db(y32, ybf) > 60

    # Carry dtypes must be STABLE (no bf16/f32 drift after block 0, which
    # would force a second full jit trace of the pipeline).
    import jax
    p = Pipeline([AutoCast(compute="bfloat16"),
                  IQBaseBand(fc=12000, width=8000, order=16, decim=4,
                             design="textbook"),
                  FMDemod()])
    p.bind(StreamSpec(jnp.complex64, fs, bs))
    c0 = p.init_carry()
    c1, _ = p.apply(c0, cplx.as_block(iq_u8[:bs]))
    d0 = [np.asarray(l).dtype for l in jax.tree_util.tree_leaves(c0)]
    d1 = [np.asarray(l).dtype for l in jax.tree_util.tree_leaves(c1)]
    assert d0 == d1, (d0, d1)

    # And bf16 carries must survive a checkpoint round-trip.
    import tempfile, os
    from libsdr_tpu.core.checkpoint import load_checkpoint, save_checkpoint
    f = os.path.join(tempfile.mkdtemp(), "ck.npz")
    save_checkpoint(f, c1, position=1)
    c2, pos, _ = load_checkpoint(f, p.init_carry())
    assert pos == 1
    for a, b in zip(jax.tree_util.tree_leaves(c1),
                    jax.tree_util.tree_leaves(c2)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
