"""The XLA analog chains against the float64 model (utils/model64.py).

Each receive mode streams a clean synthetic signal on two channels through
its bound pipeline, block by block with carries, with f32 planes and with
bf16 planes (the u8-wire storage format); the model runs the same input
samples (bf16-rounded where the device saw bf16) in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from libsdr_tpu import Pipeline, StreamSpec
from libsdr_tpu.apps.chains import rx_stages
from libsdr_tpu.core import cplx
from libsdr_tpu.ops import FMDemod, FSKDetector, IQBaseBand, siggen
from libsdr_tpu.utils.model64 import model_chain, snr_db

N_BLOCKS, N_CH = 3, 2


def _signal(mode, fs, fc, n):
    t = np.arange(n) / fs
    if mode == "WFM":
        return siggen.fm_modulate(fs, siggen.sine(fs, n, 1000.0, 0.8),
                                  75e3, carrier=fc)
    if mode == "NFM":
        return siggen.fm_modulate(fs, siggen.sine(fs, n, 700.0, 0.8),
                                  4.5e3, carrier=fc)
    if mode == "AM":
        env = 1.0 + 0.5 * np.sin(2 * np.pi * 800.0 * t)
        return (0.5 * env * np.exp(2j * np.pi * fc * t)).astype(np.complex64)
    if mode == "USB":
        return (0.5 * np.exp(2j * np.pi * (fc + 1000.0) * t)
                ).astype(np.complex64)
    bits = np.random.default_rng(5).integers(0, 2, int(n / fs * 1200) + 1)
    audio = siggen.fsk_modulate(fs, bits, 1200.0, 1200.0, 2200.0).real[:n]
    return siggen.fm_modulate(fs, 0.8 * audio, 3000.0, carrier=fc)


# mode -> (fs, block, fc, minimum SNR in dB for f32 / bf16 planes).  Each
# bound sits 10 dB under what the CPU measures (f32: WFM 130, NFM 141,
# AM 90, USB 88; the AGC's f32 envelope recurrence limits AM and USB).
# bf16 planes carry an 8-bit mantissa into the filters (measured 56-96 dB).
CASES = {
    "WFM": (480_000.0, 48_000, 60_000.0, 120.0, 85.0),
    "NFM": (96_000.0, 9_600, 10_000.0, 130.0, 53.0),
    "AM": (96_000.0, 9_600, 10_000.0, 80.0, 46.0),
    "USB": (96_000.0, 9_600, 10_000.0, 78.0, 48.0),
}


def _stages(mode, fs, fc):
    if mode == "AFSK":
        return [IQBaseBand(fc=fc, width=12.5e3, order=32, out_rate=24e3,
                           design="textbook"),
                FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0)]
    return rx_stages(mode, fs, fc)


def _run(mode, fs, block, fc, plane_dtype):
    n = block * N_BLOCKS
    x = np.stack([_signal(mode, fs, fc, n),
                  0.7 * _signal(mode, fs, fc, n)])
    if plane_dtype is not None:
        re = np.asarray(jnp.asarray(x.real, plane_dtype), np.float64)
        im = np.asarray(jnp.asarray(x.imag, plane_dtype), np.float64)
        x = re + 1j * im
    p = Pipeline(_stages(mode, fs, fc))
    p.bind(StreamSpec(np.complex64, fs, block, channels=(N_CH,),
                      plane_dtype=plane_dtype))
    step = p.compile()
    carry = p.init_carry()
    outs = []
    for b in range(N_BLOCKS):
        xb = x[:, b * block:(b + 1) * block]
        blk = cplx.Complex(jnp.asarray(xb.real, plane_dtype or jnp.float32),
                           jnp.asarray(xb.imag, plane_dtype or jnp.float32))
        carry, y = step(carry, blk)
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=-1)
    ref = np.stack([model_chain(p.stages, x[c]) for c in range(N_CH)])
    return got, ref


@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("mode", sorted(CASES))
def test_analog_chain_matches_float64_model(mode, plane):
    fs, block, fc, lo32, lo16 = CASES[mode]
    got, ref = _run(mode, fs, block, fc,
                    None if plane == "f32" else jnp.bfloat16)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    s = min(snr_db(ref[c], got[c]) for c in range(N_CH))
    assert s >= (lo32 if plane == "f32" else lo16), (mode, plane, s)


@pytest.mark.parametrize("plane", ["f32", "bf16"])
def test_afsk_front_end_matches_float64_model(plane):
    """AFSK: the correlator's symbol decisions agree with the float64
    model's except at near-ties (|mark|^2 ~ |space|^2)."""
    got, ref = _run("AFSK", 96_000.0, 9_600, 10_000.0,
                    None if plane == "f32" else jnp.bfloat16)
    assert got.shape == ref.shape
    assert np.mean(got == ref) >= 0.999, np.mean(got == ref)
