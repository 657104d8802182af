"""Randomized streaming equivalence of the analog chains.

Seeded fuzz cases sweep orders, decimations, block sizes and channel counts
(including blocks shorter than the filter) and hold three runs of one chain
to each other: the fused pipeline (core/fuse.py folds the NCO into the
demodulator) streamed block by block with carries, the unfused stage
composition one-shot over the whole signal, and the float64 model
(utils/model64.py).
"""

import numpy as np
import pytest

from libsdr_tpu import Pipeline, StreamSpec
from libsdr_tpu.core import cplx
from libsdr_tpu.ops import (AGC, AMDemod, FMDemod, FMDeemph, IQBaseBand,
                            USBDemod)
from libsdr_tpu.utils.model64 import model_chain

from tests.conftest import snr_db

N_BLOCKS = 4

CASES = [
    # (mode, order, decim, block, n_ch)
    ("fm", 16, 2, 4096, 3),
    ("fm", 64, 4, 1024, 1),
    ("fm", 31, 8, 8192, 2),
    ("fm", 128, 4, 512, 1),      # block ~ filter length (lead-heavy)
    ("fm", 96, 2, 256, 2),       # block SHORTER than the filter
    ("am", 16, 2, 4096, 3),
    ("am", 48, 4, 2048, 2),
    ("am", 80, 8, 1024, 1),
]

USB_CASES = [
    (48, 4, 4096, 2),
    (64, 8, 2048, 1),
    (96, 8, 8192, 3),
]


def _stages(mode, order, decim):
    if mode == "usb":
        return [IQBaseBand(fc=11000.0, ff=12500.0, width=3000.0,
                           order=order, decim=decim, design="textbook"),
                USBDemod(), AGC(tau=0.03)]
    bb = IQBaseBand(fc=11000.0, width=9000.0, order=order, decim=decim,
                    design="textbook")
    if mode == "fm":
        return [bb, FMDemod(), FMDeemph()]
    return [bb, AMDemod(), AGC(tau=0.03)]


def _close(a, b, min_snr):
    """FM discriminator outputs can differ near |z| ~ 0 on random data
    (angle amplification): demand a tight median error and a sane energy
    match rather than a max error."""
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b)
    scale = np.abs(a).max() + 1e-12
    assert np.median(err) / scale < 1e-4, np.median(err) / scale
    assert snr_db(a.ravel() + 1e-9, b.ravel() + 1e-9) > min_snr


def _check(rng, mode, order, decim, block, n_ch, min_snr):
    fs = 96000.0
    x = (rng.normal(size=(n_ch, N_BLOCKS * block))
         + 1j * rng.normal(size=(n_ch, N_BLOCKS * block))
         ).astype(np.complex64)

    streamed = Pipeline(_stages(mode, order, decim))
    streamed.bind(StreamSpec(np.complex64, fs, block, channels=(n_ch,)))
    c, parts = streamed.init_carry(), []
    for b in range(N_BLOCKS):
        c, y = streamed.apply(c, cplx.as_block(x[:, b * block:(b + 1) * block]))
        parts.append(np.asarray(y))
    got = np.concatenate(parts, axis=-1)

    whole = Pipeline(_stages(mode, order, decim), optimize=False)
    whole.bind(StreamSpec(np.complex64, fs, N_BLOCKS * block,
                          channels=(n_ch,)))
    _, one = whole.apply(whole.init_carry(), cplx.as_block(x))
    _close(np.asarray(one), got, min_snr)

    ref = np.stack([model_chain(streamed.stages, x[c]) for c in range(n_ch)])
    _close(ref, got, min_snr)


@pytest.mark.parametrize("mode,order,decim,block,n_ch", CASES)
def test_fused_streams_like_unfused(rng, mode, order, decim, block, n_ch):
    _check(rng, mode, order, decim, block, n_ch, 40.0)


@pytest.mark.parametrize("order,decim,block,n_ch", USB_CASES)
def test_usb_fused_streams_like_unfused(rng, order, decim, block, n_ch):
    _check(rng, "usb", order, decim, block, n_ch, 45.0)
