"""The run-time scaffolding: compile-cache placement, the on-card smoke
script's refusals, and the float64 model's agreement with the per-sample
reference loops (tests/reference_model.py)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from libsdr_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path,
                                    restore_cache_config):
    """With $JAX_COMPILATION_CACHE_DIR set, the cache lands there and the
    code sets no directory of its own."""
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_config):
    """Without it, the cache is the fixed <checkout>/.jax_cache, which git
    ignores."""
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    d = compile_cache.enable_compile_cache()
    assert d == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_app_parser_turns_on_compile_cache(monkeypatch,
                                           restore_cache_config):
    """Every app's main parses through utils/options.common_parser, which
    turns the cache on."""
    from libsdr_tpu.utils.options import common_parser

    monkeypatch.delenv(compile_cache.ENV, raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    common_parser("test").parse_args([])
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        ROOT, ".jax_cache")


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_refuses_non_gpu_platform():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "needs a GPU" in r.stderr


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_model64_fm_deemph_and_agc_match_reference_loops(rng):
    """The float64 model's de-emphasis and AGC recurrences equal the
    reference's per-sample loops."""
    from libsdr_tpu import StreamSpec
    from libsdr_tpu.ops import AGC, FMDeemph
    from libsdr_tpu.utils.model64 import _stage
    from tests import reference_model as rm

    fs = 24_000.0
    x = rng.normal(size=3000)
    de = FMDeemph()
    de.bind(StreamSpec(np.float32, fs, 3000))
    np.testing.assert_allclose(_stage(de, x, 0)[0], rm.fm_deemph(x, fs),
                               rtol=1e-12, atol=1e-12)
    agc = AGC(tau=0.1)
    agc.bind(StreamSpec(np.float32, fs, 3000))
    np.testing.assert_allclose(_stage(agc, x, 0)[0], rm.agc(x, fs, 0.1),
                               rtol=1e-9, atol=1e-12)


def test_model64_iq_baseband_matches_reference_loop(rng):
    """The float64 model's IQBaseBand equals the reference's per-sample
    filter/mix/average loop, also when started mid-stream."""
    from libsdr_tpu import StreamSpec
    from libsdr_tpu.ops import IQBaseBand, firdesign
    from libsdr_tpu.utils.model64 import _stage
    from tests import reference_model as rm

    fs, n, d = 48_000.0, 2400, 4
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    bb = IQBaseBand(fc=5000.0, width=4000.0, order=16, decim=d,
                    design="textbook")
    bb.bind(StreamSpec(np.complex64, fs, n))
    k = firdesign.complex_bandpass(16, 5000.0, 4000.0, fs)
    want = rm.iq_baseband(x, k, 5000.0, fs, d)
    got, start = _stage(bb, x, 0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert start == 0
    s0 = 800
    got2, start2 = _stage(bb, x[s0:], s0)
    assert start2 == s0 // d
    # past the filter's own warm-up the mid-stream start agrees
    np.testing.assert_allclose(got2[8:], want[s0 // d + 8:], rtol=1e-9,
                               atol=1e-12)


def test_siggen_pocsag_iq_decodes(rng):
    """siggen.pocsag_iq (the smoke script's pager source) demodulates back
    to its page, started mid-capture on an offset carrier."""
    from libsdr_tpu.apps.chains import pocsag_front_end, run_bit_chain
    from libsdr_tpu.decode import pocsag_decode_bits
    from libsdr_tpu.ops import siggen

    fs = 96_000.0
    iq = siggen.pocsag_iq(fs, "SIGGEN PAGE", 321, carrier=10_000.0,
                          n=int(1.4 * fs), start=int(0.2 * fs))
    fe = pocsag_front_end(fs, 9600, fc=10_000.0)
    msgs = pocsag_decode_bits(run_bit_chain(fe, iq[:len(iq) // 9600 * 9600]))
    assert msgs and msgs[0].address == 321
    assert msgs[0].as_text().startswith("SIGGEN PAGE")
