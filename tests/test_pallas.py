"""The bit-sync PLL Pallas kernel (ops/pll_triton.py) on the CPU, in
interpret mode, held bit-exact to the ``lax.scan`` reference; and the
dispatch that chooses between them.  The compiled kernel runs on the card
in tests/test_gpu.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libsdr_tpu import StreamSpec
from libsdr_tpu.core.stream import ConfigError
from libsdr_tpu.ops import bitsync
from libsdr_tpu.ops.bitsync import BitStream, majority, pll_scan
from libsdr_tpu.ops.pll_triton import LANES, UNROLL, pll_triton

pll_interpret = functools.partial(pll_triton, interpret=True)


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """Route :func:`bitsync.pll` to the kernel, run in interpret mode."""
    monkeypatch.setattr(bitsync, "use_kernel",
                        lambda: not bitsync._KERNEL_OFF)
    monkeypatch.setattr(bitsync, "pll_triton", pll_interpret)


def _bound(m, t, mode="normal", baud=1200.0, fs=24_000.0, time_major=True):
    bs = BitStream(baud, mode=mode, time_major=time_major)
    bs.bind(StreamSpec(np.uint8, fs, t, channels=(m,)))
    return bs


def _pll_args(rng, m, t, mode):
    """Majority codes of random symbols plus a mid-stream PLL state."""
    bs = _bound(m, t, mode)
    L = bs.corr_len
    sym = rng.integers(0, 2, size=(t, m)).astype(np.uint8)
    code, _, _ = majority(jnp.zeros((L - 1, m), jnp.int32),
                          jnp.zeros(m, jnp.int32), jnp.asarray(sym), L)
    phase = jnp.asarray(rng.random(m), jnp.float32)
    omega = jnp.full(m, bs._omega0, jnp.float32)
    last_bits = jnp.asarray(rng.integers(0, 1 << 16, m), jnp.int32)
    return (code, phase, omega, last_bits) + tuple(
        jnp.asarray(p) for p in bs.lane_params(m))


@pytest.mark.parametrize("t", [UNROLL - 6, 12 * UNROLL + 5])
@pytest.mark.parametrize("lanes", [1, 64, 200, 1024])
@pytest.mark.parametrize("mode", ["normal", "transition"])
def test_pll_kernel_interpret_bit_exact(rng, mode, lanes, t):
    """Bits, valid flags and the carried state equal the scan's, for lane
    counts that fill, pad and under-fill a lane block and for step counts
    shorter than and not a multiple of the unrolled group."""
    args = _pll_args(rng, lanes, t, mode)
    got = pll_interpret(*args)
    ref = jax.jit(pll_scan)(*args)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pallas_bitsync_kernel_matches_scan(rng, kernel_on_cpu):
    """BitStream through the kernel (interpret) equals BitStream through
    the scan across two chained blocks, both modes (reference recurrence:
    src/fsk.cc:157-202)."""
    T, M = 512, 256
    blocks = [rng.integers(0, 2, size=(T, M)).astype(np.uint8)
              for _ in range(2)]
    for mode in ("normal", "transition"):
        outs = {}
        for path in ("auto", "off"):
            bs = _bound(M, T, mode)
            c = bs.init_carry()
            got = []
            with bitsync.kernel_mode(path):
                for blk in blocks:
                    c, r = bs.apply(c, jnp.asarray(blk))
                    got.append((np.asarray(r.data), np.asarray(r.valid)))
            outs[path] = (got, c)
        for (da, va), (db, vb) in zip(outs["auto"][0], outs["off"][0]):
            np.testing.assert_array_equal(da, db)
            np.testing.assert_array_equal(va, vb)
        for k in outs["auto"][1]:
            np.testing.assert_array_equal(np.asarray(outs["auto"][1][k]),
                                          np.asarray(outs["off"][1][k]))


def test_pll_kernel_carry_chains_three_blocks(rng, kernel_on_cpu):
    """Three blocks through the kernel with the carry chained equal one
    scan over the concatenated stream (channel-major layout)."""
    T, M = 3 * 160, 64
    x = (rng.random((M, T)) > 0.5).astype(np.uint8)
    one = _bound(M, T, time_major=False)
    with bitsync.kernel_mode("off"):
        _, ref = one.apply(one.init_carry(), jnp.asarray(x))
    bs = _bound(M, T // 3, time_major=False)
    c, data, valid = bs.init_carry(), [], []
    for i in range(3):
        c, r = bs.apply(c, jnp.asarray(x[:, i * T // 3:(i + 1) * T // 3]))
        data.append(np.asarray(r.data))
        valid.append(np.asarray(r.valid))
    np.testing.assert_array_equal(np.concatenate(valid, -1),
                                  np.asarray(ref.valid))
    np.testing.assert_array_equal(np.concatenate(data, -1),
                                  np.asarray(ref.data))


def test_bitsync_kernel_lane_padding_matches_scan(rng, kernel_on_cpu):
    """A bank whose lane count does not fill a lane block (pads inside the
    wrapper) streams bit-exactly vs the scan over two carried blocks."""
    T, M = 3 * UNROLL, LANES + 36
    blocks = [rng.integers(0, 2, size=(T, M)).astype(np.uint8)
              for _ in range(2)]
    outs = {}
    for path in ("auto", "off"):
        bs = _bound(M, T)
        c, got = bs.init_carry(), []
        with bitsync.kernel_mode(path):
            for blk in blocks:
                c, r = bs.apply(c, jnp.asarray(blk))
                got.append((np.asarray(r.data), np.asarray(r.valid)))
        outs[path] = got
    for (da, va), (db, vb) in zip(outs["auto"], outs["off"]):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(va, vb)


def test_bitstream_bank_matches_individual(rng, kernel_on_cpu):
    """One PLL over the stacked lanes of three BitStreams (per-lane
    baud/window/transition) equals each BitStream applied on its own by
    the scan — across carried blocks and with distinct majority windows
    (POCSAG/AX.25 L=20, RTTY L=264)."""
    fs, t = 24_000.0, 2048
    configs = [("pocsag", 1200.0, "normal", 48),
               ("ax25", 1200.0, "transition", 40),
               ("rtty", 2 * 45.45, "normal", 40)]
    bss = {name: _bound(nch, t, mode, baud, fs, time_major=False)
           for name, baud, mode, nch in configs}
    xs = {name: (rng.random((nch, 2 * t)) > 0.5).astype(np.uint8)
          for name, _, _, nch in configs}

    ref = {}
    with bitsync.kernel_mode("off"):
        for name, bs in bss.items():
            c, outs = bs.init_carry(), []
            for i in range(2):
                c, y = bs.apply(c, jnp.asarray(xs[name][:, i * t:(i + 1) * t]))
                outs.append((np.asarray(y.data), np.asarray(y.valid)))
            ref[name] = outs

    carries = {name: bs.init_carry() for name, bs in bss.items()}
    for i in range(2):
        res = bitsync.bitstream_bank_apply(
            [(bss[name], carries[name],
              jnp.asarray(xs[name][:, i * t:(i + 1) * t])) for name in bss])
        for name, (c, y) in zip(bss, res):
            carries[name] = c
            np.testing.assert_array_equal(ref[name][i][0], np.asarray(y.data),
                                          err_msg=f"{name} block {i} bits")
            np.testing.assert_array_equal(ref[name][i][1],
                                          np.asarray(y.valid),
                                          err_msg=f"{name} block {i} valid")


def test_multimode_banked_step_matches_unbanked(rng, kernel_on_cpu):
    """apps/multimode.build_bank, whose three BitStreams run as ONE PLL
    (the kernel, interpret), equals each BitStream mode's pipeline applied
    on its own channel group by the scan, over two chained blocks.  (PSK31
    has no BitStream; its eager and jitted runs may differ in a last bit.)"""
    from libsdr_tpu.apps.multimode import MODES, build_bank
    from libsdr_tpu.core import cplx
    from libsdr_tpu.core.ragged import compact_windows
    from libsdr_tpu.ops.channelizer import Channelizer

    m = 16
    fs = m * 24_000.0
    t_full = 3072  # multiple of 12 (psk31 decimator) and 16
    block = m * t_full
    mode_map = {ch: MODES[ch % len(MODES)] for ch in range(m)}
    x = [cplx.Complex(
            jnp.asarray(rng.normal(size=block).astype(np.float32)),
            jnp.asarray(rng.normal(size=block).astype(np.float32)))
         for _ in range(2)]

    step, init_carry, groups = build_bank(fs, block, m, mode_map)
    c = init_carry()
    banked = []
    for blk in x:
        c, o = step(c, blk)
        banked.append(o)

    from libsdr_tpu.apps.multimode import _build_parts
    chan, sub, groups2, windows = _build_parts(fs, block, m, mode_map)
    assert isinstance(chan, Channelizer)
    cc = chan.init_carry()
    carries = {mo: p.init_carry() for mo, p in sub.items()}
    with bitsync.kernel_mode("off"):
        for i, blk in enumerate(x):
            cc, y = chan.apply(cc, blk)
            for mo, p in sub.items():
                carries[mo], bits = p.apply(carries[mo],
                                            y[np.asarray(groups2[mo])])
                if not isinstance(p.stages[-1], BitStream):
                    continue
                if windows[mo]:
                    bits = compact_windows(bits, windows[mo])
                np.testing.assert_array_equal(
                    np.asarray(bits.data), np.asarray(banked[i][mo].data),
                    err_msg=f"{mo} block {i} bits")
                np.testing.assert_array_equal(
                    np.asarray(bits.valid), np.asarray(banked[i][mo].valid),
                    err_msg=f"{mo} block {i} valid")


def _traced(bs, m, t):
    x = jnp.zeros((m, t), jnp.uint8)
    return str(jax.make_jaxpr(bs.apply)(bs.init_carry(), x))


def test_dispatch_gpu_backend_picks_kernel(monkeypatch):
    """On a GPU backend the PLL traces to the kernel (never interpret,
    never the scan)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert bitsync.use_kernel()
    jaxpr = _traced(_bound(64, 480, time_major=False), 64, 480)
    # pll_scan is the only scan with unroll=16 (the kernel's own time loop
    # is a fori_loop, i.e. a scan, inside the pallas_call)
    assert "pallas_call" in jaxpr and "unroll=16" not in jaxpr
    assert "interpret=True" not in jaxpr


def test_dispatch_cpu_backend_picks_scan():
    """On the CPU the PLL is the scan, the plain reference."""
    assert jax.default_backend() == "cpu"
    assert not bitsync.use_kernel()
    jaxpr = _traced(_bound(64, 480, time_major=False), 64, 480)
    assert "pallas_call" not in jaxpr and "unroll=16" in jaxpr


def test_dispatch_kernel_mode_off_keeps_scan_on_gpu(monkeypatch):
    """kernel_mode('off') — the guard for GSPMD-partitioned traces —
    keeps the kernel out even on a GPU backend, and restores on exit."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with bitsync.kernel_mode("off"):
        assert not bitsync.use_kernel()
        jaxpr = _traced(_bound(64, 480, time_major=False), 64, 480)
    assert "pallas_call" not in jaxpr
    assert bitsync.use_kernel()
    with pytest.raises(ConfigError):
        bitsync.kernel_mode("on")
