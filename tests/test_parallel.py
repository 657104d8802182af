"""Multi-device sharding tests on the 8-device virtual CPU mesh:
halo-exchange FIR, GSPMD-auto pipeline sharding, and the sharded wideband
channelizer+demod pipeline (SURVEY.md section 2.9 build targets)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libsdr_tpu import Pipeline, StreamSpec
from libsdr_tpu.core import cplx
from libsdr_tpu.ops import FMDemod, IQBaseBand, firdesign
from libsdr_tpu.ops.channelizer import Channelizer
from libsdr_tpu.ops.fir import FIRFilter, fir_overlap_save
from libsdr_tpu.ops import siggen
from libsdr_tpu.parallel.halo import fir_overlap_save_sharded
from libsdr_tpu.parallel.mesh import make_mesh, shard_pipeline_step
from libsdr_tpu.parallel.wideband import build_wideband_step

from tests.conftest import snr_db

N_DEV = 8


def _mesh1d(n=N_DEV, name="d"):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def test_halo_fir_matches_single_device(rng):
    """Time-sharded overlap-save FIR == single-device FIR, across multiple
    carried blocks."""
    mesh = _mesh1d()
    taps = firdesign.lowpass(33, 4000, 48000).astype(np.float32)
    b = 1024  # global block; 128 per device
    x = rng.normal(size=(3 * b,)).astype(np.float32)

    def sharded_step(tail, xg):
        return fir_overlap_save_sharded(taps, xg, tail, "d")

    smap = jax.jit(jax.shard_map(
        sharded_step, mesh=mesh,
        in_specs=(P(), P("d")), out_specs=(P("d"), P()),
        check_vma=False,
    ))

    tail = jnp.zeros(32, jnp.float32)
    got = []
    for i in range(3):
        xg = jax.device_put(jnp.asarray(x[i * b:(i + 1) * b]),
                            NamedSharding(mesh, P("d")))
        y, tail = smap(tail, xg)
        got.append(np.asarray(y))
    got = np.concatenate(got)

    ref_tail = jnp.zeros(32, jnp.float32)
    want = []
    for i in range(3):
        y, ref_tail = fir_overlap_save(taps, jnp.asarray(x[i * b:(i + 1) * b]),
                                       ref_tail)
        want.append(np.asarray(y))
    np.testing.assert_allclose(got, np.concatenate(want), atol=1e-5)


def test_gspmd_pipeline_matches_single_device(rng):
    """The GSPMD-auto sharded FM bank == the unsharded pipeline."""
    n_ch, fs, b = 16, 64000.0, 2048
    x = (rng.normal(size=(n_ch, b)) + 1j * rng.normal(size=(n_ch, b))
         ).astype(np.complex64)

    def build():
        p = Pipeline([IQBaseBand(fc=8000, width=10000, order=16, decim=4,
                                 design="textbook"), FMDemod()])
        p.bind(StreamSpec(np.complex64, fs, b, channels=(n_ch,)))
        return p

    p1 = build()
    c1, y1 = p1.apply(p1.init_carry(), cplx.as_block(x))

    p2 = build()
    mesh = make_mesh(n_channel=4, n_time=2)
    step, place, carry = shard_pipeline_step(p2, mesh)
    c2, y2 = step(carry, place(x))
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), atol=2e-4)


@pytest.fixture
def pll_kernel_interpret(monkeypatch):
    """Dispatch the bit-sync PLL to its Pallas kernel (interpret mode) as
    on a GPU backend, so the CPU mesh runs the kernel's program structure."""
    import functools

    from libsdr_tpu.ops import bitsync
    from libsdr_tpu.ops.pll_triton import pll_triton

    monkeypatch.setattr(bitsync, "use_kernel",
                        lambda: not bitsync._KERNEL_OFF)
    monkeypatch.setattr(bitsync, "pll_triton",
                        functools.partial(pll_triton, interpret=True))


def _pager_chain():
    from libsdr_tpu.ops import ASKDetector, BitStream

    return [IQBaseBand(fc=24e3, width=12.5e3, order=48, out_rate=48e3,
                       design="textbook"),
            FMDemod(), ASKDetector(invert=True),
            BitStream(1200.0, mode="normal")]


def test_gspmd_step_never_traces_pallas(rng, pll_kernel_interpret):
    """A pallas_call has no GSPMD partitioning rule: on a >1-device mesh
    XLA would wrap it in an all-gather of the full operands (or fail to
    compile).  shard_pipeline_step therefore keeps the PLL kernel out of
    the partitioned trace (ops/bitsync.kernel_mode('off')).  Assert it
    structurally: with the kernel dispatched, the sharded step's jaxpr
    contains NO pallas_call, while the same pipeline traced unsharded
    contains one."""
    import jax

    n_ch, fs, b = 128, 192_000.0, 16384
    x = (rng.normal(size=(n_ch, b)) + 1j * rng.normal(size=(n_ch, b))
         ).astype(np.complex64)

    def build():
        p = Pipeline(_pager_chain())
        p.bind(StreamSpec(np.complex64, fs, b, channels=(n_ch,)))
        return p

    p1 = build()
    solo = jax.make_jaxpr(p1.apply)(p1.init_carry(), cplx.as_block(x))
    assert "pallas_call" in str(solo), "fixture lost its kernel path"

    p2 = build()
    mesh = make_mesh(n_channel=4, n_time=2)
    step, place, carry = shard_pipeline_step(p2, mesh)
    sharded = jax.make_jaxpr(
        lambda c, xx: step.__wrapped__(c, xx))(carry, place(x))
    assert "pallas_call" not in str(sharded)


def test_shard_map_pipeline_keeps_kernels_bitexact(rng, pll_kernel_interpret):
    """shard_map_pipeline_step is the kernel-capable alternative to the
    GSPMD path for CHANNELWISE pipelines: each device runs the PLL kernel
    on its own channel group (device-local operands — the sharding under
    which a pallas_call is legal), the sharded jaxpr CONTAINS the
    pallas_call the GSPMD path must strip, and the bits are identical to
    the n=1 run."""
    import jax

    from libsdr_tpu.parallel.mesh import shard_map_pipeline_step

    n_ch, fs, b, n_dev = 256, 192_000.0, 8192, 8
    x = (rng.normal(size=(n_ch, b)) + 1j * rng.normal(size=(n_ch, b))
         ).astype(np.complex64)
    outs = {}
    for n in (1, n_dev):
        p = Pipeline(_pager_chain())
        p.bind(StreamSpec(np.complex64, fs, b, channels=(n_ch,)))
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("ch",))
        step, place, carry = shard_map_pipeline_step(p, mesh)
        if n > 1:
            jx = jax.make_jaxpr(
                lambda c, xx: step.__wrapped__(c, xx))(carry, place(x))
            assert "pallas_call" in str(jx), \
                "kernel did not survive the shard_map trace"
        _, y = step(carry, place(x))
        outs[n] = (np.asarray(y.data), np.asarray(y.valid))
    np.testing.assert_array_equal(outs[1][1], outs[n_dev][1])
    np.testing.assert_array_equal(outs[1][0] * outs[1][1],
                                  outs[n_dev][0] * outs[n_dev][1])


def test_wideband_sharded_pipeline():
    """Sharded channelizer+demod == local channelizer+demod, and an FM tone
    in channel c demodulates correctly."""
    mesh = _mesh1d()
    m, b = 16, 16 * 512 * N_DEV  # channels, global block
    fs = 1_024_000.0
    step, init_carry, place = build_wideband_step(mesh, m, b)

    # FM-modulate a 1 kHz tone in channel 5 (center 5*fs/M).
    n = 2 * b
    audio = siggen.sine(fs, n, 1000.0, amps=0.7)
    iq = siggen.fm_modulate(fs, audio, deviation=8000.0,
                            carrier=5 * fs / m).astype(np.complex64)

    carry = init_carry()
    outs = []
    for i in range(2):
        carry, y = step(carry, place(iq[i * b:(i + 1) * b]))
        outs.append(np.asarray(y))
    y = np.concatenate(outs, axis=-1)
    assert y.shape == (m, n // m)

    # Channel 5 demodulates to the 1 kHz tone.  (Empty channels demodulate
    # to full-scale angle noise, so tone presence is a spectral check on the
    # target channel, not a power comparison.)
    ch_rate = fs / m
    seg = y[5][m:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / ch_rate)
    spec[freqs < 100] = 0
    peak = freqs[np.argmax(spec)]
    assert abs(peak - 1000.0) < 30, peak
    # and the tone is coherent: strong line vs median bin
    assert spec.max() > 50 * np.median(spec)


def test_wideband_matches_local_channelizer(rng):
    """Bit-level check of the sharded channelizer stage vs the Processor."""
    mesh = _mesh1d()
    m, p = 8, 8
    b = 16 * m * N_DEV  # 16 frames/device (the halo needs P+1 = 9)
    fs = 64000.0
    x = (rng.normal(size=(2 * b,)) + 1j * rng.normal(size=(2 * b,))
         ).astype(np.complex64)

    step, init_carry, place = build_wideband_step(mesh, m, b, taps_per_branch=p)
    carry = init_carry()
    got = []
    for i in range(2):
        carry, y = step(carry, place(x[i * b:(i + 1) * b]))
        got.append(np.asarray(y))
    got = np.concatenate(got, axis=-1)

    chan = Channelizer(n_channels=m, taps_per_branch=p)
    chan.bind(StreamSpec(np.complex64, fs, b))
    fm = FMDemod()
    fm.bind(chan.out_spec)
    cc, cf = chan.init_carry(), fm.init_carry()
    want = []
    for i in range(2):
        cc, yc = chan.apply(cc, cplx.as_block(x[i * b:(i + 1) * b]))
        cf, ya = fm.apply(cf, yc)
        want.append(np.asarray(ya))
    want = np.concatenate(want, axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_wideband_fm_local_matches_channelizer_fm(rng):
    """The scanner's fused-stage body (parallel/wideband.wideband_fm_local:
    channelize + discriminator in time-major channel order) streams
    bit-identically to the Channelizer -> FMDemod pipeline."""
    from libsdr_tpu.parallel.wideband import _taps, wideband_fm_local

    m, p, b = 16, 8, 16 * 64
    x = (rng.normal(size=3 * b) + 1j * rng.normal(size=3 * b)
         ).astype(np.complex64)
    pipe = Pipeline([Channelizer(m, taps_per_branch=p), FMDemod()])
    pipe.bind(StreamSpec(np.complex64, m * 25_000.0, b))
    pc = pipe.init_carry()
    hist = cplx.zeros((p, m))
    prev = cplx.full_like_phasor((1, m))
    taps = _taps(m, p)
    for i in range(3):
        xb = cplx.as_block(x[i * b:(i + 1) * b])
        pc, want = pipe.apply(pc, xb)
        audio, prev = wideband_fm_local(xb, hist, prev, taps, m, p)
        hist = xb[(b // m - p) * m:].reshape((p, m))
        np.testing.assert_array_equal(np.asarray(audio).T, np.asarray(want))


@pytest.mark.parametrize("p", [3, 8])
def test_wideband_multidevice_bitexact_fallback(p):
    """n=8 vs n=1: bit-exact on the CPU (covers the halo, the ppermuted
    neighbor-computed discriminator seed, and the all_to_all reshard) —
    at the default
    polyphase depth and an odd one (the seed recompute spans P+1 frames
    of the local tail)."""
    m, n_dev = 16, 8
    block = m * n_dev * 16
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2 * block,)) + 1j * rng.normal(size=(2 * block,))
         ).astype(np.complex64)

    outs = {}
    for n in (1, n_dev):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
        step, init_carry, place = build_wideband_step(mesh, m, block,
                                                      taps_per_branch=p)
        c = init_carry()
        got = []
        for i in range(2):
            c, y = step(c, place(x[i * block:(i + 1) * block]))
            got.append(np.asarray(y))
        outs[n] = np.concatenate(got, axis=-1)
    np.testing.assert_array_equal(outs[1], outs[n_dev])


def _collective_inventory(compiled_text):
    """Parse collective defs from optimized HLO: [(op, out_bytes)]."""
    import re

    sizes = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "s8": 1, "u8": 1,
             "pred": 1, "f64": 8}
    out = []
    for line in compiled_text.splitlines():
        mo = re.search(r"=\s+(\w+)\[([\d,]*)\][^=]*"
                       r"\b(all-to-all|collective-permute|all-gather|"
                       r"all-reduce|reduce-scatter)\(", line)
        if mo and "get-tuple" not in line:
            dt, dims, op = mo.group(1), mo.group(2), mo.group(3)
            n = int(np.prod([int(d) for d in dims.split(",") if d] or [1]))
            out.append((op, n * sizes.get(dt, 4)))
        elif re.search(r"=\s+\(.*\)\s+(all-to-all|all-reduce)\(", line):
            # tuple-shaped collective (one per-plane operand group)
            op = re.search(r"(all-to-all|all-reduce)\(", line).group(1)
            out.append((op, None))
    return out


def test_scanner_compact_window_lossless():
    """compact_window > 0 losslessly decimates the scanner's bit stream on
    device: the per-channel compacted bit SEQUENCES equal the unwindowed
    path's, on both the n=1 lane-major path and the n=8 sharded path."""
    from libsdr_tpu.parallel.wideband import build_scanner_step

    m, n_dev = 16, 8
    fs = m * 25_000.0
    block = m * n_dev * 64
    rng = np.random.default_rng(5)
    x = (rng.normal(size=block) + 1j * rng.normal(size=block)
         ).astype(np.complex64) * 0.4

    def bits_of(n, w):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
        step, init_carry, place = build_scanner_step(
            mesh, m, block, fs, compact_window=w)
        c, y = step(init_carry(), place(x))
        data, valid = np.asarray(y.data), np.asarray(y.valid)
        return [data[ch][valid[ch]] for ch in range(m)]

    ref = bits_of(1, 0)
    assert any(len(b) for b in ref)
    for n in (1, n_dev):
        got = bits_of(n, 16)
        for ch in range(m):
            np.testing.assert_array_equal(got[ch], ref[ch]), ch

    with pytest.raises(ValueError):
        build_scanner_step(Mesh(np.asarray(jax.devices()[:1]), ("d",)),
                           m, block, fs, compact_window=64)  # > PLL gap


def test_scanner_packed_output_matches_ragged():
    """packed=True returns ONE uint8 array (bit 0 = data, bit 1 = valid)
    equal to the Ragged pair, on both the n=1 lane-major path and the n=8
    sharded path — half the readback bytes, same bits."""
    from libsdr_tpu.parallel.wideband import build_scanner_step

    m, n_dev = 16, 8
    fs = m * 25_000.0
    block = m * n_dev * 64
    rng = np.random.default_rng(7)
    x = (rng.normal(size=block) + 1j * rng.normal(size=block)
         ).astype(np.complex64) * 0.4

    for n in (1, n_dev):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
        outs = {}
        for packed in (False, True):
            step, init_carry, place = build_scanner_step(
                mesh, m, block, fs, compact_window=16, packed=packed)
            _, y = step(init_carry(), place(x))
            outs[packed] = y
        r, pk = outs[False], np.asarray(outs[True])
        np.testing.assert_array_equal(np.asarray(r.data), pk & 1)
        np.testing.assert_array_equal(np.asarray(r.valid), pk >= 2)


def test_min_valid_gap_matches_brute_force_pll():
    """min_valid_gap is floor(1/omega_max), NOT ceil: after an emission the
    PLL's residual phase is strictly below omega_max, so the next bit can
    land one sample sooner than ceil predicts.  At constant omega the
    emission recurrence (phase += om; emit & wrap at 1.0) has closed form —
    emission k of integer crossing m happens at k = ceil((m - r0)/om) — so
    brute-force every residual: no observed gap may be below the bound, and
    the bound must be TIGHT (observed) so the compaction window is not
    undersized either."""
    from libsdr_tpu.core.ragged import min_valid_gap

    for fs_ch, baud in ((38_400.0, 1200.0), (25_000.0, 1200.0),
                        (48_000.0, 1200.0), (9_600.0, 300.0)):
        om = (baud / fs_ch) * 1.005
        gap = min_valid_gap(om)
        crossings = np.arange(1, 2000, dtype=np.float64)
        observed = set()
        # residual r0 in [0, om): include the near-om extreme that breaks
        # the ceil bound.
        for r0 in np.concatenate([np.linspace(0.0, om, 64, endpoint=False),
                                  [om * (1 - 1e-12)]]):
            ks = np.ceil((crossings - r0) / om).astype(np.int64)
            observed.update(np.unique(np.diff(ks)).tolist())
        assert min(observed) == gap, (fs_ch, baud, gap, sorted(observed))


def test_scanner_window_respects_corrected_gap():
    """The rtl_sdr-class config (fs_ch=38.4 kHz, 1200 baud) has
    1/omega_max = 31.84: the guaranteed gap is 31, so compact_window=32
    (which the stale ceil bound accepted) must be REJECTED — two bits 31
    apart could share one 32-sample window and merge."""
    from libsdr_tpu.core.ragged import min_valid_gap
    from libsdr_tpu.parallel.wideband import build_scanner_step

    m = 16
    fs = m * 38_400.0
    assert min_valid_gap((1200.0 / 38_400.0) * 1.005) == 31
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("d",))
    with pytest.raises(ValueError):
        build_scanner_step(mesh, m, m * 1024, fs, compact_window=32)
    build_scanner_step(mesh, m, m * 1024, fs, compact_window=16)  # ok


def test_hot_path_collective_inventory():
    """Hardware-free scale-out evidence: the compiled 8-device wideband and
    scanner steps carry EXACTLY the designed collectives on the hot path —
    one all_to_all of the decimated audio, one ppermute halo per complex
    plane plus one TINY (1, M) seed ppermute per plane (the neighbor's
    last channelizer output — the shard-boundary discriminator seed), and
    small-state all-gathers only (carry tails, <1% of the block
    bytes).  No all-reduce, no bulk-data all-gather: nothing re-replicates
    the wideband stream, so per-device work stays 1/n of the block and the
    interconnect carries ~1x the (decimated) audio bytes per step."""
    from libsdr_tpu.parallel.wideband import build_scanner_step

    m, n, p = 16, 8, 8
    block = m * n * 16
    block_bytes = block * 8
    # All-gathers may only move carry-scale state: the (P+1)-frame tail and
    # the (1, M) discriminator seed, each gathered across n devices per
    # plane — BLOCK-INDEPENDENT, so at production block sizes (2^24) they
    # are <0.01% of the stream.  Anything block-proportional would show up
    # as >> this bound.
    carry_bound = n * (p + 2) * m * 4 * 2
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))

    step, init_carry, place = build_wideband_step(mesh, m, block)
    x = place(np.zeros(block, np.complex64))
    txt = step.lower(init_carry(), x).compile().as_text()
    inv = _collective_inventory(txt)
    by_op = {}
    for op, nbytes in inv:
        by_op.setdefault(op, []).append(nbytes)
    assert len(by_op.get("all-to-all", [])) == 1, inv
    # 2 halo planes (P frames) + 2 seed planes (1 frame)
    perms = sorted(by_op.get("collective-permute", []))
    assert len(perms) == 4, inv
    assert perms[0] == perms[1] == m * 4, inv          # (1, M) seed planes
    assert "all-reduce" not in by_op, inv
    for nbytes in by_op.get("all-gather", []):
        assert nbytes is not None and nbytes <= carry_bound, inv

    sstep, sinit, splace = build_scanner_step(mesh, m, block, m * 25_000.0)
    txt = sstep.lower(sinit(), splace(np.zeros(block, np.complex64))
                      ).compile().as_text()
    inv = _collective_inventory(txt)
    by_op = {}
    for op, nbytes in inv:
        by_op.setdefault(op, []).append(nbytes)
    assert len(by_op.get("all-to-all", [])) == 1, inv
    perms = sorted(by_op.get("collective-permute", []))
    assert len(perms) == 4 and perms[0] == perms[1] == m * 4, inv
    assert "all-reduce" not in by_op, inv
    for nbytes in by_op.get("all-gather", []):
        assert nbytes is not None and nbytes <= carry_bound, inv

    # Multi-mode bank: same structure, but the all_to_all reshards the
    # COMPLEX channel bank (the mode chains need it) — up to one per plane
    # (XLA may combine them), ppermute halo per plane, no all-reduce, and
    # all-gathers bounded by carry-scale state.
    from libsdr_tpu.parallel.multimode import build_multimode_step

    mstep, minit, mplace, _ = build_multimode_step(
        mesh, m, block, m * 24_000.0, ("pocsag", "ax25"))
    txt = mstep.lower(minit(), mplace(np.zeros(block, np.complex64))
                      ).compile().as_text()
    inv = _collective_inventory(txt)
    by_op = {}
    for op, nbytes in inv:
        by_op.setdefault(op, []).append(nbytes)
    assert 1 <= len(by_op.get("all-to-all", [])) <= 2, inv
    assert len(by_op.get("collective-permute", [])) == 2, inv
    assert "all-reduce" not in by_op, inv
    for nbytes in by_op.get("all-gather", []):
        assert nbytes is not None and nbytes <= carry_bound, inv


def test_sharded_multimode_matches_single_device():
    """The sharded multi-mode bank (time-sharded channelizer -> all_to_all
    complex reshard -> channel-sharded POCSAG/AX.25/RTTY/PSK31 chains)
    produces bit-identical outputs to the n=1 path over chained blocks."""
    import jax
    from jax.sharding import Mesh
    from libsdr_tpu.parallel.multimode import build_multimode_step

    m, n_dev = 32, 8
    fs = m * 24_000.0
    t_full = 576                      # % 12 == 0 (PSK31), /8 >= P+1 frames
    block = m * t_full
    pattern = ("pocsag", "ax25", "rtty", "psk31")
    rng = np.random.default_rng(7)
    blocks = [(rng.normal(size=block) + 1j * rng.normal(size=block)
               ).astype(np.complex64) * 0.3 for _ in range(2)]

    outs = {}
    for n in (1, n_dev):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
        step, init_carry, place, groups = build_multimode_step(
            mesh, m, block, fs, pattern)
        c = init_carry()
        per_block = []
        for x in blocks:
            c, o = step(c, place(x))
            per_block.append({mode: (np.asarray(r.data), np.asarray(r.valid))
                              for mode, r in o.items()})
        outs[n] = (per_block, groups)

    g1, gn = outs[1][1], outs[n_dev][1]
    for mode in pattern:
        np.testing.assert_array_equal(g1[mode], gn[mode])
        # round-robin pattern -> ascending global channel indices
        assert list(g1[mode]) == sorted(g1[mode])
        for b in range(2):
            d1, v1 = outs[1][0][b][mode]
            dn, vn = outs[n_dev][0][b][mode]
            np.testing.assert_array_equal(v1, vn)
            np.testing.assert_array_equal(d1 * v1, dn * vn)


def test_multimode_shard_map_runs_real_kernel_interpret(pll_kernel_interpret):
    """The n=8 multimode body executes the PLL Pallas kernel (interpret
    mode) on each device's stacked BitStream lanes — bit-identical to the
    n=1 kernel run and to the n=8 scan."""
    from jax.sharding import Mesh
    from libsdr_tpu.ops.bitsync import kernel_mode
    from libsdr_tpu.parallel.multimode import build_multimode_step

    m, n_dev = 64, 8
    fs = m * 24_000.0
    t_full = 128
    block = m * t_full
    pattern = ("pocsag", "ax25")
    rng = np.random.default_rng(3)
    x = (rng.normal(size=block) + 1j * rng.normal(size=block)
         ).astype(np.complex64) * 0.4

    outs = {}
    for label, n, mode in (("k1", 1, "auto"), ("k8", n_dev, "auto"),
                           ("s8", n_dev, "off")):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
        with kernel_mode(mode):
            step, init_carry, place, _ = build_multimode_step(
                mesh, m, block, fs, pattern)
            c = init_carry()
            if label == "k8":
                jx = jax.make_jaxpr(step)(c, place(x))
                assert "pallas_call" in str(jx)
            c, o = step(c, place(x))
        outs[label] = {md: (np.asarray(r.data), np.asarray(r.valid))
                       for md, r in o.items()}
    for md in pattern:
        for other in ("k1", "s8"):
            np.testing.assert_array_equal(outs[other][md][1],
                                          outs["k8"][md][1])
            np.testing.assert_array_equal(
                outs[other][md][0] * outs[other][md][1],
                outs["k8"][md][0] * outs["k8"][md][1])


def test_sharded_multimode_decodes_mixed_band():
    """END-TO-END over the 8-device mesh via the public app API
    (apps/multimode.scan_multimode_sharded): a TX-synthesized mixed band
    through the sharded bank decodes all four modes (POCSAG page,
    AX.25/APRS position frame, RTTY text, PSK31 text) on the right
    channels."""
    import jax
    from libsdr_tpu.apps.multimode import scan_multimode_sharded
    from tests.test_apps import make_mixed_band

    m, n_dev = 32, 8
    fs = m * 24_000.0
    pattern = ("pocsag", "ax25", "rtty", "psk31")
    # active channels chosen so mode == pattern[ch % 4]
    active = {4: "pocsag", 9: "ax25", 14: "rtty", 19: "psk31"}
    wide = make_mixed_band(active, m)

    found = scan_multimode_sharded(wide, fs, m, pattern, block=m * 4608,
                                   devices=jax.devices()[:n_dev])
    decoded = {ch: out for ch, (mode, out) in found.items()}

    msgs = decoded[4]
    assert msgs[0].address == 99 and msgs[0].as_text().startswith("MIXED")
    frames = decoded[9]
    assert frames and frames[0][0].frm.call == "K3MM"
    assert frames[0][1] is not None          # APRS position parsed
    assert "MULTI" in decoded[14]
    assert "cq sdr" in decoded[19]
    # No silence assertion for the other channels: the noise-free fixture's
    # square-FSK splatter is CORRELATED leakage, which the unsquelched
    # demod chains happily decode on other channels too (the single-chip
    # bank behaves identically on this fixture — verified bit-exact).


def test_sharded_multimode_bf16_wire(tmp_path):
    """The u8 wire -> bf16-plane ingest path reaches the SHARDED multi-mode
    bank's PFB front end unconverted (multimode --pattern --bf16; u8 ->
    bf16 is lossless) and all four modes still decode."""
    from libsdr_tpu.apps import multimode
    from tests.test_apps import make_mixed_band

    m = 32
    fs = m * 24_000.0
    active = {4: "pocsag", 9: "ax25", 14: "rtty", 19: "psk31"}
    wide = 0.45 * make_mixed_band(active, m)     # headroom: no u8 clipping
    inter = np.empty(2 * wide.size, np.float32)
    inter[0::2] = wide.real
    inter[1::2] = wide.imag
    u8 = np.clip(np.round(inter * 128.0 + 128.0), 0, 255).astype(np.uint8)
    cap = tmp_path / "wire.u8"
    u8.tofile(cap)

    found = multimode.main(["--raw", str(cap), "--rate", str(int(fs)),
                            "--channels", str(m), "--bf16",
                            "--pattern", "pocsag,ax25,rtty,psk31"])
    decoded = {ch: out for ch, (mode, out) in found.items()}
    msgs = decoded[4]
    assert msgs[0].address == 99 and msgs[0].as_text().startswith("MIXED")
    frames = decoded[9]
    assert frames and frames[0][0].frm.call == "K3MM"
    assert "MULTI" in decoded[14]
    assert "cq sdr" in decoded[19]


def test_sharded_scanner_matches_single_device():
    """The fully sharded scanner step (time-sharded channelizer ->
    all_to_all -> channel-sharded FM + ASK + bit-sync PLL) produces
    bit-identical PLL output to the n=1 path on the same wideband block."""
    import jax
    from jax.sharding import Mesh
    from libsdr_tpu.parallel.wideband import build_scanner_step

    m, n_dev = 16, 8
    fs = m * 25_000.0
    block = m * n_dev * 64 * 4
    rng = np.random.default_rng(11)
    x = (rng.normal(size=block) + 1j * rng.normal(size=block)
         ).astype(np.complex64) * 0.3

    outs = {}
    for n in (1, n_dev):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
        step, init_carry, place = build_scanner_step(mesh, m, block, fs)
        c = init_carry()
        c, bits = step(c, place(x))
        outs[n] = (np.asarray(bits.data), np.asarray(bits.valid))
    np.testing.assert_array_equal(outs[1][0] * outs[1][1],
                                  outs[n_dev][0] * outs[n_dev][1])
    np.testing.assert_array_equal(outs[1][1], outs[n_dev][1])
