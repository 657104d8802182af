"""Bit-clock recovery PLL (reference: src/fsk.{hh,cc} BitStream).

The reference recovers the bit clock with a per-sample PLL: a majority vote
over the last L symbols, a phase accumulator that samples a bit on overflow,
and a +-0.5% bounded frequency nudge on every symbol transition
(reference: src/fsk.cc:157-202).

Here the majority vote is data-independent of the PLL state, so it is a
vectorized windowed sum over the whole block (:func:`majority`).  What is
left is the per-lane recurrence (:func:`pll`): on the GPU one Pallas
kernel on the Triton route (ops/pll_triton.py) that keeps each lane's
state in registers and walks time inside one launch; elsewhere a
``lax.scan`` over time, the plain reference.  Both run the same step
(``pll_triton.pll_step``) and take per-lane parameters, so a bank of
differently configured BitStreams runs as one PLL over stacked lanes
(:func:`bitstream_bank_apply`).

Output is a :class:`~libsdr_tpu.core.ragged.Ragged` bit stream: one slot per
input symbol, valid where the PLL sampled a bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.ragged import Ragged
from libsdr_tpu.core.stream import ConfigError, StreamSpec
from libsdr_tpu.ops.pll_triton import pll_step, pll_triton

NORMAL = "normal"          # mark -> 1, space -> 0
TRANSITION = "transition"  # transition -> 0, no transition -> 1 (NRZI)

_KERNEL_OFF = False


class kernel_mode:
    """Context manager that keeps the PLL kernel out of a trace.

    ``kernel_mode("off")`` makes :func:`pll` take the scan while tracing.
    A ``pallas_call`` has no GSPMD partitioning rule, so a trace that XLA
    partitions over a >1-device mesh (parallel/mesh.py
    ``shard_pipeline_step``) must not contain one.  shard_map bodies see
    device-local operands and keep the kernel.  The decision is made in
    Python at trace time, so wrap the traced call::

        with kernel_mode("off"):
            jax.jit(step)(carry, x)
    """

    def __init__(self, mode: str):
        if mode not in ("auto", "off"):
            raise ConfigError(f"kernel_mode: unknown mode {mode!r}")
        self.off = mode == "off"

    def __enter__(self):
        global _KERNEL_OFF
        self._saved = _KERNEL_OFF
        _KERNEL_OFF = self.off
        return self

    def __exit__(self, *exc):
        global _KERNEL_OFF
        _KERNEL_OFF = self._saved
        return False


def use_kernel() -> bool:
    """Whether :func:`pll` runs the Triton kernel in the current trace:
    on a GPU backend, unless :class:`kernel_mode` turned it off."""
    return not _KERNEL_OFF and jax.default_backend() == "gpu"


def majority(signs, sym_sum, x_t, corr_len: int):
    """Majority vote over the last ``corr_len`` symbols (src/fsk.cc:
    163-168), vectorized over a block.

    ``x_t`` (T, M) uint8 symbols time-major; ``signs`` (L-1, M) int32 the
    previous block's last signs (oldest first); ``sym_sum`` (M,) the
    previous windowed sum.  The ring of the last L signs reduces to a
    length-L moving sum, exact in int32 via the cumsum difference; the
    zero-initialized ring is the zero signs carry.  Returns (code (T, M)
    uint8 with bit 0 = majority bit and bit 1 = majority transition,
    new_signs, new_sym_sum)."""
    L = corr_len
    new = jnp.where(x_t > 0, 1, -1).astype(jnp.int32)
    signs_c = jnp.concatenate([signs, new], axis=0)
    cs = jnp.cumsum(signs_c, axis=0)
    sym_sum_t = cs[L - 1:] - jnp.concatenate(
        [jnp.zeros_like(cs[:1]), cs[:-L]], axis=0)
    last_sum_t = jnp.concatenate([sym_sum[None], sym_sum_t[:-1]], axis=0)
    crossed = ((last_sum_t < 0) & (sym_sum_t >= 0)) | \
              ((last_sum_t >= 0) & (sym_sum_t < 0))
    code = ((sym_sum_t > 0).astype(jnp.uint8)
            | (crossed.astype(jnp.uint8) << 1))
    return code, signs_c[signs_c.shape[0] - (L - 1):], sym_sum_t[-1]


def pll_scan(code, phase, omega, last_bits, omega_min, omega_max, gain,
             transition):
    """The PLL as a ``lax.scan`` over time: the plain reference of the
    kernel, same arguments and results as :func:`pll_triton.pll_triton`."""
    params = (omega_min, omega_max, gain, transition != 0)

    def step(state, c):
        return pll_step(state, c, *params)

    # unroll cuts the sequential-loop bookkeeping per step.
    (phase, omega, last_bits), out = jax.lax.scan(
        step, (phase, omega, last_bits), code, unroll=16)
    return out, phase, omega, last_bits


def pll(code, phase, omega, last_bits, omega_min, omega_max, gain,
        transition):
    """The PLL over ``code`` (T, M): the Triton kernel on the GPU, the
    scan elsewhere (see :func:`use_kernel`)."""
    f = pll_triton if use_kernel() else pll_scan
    return f(code, phase, omega, last_bits, omega_min, omega_max, gain,
             transition)


class BitStream(Processor):
    """Args:
      baud: bit rate of the input symbol stream.
      mode: 'normal' or 'transition' (reference: src/fsk.hh:127-131).
      time_major: when True, blocks are (T, channels...) instead of
        (channels..., T) — the layout of the PLL itself, skipping two
        transposes per block.  The carry layout is unchanged.
    """

    def __init__(self, baud: float, mode: str = TRANSITION,
                 time_major: bool = False):
        super().__init__()
        if mode not in (NORMAL, TRANSITION):
            raise ValueError(f"BitStream: unknown mode {mode!r}")
        self.baud = float(baud)
        self.mode = mode
        self.time_major = bool(time_major)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_dtype("BitStream", jnp.uint8)
        fs = in_spec.rate_hz
        self.corr_len = int(fs / self.baud)       # src/fsk.cc:122
        self._omega0 = self.baud / fs             # src/fsk.cc:127
        self._omega_min = self._omega0 * (1 - 0.005)  # src/fsk.cc:129-130
        self._omega_max = self._omega0 * (1 + 0.005)
        self._pll_gain = 0.0005                   # src/fsk.cc:132
        return in_spec.with_(dtype=jnp.uint8, sample_rate=self.baud,
                             ragged=True)

    def init_carry(self):
        ch = self.in_spec.channels
        L = self.corr_len
        return dict(
            # last L-1 symbol signs + the previous windowed sum: together
            # they replace the reference's per-sample majority ring
            # (see :func:`majority`).
            signs=jnp.zeros(ch + (L - 1,), jnp.int32),
            sym_sum=jnp.zeros(ch, jnp.int32),
            phase=jnp.zeros(ch, jnp.float32),
            omega=jnp.full(ch, self._omega0, jnp.float32),
            last_bits=jnp.zeros(ch, jnp.int32),
        )

    def lane_params(self, m: int):
        """(omega_min, omega_max, gain, transition) as (m,) per-lane
        vectors for :func:`pll`."""
        return (np.full(m, self._omega_min, np.float32),
                np.full(m, self._omega_max, np.float32),
                np.full(m, self._pll_gain, np.float32),
                np.full(m, self.mode == TRANSITION, np.int32))

    def apply(self, carry, x):
        return bitstream_bank_apply([(self, carry, x)])[0]


def _to_lanes(bs: BitStream, carry, x):
    """One BitStream's block and carry as (T, m) lanes: (code, state)."""
    x_t = x if bs.time_major else jnp.moveaxis(x, -1, 0)
    t = x_t.shape[0]
    m = int(np.prod(x_t.shape[1:]))
    L = bs.corr_len
    code, signs, sym_sum = majority(
        jnp.moveaxis(carry["signs"], -1, 0).reshape(L - 1, m),
        carry["sym_sum"].reshape(m), x_t.reshape(t, m), L)
    state = tuple(carry[k].reshape(m)
                  for k in ("phase", "omega", "last_bits"))
    return code, (signs, sym_sum) + state


def _from_lanes(bs: BitStream, x, out, state):
    """Inverse of :func:`_to_lanes`: (new_carry, Ragged bits)."""
    ch = x.shape[1:] if bs.time_major else x.shape[:-1]
    t = out.shape[0]
    signs, sym_sum, phase, omega, last_bits = state
    new_carry = dict(
        signs=jnp.moveaxis(signs.reshape((bs.corr_len - 1,) + ch), 0, -1),
        sym_sum=sym_sum.reshape(ch), phase=phase.reshape(ch),
        omega=omega.reshape(ch), last_bits=last_bits.reshape(ch))
    bits = (out & 1).reshape((t,) + ch)
    valid = ((out & 2) != 0).reshape((t,) + ch)
    if bs.time_major:
        return new_carry, Ragged(bits, valid)
    return new_carry, Ragged(jnp.moveaxis(bits, 0, -1),
                             jnp.moveaxis(valid, 0, -1))


def bitstream_bank_apply(entries):
    """Run SEVERAL bound BitStreams as ONE PLL over stacked lanes.

    ``entries``: list of ``(bitstream, carry, x)``.  Returns a list of
    ``(new_carry, Ragged)`` in order, per lane bit-exact vs calling each
    ``bitstream.apply`` separately (same recurrence, per-lane parameters).
    Each entry's majority vote runs on its own window length; the PLL is
    time-sequential, so N separate runs pay N serial passes over T while
    stacked lanes pay one (one kernel launch on the GPU).  All entries
    must share the block length T."""
    lanes = [_to_lanes(bs, c, x) for bs, c, x in entries]
    if len({code.shape[0] for code, _ in lanes}) > 1:
        raise ConfigError("bitstream_bank_apply: entries differ in block "
                          "length")
    ms = [code.shape[1] for code, _ in lanes]
    params = [np.concatenate(p) for p in
              zip(*(bs.lane_params(m) for (bs, _, _), m in zip(entries, ms)))]

    def cat(parts):
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, -1)

    code = cat([c for c, _ in lanes])
    state = [cat([s[k] for _, s in lanes]) for k in range(2, 5)]
    out, *state = pll(code, *state, *params)
    results, off = [], 0
    for (bs, _, x), (_, st), m in zip(entries, lanes, ms):
        sl = slice(off, off + m)
        results.append(_from_lanes(
            bs, x, out[:, sl], st[:2] + tuple(s[sl] for s in state)))
        off += m
    return results


def apply_mode_chains(sub, carries, y, groups,
                      windows):
    """Run every mode pipeline on its channel group of the complex bank
    ``y``, merging all final BitStream PLLs into ONE PLL over stacked lanes
    (:func:`bitstream_bank_apply`): N per-mode PLLs would pay N serial
    passes over T.  Returns (outs, new_carries); shared by the single-chip
    bank (apps/multimode.py) and the shard_map body
    (parallel/multimode.py).  ``sub``: {mode: bound Pipeline};
    ``windows``: {mode: compaction window}."""
    from libsdr_tpu.core.ragged import compact_windows
    def take_rows(bank, idxs):
        # Round-robin mode patterns make each group an arithmetic
        # progression: a strided basic slice instead of a row gather.
        if len(idxs) > 1:
            d = np.diff(idxs)
            if np.all(d == d[0]) and d[0] > 0:
                s, st = int(idxs[0]), int(d[0])
                return bank[s:s + st * len(idxs):st]
        return bank[idxs]

    outs, new = {}, {}
    banked = []   # (mode, bitstream, bs_carry, symbols, new_pre_carries)
    for mode, p in sub.items():
        pc = carries[mode]
        if isinstance(p.stages[-1], BitStream):
            xm = take_rows(y, groups[mode])
            new_pre = []
            for stage, c in zip(p.stages[:-1], pc[:-1]):
                c, xm = stage.apply(c, xm)
                new_pre.append(c)
            banked.append((mode, p.stages[-1], pc[-1], xm, tuple(new_pre)))
        else:
            cg, bits = p.apply(pc, take_rows(y, groups[mode]))
            new[mode] = cg
            outs[mode] = (compact_windows(bits, windows[mode])
                          if windows[mode] else bits)
    if banked:
        results = bitstream_bank_apply(
            [(bs, c, xm) for _, bs, c, xm, _ in banked])
        for (mode, _, _, _, new_pre), (nc, bits) in zip(banked, results):
            new[mode] = new_pre + (nc,)
            outs[mode] = (compact_windows(bits, windows[mode])
                          if windows[mode] else bits)
    return outs, new
