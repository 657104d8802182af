"""Bit-clock PLL as one Pallas kernel on the Triton route (GPU).

The PLL of :mod:`libsdr_tpu.ops.bitsync` is a recurrence over time with
three words of state per lane (phase, omega, last 16 bits).  As a
``lax.scan`` the GPU runs it as a device while-loop whose every trip
launches several kernels; here one program owns a block of lanes, keeps the
state in registers and walks the whole block of time steps itself:

- the grid runs over lane blocks (``lanes`` channels per program, one
  thread per lane), so a 1024-channel bank spreads over many SMs;
- the time loop is a ``fori_loop`` over groups of ``unroll`` steps; the
  next group's symbol rows are loaded before the current group is computed,
  so global-memory latency overlaps the serial arithmetic;
- input is the majority-vote code (bit 0 = majority bit, bit 1 = symbol
  transition, computed in XLA by :func:`~libsdr_tpu.ops.bitsync.majority`),
  output packs the sampled bit (bit 0) and its valid flag (bit 1) into one
  uint8 per step;
- ``omega_min``, ``omega_max``, ``gain`` and ``transition`` are per-lane
  inputs, so one launch serves a single :class:`BitStream` and a bank of
  differently configured ones alike.

The arithmetic is the scan's (:func:`~libsdr_tpu.ops.bitsync.pll_scan`),
op for op; ``interpret=True`` runs the same kernel on the CPU, which is how
the tests hold it bit-exact to the scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

LANES = 64     # lanes per program (two warps)
UNROLL = 16    # time steps per loop trip


def pll_step(state, code, omega_min, omega_max, gain, transition):
    """One PLL time step on a vector of lanes (reference: src/fsk.cc:
    170-198).  Shared by the kernel and the scan so the two run the same
    op sequence.  Returns (new_state, packed uint8 bit | valid << 1)."""
    phase, omega, last_bits = state
    code = code.astype(jnp.int32)
    bit_now = code & 1
    crossed = (code & 2) != 0
    # phase advance & bit sampling (src/fsk.cc:170-187)
    phase = phase + omega
    emit = phase >= 1.0
    phase = jnp.where(emit, phase - 1.0, phase)
    last_bits = jnp.where(emit, ((last_bits << 1) | bit_now) & 0xFFFF,
                          last_bits)
    bit = jnp.where(transition, (last_bits ^ (last_bits >> 1) ^ 1) & 1,
                    last_bits & 1)
    # PLL nudge on symbol transition (src/fsk.cc:189-198);
    # g*(0.5-phase) == -g*(phase-0.5) exactly in IEEE, so one expression
    # covers both halves of the reference's branch.
    omega = jnp.where(crossed, omega + gain * (0.5 - phase), omega)
    omega = jnp.minimum(jnp.maximum(omega, omega_min), omega_max)
    out = (bit | (emit.astype(jnp.int32) << 1)).astype(jnp.uint8)
    return (phase, omega, last_bits), out


def _kernel(code_ref, ph_ref, om_ref, lb_ref, omin_ref, omax_ref, gain_ref,
            tr_ref, out_ref, ph_out, om_out, lb_out, *, t_steps: int,
            lanes: int, unroll: int):
    sl = pl.ds(pl.program_id(0) * lanes, lanes)
    params = (omin_ref[sl], omax_ref[sl], gain_ref[sl], tr_ref[sl] != 0)
    state = (ph_ref[sl], om_ref[sl], lb_ref[sl])
    n_groups = t_steps // unroll

    def rows(t0):
        # Clamped: the prefetch after the last group reads valid rows it
        # never uses.
        return tuple(code_ref[jnp.minimum(t0 + r, t_steps - 1), sl]
                     for r in range(unroll))

    def group(g, carry):
        state, cur = carry
        t0 = g * unroll
        nxt = rows(t0 + unroll)
        for r in range(unroll):
            state, o = pll_step(state, cur[r], *params)
            out_ref[t0 + r, sl] = o
        return state, nxt

    if n_groups:
        state, _ = jax.lax.fori_loop(0, n_groups, group, (state, rows(0)))
    for t in range(n_groups * unroll, t_steps):
        state, o = pll_step(state, code_ref[t, sl], *params)
        out_ref[t, sl] = o
    ph_out[sl], om_out[sl], lb_out[sl] = state


@functools.partial(jax.jit, static_argnames=("interpret",))
def pll_triton(code, phase, omega, last_bits, omega_min, omega_max, gain,
               transition, *, interpret: bool = False):
    """Run the PLL over ``code`` (T, M) uint8 time-major.

    ``phase``, ``omega`` (float32), ``last_bits`` (int32) are the (M,)
    carried state; ``omega_min``, ``omega_max``, ``gain`` (float32) and
    ``transition`` (int32, nonzero = NRZI bit mapping) are (M,) per-lane
    parameters.  Returns (out (T, M) uint8 with bit 0 = bit and bit 1 =
    valid, phase, omega, last_bits).  Lanes pad to a multiple of
    :data:`LANES` (pad lanes run with zero parameters and are dropped).
    ``LANES`` and ``UNROLL`` were chosen on an H100 at 1024 lanes x 12000
    steps: {16..128} lanes x {8, 16, 32} steps all ran within 0.50-0.63 ms
    (PERF.md)."""
    lanes, unroll = LANES, UNROLL
    t, m = code.shape
    mp = -(-m // lanes) * lanes

    def pad(a):
        return a if mp == m else jnp.pad(a, [(0, 0)] * (a.ndim - 1)
                                         + [(0, mp - m)])

    args = [pad(a) for a in (code, phase, omega, last_bits, omega_min,
                             omega_max, gain, transition)]
    out, ph, om, lb = pl.pallas_call(
        functools.partial(_kernel, t_steps=t, lanes=lanes, unroll=unroll),
        out_shape=(jax.ShapeDtypeStruct((t, mp), jnp.uint8),
                   jax.ShapeDtypeStruct((mp,), jnp.float32),
                   jax.ShapeDtypeStruct((mp,), jnp.float32),
                   jax.ShapeDtypeStruct((mp,), jnp.int32)),
        grid=(mp // lanes,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, lanes // 32), num_stages=1),
        interpret=interpret,
        name="bitsync_pll",
    )(*args)
    if mp != m:
        out, ph, om, lb = out[:, :m], ph[:m], om[:m], lb[:m]
    return out, ph, om, lb
