"""Mesh + sharding helpers: run a bound Pipeline's step function SPMD over a
``jax.sharding.Mesh`` with channels sharded on one axis and the time block on
another.

Design (the "How to Scale Your Model" recipe): annotate the input block with a
NamedSharding, replicate or channel-shard the carries, and let XLA GSPMD
propagate shardings and insert the collectives (halo exchanges for the
overlap-save convolutions become collective-permutes).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libsdr_tpu.core import cplx
from libsdr_tpu.core.graph import Pipeline


def make_mesh(n_channel: int = 0, n_time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a ('ch', 'time') mesh.  ``n_channel=0`` uses all remaining
    devices on the channel axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_channel <= 0:
        n_channel = len(devices) // n_time
    devs = np.asarray(devices[:n_channel * n_time]).reshape(n_channel, n_time)
    return Mesh(devs, ("ch", "time"))


def _carry_spec(leaf, n_channels: int, axis: str) -> P:
    """THE carry-placement rule, shared by the GSPMD and shard_map paths:
    leaves whose leading dim is the channel dim shard on ``axis``;
    everything else (scalars, NCO phasors, small tails) replicates."""
    if hasattr(leaf, "ndim") and leaf.ndim >= 1 and \
            leaf.shape[0] == n_channels:
        return P(axis, *([None] * (leaf.ndim - 1)))
    return P()


def _shard_carry(carry, mesh: Mesh, n_channels: int):
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(
            leaf, NamedSharding(mesh, _carry_spec(leaf, n_channels, "ch"))),
        carry)


def shard_pipeline_step(pipeline: Pipeline, mesh: Mesh,
                        shard_time: bool = True):
    """Compile a bound pipeline into an SPMD step over ``mesh``.

    Returns (step, place_input, carry) where ``place_input`` puts a host
    block onto the mesh with (channels->'ch', time->'time') sharding and
    ``carry`` is the initial carry placed on the mesh.
    """
    in_spec = pipeline.in_spec
    assert in_spec.channels, "shard_pipeline_step needs a channel dim"
    n_ch = in_spec.channels[0]
    # Channels on 'ch', trailing time dim on 'time'.
    dims = ["ch"] + [None] * (len(in_spec.channels) - 1) + \
           (["time"] if shard_time else [None])
    block_sharding = NamedSharding(mesh, P(*dims))

    def place_input(block):
        x = cplx.as_block(block)
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, block_sharding), x)

    carry = _shard_carry(pipeline.init_carry(), mesh, n_ch)

    # GSPMD partitions this trace over the mesh.  A pallas_call has no SPMD
    # partitioning rule: on a >1-device mesh XLA would wrap it in an
    # all-gather (or fail to compile), so the bit-sync PLL kernel is kept
    # out of this trace — its scan shards cleanly.  (On multi-device meshes
    # the kernel runs via shard_map with device-local operands instead:
    # shard_map_pipeline_step below, parallel/wideband.py.)
    n_dev = int(mesh.devices.size)

    def step_fn(carry, x):
        if n_dev > 1:
            from libsdr_tpu.ops.bitsync import kernel_mode
            with kernel_mode("off"):
                return pipeline.apply(carry, x)
        return pipeline.apply(carry, x)

    step = jax.jit(step_fn)
    return step, place_input, carry


def shard_map_pipeline_step(pipeline: Pipeline, mesh: Mesh,
                            axis: str = "ch"):
    """Channel-sharded shard_map variant of :func:`shard_pipeline_step`
    that KEEPS the bit-sync PLL kernel.

    Each device runs the pipeline's step on its own channel group with
    device-local operands — the only sharding under which a ``pallas_call``
    is legal — so the kernel dispatches per shard instead of being kept
    out like in the GSPMD path above.  Valid for
    CHANNELWISE pipelines (every stage maps channels independently: the
    demod-bank chains; NOT Channelizer/Combine, whose cross-channel data
    flow needs the explicit builders in parallel/wideband.py): the body
    needs no collectives, so the step is exactly the single-chip program
    replicated per channel group.

    The pipeline stays bound to the GLOBAL channel count (taps and other
    baked constants are channel-independent for channelwise stages; the
    kernel sees the LOCAL operand shapes at trace time).  Returns
    (step, place_input, carry) like :func:`shard_pipeline_step`.
    """
    in_spec = pipeline.in_spec
    assert in_spec.channels, "shard_map_pipeline_step needs a channel dim"
    n_ch = in_spec.channels[0]
    n = int(mesh.shape[axis])
    if n_ch % n:
        raise ValueError(f"channels {n_ch} must divide the mesh axis "
                         f"{axis!r} size {n}")

    carry0 = pipeline.init_carry()
    carry_specs = jax.tree_util.tree_map(
        lambda leaf: _carry_spec(leaf, n_ch, axis), carry0)
    x_spec = P(axis, *([None] * len(in_spec.channels)))
    block_sharding = NamedSharding(mesh, x_spec)

    def place_input(block):
        x = cplx.as_block(block)
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, block_sharding), x)

    carry = jax.tree_util.tree_map(
        lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
        carry0, carry_specs)

    if n == 1:
        step = jax.jit(lambda c, x: pipeline.apply(c, x))
    else:
        step = jax.jit(jax.shard_map(
            lambda c, x: pipeline.apply(c, x), mesh=mesh,
            in_specs=(carry_specs, x_spec),
            out_specs=(carry_specs, x_spec),
            check_vma=False,
        ))
    return step, place_input, carry
