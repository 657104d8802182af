"""Multi-host (DCN) initialization hooks.

The reference is strictly single-process (SURVEY.md section 2.9).  For
multi-host deployments the recipe is standard JAX: ``jax.distributed`` +
a global mesh; channel shards cross the network between hosts while halos
stay on the intra-host interconnect.  Actual multi-host hardware is not available in this
environment, so this module provides the initialization path and documents
the deployment contract; the sharded pipelines in
:mod:`libsdr_tpu.parallel` are host-count agnostic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed (no-op for single-process runs).

    Where a cluster environment describes the job, the arguments may be
    omitted (jax auto-detects); pass them explicitly elsewhere.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def global_mesh(axis_names: Sequence[str] = ("ch", "time"),
                time_parallel: int = 1) -> Mesh:
    """Mesh over ALL devices (across hosts after init_multihost): channels
    on the first axis (DCN-friendly — no per-block communication between
    channel shards), time-block parallelism on the second (halos should stay
    within a host's interconnect domain, so keep ``time_parallel`` <= devices/host)."""
    devs = np.asarray(jax.devices())
    n = devs.size
    t = max(1, time_parallel)
    if t > n:
        raise ValueError(
            f"global_mesh: time_parallel={t} exceeds device count {n}")
    return Mesh(devs[: (n // t) * t].reshape(n // t, t), tuple(axis_names))


def place_global(x, mesh: Mesh, spec) -> jax.Array:
    """Place host data as a global array over ``mesh`` with PartitionSpec
    ``spec`` — works in BOTH single- and multi-process runs.

    ``x`` must be the FULL global array on every process (fine for carries
    and replicated state; the callback receives GLOBAL shard indices and
    slices ``x`` with them).  Only the shards on this process's devices are
    materialized/transferred.  For true host-sharded ingest — each host
    reading ONLY its own capture range — use :func:`place_global_ingest`.
    """
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x_np = np.asarray(x)
    return jax.make_array_from_callback(x_np.shape, sharding,
                                        lambda idx: x_np[idx])


def place_global_ingest(global_shape, mesh: Mesh, spec, fetch) -> jax.Array:
    """Host-sharded ingest: build a global array where each process reads
    ONLY its own shards — the multi-host replacement for the reference's
    single RTL ingest thread.

    ``fetch(index)`` is called once per addressable shard with the GLOBAL
    index (a tuple of slices into ``global_shape``) and must return that
    shard's data (e.g. a pread of the capture at the sliced offsets, or
    this host's DMA region).  Shards on other hosts are never requested
    here, so no host needs the full stream."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(tuple(global_shape), sharding,
                                        lambda idx: np.asarray(fetch(idx)))


def _shard_key(index) -> str:
    """Stable string key for a global-shard index (tuple of slices)."""
    return ";".join(f"{s.start or 0}:{s.stop if s.stop is not None else -1}"
                    for s in index)


def save_sharded_checkpoint(path: str, carry, position: int) -> None:
    """Per-process checkpoint of a (possibly globally sharded) carry: each
    process serializes only the shards on ITS OWN devices, so no
    cross-host gather happens — the multi-host form of
    core/checkpoint.save_checkpoint.  Write to a per-process path."""
    import json

    from libsdr_tpu.core.checkpoint import _storable

    leaves, treedef = jax.tree_util.tree_flatten(carry)
    arrays = {}
    for i, leaf in enumerate(leaves):
        if hasattr(leaf, "addressable_shards"):
            seen = set()
            for s in leaf.addressable_shards:
                k = _shard_key(s.index)
                if k not in seen:    # replicated: one copy is enough
                    seen.add(k)
                    arrays[f"leaf{i}|{k}"] = _storable(s.data)
        else:
            arrays[f"leaf{i}|"] = _storable(leaf)
    header = json.dumps({"position": int(position), "n_leaves": len(leaves)})
    np.savez(path, __header__=np.frombuffer(header.encode(), np.uint8),
             **arrays)


def load_sharded_checkpoint(path: str, carry_like):
    """Restore (carry, position) from :func:`save_sharded_checkpoint`:
    every leaf is rebuilt with ``jax.make_array_from_callback``, which asks
    each process only for its own shards — exactly the ones it saved."""
    import json

    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        saved = {k: z[k] for k in z.files if k != "__header__"}
    like_leaves, treedef = jax.tree_util.tree_flatten(carry_like)
    out = []
    for i, like in enumerate(like_leaves):
        if hasattr(like, "sharding") and hasattr(like, "addressable_shards"):
            dtype = np.asarray(like.addressable_shards[0].data).dtype

            def cb(idx, i=i, dtype=dtype):
                return saved[f"leaf{i}|{_shard_key(idx)}"].astype(dtype)

            out.append(jax.make_array_from_callback(
                like.shape, like.sharding, cb))
        else:
            # Cast back to the live carry's dtype (bf16 & friends were
            # widened to f32 by _storable at save time).
            out.append(saved[f"leaf{i}|"].astype(np.asarray(like).dtype))
    return (jax.tree_util.tree_unflatten(treedef, out),
            header["position"])


def run_supervised(make_cmd, num_processes: int, max_restarts: int = 2,
                   poll_s: float = 0.25, timeout_s: float = 600.0,
                   popen_kwargs: Optional[dict] = None) -> int:
    """Host-loss detection + elastic restart for a multi-process job
    (SURVEY.md section 5: the reference has nothing here; BASELINE's
    multi-host north star asks at minimum for lost-host detection with
    restart from stream position).

    Launches the N processes of a ``jax.distributed`` job and monitors
    them; when ANY process exits abnormally (crash, OOM-kill, lost host),
    the survivors are torn down (their collectives would hang forever
    waiting for the dead peer) and the whole cluster is relaunched — the
    workers themselves resume from their last checkpoint
    (core/checkpoint.py), so completed stream position is never recomputed.

    Args:
      make_cmd: callable ``(coordinator, process_id, incarnation) ->
        argv list`` for one worker.
      num_processes: cluster size.
      max_restarts: relaunch budget before giving up.
    Returns the number of restarts performed.  Raises RuntimeError when
    the budget is exhausted.
    """
    import socket
    import subprocess
    import time

    restarts = 0
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{s.getsockname()[1]}"
        procs = [subprocess.Popen(make_cmd(coordinator, i, restarts),
                                  **(popen_kwargs or {}))
                 for i in range(num_processes)]
        t0 = time.monotonic()
        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    return restarts
                if any(c not in (None, 0) for c in codes):
                    break    # lost host detected
                if time.monotonic() - t0 > timeout_s:
                    break
                time.sleep(poll_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"run_supervised: job failed {restarts} times "
                f"(budget {max_restarts})")


def process_local_batch(global_channels: int) -> slice:
    """The channel range this host should feed (host-sharded ingest: each
    host reads only its own capture segment — the multi-host replacement for
    the reference's single RTL ingest thread)."""
    p = jax.process_index()
    n = jax.process_count()
    if global_channels % n:
        raise ValueError(
            f"process_local_batch: {global_channels} channels do not divide "
            f"over {n} processes (the remainder would never be ingested)")
    per = global_channels // n
    return slice(p * per, (p + 1) * per)
