"""Graph peephole fusions — the optimization half of the "Config
propagation" compile pass (reference: src/node.cc:97-114 propagates configs;
here binding a Pipeline also algebraically rewrites adjacent stages).

Rules (all EXACT in exact arithmetic, applied to adjacent stages of one
Pipeline — a sequential pipeline edge has a single consumer, so dropping an
intermediate representation is always safe):

1. ``FreqShift(f, exact) -> FMDemod(quadrature)``: the quadrature
   discriminator only sees ``x[n] * conj(x[n-1])``; a mixer rotation
   ``e^(-i w n)`` collapses to the CONSTANT ``e^(-i w)`` in that product.
   The per-sample NCO (two transcendentals + a full complex multiply per
   sample) is deleted; FMDemod picks up one constant complex rotation.

2. ``IQBaseBand -> FMDemod(quadrature)``: same, for the decimated-rate NCO
   that IQBaseBand commutes to its output (ops/baseband.py); IQBaseBand then
   emits the unrotated filtered stream straight from the FIR matmul.

3. ``FreqShift/IQBaseBand-NCO -> AMDemod``: ``|x|`` is rotation-invariant —
   the NCO is dropped outright.

The rewrite happens in ``Pipeline._bind`` before spec propagation, so nested
pipelines (e.g. app chains) fuse on their own stage lists.
"""

from __future__ import annotations

from typing import List


def reset_fusion_state(stages: List) -> None:
    """Clear the fusion state fuse_stages writes onto stage INSTANCES
    (folded rotations, fold_nco flags).  Called before every rewrite, so
    that re-binding never applies a folded rotation twice."""
    from libsdr_tpu.ops.baseband import IQBaseBand
    from libsdr_tpu.ops.demod import FMDemod

    for st in stages:
        if isinstance(st, FMDemod):
            st._pending_rot_freqs = []
            st._rot = None
        if isinstance(st, IQBaseBand):
            st.fold_nco = False


def fuse_stages(stages: List) -> List:
    """Return a rewritten stage list with NCO rotations folded into
    rotation-invariant / product-form consumers."""
    from libsdr_tpu.ops.baseband import IQBaseBand
    from libsdr_tpu.ops.demod import AMDemod, FMDemod
    from libsdr_tpu.ops.nco import FreqShift

    # Fusion state lives on the stage instances; reset it first so that
    # re-binding, or reusing a stage object in a different pipeline, never
    # inherits stale rotations/flags from an earlier fusion decision.
    reset_fusion_state(stages)

    out: List = []
    i = 0
    while i < len(stages):
        st = stages[i]
        nxt = stages[i + 1] if i + 1 < len(stages) else None

        def _demod_takes_rot(d):
            return isinstance(d, FMDemod) and d.mode == "quadrature"

        if (isinstance(st, FreqShift) and st.mode == "exact"
                and st.freq != 0.0 and _demod_takes_rot(nxt)):
            nxt._pending_rot_freqs.append(st.freq)
            i += 1  # drop the FreqShift; demod folds the rotation
            continue
        if (isinstance(st, FreqShift) and st.mode == "exact"
                and isinstance(nxt, AMDemod)):
            i += 1  # |x| is rotation-invariant: drop outright
            continue
        if (isinstance(st, IQBaseBand) and st.fc != 0.0
                and (_demod_takes_rot(nxt) or isinstance(nxt, AMDemod))):
            st.fold_nco = True
            if _demod_takes_rot(nxt):
                nxt._pending_rot_freqs.append(st.fc)
            out.append(st)
            i += 1
            continue
        out.append(st)
        i += 1
    return out
