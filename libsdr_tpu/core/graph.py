"""Pipeline builder — the array-native analog of the reference's node graph.

The reference wires nodes with ``Source::connect`` and "compiles" the graph by
propagating ``Config`` records through it (reference: src/node.cc:87-114).
Here a :class:`Pipeline` is an ordered chain of processors; :meth:`bind` runs
the same spec-propagation pass, and :meth:`compile` produces one jitted

    step(carry, block) -> (carry, out_block)

covering the entire chain — the analog of all ``direct=true`` edges fused into
one XLA program (reference edge dispatch: src/node.cc:66-84).  Fan-out (the
reference's multi-sink ``Source::send``) is provided by :class:`Tee`, which
returns a tuple of branch outputs.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import jax

from libsdr_tpu.core.block import Carry, Processor
from libsdr_tpu.core.stream import StreamSpec


class Pipeline(Processor):
    """Sequential composition of processors.

    A Pipeline is itself a Processor, so pipelines nest (the analog of
    composite reference chains like sdr_fm's RTL -> AutoCast -> IQBaseBand ->
    FMDemod -> FMDeemph -> PortSink, reference: examples/sdr_fm.cc:38-64).
    """

    def __init__(self, stages: Sequence[Processor], name: str = "Pipeline",
                 optimize: bool = True):
        super().__init__()
        self.stages: List[Processor] = list(stages)
        self.name = name
        self.optimize = optimize
        self._step = None
        self._step_donate = None
        self._step_chunked = {}

    # -- spec propagation (the "Config propagation" pass) ---------------------

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        # (Re)binding recomputes baked constants (taps, kernels, fusion
        # decisions) — a previously compiled step has the OLD ones traced
        # in, so it must be invalidated (retune contract: set_freq/set_band
        # then re-bind + compile).
        self._step = None
        self._step_chunked = {}
        if self.optimize:
            from libsdr_tpu.core.fuse import fuse_stages
            self.stages = fuse_stages(list(self.stages))
        spec = in_spec
        for stage in self.stages:
            spec = stage.bind(spec)
        return spec

    def init_carry(self) -> Carry:
        return tuple(stage.init_carry() for stage in self.stages)

    def apply(self, carry: Carry, x) -> Tuple[Carry, Any]:
        new_carries = []
        for stage, c in zip(self.stages, carry):
            c, x = stage.apply(c, x)
            new_carries.append(c)
        return tuple(new_carries), x

    # -- compilation -----------------------------------------------------------

    def compile(self, donate_carry: bool = False):
        """Return a jitted ``step(carry, x) -> (carry, y)``.

        ``donate_carry`` donates the carry buffers so XLA updates state in
        place — the analog of the reference's allow_overwrite in-place
        discipline (reference: src/node.cc:73-81).  Off by default: carries
        are small.
        """
        donate_carry = bool(donate_carry)
        if self._step is None or self._step_donate != donate_carry:
            donate = (0,) if donate_carry else ()
            # A fresh lambda per compile: jax.jit keys its trace cache on
            # the wrapped callable, and bound methods of the same object
            # hash equal — re-compiling after a retune/re-bind would
            # otherwise hit the stale trace with the OLD constants baked in.
            self._step = jax.jit(lambda carry, x: self.apply(carry, x),
                                 donate_argnums=donate)
            self._step_donate = donate_carry
        return self._step

    def compile_chunked(self, mode: str = "unroll"):
        """Jitted ``step(carry, xs) -> (carry, ys)`` over K blocks — ONE
        device dispatch processes K pipeline blocks.

        Why: every dispatch pays a fixed launch cost on the host; chaining
        K blocks per dispatch amortizes it K-fold at a latency budget of K
        blocks.  Whether that pays on the GPU is not measured.

        Modes (both bit-identical to K repeated :meth:`compile` steps —
        tests/test_core.py):

        * ``"unroll"``: ``xs``/``ys`` are length-K TUPLES of blocks; the
          trace Python-unrolls ``apply`` K times.  Every block stays its
          own XLA buffer — no on-device staging copies.  K is static per
          compiled shape (jit retraces per K).
        * ``"scan"``: ``xs``/``ys`` are K-STACKED arrays (leading axis K)
          via ``lax.scan``.  The scan's per-iteration dynamic-slice of the
          stacked input and dynamic-update-slice of the stacked output are
          copies that grow with block size; kept for comparison
          (tools/bench_streaming.py) and for callers that want bounded
          code size at very large K.
        """
        if mode not in ("unroll", "scan"):
            raise ValueError(f"compile_chunked: unknown mode {mode!r}")
        if self._step_chunked.get(mode) is None:
            if mode == "scan":
                # Fresh lambda per compile (see compile()).
                self._step_chunked[mode] = jax.jit(
                    lambda carry, xs: jax.lax.scan(
                        lambda c, x: self.apply(c, x), carry, xs))
            else:
                def unrolled(carry, xs):
                    ys = []
                    for x in xs:
                        carry, y = self.apply(carry, x)
                        ys.append(y)
                    return carry, tuple(ys)

                self._step_chunked[mode] = jax.jit(unrolled)
        return self._step_chunked[mode]

    def switch_stages(self, new_stages: Sequence[Processor], old_carry):
        """Live restructuring of a BOUND pipeline mid-stream — the analog of
        the reference's runtime graph surgery (``connect()`` on a running
        queue reconfigures via Config propagation, src/node.cc:87-114, and
        sdr_rec's per-mode demod plumbing, examples/sdr_rec.cc:44-63).

        Replaces the stage list, re-runs fusion + spec propagation with the
        same input spec, and returns the carry for the NEW structure with
        the state of every structurally-unchanged leading piece
        TRANSPLANTED from ``old_carry`` (e.g. switching WFM -> AM keeps the
        front-end FIR tail warm; only the demod-side state starts fresh).
        The compiled step is invalidated — call :meth:`compile` again.
        """
        if not self.is_bound:
            raise RuntimeError("switch_stages: pipeline is not bound")
        in_spec = self._in_spec_orig
        self.stages = list(new_stages)
        self.bind(in_spec)
        fresh = self.init_carry()
        return _transplant_carry(tuple(old_carry), fresh)

    def bind(self, in_spec: StreamSpec) -> StreamSpec:
        # Remember the original input spec so switch_stages can re-propagate.
        self._in_spec_orig = in_spec
        return super().bind(in_spec)

    def describe(self) -> str:
        """Human-readable config echo of each bound stage — the analog of the
        reference's per-node debug log on reconfigure (e.g. src/baseband.hh:179-189)."""
        lines = [f"{self.name}:"]
        for stage in self.stages:
            out = str(stage.out_spec) if stage.is_bound else "(unbound)"
            lines.append(f"  {type(stage).__name__:<24} -> {out}")
        return "\n".join(lines)


def _transplant_carry(old, fresh):
    """Recursively transplant state from ``old`` into the structure of
    ``fresh``: wherever a sub-tree of the new carry matches the old one
    (same pytree structure, leaf shapes and dtypes), the old values carry
    over; mismatched sub-trees (new or reconfigured stages) keep their
    fresh initial state.  Tuples/lists of different length transplant their
    common prefix — the fused-stage analog of keeping upstream node state
    while downstream nodes are re-created."""
    def leaves_match(a, b):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        if ta != tb:
            return False
        for x, y in zip(la, lb):
            if (getattr(x, "shape", None) != getattr(y, "shape", None)
                    or getattr(x, "dtype", None) != getattr(y, "dtype",
                                                            None)):
                return False
        return True

    if leaves_match(old, fresh):
        return old
    if isinstance(old, (tuple, list)) and isinstance(fresh, (tuple, list)):
        out = [(_transplant_carry(old[i], f) if i < len(old) else f)
               for i, f in enumerate(fresh)]
        return type(fresh)(out)
    if isinstance(old, dict) and isinstance(fresh, dict):
        return {k: (_transplant_carry(old[k], v) if k in old else v)
                for k, v in fresh.items()}
    return fresh


class Combine(Processor):
    """N-input join: stack equal-spec branch outputs (e.g. from a preceding
    :class:`Tee`) onto a new leading channel axis — the analog of
    ``sdr::Combine``/``CombineSink`` which unifies N inputs of matching
    type/rate (reference: src/combine.hh:16-227; its per-input ring buffers
    vanish here because a fused pipeline is lockstep by construction)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = int(n)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        # in_spec is the (common) spec of each branch.
        return in_spec.with_(channels=(self.n,) + in_spec.channels)

    def apply(self, carry, xs):
        from libsdr_tpu.core import cplx
        if len(xs) != self.n:
            raise ValueError(f"Combine: expected {self.n} inputs, got {len(xs)}")
        if cplx.is_complex(xs[0]):
            import jax.numpy as jnp
            from libsdr_tpu.core.cplx import Complex
            return carry, Complex(jnp.stack([x.re for x in xs]),
                                  jnp.stack([x.im for x in xs]))
        import jax.numpy as jnp
        return carry, jnp.stack(xs)


class Tee(Processor):
    """Fan-out: feed one input to N branch processors, return a tuple of their
    outputs (the analog of ``Source::send`` to multiple connected sinks,
    reference: src/node.cc:66-84)."""

    def __init__(self, branches: Sequence[Processor]):
        super().__init__()
        self.branches: List[Processor] = list(branches)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        self._branch_specs = tuple(b.bind(in_spec) for b in self.branches)
        # A Tee's "spec" is its first branch's spec; use branch_specs for the rest.
        return self._branch_specs[0]

    @property
    def branch_specs(self) -> Tuple[StreamSpec, ...]:
        return self._branch_specs

    def init_carry(self) -> Carry:
        return tuple(b.init_carry() for b in self.branches)

    def apply(self, carry: Carry, x):
        new_carries, outs = [], []
        for b, c in zip(self.branches, carry):
            c, y = b.apply(c, x)
            new_carries.append(c)
            outs.append(y)
        return tuple(new_carries), tuple(outs)
