"""Processor protocol — the array-native analog of the reference's node classes.

A reference node is a ``Sink<T>`` + ``Source`` with three responsibilities
(reference: src/node.hh:174-258):

1. ``config(Config)``  — validate input metadata, derive kernels/LUTs,
   allocate buffers, propagate its own output Config downstream
   (reference: src/node.cc:97-114).
2. persistent per-node state — FIR ring buffers, NCO phase, PLL registers.
3. ``process(buffer)`` — transform one buffer, push to connected sinks.

Here these become:

1. :meth:`Processor.bind` — called once at pipeline-build time with the input
   :class:`StreamSpec`; validates, computes derived constants (as numpy — they
   become XLA constants at trace time), and returns the output spec.
2. :meth:`Processor.init_carry` — returns the explicit state pytree.
3. :meth:`Processor.apply` — pure ``(carry, x) -> (carry, y)``; traced once
   under ``jax.jit`` and therefore free of data-dependent Python control flow.

All processors treat the trailing axis as time and broadcast over arbitrary
leading (channel) axes — that is where data parallelism comes from on the device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from libsdr_tpu.core.stream import ConfigError, StreamSpec

Carry = Any


class Processor:
    """Base class for all stream processors.

    Subclasses implement :meth:`_bind` (spec inference + derived constants)
    and :meth:`apply`.  ``bind`` may be called again with a different spec —
    the analog of the reference's reconfiguration on ``setConfig``
    (reference: src/node.cc:97-114) — which recomputes all derived state.
    """

    def __init__(self) -> None:
        self._in_spec: Optional[StreamSpec] = None
        self._out_spec: Optional[StreamSpec] = None

    # -- binding -------------------------------------------------------------

    def bind(self, in_spec: StreamSpec) -> StreamSpec:
        out = self._bind(in_spec)
        self._in_spec = in_spec
        self._out_spec = out
        return out

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        """Validate ``in_spec`` and return the output spec.  Default: pass
        through unchanged (the analog of ``sdr::Proxy``, src/node.hh:315-327)."""
        return in_spec

    @property
    def in_spec(self) -> StreamSpec:
        if self._in_spec is None:
            raise ConfigError(f"{type(self).__name__} is not bound yet")
        return self._in_spec

    @property
    def out_spec(self) -> StreamSpec:
        if self._out_spec is None:
            raise ConfigError(f"{type(self).__name__} is not bound yet")
        return self._out_spec

    @property
    def is_bound(self) -> bool:
        return self._out_spec is not None

    # -- state / compute -------------------------------------------------------

    def init_carry(self) -> Carry:
        """Initial state pytree.  Default: stateless."""
        return ()

    def apply(self, carry: Carry, x) -> Tuple[Carry, Any]:
        raise NotImplementedError

    def __call__(self, carry: Carry, x):
        return self.apply(carry, x)

    def __repr__(self) -> str:
        s = f"<{type(self).__name__}"
        if self._out_spec is not None:
            s += f" -> {self._out_spec}"
        return s + ">"


class Proxy(Processor):
    """Pass-through node (reference: src/node.hh:315-327 ``sdr::Proxy``)."""

    def apply(self, carry, x):
        return carry, x


class Lambda(Processor):
    """Wrap a stateless elementwise function as a processor.

    The analog of the reference's small plumbing nodes (``Scale``, ``Cast``,
    ``RealPart`` — reference: src/utils.hh:16-428).

    Args:
      fn: pure function block -> block (shape-preserving on the time axis).
      spec_fn: optional ``in_spec -> out_spec``; default passthrough.
    """

    def __init__(self, fn: Callable, spec_fn: Optional[Callable] = None,
                 name: str = "Lambda"):
        super().__init__()
        self._fn = fn
        self._spec_fn = spec_fn
        self._name = name

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        return self._spec_fn(in_spec) if self._spec_fn else in_spec

    def apply(self, carry, x):
        return carry, self._fn(x)

    def __repr__(self) -> str:
        return f"<Lambda:{self._name}>"
