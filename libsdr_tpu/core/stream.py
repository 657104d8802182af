"""Stream metadata — the array-native analog of the reference's ``sdr::Config``.

The reference propagates a ``Config{type, sampleRate, bufferSize, numBuffers}``
record through the node graph on connect/reconfigure (reference: src/node.hh:35-168,
src/node.cc:97-114); each node validates the dtype and derives its own output
Config.  Here the same contract is a frozen :class:`StreamSpec` that flows
through :meth:`Processor.bind` at pipeline-build time.  Because everything
downstream is jit-compiled with static shapes, the spec additionally pins the
*block size* (samples per step on the time axis) and the leading *channel
shape* (the data-parallel axis that replaces the reference's
one-channel-per-process model).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Tuple, Union

import jax.numpy as jnp
import numpy as np


class SDRError(Exception):
    """Base error (reference: src/exception.hh:10-25 ``sdr::SDRError``)."""


class ConfigError(SDRError):
    """Raised when a processor rejects its input spec
    (reference: src/exception.hh:28-35 ``sdr::ConfigError``)."""


class RuntimeSDRError(SDRError):
    """Runtime failure (reference: src/exception.hh:38-44 ``sdr::RuntimeError``)."""


RateLike = Union[int, float, Fraction]


def _as_fraction(rate: RateLike) -> Fraction:
    if isinstance(rate, Fraction):
        return rate
    if isinstance(rate, int):
        return Fraction(rate)
    # Floats come from user-facing APIs (e.g. 22050.0); keep them exact if
    # they are exactly representable, as sample rates essentially always are.
    return Fraction(rate).limit_denominator(10**9)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static description of a sample stream between two processors.

    Attributes:
      dtype: element dtype of one sample (e.g. ``jnp.complex64`` for IQ,
        ``jnp.float32`` for audio, ``jnp.uint8`` for symbol/bit streams).
        Mirrors ``Config::Type`` (reference: src/node.hh:40-56) except that the
        device pipeline computes in float32/complex64 by default rather than the
        reference's fixed-point integer formats; fixed-point-exact paths are
        provided separately where decoder bit-parity demands them.
      sample_rate: samples per second, exact rational.
      block_size: number of samples per block on the trailing time axis.
        This is the static-shape analog of ``Config::bufferSize``.
      channels: leading batch shape, e.g. ``()`` for one stream or ``(1024,)``
        for a channelizer bank.  All ops broadcast over leading dims.
    """

    dtype: jnp.dtype
    sample_rate: Fraction
    block_size: int
    channels: Tuple[int, ...] = ()
    ragged: bool = False  # True: blocks are Ragged(data, valid) at capacity
    #                       block_size and *nominal* rate sample_rate
    plane_dtype: object = None  # storage dtype of the (planar) samples when
    #                             narrower than the logical dtype, e.g.
    #                             bfloat16 planes from AutoCast(compute=...)

    def __init__(self, dtype, sample_rate: RateLike, block_size: int,
                 channels: Tuple[int, ...] = (), ragged: bool = False,
                 plane_dtype=None):
        object.__setattr__(self, "dtype", jnp.dtype(dtype))
        object.__setattr__(self, "sample_rate", _as_fraction(sample_rate))
        object.__setattr__(self, "block_size", int(block_size))
        object.__setattr__(self, "channels", tuple(int(c) for c in channels))
        object.__setattr__(self, "ragged", bool(ragged))
        object.__setattr__(self, "plane_dtype",
                           None if plane_dtype is None else
                           jnp.dtype(plane_dtype))

    # -- geometry ----------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, ...]:
        """Full array shape of one block: ``channels + (block_size,)``."""
        return self.channels + (self.block_size,)

    @property
    def rate_hz(self) -> float:
        return float(self.sample_rate)

    @property
    def is_complex(self) -> bool:
        return jnp.issubdtype(self.dtype, jnp.complexfloating)

    @property
    def real_dtype(self) -> jnp.dtype:
        """Per-plane storage dtype (honors a narrower ``plane_dtype``)."""
        if self.plane_dtype is not None:
            return self.plane_dtype
        return real_dtype_of(self.dtype)

    def zeros(self):
        """A zero block in the device representation: complex streams are
        planar :class:`~libsdr_tpu.core.cplx.Complex` pytrees (see
        cplx.py), real streams plain arrays."""
        if self.is_complex:
            from libsdr_tpu.core import cplx
            return cplx.zeros(self.shape, self.real_dtype)
        return jnp.zeros(self.shape, self.real_dtype)

    def with_(self, **kw) -> "StreamSpec":
        """Functional update (named like dataclasses.replace but tolerant of
        the custom __init__)."""
        cur = dict(dtype=self.dtype, sample_rate=self.sample_rate,
                   block_size=self.block_size, channels=self.channels,
                   ragged=self.ragged, plane_dtype=self.plane_dtype)
        cur.update(kw)
        return StreamSpec(**cur)

    # -- validation helpers (the analog of the reference's per-node
    #    Config::typeId<T>() checks, e.g. src/demod.hh:195-204) -------------

    def require_dtype(self, who: str, *allowed) -> None:
        allowed_d = tuple(jnp.dtype(a) for a in allowed)
        if self.dtype not in allowed_d:
            raise ConfigError(
                f"Can not configure {who}: invalid dtype {self.dtype}, "
                f"expected one of {[str(d) for d in allowed_d]}")

    def require_complex(self, who: str) -> None:
        if not jnp.issubdtype(self.dtype, jnp.complexfloating):
            raise ConfigError(
                f"Can not configure {who}: expected complex input, got {self.dtype}")

    def require_real(self, who: str) -> None:
        if jnp.issubdtype(self.dtype, jnp.complexfloating):
            raise ConfigError(
                f"Can not configure {who}: expected real input, got {self.dtype}")

    def require_block_multiple(self, who: str, n: int) -> None:
        if n <= 0 or self.block_size % n:
            raise ConfigError(
                f"Can not configure {who}: block_size {self.block_size} must be "
                f"a positive multiple of {n}")

    def __str__(self) -> str:
        ch = "x".join(map(str, self.channels)) + " ch, " if self.channels else ""
        return (f"StreamSpec({ch}{self.dtype} @ {float(self.sample_rate):g} Hz, "
                f"block={self.block_size})")


def result_dtype(*dtypes):
    return jnp.result_type(*dtypes)


def real_dtype_of(dtype) -> jnp.dtype:
    """float32 for complex64, float64 for complex128, identity otherwise."""
    return jnp.dtype(np.zeros(0, dtype=dtype).real.dtype)
