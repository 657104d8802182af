"""Plumbing nodes: gain, dtype/layout conversion, I/Q balance, interleave
(reference: src/utils.hh Scale/Cast/ToComplex/RealPart/ImagPart/
UnsignedToSigned/SignedToUnsigned/IQBalance/Interleave and src/autocast.hh).

The device pipeline computes in float32/complex64, so most of the reference's
fixed-point cast zoo collapses into :class:`Cast` + :class:`Normalize`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from libsdr_tpu.core import cplx
from libsdr_tpu.core.block import Processor
from libsdr_tpu.core.cplx import Complex
from libsdr_tpu.core.stream import ConfigError, StreamSpec, real_dtype_of


class Scale(Processor):
    """y = scale * x (reference: src/utils.hh Scale node)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def apply(self, carry, x):
        if self.scale == 1.0:
            return carry, x
        return carry, x * self.scale


class Cast(Processor):
    """Convert dtype (reference: src/utils.hh Cast / src/autocast.hh AutoCast).

    Integer->float casts optionally normalize to [-1, 1) full scale
    (the float replacement for the reference's fixed-point Traits
    scale/shift machinery, src/traits.hh)."""

    def __init__(self, dtype, normalize: bool = False):
        super().__init__()
        self.dtype = jnp.dtype(dtype)
        self.normalize = normalize

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        self._scale = 1.0
        if self.normalize and jnp.issubdtype(in_spec.dtype, jnp.integer):
            bits = jnp.iinfo(in_spec.dtype).bits
            self._scale = 1.0 / (1 << (bits - 1))
        if in_spec.is_complex and not jnp.issubdtype(
                self.dtype, jnp.complexfloating):
            raise ConfigError("Cast: can not cast complex stream to real "
                              "dtype; use RealPart/ImagPart")
        return in_spec.with_(dtype=self.dtype)

    def apply(self, carry, x):
        y = x.astype(self.dtype)
        if self._scale != 1.0:
            y = y * self._scale
        return carry, y


class AutoCast(Cast):
    """Runtime dtype normalization to the compute format (reference:
    src/autocast.hh AutoCast<T>, the table of 14 cast kernels): any integer
    or float stream becomes normalized float32 (or complex64 for complex
    streams), which is what every downstream device op consumes.

    Args:
      compute: plane dtype, 'float32' (default) or 'bfloat16'.  bf16 planes
        HALVE the device-memory traffic of the (bandwidth-bound) front
        end and are LOSSLESS for 8-bit sources (rtl_sdr u8 wire format: 8
        significand bits fit bf16 exactly); the filters accumulate in f32.  Use float32 for >=12-bit sources.
    """

    def __init__(self, compute: str = "float32"):
        super().__init__(jnp.float32, normalize=True)
        self._compute = jnp.dtype(compute)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        self.dtype = jnp.dtype(
            jnp.complex64 if in_spec.is_complex else jnp.float32)
        out = super()._bind(in_spec)
        if self._compute != jnp.float32:
            # Advertise the narrow plane dtype so downstream carries (FIR
            # tails etc.) initialize consistently with the runtime planes —
            # no dtype drift, no re-trace after block 0.
            out = out.with_(plane_dtype=self._compute)
        return out

    def apply(self, carry, x):
        carry, y = super().apply(carry, x)
        if self._compute != jnp.float32:
            y = y.astype(self._compute) if not isinstance(y, Complex) else \
                Complex(y.re.astype(self._compute),
                        y.im.astype(self._compute))
        return carry, y


class ToComplex(Processor):
    """Real -> complex with zero imaginary part
    (reference: src/utils.hh ToComplex)."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("ToComplex")
        out = jnp.complex64 if in_spec.dtype != jnp.float64 else jnp.complex128
        return in_spec.with_(dtype=out)

    def apply(self, carry, x):
        rdt = self.out_spec.real_dtype
        x = x.astype(rdt)
        return carry, Complex(x, jnp.zeros_like(x))


class RealPart(Processor):
    """Complex -> real part (reference: src/utils.hh RealPart)."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("RealPart")
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype))

    def apply(self, carry, x):
        return carry, x.re


class ImagPart(Processor):
    """Complex -> imaginary part (reference: src/utils.hh ImagPart)."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("ImagPart")
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype))

    def apply(self, carry, x):
        return carry, x.im


class UnsignedToSigned(Processor):
    """u8/u16 -> s8/s16 by subtracting half range
    (reference: src/utils.hh UnsignedToSigned, src/utils.cc:9-106)."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        d = in_spec.dtype
        mapping = {jnp.dtype(jnp.uint8): jnp.int8,
                   jnp.dtype(jnp.uint16): jnp.int16,
                   jnp.dtype(jnp.uint32): jnp.int32}
        if d not in mapping:
            raise ConfigError(f"UnsignedToSigned: unsupported dtype {d}")
        self._half = 1 << (jnp.iinfo(d).bits - 1)
        return in_spec.with_(dtype=mapping[d])

    def apply(self, carry, x):
        return carry, (x.astype(jnp.int32) - self._half).astype(self.out_spec.dtype)


class SignedToUnsigned(Processor):
    """s8/s16 -> u8/u16 by adding half range
    (reference: src/utils.hh SignedToUnsigned)."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        d = in_spec.dtype
        mapping = {jnp.dtype(jnp.int8): jnp.uint8,
                   jnp.dtype(jnp.int16): jnp.uint16,
                   jnp.dtype(jnp.int32): jnp.uint32}
        if d not in mapping:
            raise ConfigError(f"SignedToUnsigned: unsupported dtype {d}")
        self._half = 1 << (jnp.iinfo(d).bits - 1)
        return in_spec.with_(dtype=mapping[d])

    def apply(self, carry, x):
        return carry, (x.astype(jnp.int32) + self._half).astype(self.out_spec.dtype)


class IQBalance(Processor):
    """I/Q gain-imbalance correction (reference: src/utils.hh:112-204
    IQBalance, which applies Q8 fixed-point per-rail gains): y = I*gi + j*Q*gq."""

    def __init__(self, i_gain: float = 1.0, q_gain: float = 1.0):
        super().__init__()
        self.i_gain, self.q_gain = float(i_gain), float(q_gain)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("IQBalance")
        return in_spec

    def apply(self, carry, x):
        return carry, Complex(x.re * self.i_gain, x.im * self.q_gain)


class Interleave(Processor):
    """Interleave N equal-rate streams sample-by-sample into one stream at
    N-times the rate (reference: src/combine.hh:216-227 Interleave).  Input
    block shape (..., N, B) -> output (..., N*B) with out[n*N+k] = in[k, n]."""

    def __init__(self, n: int):
        super().__init__()
        self.n = int(n)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        if not in_spec.channels or in_spec.channels[-1] != self.n:
            raise ConfigError(
                f"Interleave: expected trailing channel dim {self.n}, "
                f"got channels {in_spec.channels}")
        return in_spec.with_(
            channels=in_spec.channels[:-1],
            sample_rate=in_spec.sample_rate * self.n,
            block_size=in_spec.block_size * self.n)

    def apply(self, carry, x):
        # (..., N, B) -> (..., B, N) -> (..., B*N)
        def go(a):
            y = jnp.swapaxes(a, -1, -2)
            return y.reshape(y.shape[:-2] + (-1,))
        return carry, x.map(go) if cplx.is_complex(x) else go(x)


class Deinterleave(Processor):
    """Inverse of :class:`Interleave`: (..., N*B) -> (..., N, B)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = int(n)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_block_multiple("Deinterleave", self.n)
        return in_spec.with_(
            channels=in_spec.channels + (self.n,),
            sample_rate=in_spec.sample_rate / self.n,
            block_size=in_spec.block_size // self.n)

    def apply(self, carry, x):
        def go(a):
            y = a.reshape(a.shape[:-1] + (-1, self.n))
            return jnp.swapaxes(y, -1, -2)
        return carry, x.map(go) if cplx.is_complex(x) else go(x)


def to_device_cached(cache: dict, key, build_np, cap: int = 64):
    """Device-resident constant pytree, cached ACROSS traces.

    ``build_np()`` produces the numpy value on a miss; the device upload
    runs under :func:`jax.ensure_compile_time_eval`, so even when first
    touched inside a jit/shard_map trace it evaluates eagerly to a plain
    committed array (safe to reuse by any later trace, where it folds as a
    compile-time constant).  Keyed additionally by backend so the CPU and
    an accelerator never share buffers.  Saves rebuilding and re-uploading
    the constant on every eager call."""
    import jax

    key = (key, jax.default_backend())
    m = cache.get(key)
    if m is None:
        with jax.ensure_compile_time_eval():
            m = jax.tree_util.tree_map(jnp.asarray, build_np())
        if len(cache) > cap:
            cache.clear()
        cache[key] = m
    return m
