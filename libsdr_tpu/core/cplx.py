"""Planar complex arrays — the device IQ representation.

The framework represents complex streams as a :class:`Complex` pytree of
separate real/imaginary float planes.  All complex arithmetic is explicit
real arithmetic — what XLA would decompose ``complex64`` into, but under our
control (e.g. 3-multiply Karatsuba convolutions in :mod:`libsdr_tpu.ops.fir`).

Host boundaries (fixtures, WAV files, tests) still use numpy ``complex64``;
:func:`as_block` / :func:`to_host` convert at the edges.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class Complex:
    """A complex array stored as two real planes of identical shape/dtype."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    # -- pytree ------------------------------------------------------------

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- metadata -----------------------------------------------------------

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        """Logical complex dtype (complex64 for float32 planes)."""
        return jnp.dtype(np.result_type(self.re.dtype, np.complex64))

    @property
    def real_dtype(self):
        return self.re.dtype

    # -- arithmetic ----------------------------------------------------------

    def __add__(self, o):
        if isinstance(o, Complex):
            return Complex(self.re + o.re, self.im + o.im)
        return Complex(self.re + o, self.im)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Complex):
            return Complex(self.re - o.re, self.im - o.im)
        return Complex(self.re - o, self.im)

    def __rsub__(self, o):
        return Complex(o - self.re, -self.im)

    def __neg__(self):
        return Complex(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, Complex):
            return Complex(self.re * o.re - self.im * o.im,
                           self.re * o.im + self.im * o.re)
        return Complex(self.re * o, self.im * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Complex):
            d = o.re * o.re + o.im * o.im
            return Complex((self.re * o.re + self.im * o.im) / d,
                           (self.im * o.re - self.re * o.im) / d)
        return Complex(self.re / o, self.im / o)

    def conj(self) -> "Complex":
        return Complex(self.re, -self.im)

    def abs(self):
        return jnp.sqrt(self.re * self.re + self.im * self.im)

    def abs2(self):
        """|x|^2 without the sqrt."""
        return self.re * self.re + self.im * self.im

    def angle(self):
        return jnp.arctan2(self.im, self.re)

    # -- structural ops (linear: apply to both planes) -----------------------

    def map(self, fn) -> "Complex":
        """Apply a (linear) array function to both planes."""
        return Complex(fn(self.re), fn(self.im))

    def __getitem__(self, idx) -> "Complex":
        return Complex(self.re[idx], self.im[idx])

    def reshape(self, *shape) -> "Complex":
        return self.map(lambda a: a.reshape(*shape))

    def astype(self, dtype) -> "Complex":
        rdt = jnp.dtype(np.zeros(0, dtype=dtype).real.dtype)
        return self.map(lambda a: a.astype(rdt))

    def sum(self, axis=None, **kw):
        return self.map(lambda a: a.sum(axis=axis, **kw))

    def mean(self, axis=None, **kw):
        return self.map(lambda a: a.mean(axis=axis, **kw))

    def __repr__(self):
        return f"Complex(shape={self.shape}, dtype={self.re.dtype})"


# ---------------------------------------------------------------------------
# Free functions
# ---------------------------------------------------------------------------

def is_complex(x: Any) -> bool:
    return isinstance(x, Complex)


def zeros(shape, real_dtype=jnp.float32) -> Complex:
    z = jnp.zeros(shape, real_dtype)
    return Complex(z, z)


def full_like_phasor(shape, real_dtype=jnp.float32) -> Complex:
    """Unit phasor 1+0j of the given shape."""
    return Complex(jnp.ones(shape, real_dtype), jnp.zeros(shape, real_dtype))


def exp_i(theta) -> Complex:
    """exp(1j * theta) for a real array theta."""
    return Complex(jnp.cos(theta), jnp.sin(theta))


def pack_planes(x: Complex) -> jnp.ndarray:
    """Planar Complex -> one packed (..., 2, L) real array (re plane first).

    A real copy when the planes are independent buffers; XLA's algebraic
    simplifier elides it (stack of adjacent slices == original buffer) when
    the planes came from :func:`unpack_planes` of an already-packed array —
    so feeding jitted steps packed input (see ``io.ingest`` / the runtime)
    makes conv feature-packing free."""
    return jnp.stack([x.re, x.im], axis=-2)


def unpack_planes(packed) -> Complex:
    """Packed (..., 2, L) real array -> planar Complex view (slices)."""
    return Complex(packed[..., 0, :], packed[..., 1, :])


def concatenate(xs: Sequence, axis: int = -1):
    if isinstance(xs[0], Complex):
        return Complex(jnp.concatenate([x.re for x in xs], axis=axis),
                       jnp.concatenate([x.im for x in xs], axis=axis))
    return jnp.concatenate(xs, axis=axis)


def where(cond, a, b):
    if isinstance(a, Complex) or isinstance(b, Complex):
        return Complex(jnp.where(cond, a.re, b.re),
                       jnp.where(cond, a.im, b.im))
    return jnp.where(cond, a, b)


def from_numpy(x: np.ndarray, real_dtype=jnp.float32) -> Complex:
    """numpy complex -> planar Complex on device."""
    x = np.asarray(x)
    return Complex(jnp.asarray(np.ascontiguousarray(x.real), dtype=real_dtype),
                   jnp.asarray(np.ascontiguousarray(x.imag), dtype=real_dtype))


def to_numpy(x) -> np.ndarray:
    """Planar Complex (or real array) -> numpy (complex if planar)."""
    if isinstance(x, Complex):
        re = np.asarray(x.re)
        im = np.asarray(x.im)
        return (re + 1j * im).astype(np.result_type(re.dtype, np.complex64))
    return np.asarray(x)


def as_block(x, real_dtype=jnp.float32):
    """Convert a host block to the device representation: numpy/jnp complex
    becomes planar :class:`Complex`, real arrays pass through jnp.asarray."""
    if isinstance(x, Complex):
        return x
    if np.iscomplexobj(x):
        return from_numpy(np.asarray(x), real_dtype)
    return jnp.asarray(x)


def constant(value, real_dtype=jnp.float32):
    """Complex scalar/array constant from a numpy complex value."""
    value = np.asarray(value)
    if np.iscomplexobj(value):
        return Complex(jnp.asarray(value.real, dtype=real_dtype),
                       jnp.asarray(value.imag, dtype=real_dtype))
    return jnp.asarray(value, dtype=real_dtype)
