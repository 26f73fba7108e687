"""Split-complex representation: complex tensors as float32 with a trailing
re/im axis of size 2.

Rationale: XLA decomposes complex arithmetic anyway.  Keeping re/im as an
explicit trailing axis makes every op (gather, matmul, elementwise) a plain
float op on any backend: a complex matmul is four real matmuls, and the
(…, 2) layout keeps the real and imaginary parts of a sample adjacent.

This module is the framework-wide convention: "cf tensors" are float arrays
whose last axis is (re, im).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def from_numpy(x: np.ndarray) -> jnp.ndarray:
    """complex numpy -> (..., 2) float32."""
    return jnp.asarray(np.stack([x.real, x.imag], axis=-1).astype(np.float32))


def to_numpy(x) -> np.ndarray:
    """(..., 2) float -> complex64 numpy."""
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def make(re, im) -> jnp.ndarray:
    return jnp.stack([re, im], axis=-1)


def zeros(shape, dtype=jnp.float32) -> jnp.ndarray:
    return jnp.zeros(tuple(shape) + (2,), dtype)


def re(x):
    return x[..., 0]


def im(x):
    return x[..., 1]


def conj(x):
    return x * jnp.asarray(np.array([1.0, -1.0], np.float32))


def mul(a, b):
    """Elementwise complex multiply of cf tensors (broadcasting)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br - ai * bi, ar * bi + ai * br], axis=-1)


def mul_conj(a, b):
    """a * conj(b)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br + ai * bi, ai * br - ar * bi], axis=-1)


def abs2(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2


def scale(x, s):
    """Multiply by a real scalar/array (broadcast against the non-cplx dims)."""
    return x * jnp.asarray(s)[..., None]


def div(a, b, eps: float = 0.0):
    """Elementwise complex division a / b."""
    d = abs2(b) + eps
    return mul_conj(a, b) / d[..., None]


def matmul(a, w_re, w_im):
    """cf tensor (..., K, 2) times complex matrix W (K, N) given as two real
    matrices -> (..., N, 2).  Four real matmuls."""
    ar, ai = a[..., 0], a[..., 1]
    out_r = ar @ w_re - ai @ w_im
    out_i = ar @ w_im + ai @ w_re
    return jnp.stack([out_r, out_i], axis=-1)


def exp_i(theta):
    """e^{j theta} as cf tensor."""
    return jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
