"""DFT/IDFT as matmuls (the `lib/src/phy/dft/dft_fftw.c` replacement).

Reference behavior: FFTW3 single-precision plans with wisdom caching
(dft_fftw.c:34-56).

Design: LTE sizes are small (OFDM: 128..2048; SC-FDMA transform precoding:
12..1296), and the batch is huge (14 symbols x subframes x cells), so the
transform is a dense DFT matrix multiply — a (B, N) @ (N, N) complex
product expressed as four real matmuls, which any backend runs as one
large batched matrix product (and which needs no FFT lowering).  The DFT
matrices are host-generated per size ("the plan") and lifted as
compile-time constants ("the wisdom").

For the OFDM sizes (all multiples of 128 once N >= 256) the transform runs
as a two-stage Cooley-Tukey: a small DFT_(N/128) over the strided index, a
complex twiddle, and a DFT_128 — N*(N/128 + 128) MACs instead of N^2 (14x
fewer at N=2048).  Sizes that don't divide by 128 (SC-FDMA transform
precoding: 12..1296) keep the dense single-matmul path, where the huge
batch keeps the matrix product large.
"""

from __future__ import annotations

import functools

import numpy as np

from . import cplx

OFDM_SYMBOL_SZ = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}


@functools.lru_cache(maxsize=None)
def _dft_matrices(n: int, inverse: bool, ortho: bool):
    k = np.arange(n)
    sign = 2j if inverse else -2j
    m = np.exp(sign * np.pi * np.outer(k, k) / n)
    if ortho:
        m = m / np.sqrt(n)
    elif inverse:
        m = m / n
    return m.real.astype(np.float32), m.imag.astype(np.float32)


def _ct_split(n: int):
    """(N2, N1) two-stage factorization, or None for the dense path."""
    return (n // 128, 128) if (n % 128 == 0 and n >= 256) else None


@functools.lru_cache(maxsize=None)
def _ct_tables(n: int, inverse: bool, ortho: bool):
    """Stage matrices + twiddle for X[N2*k1+k2] = DFT_N1(tw * DFT_N2(x)).

    n = N1*n2 + n1, k = N2*k1 + k2:
      Y[k2, n1] = sum_n2 x[N1*n2 + n1] W_N2^(n2 k2)
      Z = Y * W_N^(k2 n1)            (normalization folded in here)
      X[N2*k1 + k2] = sum_n1 Z[k2, n1] W_N1^(n1 k1)
    """
    n2, n1 = _ct_split(n)
    sign = 2j if inverse else -2j
    f = lambda m: np.exp(sign * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    tw = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)
    if ortho:
        tw = tw / np.sqrt(n)
    elif inverse:
        tw = tw / n
    as_ri = lambda m, dt: (m.real.astype(dt), m.imag.astype(dt))
    return as_ri(f(n2), np.float32), as_ri(f(n1), np.float32), \
        as_ri(tw, np.float32)


def _dft_ct(x, n: int, inverse: bool, ortho: bool):
    """Two-stage Cooley-Tukey as two matmuls (see _ct_tables).  Both stages
    are trailing-dim dot_generals (the same primitive the dense path uses,
    which the eager CPU runtime also supports for bf16)."""
    import jax
    import jax.numpy as jnp

    n2, n1 = _ct_split(n)
    (f2r, f2i), (f1r, f1i), (twr, twi) = _ct_tables(n, inverse, ortho)
    lead = x.shape[:-2]
    # [n1][n2] layout so stage 1 contracts the trailing axis
    xr = x[..., 0].reshape(lead + (n2, n1)).swapaxes(-1, -2)
    xi = x[..., 1].reshape(lead + (n2, n1)).swapaxes(-1, -2)
    xr = xr.astype(jnp.bfloat16)
    xi = xi.astype(jnp.bfloat16)
    nd = xr.ndim
    dims = (((nd - 1,), (0,)), ((), ()))
    mm = lambda a, b: jax.lax.dot_general(
        a, jnp.asarray(b, jnp.bfloat16), dimension_numbers=dims,
        preferred_element_type=jnp.float32)
    yr = mm(xr, f2r) - mm(xi, f2i)  # (..., n1, k2)
    yi = mm(xr, f2i) + mm(xi, f2r)
    twr = jnp.asarray(twr.T)  # [n1][k2]
    twi = jnp.asarray(twi.T)
    zr = (yr * twr - yi * twi).swapaxes(-1, -2).astype(jnp.bfloat16)
    zi = (yr * twi + yi * twr).swapaxes(-1, -2).astype(jnp.bfloat16)
    out_r = mm(zr, f1r) - mm(zi, f1i)  # (..., k2, k1)
    out_i = mm(zr, f1i) + mm(zi, f1r)
    out = cplx.make(out_r, out_i)  # indexed [k2][k1]
    return out.swapaxes(-2, -3).reshape(lead + (n, 2))


def dft(x, n: int = None, inverse: bool = False, ortho: bool = True):
    """cf tensor (..., N, 2) -> DFT along axis -2.  ortho: 1/sqrt(N) both ways
    (keeps grid/time powers equal); else forward unscaled, inverse 1/N.

    Inputs round to bf16 with f32 accumulation: bf16 operands halve the
    bytes and take the fastest matmul path, at a roundtrip EVM of
    ~ -52 dB (256QAM needs ~ -32 dB)."""
    import jax

    n = x.shape[-2] if n is None else n
    if _ct_split(n) is not None:
        return _dft_ct(x, n, inverse, ortho)
    w_re, w_im = _dft_matrices(n, inverse, ortho)
    # (..., N, 2) -> treat N as contraction dim: out[..., m] = sum_k x[k] W[k, m]
    import jax.numpy as jnp

    xr = x[..., 0].astype(jnp.bfloat16)
    xi = x[..., 1].astype(jnp.bfloat16)
    wr = jnp.asarray(w_re, jnp.bfloat16)
    wi = jnp.asarray(w_im, jnp.bfloat16)
    nd = xr.ndim
    dims = (((nd - 1,), (0,)), ((), ()))
    mm = lambda a, b: jax.lax.dot_general(
        a, b, dimension_numbers=dims, preferred_element_type=jnp.float32)
    out_r = mm(xr, wr) - mm(xi, wi)
    out_i = mm(xr, wi) + mm(xi, wr)
    return cplx.make(out_r, out_i)


def idft(x, n: int = None, ortho: bool = True):
    return dft(x, n, inverse=True, ortho=ortho)


def dft_host(x: np.ndarray, inverse: bool = False, ortho: bool = True) -> np.ndarray:
    """NumPy oracle via np.fft."""
    norm = "ortho" if ortho else None
    fn = np.fft.ifft if inverse else np.fft.fft
    return fn(x, axis=-1, norm=norm).astype(np.complex64)
