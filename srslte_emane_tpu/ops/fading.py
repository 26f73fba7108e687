"""Channel simulator: TDL Rayleigh fading (EPA/EVA/ETU), delay, HST Doppler,
radio-link-failure injection.

Reference behavior: `lib/src/phy/channel/` — fading.c (tapped-delay-line
Rayleigh with Doppler, profiles at fading.c:38-50), delay.c (dynamic delay),
hst.c (high-speed-train Doppler trajectory), rlf.c (periodic outage),
composed by `srslte::channel` (channel.h:34-60).

Design: taps are generated per subframe by a Jakes sum-of-sinusoids
(deterministic in (seed, subframe index) — reproducible, batched), and the
convolution is a dense (n_taps)-term shifted accumulation, vectorized over
the batch; no per-sample loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx

# 36.101 Annex B.2 tapped-delay-line profiles: (delay ns, power dB)
PROFILES = {
    "epa": ([0, 30, 70, 90, 110, 190, 410],
            [0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8]),
    "eva": ([0, 30, 150, 310, 370, 710, 1090, 1730, 2510],
            [0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9]),
    "etu": ([0, 50, 120, 200, 230, 500, 1600, 2300, 5000],
            [-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0]),
    "none": ([0], [0.0]),
}
N_SINUSOIDS = 16


@functools.lru_cache(maxsize=None)
def profile_taps(profile: str, srate_hz: float):
    """Tap sample delays + linear amplitudes at the given sample rate."""
    delays_ns, powers_db = PROFILES[profile]
    d = np.round(np.asarray(delays_ns) * 1e-9 * srate_hz).astype(np.int64)
    a = 10.0 ** (np.asarray(powers_db) / 20.0)
    a = a / np.sqrt(np.sum(a**2))  # unit average channel power
    return d, a.astype(np.float32)


def tap_gains(key, n_taps: int, t_s, doppler_hz: float, batch: int):
    """Jakes sum-of-sinusoids Rayleigh gains: (batch, len(t_s), n_taps, 2).

    Deterministic in (key, t_s): evaluating at later subframe times continues
    the same fading trajectory (the state the reference keeps in fading.c)."""
    k1, k2 = jax.random.split(key)
    alpha = jax.random.uniform(k1, (batch, n_taps, N_SINUSOIDS), minval=0.0,
                               maxval=2 * np.pi)
    phi = jax.random.uniform(k2, (batch, n_taps, N_SINUSOIDS), minval=0.0,
                             maxval=2 * np.pi)
    t = jnp.asarray(t_s)[None, :, None, None]
    arg = 2 * np.pi * doppler_hz * jnp.cos(alpha)[:, None] * t + phi[:, None]
    # h = (1/sqrt(N)) sum_k e^{j arg_k}: unit average power Rayleigh
    re = jnp.sum(jnp.cos(arg), axis=-1) / np.sqrt(N_SINUSOIDS)
    im = jnp.sum(jnp.sin(arg), axis=-1) / np.sqrt(N_SINUSOIDS)
    return jnp.stack([re, im], axis=-1)  # (B, T, n_taps, 2)


def apply_fading(x, key, profile: str, srate_hz: float, doppler_hz: float = 5.0,
                 sf_time_s: float = 0.0):
    """x: (B, T, 2) one-subframe samples.  Taps held constant within the
    subframe (block fading), evolving across subframes via sf_time_s.
    Returns (y (B, T, 2), taps (B, n_taps, 2))."""
    d, a = profile_taps(profile, srate_hz)
    B, T, _ = x.shape
    g = tap_gains(key, len(d), np.array([sf_time_s]), doppler_hz, B)[:, 0]  # (B,L,2)
    g = g * jnp.asarray(a)[None, :, None]
    y = jnp.zeros_like(x)
    for l, dl in enumerate(d):
        shifted = jnp.pad(x, ((0, 0), (int(dl), 0), (0, 0)))[:, :T, :]
        y = y + cplx.mul(g[:, None, l, :], shifted)
    return y, g


def apply_delay(x, delay_samples: int):
    """Static integer delay (delay.c's fixed case)."""
    T = x.shape[-2]
    return jnp.pad(x, ((0, 0), (delay_samples, 0), (0, 0)))[:, :T, :]


def hst_doppler_hz(t_s, fd_hz: float = 750.0, period_s: float = 7.2):
    """High-speed-train Doppler trajectory (36.101 B.3 / hst.c): the Doppler
    shift seen as the train passes the site, periodic."""
    t = np.mod(np.asarray(t_s), period_s)
    ds = period_s / 2
    # cosine model of the pass-by geometry
    return fd_hz * np.cos(np.pi * (t - ds) / ds)


def dynamic_delay_samples(t_s, min_samp: float, max_samp: float,
                          period_s: float) -> float:
    """Sinusoidal path-delay trajectory (lib/src/phy/channel/delay.c:26-44):
    the delay sweeps between min and max with the configured period."""
    mid = (max_samp + min_samp) / 2.0
    amp = (max_samp - min_samp) / 2.0
    return mid + amp * np.sin(2 * np.pi * np.asarray(t_s) / period_s)


def apply_delay_dyn(x, delay_samples):
    """Integer delay with a TRACED sample count: one compiled kernel
    serves the whole delay trajectory (gather with head zeroing)."""
    T = x.shape[-2]
    d = jnp.asarray(delay_samples, jnp.int32)
    src = jnp.arange(T, dtype=jnp.int32) - d
    vals = jnp.take(x, jnp.clip(src, 0, T - 1), axis=-2)
    return jnp.where((src >= 0)[:, None], vals, 0.0)


def apply_cfo_dyn(x, cfo_hz, srate_hz: float):
    """apply_cfo with a TRACED frequency (HST trajectories sweep the
    Doppler per subframe; a static-arg version would compile one kernel
    per shift value)."""
    T = x.shape[-2]
    n = jnp.arange(T, dtype=jnp.float32)
    ph = 2 * jnp.pi * jnp.asarray(cfo_hz, jnp.float32) * n / srate_hz
    rot = cplx.make(jnp.cos(ph), jnp.sin(ph))
    return cplx.mul(x, rot[None])


def apply_cfo(x, cfo_hz: float, srate_hz: float):
    """Frequency offset (also used for HST shift application)."""
    T = x.shape[-2]
    n = np.arange(T, dtype=np.float32)
    rot = cplx.make(jnp.asarray(np.cos(2 * np.pi * cfo_hz * n / srate_hz)),
                    jnp.asarray(np.sin(2 * np.pi * cfo_hz * n / srate_hz)))
    return cplx.mul(x, rot[None])


def apply_rlf(x, t_s: float, period_s: float = 2.0, outage_s: float = 0.2):
    """Radio-link-failure injection (rlf.c): zero the signal during periodic
    outage windows."""
    in_outage = (t_s % period_s) < outage_s
    return jnp.where(jnp.asarray(in_outage), jnp.zeros_like(x), x)
