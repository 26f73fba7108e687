"""Traced-cell beacon synthesis: N heterogeneous cells in ONE program.

Reference context: every srsLTE cell object is specialized at init to its
PCI — CRS sequences pregenerated per cell (`lib/src/phy/ch_estimation/
refsignal_dl.c`), PSS/SSS chosen from the id (`lib/src/phy/sync/pss.c`,
`sss.c`), and a network of N cells is N processes.  Scanning a deployment
(`srsue/src/phy/scell/intra_measure.cc` neighbor search) walks them serially.

Design: `cell_id` becomes DATA, not a compile-time constant —

- CRS values: c_init arithmetic is done in-graph and the Gold sequence is
  the (31, n) GF(2) response matmul (`ops/sequence.py`), so any batch of
  (cell, symbol) pilots is one matmul;
- CRS placement: frequency shift (cell_id mod 6) becomes a one-hot
  (pilot -> subcarrier) matmul instead of a host-precomputed scatter table;
- PSS/SSS: the 3 PSS replicas and the full 504-entry SSS bank are small
  constant tables gathered by traced id.

One jitted `build_beacons` therefore synthesizes ANY number of distinct
cells, vmap/shard-ready — the building block for deployment-scale scans
(cells sharded over the device mesh via `parallel.ota_collective`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx, ofdm, sequence
from ..phch import grid as grid_mod, sync

MAX_PRB = 110


@functools.lru_cache(maxsize=4)
def _sss_table(sf_idx: int) -> np.ndarray:
    """(504, 62) bipolar SSS for every cell id at subframe 0 or 5."""
    out = np.zeros((504, 62), np.float32)
    for cid in range(504):
        out[cid] = sync.sss_sequence(cid // 3, cid % 3, sf_idx)
    return out


@functools.lru_cache(maxsize=2)
def _pss_table() -> np.ndarray:
    """(3, 62) complex PSS replicas."""
    return np.stack([sync.pss_freq(h) for h in range(3)])


def _crs_values_traced(cell_ids, sf_idx: int, n_prb: int):
    """(N, 4, 2*n_prb, 2) port-0 CRS pilot values for traced cell ids.

    grid.crs_values with c_init computed in-graph (36.211 §6.10.1.1):
    c_init = 2^10 (7(ns+1)+l+1)(2 cid+1) + 2 cid + 1  [normal CP]."""
    cell_ids = jnp.asarray(cell_ids, jnp.int32)
    N = cell_ids.shape[0]
    syms = grid_mod.pilot_syms(0)  # (0, 4, 7, 11)
    ns_l = np.array([(2 * sf_idx + s // 7, s % 7) for s in syms], np.int64)
    sym_f = jnp.asarray(7 * (ns_l[:, 0] + 1) + ns_l[:, 1] + 1, jnp.int32)
    c_init = (1024 * sym_f[None, :] * (2 * cell_ids[:, None] + 1)
              + 2 * cell_ids[:, None] + 1)  # (N, 4)
    c = sequence.gold_sequence(c_init.reshape(-1), 4 * MAX_PRB)
    c = c.reshape(N, len(syms), 4 * MAX_PRB).astype(jnp.float32)
    m = np.arange(2 * n_prb)
    mp = m + MAX_PRB - n_prb
    re = (1.0 - 2.0 * c[..., 2 * mp]) / np.sqrt(2.0)
    im = (1.0 - 2.0 * c[..., 2 * mp + 1]) / np.sqrt(2.0)
    return jnp.stack([re, im], axis=-1)


def build_beacons(cell_ids, n_prb: int = 6, sf_idx: int = 0):
    """(N, 14, 12*n_prb, 2) beacon grids — port-0 CRS + PSS/SSS — for a
    vector of (traced) cell ids.  Call under jit/vmap/shard_map."""
    cell_ids = jnp.asarray(cell_ids, jnp.int32)
    N = cell_ids.shape[0]
    nre = 12 * n_prb
    vals = _crs_values_traced(cell_ids, sf_idx, n_prb)  # (N, 4, 2*n_prb, 2)
    # pilot -> subcarrier one-hot: k = (v + cid%6) % 6 + 6m
    v = np.array([grid_mod.cs_v(0, i) for i in range(4)], np.int32)  # 0,3,0,3
    shift = cell_ids % 6  # (N,)
    k = ((v[None, :, None] + shift[:, None, None]) % 6
         + 6 * np.arange(2 * n_prb)[None, None, :])  # (N, 4, 2*n_prb)
    onehot = (k[..., None] == np.arange(nre)).astype(jnp.float32)
    # (N, 4, P, NRE) x (N, 4, P, 2) -> (N, 4, NRE, 2): a matmul per re/im part
    crs_rows = jnp.einsum("nspk,nspc->nskc", onehot, vals)
    grid = jnp.zeros((N, 14, nre, 2), jnp.float32)
    syms = grid_mod.pilot_syms(0)
    for i, s in enumerate(syms):
        grid = grid.at[:, s].set(crs_rows[:, i])
    # PSS (symbol 6) / SSS (symbol 5): constant tables gathered by id
    ks = np.arange(nre // 2 - 31, nre // 2 + 31)
    pss = cplx.from_numpy(_pss_table())  # (3, 62, 2)
    pss_n = jnp.take(pss, cell_ids % 3, axis=0)
    sss_t = _sss_table(sf_idx)  # (504, 62) real bipolar
    sss_n = jnp.take(jnp.asarray(sss_t), cell_ids, axis=0)
    sss_n = jnp.stack([sss_n, jnp.zeros_like(sss_n)], axis=-1)
    grid = grid.at[:, 6, ks].set(pss_n)
    grid = grid.at[:, 5, ks].set(sss_n)
    return grid


def beacon_waveforms(cell_ids, n_prb: int = 6, sf_idx: int = 0):
    """(N, T, 2) time-domain beacon subframes (1.92 Msps at 6 PRB)."""
    return ofdm.modulate(build_beacons(cell_ids, n_prb, sf_idx), n_prb)


def network_scan(mesh, cell_ids, gains, key=None, noise_std: float = 0.0,
                 n_prb: int = 6):
    """Deployment-scale scan: synthesize all cells' beacons (one traced
    program), superpose them over the sharded OTA medium, and run batched
    cell search on every observation point's capture.

    cell_ids: (N,) ints; gains: (N, N) complex rx-by-tx link matrix
    (diagonal ignored).  Returns the `sync.cell_search` dict per row —
    observation point i sees the gain-weighted sum of all OTHER cells.
    """
    from ..parallel import ota_collective

    tx = beacon_waveforms(jnp.asarray(cell_ids, jnp.int32), n_prb)
    tx = tx[:, None]  # (N, B=1, T, 2)
    if mesh is not None:
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("node", None, None, None))
        tx = jax.lax.with_sharding_constraint(tx, sharding)
        rx = ota_collective.ota_mix_sharded(mesh, tx, gains, key=key,
                                            noise_std=noise_std)
    else:
        g = jnp.asarray(gains) * (1.0 - jnp.eye(tx.shape[0]))
        xr = (jnp.einsum("mn,nbs->mbs", jnp.real(g).astype(jnp.float32), tx[..., 0])
              - jnp.einsum("mn,nbs->mbs", jnp.imag(g).astype(jnp.float32), tx[..., 1]))
        xi = (jnp.einsum("mn,nbs->mbs", jnp.real(g).astype(jnp.float32), tx[..., 1])
              + jnp.einsum("mn,nbs->mbs", jnp.imag(g).astype(jnp.float32), tx[..., 0]))
        rx = jnp.stack([xr, xi], axis=-1)
        if noise_std and key is not None:
            rx = rx + noise_std * jax.random.normal(key, rx.shape) / jnp.sqrt(2.0)
    return sync.cell_search(rx[:, 0])
