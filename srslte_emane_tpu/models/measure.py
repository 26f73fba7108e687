"""Neighbor-cell measurement: RSRP/RSRQ from CRS, batched over cell ids.

Reference behavior: `srsue/src/phy/scell/intra_measure.cc` (neighbor RSRP
measurement thread) and `scell_recv.cc` (secondary-cell sync) over
`chest_dl.c`'s measurement outputs.

Design: RSRP for every candidate PCI is one correlation — CRS pilot
positions/values per PCI are host tables; the measurement over all
candidates batches into a single gather + einsum per subframe batch.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..phch import grid as grid_mod


def measure_cells(rx_grid, n_prb: int, sf_idx: int, pci_list, port: int = 0):
    """rx_grid: (B, 14, NRE, 2).  Returns dict pci -> (rsrp (B,), rsrq (B,)).

    RSRP = |mean LS estimate at that PCI's CRS positions|-power;
    RSRQ = N_PRB * RSRP / RSSI (36.214 definitions, wideband)."""
    B = rx_grid.shape[0]
    nre = 12 * n_prb
    flat = rx_grid.reshape(B, -1, 2)
    rssi = jnp.mean(cplx.abs2(rx_grid), axis=(-3, -2))  # mean RE power
    out = {}
    for pci in pci_list:
        cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=pci)
        ks = grid_mod.crs_k(pci, n_prb, port)
        syms = grid_mod.pilot_syms(port)
        vals = grid_mod.crs_values(pci, sf_idx, n_prb, port)
        pidx = (np.asarray(syms)[:, None] * nre + ks).reshape(-1).astype(np.int32)
        y = jnp.take(flat, jnp.asarray(pidx), axis=-2)
        r = cplx.from_numpy(vals.reshape(-1))
        h = cplx.mul_conj(y, jnp.asarray(r))
        # coherent average within each PRB pair (2 pilots) to reject noise,
        # power-average across pilots
        hp = h.reshape(B, -1, 2, 2)  # (B, groups, pair, cf)
        coh = jnp.mean(hp, axis=-2)
        rsrp = jnp.mean(cplx.abs2(coh), axis=-1)
        rsrq = n_prb * rsrp / (jnp.maximum(rssi, 1e-12) * nre / 12.0)
        out[pci] = (rsrp, rsrq)
    return out


def strongest_cell(rx_grid, n_prb: int, sf_idx: int, pci_list):
    meas = measure_cells(rx_grid, n_prb, sf_idx, pci_list)
    rsrps = jnp.stack([meas[p][0] for p in pci_list], axis=1)
    best = jnp.argmax(rsrps, axis=1)
    return [pci_list[int(b)] for b in np.asarray(best)], meas
