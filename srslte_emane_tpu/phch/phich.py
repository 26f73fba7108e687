"""PHICH: HARQ indicator channel (normal duration, normal CP).

Reference behavior: `lib/src/phy/phch/phich.c` — BPSK ACK/NACK, 3x repetition,
length-4 orthogonal Walsh spreading (8 sequences: 4 real, 4 imaginary),
cell/subframe scrambling, superposition of up to 8 PHICHs per group on 3 REGs.

Design: encode/decode of all groups and sequence indices batches as one
einsum against the (8, 12) spread-scramble matrix per subframe.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..ops import sequence as seq_mod
from . import grid as grid_mod, regs as regs_mod

NSF = 4  # spreading factor, normal CP
# 36.211 Table 6.9.1-2 orthogonal sequences (seq 0-3 real, 4-7 = j * seq 0-3)
WALSH = np.array(
    [[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]], dtype=np.float32
)


def n_groups(n_prb: int, ng: str = "1") -> int:
    return int(np.ceil(regs_mod.PHICH_NG[ng] * n_prb / 8))


def alloc(i_prb_lowest: int, n_dmrs: int, n_group: int) -> tuple:
    """(n_group, n_seq) for a PUSCH's HARQ indicator (36.213 §9.1.2):
    derived from the PUSCH's lowest PRB and its DMRS cyclic shift —
    the mapping the eNB and UE must agree on without signalling
    (lib/src/phy/phch/phich.c:131-134 ngroup/nseq calc)."""
    g = (i_prb_lowest + n_dmrs) % n_group
    s = (i_prb_lowest // n_group + n_dmrs) % (2 * NSF)
    return g, s


@functools.lru_cache(maxsize=None)
def re_indices(cell: grid_mod.CellConfig, ng: str = "1") -> np.ndarray:
    ch = regs_mod.channel_regs(cell.n_prb, cell.cell_id, cell.n_ports, ng)
    return regs_mod.reg_re_indices(
        cell.n_prb, cell.cell_id, cell.n_ports, ch["phich"]
    ).reshape(ch["phich"].shape[0], 12)


@functools.lru_cache(maxsize=None)
def _spread_matrix(cell_id: int, sf_idx: int) -> np.ndarray:
    """(8, 12, 2) cf: sequence nseq -> spread+scrambled unit-ACK waveform.
    d(i) = w(i mod 4) * (1 - 2 c(i)), repeated x3 (phich.c)."""
    c_init = ((sf_idx + 1) * (2 * cell_id + 1) << 9) + cell_id
    c = seq_mod.gold_sequence_host(c_init, 12).astype(np.float32)
    scr = 1.0 - 2.0 * c
    out = np.zeros((8, 12, 2), dtype=np.float32)
    for nseq in range(8):
        w = WALSH[nseq % 4]
        d = np.tile(w, 3) * scr
        if nseq < 4:
            out[nseq, :, 0] = d
        else:
            out[nseq, :, 1] = d
    return out


def encode(acks, cell: grid_mod.CellConfig, sf_idx: int, grid, ng: str = "1"):
    """acks: (B, ngroups, 8) in {-1 (nack), 0 (off), +1 (ack)} — superposed.
    Places all PHICH groups into grid."""
    sm = jnp.asarray(_spread_matrix(cell.cell_id, sf_idx))  # (8, 12, 2)
    d = jnp.einsum("bgs,sic->bgic", acks.astype(jnp.float32), sm)  # (B,G,12,2)
    idx = re_indices(cell, ng)[: d.shape[1]]  # (G, 12)
    flat = grid.reshape(grid.shape[0], -1, 2)
    flat = flat.at[:, jnp.asarray(idx.reshape(-1)), :].set(
        d.reshape(d.shape[0], -1, 2)
    )
    return flat.reshape(grid.shape)


def decode(rx_grid, ce, cell: grid_mod.CellConfig, sf_idx: int, ng: str = "1"):
    """Despread all (group, nseq) hypotheses.  Returns soft metrics
    (B, ngroups, 8): >0 means ACK."""
    from . import chest

    idx = re_indices(cell, ng)
    flat_rx = rx_grid.reshape(rx_grid.shape[0], -1, 2)
    flat_ce = ce.reshape(ce.shape[0], -1, 2)
    y = jnp.take(flat_rx, jnp.asarray(idx.reshape(-1)), axis=-2)
    h = jnp.take(flat_ce, jnp.asarray(idx.reshape(-1)), axis=-2)
    x_eq, csi = chest.equalize_zf(y, h)
    x = (x_eq * csi[..., None]).reshape(rx_grid.shape[0], idx.shape[0], 12, 2)
    sm = jnp.asarray(_spread_matrix(cell.cell_id, sf_idx))
    # correlate: real part of <x, conj(spread)>
    corr = jnp.einsum("bgic,sic->bgs", x, sm)
    return corr / 12.0
