"""PCFICH: control format indicator channel.

Reference behavior: `lib/src/phy/phch/pcfich.c` — 32-bit CFI codewords,
cell/subframe scrambling, QPSK, 4 REG quadruplets (regs placement in regs.c).

Design: encode is a LUT + scramble + modulate; decode is a correlation of
the 32 descrambled LLRs against the 3 codewords, batched — soft ML detection
(the reference does the same correlation, pcfich.c).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..ops import modem, scrambling
from . import grid as grid_mod, regs as regs_mod

# 36.212 Table 5.3.4-1: repeating patterns (0,1,1) / (1,0,1) / (1,1,0), 32 bits
CFI_CODEWORDS = np.stack(
    [np.tile(np.array(p, dtype=np.int8), 11)[:32]
     for p in ((0, 1, 1), (1, 0, 1), (1, 1, 0))]
)


@functools.lru_cache(maxsize=None)
def re_indices(cell: grid_mod.CellConfig) -> np.ndarray:
    ch = regs_mod.channel_regs(cell.n_prb, cell.cell_id, cell.n_ports)
    return regs_mod.reg_re_indices(
        cell.n_prb, cell.cell_id, cell.n_ports, ch["pcfich"]
    ).reshape(-1)


def encode(cfi, cell: grid_mod.CellConfig, sf_idx: int, grid):
    """Place PCFICH for scalar CFI value (1..3) into grid (B, 14, NRE, 2)."""
    bits = jnp.asarray(CFI_CODEWORDS)[jnp.asarray(cfi) - 1]
    if bits.ndim == 1:
        bits = jnp.broadcast_to(bits, (grid.shape[0], 32))
    c_init = scrambling.pcfich_cinit(sf_idx, cell.cell_id)
    scr = scrambling.scramble_bits(bits, c_init)
    syms = modem.modulate(scr, modem.QPSK)  # (B, 16, 2)
    idx = re_indices(cell)
    flat = grid.reshape(grid.shape[0], -1, 2)
    flat = flat.at[:, jnp.asarray(idx), :].set(syms)
    return flat.reshape(grid.shape)


def decode(rx_grid, ce, cell: grid_mod.CellConfig, sf_idx: int, ce_port1=None):
    """Soft-ML CFI detection.  Returns (cfi (B,) int32 in 1..3, corr (B,3)).

    With ce_port1 given, uses SFBC/Alamouti combining (2-port cells)."""
    from . import chest
    from ..ops import mimo

    idx = jnp.asarray(re_indices(cell))
    y = jnp.take(rx_grid.reshape(rx_grid.shape[0], -1, 2), idx, axis=-2)
    h = jnp.take(ce.reshape(ce.shape[0], -1, 2), idx, axis=-2)
    if ce_port1 is not None:
        h1 = jnp.take(ce_port1.reshape(ce.shape[0], -1, 2), idx, axis=-2)
        layers, csi = mimo.decode_sfbc(y, jnp.stack([h, h1], axis=1))
        x_eq = mimo.layer_demap(layers, 1)[0]
        w = csi.swapaxes(-1, -2).reshape(csi.shape[0], -1)
        llr = modem.demod_soft(x_eq, modem.QPSK) * jnp.repeat(w, 2, axis=-1)
    else:
        x_eq, csi = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x_eq, modem.QPSK) * jnp.repeat(csi, 2, axis=-1)
    c_init = scrambling.pcfich_cinit(sf_idx, cell.cell_id)
    llr = scrambling.scramble_llrs(llr, c_init)
    # correlation with bipolar codewords (positive llr = bit 0)
    bip = 1.0 - 2.0 * CFI_CODEWORDS.astype(np.float32)
    corr = llr @ jnp.asarray(bip.T)  # (B, 3)
    return jnp.argmax(corr, axis=-1).astype(jnp.int32) + 1, corr
