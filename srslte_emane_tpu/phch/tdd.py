"""TDD frame structure (36.211 §4.2): UL/DL configurations 0-6 and special
subframe configurations 0-9.

Reference behavior: `lib/src/phy/common/phy_common.c:90-163`
(srslte_sfidx_tdd_type / _nof_dw / _nof_gp / _nof_up / _nof_dw_slot /
srslte_tdd_nof_harq).  Tables re-stated from 36.211 Tables 4.2-1/4.2-2;
note the reference's special-subframe row 8 sums to 13 symbols (typo) —
we use the spec value {11, 1, 2}.

Design: `dl_symbol_mask` returns a static (10, 14) frame mask so a whole
radio frame of grids can be masked in one vectorised multiply, and DwPTS
PDSCH uses the same host-precomputed RE index tables as FDD with the symbol
range truncated (grid.pdsch_re_indices(max_sym=nof_dw))."""

from __future__ import annotations

import numpy as np

# 36.211 Table 4.2-2: uplink-downlink configurations (5 ms / 10 ms switch)
UL_DL = (
    "DSUUUDSUUU",  # 0
    "DSUUDDSUUD",  # 1
    "DSUDDDSUDD",  # 2
    "DSUUUDDDDD",  # 3
    "DSUUDDDDDD",  # 4
    "DSUDDDDDDD",  # 5
    "DSUUUDSUUD",  # 6
)

# 36.211 Table 4.2-1: special subframe (DwPTS, GP, UpPTS) in normal-CP symbols
SS_SYMBOLS = (
    (3, 10, 1),
    (9, 4, 1),
    (10, 3, 1),
    (11, 2, 1),
    (12, 1, 1),
    (3, 9, 2),
    (9, 3, 2),
    (10, 2, 2),
    (11, 1, 2),
    (6, 6, 2),
)

# UL HARQ processes per configuration (36.213 Table 8-1 derived;
# phy_common.c:149 tdd_nof_harq)
NOF_HARQ = (7, 4, 2, 3, 2, 1, 6)

N_SYM = 14


def sf_type(sf_config: int, sf_idx: int) -> str:
    """'D' (downlink), 'S' (special) or 'U' (uplink) for subframe sf_idx."""
    return UL_DL[sf_config][sf_idx % 10]


def nof_dw(ss_config: int) -> int:
    """DwPTS length in OFDM symbols (normal CP)."""
    return SS_SYMBOLS[ss_config][0]


def nof_gp(ss_config: int) -> int:
    return SS_SYMBOLS[ss_config][1]


def nof_up(ss_config: int) -> int:
    return SS_SYMBOLS[ss_config][2]


def nof_dw_slot(ss_config: int, slot: int, n_slot_sym: int = 7) -> int:
    """DwPTS symbols falling in slot 0 / slot 1 (phy_common.c:113)."""
    n = nof_dw(ss_config)
    if n < n_slot_sym:
        return 0 if slot == 1 else n
    return n - n_slot_sym if slot == 1 else n_slot_sym


def nof_harq(sf_config: int) -> int:
    return NOF_HARQ[sf_config]


def dl_subframes(sf_config: int) -> tuple:
    """Subframe indices usable for PDSCH (D plus S with DwPTS)."""
    return tuple(i for i, t in enumerate(UL_DL[sf_config]) if t != "U")


def ul_subframes(sf_config: int) -> tuple:
    return tuple(i for i, t in enumerate(UL_DL[sf_config]) if t == "U")


def pdsch_max_sym(sf_config: int, ss_config: int, sf_idx: int) -> int:
    """Last usable PDSCH symbol (exclusive) in subframe sf_idx: 14 for D,
    DwPTS length for S.  Raises on U (no PDSCH)."""
    t = sf_type(sf_config, sf_idx)
    if t == "D":
        return N_SYM
    if t == "S":
        return nof_dw(ss_config)
    raise ValueError(f"subframe {sf_idx} is uplink in config {sf_config}")


def dl_symbol_mask(sf_config: int, ss_config: int) -> np.ndarray:
    """(10, 14) bool mask: True where a symbol carries downlink.

    One static table per (sf_config, ss_config); multiplying a whole frame
    of grids (B, 10, 14, NRE, 2) by mask[None, :, :, None, None] silences
    GP/UpPTS/UL in a single fused elementwise op."""
    m = np.zeros((10, N_SYM), dtype=bool)
    for i in range(10):
        t = sf_type(sf_config, i)
        if t == "D":
            m[i] = True
        elif t == "S":
            m[i, : nof_dw(ss_config)] = True
    return m


def ul_symbol_mask(sf_config: int, ss_config: int) -> np.ndarray:
    """(10, 14) bool mask: True where a symbol carries uplink (U subframes
    fully; last UpPTS symbols of S subframes)."""
    m = np.zeros((10, N_SYM), dtype=bool)
    for i in range(10):
        t = sf_type(sf_config, i)
        if t == "U":
            m[i] = True
        elif t == "S":
            m[i, N_SYM - nof_up(ss_config):] = True
    return m


# 36.213 Table 10.1.3.1-1: DL association sets K — UL subframe n carries
# HARQ-ACK for DL subframes n - k, k in K[sf_config][n]
DL_ASSOC_K = (
    {2: (6,), 4: (4,), 7: (6,), 9: (4,)},                      # 0
    {2: (7, 6), 3: (4,), 7: (7, 6), 8: (4,)},                  # 1
    {2: (8, 7, 4, 6), 7: (8, 7, 4, 6)},                        # 2
    {2: (7, 6, 11), 3: (6, 5), 4: (5, 4)},                     # 3
    {2: (12, 8, 7, 11), 3: (6, 5, 4, 7)},                      # 4
    {2: (13, 12, 9, 8, 7, 5, 4, 11, 6)},                       # 5
    {2: (7,), 3: (7,), 4: (5,), 7: (7,), 8: (7,)},             # 6
)

# 36.213 Table 8-2: UL grant timing — DCI0 in DL subframe n schedules PUSCH
# at n + K_UL[sf_config][n]
UL_GRANT_K = (
    {0: 4, 1: 6, 5: 4, 6: 6},      # 0
    {1: 6, 4: 4, 6: 6, 9: 4},      # 1
    {3: 4, 8: 4},                  # 2
    {0: 4, 8: 4, 9: 4},            # 3
    {8: 4, 9: 4},                  # 4
    {8: 4},                        # 5
    {0: 7, 1: 7, 5: 7, 6: 7, 9: 5},  # 6
)


def ack_subframe_for_dl(sf_config: int, dl_sf: int) -> int:
    """The UL subframe (as an offset-carrying absolute index) in which the
    HARQ-ACK for a PDSCH at subframe dl_sf is reported."""
    for n, ks in DL_ASSOC_K[sf_config].items():
        for k in ks:
            if (n - k) % 10 == dl_sf % 10:
                delta = (n - dl_sf % 10) % 10
                return dl_sf + (delta if delta else 10)
    raise ValueError((sf_config, dl_sf))


def pusch_subframe_for_grant(sf_config: int, dci_sf: int) -> int:
    """PUSCH subframe scheduled by a DCI0 sent at dci_sf."""
    k = UL_GRANT_K[sf_config].get(dci_sf % 10)
    if k is None:
        raise ValueError((sf_config, dci_sf))
    return dci_sf + k
