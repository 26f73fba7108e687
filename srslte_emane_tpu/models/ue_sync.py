"""UE synchronization state machine: CELL_SEARCH -> SFN_SYNC -> CAMPING.

Reference behavior: `srsue/src/phy/sync.cc` (state machine at sync.cc:364-470)
over `lib/src/phy/ue/ue_sync.c` (track/find with PSS + CP + CFO loops) and
`ue/ue_mib.c` (MIB decode for SFN).

Design: the host drives the state machine; each state's work is a batched
device call (correlation banks, MIB hypothesis decode).  Tracking refines
timing by a windowed PSS correlation around the expected position and blends
CFO estimates (the sync.c:343 blend) from CP and PSS phase.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import cplx, ofdm
from ..phch import chest, grid as grid_mod, pbch, sync


@dataclasses.dataclass
class UeSyncState:
    state: str = "CELL_SEARCH"
    cell_id: int = -1
    n_prb: int = 6
    sample_offset: int = 0
    cfo_hz: float = 0.0
    sfn: int = -1
    n_ports: int = 1
    quality: float = 0.0
    sfo_ppm: float = 0.0  # sample-clock error estimate (sfo.c)
    cp: str = "normal"  # auto-detected during cell search (sync.c:68-78)


def sfo_estimate(peak_drifts, period_samples: int) -> float:
    """Sample-frequency-offset from successive PSS timing drifts
    (`lib/src/phy/sync/sfo.c` srslte_sfo_estimate): the mean drift per
    tracking period, as a fraction of the sample clock (x1e6 = ppm)."""
    d = np.asarray(peak_drifts, dtype=np.float64)
    if d.size == 0:
        return 0.0
    return float(np.mean(d)) / period_samples


def cfo_est_cp(samples, n_prb: int) -> float:
    """CP-based CFO estimate (averaged over symbols): angle between CP and
    its copy N samples later (ue_sync.c cfo_cp)."""
    p = ofdm.params(n_prb)
    n = p["n"]
    x = np.asarray(samples)
    acc = 0j
    for start, cp in ofdm._symbol_starts(n_prb):
        a = x[start : start + cp]
        b = x[start + n : start + n + cp]
        acc += np.sum(np.conj(a) * b)
    ang = np.angle(acc)
    srate = p["sf_len"] * 1000.0
    return ang / (2 * np.pi) * srate / n


class UeSync:
    """Host-side driver; consumes one subframe of samples per step."""

    def __init__(self, n_prb: int = 6):
        self.s = UeSyncState(n_prb=n_prb)
        self._sf_count = 0

    def step(self, samples: np.ndarray) -> UeSyncState:
        """samples: (SF_LEN_max,) complex64 stream chunk (>= 1 subframe)."""
        if self.s.state == "CELL_SEARCH":
            self._cell_search(samples)
        elif self.s.state == "SFN_SYNC":
            self._sfn_sync(samples)
        else:
            self._track(samples)
        return self.s

    def _cell_search(self, samples):
        res = sync.cell_search(cplx.from_numpy(samples[None]), detect_cp=True)
        q = float(np.asarray(res["quality"])[0])
        if q < 10.0:
            return
        self.s.cell_id = int(np.asarray(res["cell_id"])[0])
        self.s.cp = "ext" if bool(np.asarray(res["cp_ext"])[0]) else "normal"
        pss_pos = int(np.asarray(res["pss_pos"])[0])
        sf_idx = int(np.asarray(res["sf_idx"])[0])
        # align so the NEXT chunk starts at a subframe boundary of sf 0/5
        self.s.sample_offset = pss_pos - sync.pss_symbol_start(
            self.s.n_prb, self.s.cp)
        self.s.quality = q
        self.s.cfo_hz = cfo_est_cp(
            samples[self.s.sample_offset : self.s.sample_offset + 1920], self.s.n_prb)
        self._search_sf = sf_idx
        self.s.state = "SFN_SYNC"

    def _corrected(self, samples):
        off = self.s.sample_offset
        sf_len = ofdm.params(self.s.n_prb)["sf_len"]
        x = samples[off : off + sf_len]
        if self.s.cfo_hz:
            n = np.arange(len(x))
            x = x * np.exp(-2j * np.pi * self.s.cfo_hz * n / (sf_len * 1000.0))
        return x

    def _sfn_sync(self, samples):
        """Decode MIB from the sf0 capture to learn SFN + ports."""
        if self._search_sf != 0:
            # the found PSS was sf5; next PSS occurrence 5 sf later is sf0 —
            # callers feed a continuous stream, just flip the expectation
            self._search_sf = 0
            return
        x = self._corrected(samples)
        cell = grid_mod.CellConfig(n_prb=self.s.n_prb, cell_id=self.s.cell_id)
        g = ofdm.demodulate(cplx.from_numpy(x[None]), self.s.n_prb)
        ch0 = chest.estimate(g, cell, 0, port=0)
        ch1 = chest.estimate(g, cell, 0, port=1)
        mib, ports, off, ok = pbch.decode(g, ch0.ce, cell, ce_port1=ch1.ce)
        if bool(np.asarray(ok)[0]):
            info = pbch.unpack_mib(np.asarray(mib)[0])
            self.s.sfn = info["sfn_msb"] * 4 + int(np.asarray(off)[0])
            self.s.n_ports = int(np.asarray(ports)[0])
            self.s.state = "CAMPING"

    def _track(self, samples):
        """CAMPING: refine timing via PSS around the expected position and
        update the CFO blend (only on sf 0/5 when PSS is present)."""
        self._sf_count += 1
        sf_idx = (self.s.sfn * 10 + self._sf_count) % 10
        if sf_idx not in (0, 5):
            return
        exp = self.s.sample_offset + sync.pss_symbol_start(self.s.n_prb)
        lo = max(0, exp - 16)
        win = samples[lo : exp + 16 + 128]
        e, _ = sync.pss_correlate(cplx.from_numpy(win[None]))
        n2 = self.s.cell_id % 3
        pos = int(np.argmax(np.asarray(e)[0, n2]))
        drift = (lo + pos) - exp
        if abs(drift) <= 16:
            self.s.sample_offset += drift
            # SFO: mean timing drift per 5 ms tracking period (sfo.c)
            if not hasattr(self, "_drifts"):
                import collections as _c

                self._drifts = _c.deque(maxlen=16)
            self._drifts.append(drift)
            period = 5 * ofdm.params(self.s.n_prb)["sf_len"]
            self.s.sfo_ppm = 1e6 * sfo_estimate(self._drifts, period)
        cfo_new = cfo_est_cp(self._corrected(samples), self.s.n_prb)
        self.s.cfo_hz += 0.3 * cfo_new  # blended tracking loop (sync.c:343)
