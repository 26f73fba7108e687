"""Timed TTI message bus — the libemanelte MHAL equivalent.

Reference behavior: `EMANELTE::MHAL::{ENB,UE}::send_msg(msg, tx_control)` and
blocking `get_messages(msgs, &sor_time)` that paces the 1 ms TTI clock
(SURVEY.md §2.3/§5); receive-side messages carry a SINRTester handle.

This in-process bus runs whole emulated networks in one process,
faster-than-real-time by default (the framework's design goal) or paced at 1 kHz
(`paced=True`) to mirror the reference's real-time budget.  Multi-host
operation shards nodes across processes/chips; frames then ride
host-side transport while PHY tensors stay device-resident (parallel/mesh).
"""

from __future__ import annotations

import collections
import time
import typing


from . import otamsg, sinr as sinr_mod


def frame_rnti_set(fr) -> set:
    """RNTIs a DL frame addresses (cached on the frame; shared with the
    UE adapters' dormant filter)."""
    rset = getattr(fr, "_rnti_set", None)
    if rset is None:
        msg = fr.msg
        rset = {d.rnti for d in getattr(msg, "pdcch_dl", ())}
        rset.update(d.rnti for d in getattr(msg, "pdcch_ul", ()))
        rset.update(d.refid for d in getattr(msg, "pdsch", ()))
        rset.update(ph["rnti"] for ph in getattr(msg, "phich", ()))
        pm = getattr(msg, "pmch", None)
        if pm is not None:
            rset.add(pm.get("rnti", 0xFFFD))  # M-RNTI wakes MBMS listeners
        fr._rnti_set = rset
    return rset


class OtaBus:
    def __init__(self, prop: sinr_mod.Propagation, node_ids, n_prb: int,
                 paced: bool = False, roles: dict = None):
        self.prop = prop
        self.node_ids = list(node_ids)
        self.n_prb = n_prb
        self.paced = paced
        # optional node_id -> "enb"|"ue" map: with roles known, DL frames
        # are delivered (and adjudicated) only to UEs and UL frames only to
        # eNBs — the EMANE hub's O(tx x rx) fan-out pruned to O(relevant)
        self.roles = roles
        self._rx_of = None if roles is None else {
            "ue": [n for n in self.node_ids if roles.get(n) == "ue"],
            "enb": [n for n in self.node_ids if roles.get(n) == "enb"]}
        self.curr_tti = 0
        self._pending: typing.List[otamsg.OtaFrame] = []
        self._delivered: typing.Dict[int, list] = collections.defaultdict(list)
        # DRX-like receiver sleep registry: node_id -> (until_tti,
        # listen_rnti_set, serving_pci).  While a node sleeps, serving-cell
        # DL frames that address none of its RNTIs are neither delivered
        # nor SINR-adjudicated for it (the EMANE hub's fan-out pruned to
        # receivers that would act on the frame).
        self.sleep_state: typing.Dict[int, tuple] = {}
        # sleeping receivers that were handed a frame this TTI: the event-
        # driven ttiloop re-activates them immediately (paging / grant /
        # neighbor-cell wake)
        self.woken: set = set()
        # indexed receiver selection (O(relevant) per frame, not O(nodes)):
        #   _awake        UE ids NOT sleeping (with roles known)
        #   _listen_idx   rnti -> sleeping ids listening for it
        #   _sleep_by_cell serving pci -> sleeping ids (cross-cell frames
        #                 always deliver: neighbor measurement / wake)
        #   _due_at       wrapped tti -> [(id, until)] one-TTI-before-wake
        #                 deliveries (the wake-TTI subframe)
        self._awake: typing.Optional[set] = (
            set(self._rx_of["ue"]) if self._rx_of is not None else None)
        self._listen_idx: typing.Dict[int, set] = {}
        self._sleep_by_cell: typing.Dict[int, set] = {}
        self._due_at: typing.Dict[int, list] = {}
        self._outs_memo: typing.Dict[tuple, tuple] = {}
        self._t0 = time.monotonic()

    def set_sleep(self, node_id: int, until_tti: int, listen, serving_pci):
        old = self.sleep_state.get(node_id)
        if old is not None:
            if old[1] == listen and old[2] == serving_pci:
                # re-sleep with unchanged listen set / cell: keep the
                # bucket entries, just extend the window
                self.sleep_state[node_id] = (until_tti, listen, serving_pci)
                if self._awake is not None:
                    self._due_at.setdefault(
                        (until_tti - 1) % 10240, []).append(
                        (node_id, until_tti))
                return
            self._unsleep(node_id)
        self.sleep_state[node_id] = (until_tti, listen, serving_pci)
        if self._awake is not None:
            self._awake.discard(node_id)
            self._sleep_by_cell.setdefault(serving_pci, set()).add(node_id)
            for rnti in listen:
                self._listen_idx.setdefault(rnti, set()).add(node_id)
            self._due_at.setdefault((until_tti - 1) % 10240, []).append(
                (node_id, until_tti))

    def _unsleep(self, node_id: int):
        sl = self.sleep_state.pop(node_id, None)
        if sl is None or self._awake is None:
            return
        self._awake.add(node_id)
        cell = self._sleep_by_cell.get(sl[2])
        if cell is not None:
            cell.discard(node_id)
        for rnti in sl[1]:
            idx = self._listen_idx.get(rnti)
            if idx is not None:
                idx.discard(node_id)
                if not idx:
                    del self._listen_idx[rnti]
        # stale _due_at entries are validated (id, until) at pop time

    def clear_sleep(self, node_id: int):
        self._unsleep(node_id)

    def send_msg(self, frame: otamsg.OtaFrame):
        """Transmit during the current TTI (MHAL send_msg)."""
        self._pending.append(frame)

    def step_tti(self):
        """Close the current TTI: adjudicate SINR for all emissions and
        enqueue (frame, tester) at each receiver; advance the clock.
        Sleeping receivers get neither delivery nor testers for
        serving-cell frames that address none of their RNTIs."""
        tti = self.curr_tti
        sleep = self.sleep_state
        # sleepers whose wake TTI is next: they receive this TTI's frames
        # (consumed on their wake TTI — the stride-boundary sync sample)
        due = set()
        for nid, until in self._due_at.pop(tti, ()):
            sl = sleep.get(nid)
            if sl is not None and sl[0] == until:
                due.add(nid)
        recv = {}
        for fr in self._pending:
            if self._rx_of is None:
                # no role map: legacy full scan with per-receiver filters
                outs = []
                rset = None
                for rid in self.node_ids:
                    if rid == fr.src:
                        continue
                    sl = sleep.get(rid) if fr.txc.is_downlink else None
                    if (sl is not None and tti + 1 < sl[0]
                            and fr.txc.phy_cell_id == sl[2]):
                        if rset is None:
                            rset = frame_rnti_set(fr)
                        if not (rset & sl[1]):
                            continue
                    outs.append(rid)
            elif not fr.txc.is_downlink:
                outs = [r for r in self._rx_of["enb"] if r != fr.src]
            else:
                # indexed selection: awake UEs + due-to-wake sleepers +
                # sleepers listening for an addressed rnti + sleepers
                # camped on a different cell (neighbor frames always
                # deliver — measurement and wake)
                cands = self._awake | due
                lidx = self._listen_idx
                if lidx:
                    for rnti in frame_rnti_set(fr):
                        s = lidx.get(rnti)
                        if s:
                            cands |= s
                pci = fr.txc.phy_cell_id
                for pci2, ids in self._sleep_by_cell.items():
                    if pci2 != pci and ids:
                        cands |= ids
                cands.discard(fr.src)
                outs = sorted(cands)
            # intern equal receiver lists as ONE tuple object per source:
            # python tuples cache their hash, so the SINR adjudication
            # cache key hashes the (possibly 500-long) receiver tuple once
            # per change instead of once per TTI
            key = (fr.src, fr.txc.is_downlink, fr.txc.phy_cell_id,
                   fr.txc.freq_idx)
            memo = self._outs_memo.get(key)
            if memo is not None and memo[0] == outs:
                outs_t = memo[1]
            else:
                outs_t = tuple(outs)
                self._outs_memo[key] = (outs, outs_t)
            recv[id(fr)] = outs_t
        testers = sinr_mod.adjudicate(
            self._pending, self.prop, self.n_prb, self.node_ids,
            roles=self.roles, recv=recv
        )
        for fr in self._pending:
            dl = self._delivered
            t = testers
            fid = id(fr)
            for rid in recv[fid]:
                dl[rid].append((fr, t[(fid, rid)]))
                if rid in sleep:
                    self._unsleep(rid)
                    self.woken.add(rid)
        self._pending = []
        self.curr_tti = (self.curr_tti + 1) % 10240
        if self.paced:
            target = self._t0 + self.curr_tti * 1e-3
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)

    def take_woken(self) -> set:
        """Drain the set of receivers woken by a delivery this TTI."""
        w = self.woken
        if w:
            self.woken = set()
        return w

    def get_messages(self, node_id: int):
        """Drain messages delivered to `node_id` (MHAL get_messages): list of
        (OtaFrame, SinrTester)."""
        out = self._delivered[node_id]
        self._delivered[node_id] = []
        return out
