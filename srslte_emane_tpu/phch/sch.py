"""DL-SCH / UL-SCH transport-block codec (the engine shared by PDSCH/PUSCH/PMCH).

Reference behavior: `lib/src/phy/phch/sch.c` — encode_tb (sch.c:291): TB CRC24A
attach -> segmentation -> per-CB CRC24B -> turbo encode -> rate match -> concat;
decode_tb (sch.c:429) with CRC early stop (sch.c:350-383) and per-CB soft
buffers for IR-HARQ (sch.c:389-414).

Design: all C code blocks of a TB are batched along one axis (padded to
K_plus — C_minus blocks of K_minus are right-padded as known-zero "virtual
fillers" only at the *decoder* a-priori level; for exactness we instead run
two batched calls when K differs).  Across-TB batching: callers batch TBs of
identical grant shape, the natural unit of batched work.

Per-CB rate-match output sizes E_r (36.212 §5.1.4.1.2):
  E_r = Nl*Qm*floor(G'/C) for r <= C - (G' mod C) - 1 else Nl*Qm*ceil(G'/C),
  G' = G/(Nl*Qm).
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from ..ops.fec import cbsegm, crc, rm_turbo, turbo, turbodecoder


@dataclasses.dataclass(frozen=True)
class SchConfig:
    """Static shape parameters of one TB configuration."""
    tbs: int  # transport block size (bits, no CRC)
    G: int  # total rate-matched bits for the codeword
    Qm: int  # modulation order (bits/symbol)
    Nl: int  # layers this codeword maps to
    rv: int = 0
    ncb: int = 0  # soft-buffer limit (0 = unlimited, 3*Kp)

    @functools.cached_property
    def segm(self) -> cbsegm.CbSegm:
        return cbsegm.cbsegm(self.tbs)

    @functools.cached_property
    def e_sizes(self) -> list:
        s = self.segm
        C = s.C
        gp = self.G // (self.Nl * self.Qm)
        gamma = gp % C
        e = []
        for r in range(C):
            if r <= C - gamma - 1:
                e.append(self.Nl * self.Qm * (gp // C))
            else:
                e.append(self.Nl * self.Qm * (-(-gp // C)))
        assert sum(e) == self.G
        return e


def _segment_bits(tb_bits: np.ndarray, cfg: SchConfig):
    """Host-side segmentation of (B, tbs) payload bits into per-CB bit arrays
    with CRCs and fillers.  Returns list of (B, K_r) arrays (device)."""
    s = cfg.segm
    b = jnp.asarray(tb_bits, dtype=jnp.int8)
    with_tb_crc = crc.crc_attach(b, crc.LTE_CRC24A)  # (B, tbs+24)
    if s.C == 1:
        k = s.K_plus
        filler = jnp.zeros((b.shape[0], s.F), dtype=jnp.int8)
        return [jnp.concatenate([filler, with_tb_crc], axis=1)], [s.F]
    # split into C chunks: first chunk shorter by F
    sizes = [kr - cbsegm.CB_CRC_LEN for kr in s.cb_sizes]
    sizes[0] -= s.F
    out, fs = [], []
    off = 0
    for r, sz in enumerate(sizes):
        chunk = with_tb_crc[:, off : off + sz]
        off += sz
        if r == 0 and s.F:
            chunk = jnp.concatenate(
                [jnp.zeros((b.shape[0], s.F), dtype=jnp.int8), chunk], axis=1
            )
        out.append(crc.crc_attach(chunk, crc.LTE_CRC24B))
        fs.append(s.F if r == 0 else 0)
    assert off == with_tb_crc.shape[1]
    return out, fs


def _groups(cfg: SchConfig):
    """Group code blocks by identical (K, F, E) so each group is one batched
    kernel invocation (CBs ride the batch axis, the batched replacement for
    pdsch.c:333-390's per-codeword coworker threads)."""
    s = cfg.segm
    es = cfg.e_sizes
    groups = {}
    for r in range(s.C):
        key = (s.cb_sizes[r], s.F if r == 0 else 0, es[r])
        groups.setdefault(key, []).append(r)
    return groups


def encode_tb(tb_bits, cfg: SchConfig, rv_b=None) -> jnp.ndarray:
    """(B, tbs) payload bits -> (B, G) rate-matched codeword bits.

    rv_b: optional TRACED (B,) per-row redundancy version overriding
    cfg.rv — the in-block HARQ retransmission path (RV cycling without a
    compiled variant per RV)."""
    cbs, fillers = _segment_bits(tb_bits, cfg)
    s = cfg.segm
    es = cfg.e_sizes
    B = cbs[0].shape[0]
    pieces = [None] * s.C
    for (k, f, e), rs in _groups(cfg).items():
        stacked = jnp.concatenate([cbs[r] for r in rs], axis=0)  # (n*B, K)
        d0, d1, d2 = turbo.turbo_encode(stacked)
        d_flat = jnp.concatenate([d0, d1, d2], axis=1)
        if rv_b is None:
            tx = rm_turbo.rate_match_tx(d_flat, k, f, e, cfg.rv, cfg.ncb)
        else:
            tx = rm_turbo.rate_match_tx_dyn(
                d_flat, k, f, e, jnp.tile(rv_b, len(rs)), cfg.ncb)
        for i, r in enumerate(rs):
            pieces[r] = tx[i * B : (i + 1) * B]
    return jnp.concatenate(pieces, axis=1)


def init_softbuffer(batch: int, cfg: SchConfig, dtype=jnp.float32):
    """Per-CB HARQ w-buffers (list over CBs): the softbuffer.c equivalent."""
    s = cfg.segm
    return [
        jnp.zeros((batch, rm_turbo.wbuf_size(kr)), dtype=dtype)
        for kr in s.cb_sizes
    ]


def decode_tb(llrs, cfg: SchConfig, softbuf=None, max_iter: int = 8,
              llr_bits: int = 32, rv_b=None):
    """(B, G) codeword LLRs (positive = bit 0) -> (tb_bits (B, tbs), ok (B,),
    softbuf', n_iter).

    Soft-combines into `softbuf` (HARQ IR) if given.  ok requires every CB CRC
    and the TB CRC24A to pass (sch.c decode_tb semantics).
    rv_b: optional TRACED (B,) per-row redundancy version overriding cfg.rv.
    """
    s = cfg.segm
    B = llrs.shape[0]
    es = cfg.e_sizes
    if llr_bits <= 16:
        # The 16-bit decoder width stores the de-rate-match stream in
        # bf16: casting HERE fuses into the producer chain, and the
        # (B, G) buffer, the w-buffer gathers and the HARQ softbuffers
        # all materialize at half width.  Single-transmission combines
        # (0/1 contribution per position) stay exact; HARQ
        # retransmission sums round to bf16.
        llrs = llrs.astype(jnp.bfloat16)
    if softbuf is None:
        softbuf = init_softbuffer(
            B, cfg, jnp.bfloat16 if llr_bits <= 16 else jnp.float32)
    offs = np.concatenate([[0], np.cumsum(es)])
    cb_bits = [None] * s.C
    cb_ok = [None] * s.C
    new_soft = [None] * s.C
    total_iters = 0
    check = crc.LTE_CRC24B if s.C > 1 else crc.LTE_CRC24A
    # de-rate-match per (K, F, E) group (host tables are E-specific), but
    # run ONE turbo decode per K: the MAP recursions are latency-bound
    # (sequential trellis scans), so fewer, wider decoder calls win — F/E
    # only shape the w-buffer tables and filler clamps, never the trellis.
    by_k = {}
    for (kr, f, e), rs in _groups(cfg).items():
        e_llr = jnp.concatenate([llrs[:, offs[r] : offs[r + 1]] for r in rs], axis=0)
        wbuf = jnp.concatenate([softbuf[r] for r in rs], axis=0)
        if rv_b is None:
            wbuf = rm_turbo.rate_unmatch_rx(e_llr, wbuf, kr, f, e, cfg.rv,
                                            cfg.ncb)
        else:
            wbuf = rm_turbo.rate_unmatch_rx_dyn(
                e_llr, wbuf, kr, f, e, jnp.tile(rv_b, len(rs)), cfg.ncb)
        d3 = rm_turbo.wbuf_to_d_llrs(wbuf, kr, f)
        for i, r in enumerate(rs):
            new_soft[r] = wbuf[i * B : (i + 1) * B]
        by_k.setdefault(kr, []).append((rs, d3))
    for kr, parts in by_k.items():
        rs_all = [r for rs, _ in parts for r in rs]
        l0, l1, l2 = (
            jnp.concatenate([d3[j] for _, d3 in parts], axis=0)
            if len(parts) > 1 else parts[0][1][j]
            for j in range(3))
        nB = len(rs_all) * B
        bits, ok, it = turbodecoder.turbo_decode(
            l0, l1, l2, jnp.ones((nB,), bool), kr, max_iter, check,
            llr_bits=llr_bits,
        )
        total_iters += it
        for i, r in enumerate(rs_all):
            cb_bits[r] = bits[i * B : (i + 1) * B]
            cb_ok[r] = ok[i * B : (i + 1) * B]
    # reassemble payload: strip fillers + CB CRCs, then strip/verify TB CRC
    if s.C == 1:
        tb_with_crc = cb_bits[0][:, s.F :]
    else:
        parts = []
        for r in range(s.C):
            f = s.F if r == 0 else 0
            parts.append(cb_bits[r][:, f : s.cb_sizes[r] - cbsegm.CB_CRC_LEN])
        tb_with_crc = jnp.concatenate(parts, axis=1)
    payload = tb_with_crc[:, : cfg.tbs]
    tb_crc_ok = crc.crc_ok(tb_with_crc, crc.LTE_CRC24A)
    all_ok = tb_crc_ok
    for ok in cb_ok:
        all_ok = all_ok & ok
    return payload, all_ok, new_soft, total_iters
