"""MME: S1AP endpoint + NAS EMM/ESM state machines.

Reference behavior: `srsepc/src/mme/{mme.cc,s1ap.cc,s1ap_*_proc.cc,nas.cc,
mme_gtpc.cc}` — S1 Setup, InitialUEMessage -> NAS attach -> HSS auth ->
security mode -> create-session toward SPGW -> InitialContextSetup (KeNB),
paging, detach.

S1AP here is a typed message interface between the eNB's s1ap client and
this MME; across process boundaries the NAS-transport / UE-context /
paging / InitialContextSetup procedures ride as REAL 36.413 APER PDUs
(epc/s1ap_wire.py over apps/rpc.py TCP framing — no SCTP in this kernel).
NAS PDUs are true 24.301 bytes (stack/nas_wire.py), integrity-protected
after the security mode procedure (NasSecurity, §4.4.3).
"""

from __future__ import annotations

import dataclasses

from ..stack import codec, nas_wire, per, nas_msgs, security  # noqa: F401 (security: HO keys)


@codec.register
@per.schema(("enb_ue_id", "int"), ("nas_pdu", "bytes"),
            ("s_tmsi", "int", "?"))
@dataclasses.dataclass
class InitialUEMessage:
    enb_ue_id: int
    nas_pdu: bytes
    # S-TMSI from the RRC connection request's ue-Identity (36.413 IE 96):
    # identifies the UE for identity-less NAS (the Service Request)
    s_tmsi: int = None


@codec.register
@per.schema(("mme_ue_id", "int"), ("enb_ue_id", "int"), ("nas_pdu", "bytes"))
@dataclasses.dataclass
class UplinkNASTransport:
    mme_ue_id: int
    enb_ue_id: int
    nas_pdu: bytes


@codec.register
@per.schema(("mme_ue_id", "int"), ("enb_ue_id", "int"), ("nas_pdu", "bytes"))
@dataclasses.dataclass
class DownlinkNASTransport:
    mme_ue_id: int
    enb_ue_id: int
    nas_pdu: bytes


@codec.register
@per.schema(("mme_ue_id", "int"), ("enb_ue_id", "int"), ("kenb", "bytes"),
            ("ue_ip", "str"), ("teid_spgw", "int"), ("teid_enb", "int"),
            ("eps_bearer_id", "cint", 0, 15), ("nas_pdu", "bytes", "?"))
@dataclasses.dataclass
class InitialContextSetupRequest:
    mme_ue_id: int
    enb_ue_id: int
    kenb: bytes
    ue_ip: str
    teid_spgw: int  # eNB sends UL GTP-U with this TEID
    teid_enb: int  # SPGW sends DL with this (eNB's rx teid)
    eps_bearer_id: int
    nas_pdu: bytes = b""


@codec.register
@per.schema(("mme_ue_id", "int"), ("enb_ue_id", "int"),
            ("eps_bearer_id", "cint", 0, 15), ("qci", "cint", 0, 255),
            ("nas_pdu", "bytes"), ("tft", "bytes", "?"))
@dataclasses.dataclass
class ERabSetupRequest:
    """S1AP E-RAB Setup (s1ap_ctx_mngmt_proc.cc): dedicated bearer toward
    the eNB with the piggybacked NAS activate-dedicated-bearer PDU.
    The TFT rides as an explicit field for the eNB's DL classifier (a
    beyond-reference feature: srsepc has no dedicated bearers and its
    DL routing is single-bearer) — the NAS PDU is ciphered for the UE,
    so the eNB cannot peek it."""

    mme_ue_id: int
    enb_ue_id: int
    eps_bearer_id: int
    qci: int
    nas_pdu: bytes = b""
    tft: bytes = b""


@codec.register
@per.schema(("mme_ue_id", "int"), ("enb_ue_id", "int"),
            ("csfb_indicator", "bool"))
@dataclasses.dataclass
class UEContextModificationRequest:
    """S1AP UE Context Modification (36.413 §8.3.4): the CS Fallback
    Indicator tells the eNB to move the UE to a CS RAT
    (srsenb/src/stack/upper/s1ap.cc CSFB path)."""

    mme_ue_id: int
    enb_ue_id: int
    csfb_indicator: bool = False


@dataclasses.dataclass
class UEContextReleaseCommand:
    mme_ue_id: int
    enb_ue_id: int
    cause: str = "user-inactivity"


@codec.register
@per.schema(("mme_ue_id", "int"), ("enb_ue_id", "int"),
            ("target_pci", "cint", 0, 503))
@dataclasses.dataclass
class HandoverRequired:
    mme_ue_id: int
    enb_ue_id: int
    target_pci: int


@codec.register
@per.schema(("mme_ue_id", "int"), ("kenb_star", "bytes"), ("ue_ip", "str"),
            ("teid_spgw", "int"), ("teid_enb", "int"))
@dataclasses.dataclass
class HandoverRequest:
    mme_ue_id: int
    kenb_star: bytes
    ue_ip: str
    teid_spgw: int
    teid_enb: int


@codec.register
@per.schema(("mme_ue_id", "int"), ("enb_ue_id", "int"),
            ("target_pci", "cint", 0, 503), ("new_rnti", "cint", 0, 65535),
            ("dedicated_preamble", "cint", 0, 63), ("kenb_star", "bytes"))
@dataclasses.dataclass
class HandoverCommand:
    """Container back to the source eNB (-> RRC mobility control info)."""
    mme_ue_id: int
    enb_ue_id: int
    target_pci: int
    new_rnti: int
    dedicated_preamble: int
    kenb_star: bytes


@codec.register
@per.schema(("mme_ue_id", "int"), ("target_enb_ue_id", "int"))
@dataclasses.dataclass
class PathSwitchRequest:
    mme_ue_id: int
    target_enb_ue_id: int


class Mme:
    def __init__(self, hss, spgw):
        self.hss = hss
        self.spgw = spgw
        self.enbs = {}  # enb_id -> s1ap callback interface
        self.ues = {}  # mme_ue_id -> state dict
        self.next_mme_ue_id = 1
        self.metrics = dict(attach_ok=0, auth_fail=0)

    # ---- S1 setup ----
    def s1_setup(self, enb_id: int, enb_iface):
        """enb_iface must expose dl_nas(msg), ctx_setup(msg), release(msg)."""
        self.enbs[enb_id] = enb_iface
        return dict(mme_name="emu-mme", served_plmn=0x00F110)

    # ---- NAS transport (s1ap_nas_transport.cc) ----
    def initial_ue_message(self, enb_id: int, msg: InitialUEMessage):
        nas = nas_wire.decode(msg.nas_pdu)
        if isinstance(nas, (nas_msgs.ExtendedServiceRequest,
                            nas_msgs.TrackingAreaUpdateRequest)):
            # idle-resume procedures arrive integrity-protected with the
            # stored context: verify the MAC before acting (§4.4.4)
            ue = self.ues.get(nas.guti)
            sec = ue.get("nas_sec") if ue is not None else None
            if sec is not None:
                _, ok = sec.unprotect(msg.nas_pdu, downlink=False)
                if not ok:
                    self.metrics["nas_mac_fail"] = \
                        self.metrics.get("nas_mac_fail", 0) + 1
                    return
        if isinstance(nas, nas_msgs.ExtendedServiceRequest):
            # idle UE starting/answering a CS call: restore the session,
            # then order the eNB to release with redirection (CSFB)
            self._service_request(enb_id, msg, nas)
            ue = self.ues.get(nas.guti)
            if ue is not None and ue["state"] == "ATTACHED":
                self._csfb(nas.guti)
            return
        if isinstance(nas, nas_msgs.TrackingAreaUpdateRequest):
            # periodic TAU (s1ap nas.cc TAU proc): refresh the context and
            # release the UE back to idle — no bearer activation
            ue = self.ues.get(nas.guti)
            if ue is None or ue["state"] != "ATTACHED":
                self._dl_nas(enb_id, nas.guti, msg.enb_ue_id,
                             nas_msgs.ServiceReject())
                return
            ue["enb_id"] = enb_id
            ue["enb_ue_id"] = msg.enb_ue_id
            # the UE advances its NAS uplink count (KeNB input) on EVERY
            # idle-resume, TAU included — mirror it or the next service
            # request derives a mismatched KeNB and the UE loses all DL
            ue["ul_nas_count"] += 1
            self._dl_nas(enb_id, nas.guti, msg.enb_ue_id,
                         nas_msgs.TrackingAreaUpdateAccept(t3412=500))
            ue["ecm_connected"] = False
            self.enbs[enb_id].release(UEContextReleaseCommand(
                nas.guti, msg.enb_ue_id, "tau-complete"))
            self.metrics["tau_ok"] = self.metrics.get("tau_ok", 0) + 1
            return
        if isinstance(nas, nas_msgs.ServiceRequest):
            # resolve the UE from the S1AP S-TMSI (the 4-byte Service
            # Request carries no identity) and verify its short MAC
            # (nas.cc gen_service_request / srsepc short-MAC check)
            if msg.s_tmsi is not None:
                nas = dataclasses.replace(nas, guti=msg.s_tmsi)
                ue = self.ues.get(msg.s_tmsi)
                sec = ue.get("nas_sec") if ue is not None else None
                if sec is not None and \
                        not sec.verify_service_request(msg.nas_pdu):
                    self.metrics["nas_mac_fail"] = \
                        self.metrics.get("nas_mac_fail", 0) + 1
                    return
            self._service_request(enb_id, msg, nas)
            return
        if not isinstance(nas, nas_msgs.AttachRequest):
            return
        imsi = nas.imsi
        old_guti = None
        if not imsi and nas.guti is not None:
            # GUTI attach (24.301 §5.5.1.2.2): resolve from the stored
            # context; an unknown GUTI triggers the identity procedure
            old = self.ues.get(nas.guti)
            if old is not None and old.get("imsi"):
                imsi = old["imsi"]
                old_guti = nas.guti
        if old_guti is not None:
            # the fresh registration replaces the stored context: tear
            # down the old SPGW session and drop the entry, else contexts
            # and DL routes leak on every power cycle
            stale = self.ues.pop(old_guti)
            if stale.get("ue_ip"):
                self.spgw.release_session(stale["ue_ip"])
        mme_ue_id = self.next_mme_ue_id
        self.next_mme_ue_id += 1
        if not imsi:
            self.ues[mme_ue_id] = dict(
                imsi=None, enb_id=enb_id, enb_ue_id=msg.enb_ue_id,
                vec=None, state="IDENTITY", ul_nas_count=0,
                pdn_type=nas.pdn_type,
            )
            self._dl_nas(enb_id, mme_ue_id, msg.enb_ue_id,
                         nas_msgs.IdentityRequest())
            self.metrics["identity_req"] = \
                self.metrics.get("identity_req", 0) + 1
            return
        self.ues[mme_ue_id] = dict(
            imsi=imsi, enb_id=enb_id, enb_ue_id=msg.enb_ue_id,
            vec=None, state="AUTH", ul_nas_count=0,
            pdn_type=nas.pdn_type,
        )
        self._start_auth(enb_id, mme_ue_id, msg.enb_ue_id)

    def _start_auth(self, enb_id, mme_ue_id, enb_ue_id):
        """HSS vector fetch + Authentication Request (nas.cc attach)."""
        ue = self.ues[mme_ue_id]
        vec = self.hss.get_auth_vector(ue["imsi"])
        if vec is None:
            self.metrics["auth_fail"] += 1
            self._dl_nas(enb_id, mme_ue_id, enb_ue_id,
                         nas_msgs.AuthenticationReject())
            return
        ue["vec"] = vec
        ue["state"] = "AUTH"
        self._dl_nas(enb_id, mme_ue_id, enb_ue_id,
                     nas_msgs.AuthenticationRequest(rand=vec["rand"],
                                                    autn=vec["autn"]))

    def uplink_nas(self, enb_id: int, msg: UplinkNASTransport):
        ue = self.ues.get(msg.mme_ue_id)
        if ue is None:
            return
        nas_pdu = msg.nas_pdu
        sec = ue.get("nas_sec")
        if sec is not None:
            nas_pdu, ok = sec.unprotect(nas_pdu, downlink=False)
            if not ok:
                self.metrics["nas_mac_fail"] = \
                    self.metrics.get("nas_mac_fail", 0) + 1
                return
        nas = nas_wire.decode(nas_pdu)
        if isinstance(nas, nas_msgs.AuthenticationResponse) and ue["state"] == "AUTH":
            if nas.res != ue["vec"]["xres"]:
                self.metrics["auth_fail"] += 1
                self._dl_nas(enb_id, msg.mme_ue_id, msg.enb_ue_id,
                             nas_msgs.AuthenticationReject())
                return
            ue["state"] = "SMC"
            # EPS security context: K_NAS_int/K_NAS_enc from KASME; the
            # SMC itself goes integrity-protected-only with the new
            # context (§4.4.4 — the UE has no keys until it reads it);
            # everything after is ciphered EEA2 + integrity EIA2
            ue["nas_sec"] = nas_wire.NasSecurity(ue["vec"]["kasme"],
                                                 eia=2, eea=2)
            self._dl_nas(enb_id, msg.mme_ue_id, msg.enb_ue_id,
                         nas_msgs.NasSecurityModeCommand(eea=2, eia=2))
        elif isinstance(nas, nas_msgs.AuthenticationFailure) \
                and ue["state"] == "AUTH":
            # SQN resynchronisation (nas.cc handle_authentication_failure):
            # hand AUTS to the HSS, retry authentication with a fresh vector
            vec = None
            if nas.cause == "synch-failure":
                vec = self.hss.resync(ue["imsi"], ue["vec"]["rand"], nas.auts)
            if vec is None:
                self.metrics["auth_fail"] += 1
                self._dl_nas(enb_id, msg.mme_ue_id, msg.enb_ue_id,
                             nas_msgs.AuthenticationReject())
                return
            ue["vec"] = vec
            self.metrics["sqn_resync"] = self.metrics.get("sqn_resync", 0) + 1
            self._dl_nas(enb_id, msg.mme_ue_id, msg.enb_ue_id,
                         nas_msgs.AuthenticationRequest(rand=vec["rand"],
                                                        autn=vec["autn"]))
        elif isinstance(nas, nas_msgs.NasSecurityModeComplete) and ue["state"] == "SMC":
            # create user-plane session, then InitialContextSetup with
            # piggybacked Attach Accept (mme_gtpc.cc + s1ap_ctx_mngmt_proc.cc)
            enb = self.enbs[ue["enb_id"]]
            # S11: byte-exact GTPv2-C exchange (mme_gtpc.cc / gtpc.cc)
            from . import gtpc

            resp = self.spgw.handle_gtpc(
                gtpc.create_session_request(
                    ue["imsi"], msg.mme_ue_id,
                    pdn_type=ue.get("pdn_type", "ipv4")),
                enb.gtpu_dl)
            sess = gtpc.parse_create_session_response(resp)
            if sess["cause"] != gtpc.CAUSE_ACCEPTED:
                # session rejected: fail the attach cleanly (UE retries
                # under T3410) instead of crashing the rx path
                self.metrics["session_reject"] = \
                    self.metrics.get("session_reject", 0) + 1
                return
            kenb = security.kdf_kenb(ue["vec"]["kasme"], ue["ul_nas_count"])
            # ipv6/ipv4v6 PDNs: the NAS PDN address carries the 8-byte
            # interface identifier of the allocated address (24.301
            # §9.9.4.9); the UE composes prefix + IID (gw.cc IPv6 path)
            iid = b""
            if sess.get("ue_ip6"):
                import socket as _s

                iid = _s.inet_pton(_s.AF_INET6, sess["ue_ip6"])[8:]
            accept = nas_msgs.AttachAccept(
                ip_addr=sess["ue_ip"], guti=msg.mme_ue_id,
                pdn_type=sess.get("pdn_type", "ipv4"), ip6_iid=iid)
            ue["state"] = "CTX"
            ue["ue_ip"] = sess["ue_ip"]
            ue["teid_spgw"] = sess["teid_in"]
            ue["teid_enb"] = sess["teid_out"]
            enb.ctx_setup(InitialContextSetupRequest(
                mme_ue_id=msg.mme_ue_id, enb_ue_id=msg.enb_ue_id, kenb=kenb,
                ue_ip=sess["ue_ip"], teid_spgw=sess["teid_in"],
                teid_enb=sess["teid_out"], eps_bearer_id=5,
                nas_pdu=ue["nas_sec"].protect(
                    nas_wire.encode(accept), downlink=True)))
        elif isinstance(nas, nas_msgs.AttachComplete) and ue["state"] == "CTX":
            ue["state"] = "ATTACHED"
            self.metrics["attach_ok"] += 1
            # network name push (srsepc nas.cc sends EMM Information
            # right after the attach completes)
            self._dl_nas(enb_id, msg.mme_ue_id, msg.enb_ue_id,
                         nas_msgs.EmmInformation())
        elif isinstance(nas, nas_msgs.ActivateDedicatedEpsBearerAccept):
            ue.setdefault("dedicated_bearers", []).append(nas.eps_bearer_id)
            self.metrics["ded_bearer_ok"] = self.metrics.get("ded_bearer_ok", 0) + 1
        elif isinstance(nas, nas_msgs.DetachRequest):
            ue["state"] = "DETACHED"
            ue["ecm_connected"] = False
            if ue.get("ue_ip"):
                self.spgw.release_session(ue["ue_ip"])
            self.enbs[ue["enb_id"]].release(UEContextReleaseCommand(
                msg.mme_ue_id, msg.enb_ue_id, "detach"))
        elif isinstance(nas, nas_msgs.IdentityResponse) \
                and ue["state"] == "IDENTITY":
            ue["imsi"] = nas.imsi
            self._start_auth(enb_id, msg.mme_ue_id, msg.enb_ue_id)
        elif isinstance(nas, nas_msgs.ExtendedServiceRequest):
            # connected UE starting (MO) or answering (MT) a CS voice call
            self._csfb(msg.mme_ue_id)

    def _csfb(self, mme_ue_id: int):
        """Order the serving eNB to release the UE toward the CS RAT
        (s1ap.cc sends UE Context Modification with the CSFB indicator;
        srsepc nas.cc CSFB path)."""
        ue = self.ues.get(mme_ue_id)
        if ue is None:
            return
        self.enbs[ue["enb_id"]].ctx_modification(UEContextModificationRequest(
            mme_ue_id=mme_ue_id, enb_ue_id=ue["enb_ue_id"],
            csfb_indicator=True))
        ue["csfb_active"] = True
        self.metrics["csfb"] = self.metrics.get("csfb", 0) + 1

    def cs_call(self, mme_ue_id: int, caller_id: str = ""):
        """Mobile-terminated CS call arrives from the CS core (SGs
        interface role): notify a connected UE via NAS CS Service
        Notification; page an idle UE in the CS domain."""
        ue = self.ues.get(mme_ue_id)
        if ue is None or ue["state"] != "ATTACHED":
            return
        # ECM state is MME-local (the eNB may be a cross-process RPC
        # proxy that cannot be introspected): a UE that resumed since its
        # last release has ecm_connected set by _service_request
        if ue.get("ecm_connected", True):
            self._dl_nas(ue["enb_id"], mme_ue_id, ue["enb_ue_id"],
                         nas_msgs.CsServiceNotification(caller_id=caller_id))
        else:
            # CS page TARGETS the UE's S-TMSI: a wildcard CS page would
            # drag every idle UE off LTE via MT-CSFB
            for e in self.enbs.values():
                if hasattr(e, "page"):
                    e.page(mme_ue_id, cn_domain="cs")
            self.metrics["cs_paging"] = self.metrics.get("cs_paging", 0) + 1

    # ---- S1 handover (s1ap_ctx_mngmt_proc.cc / intra-MME HO) ----
    def handover_required(self, enb_id: int, msg: HandoverRequired):
        ue = self.ues.get(msg.mme_ue_id)
        if ue is None:
            return
        target = next(((eid, enb) for eid, enb in self.enbs.items()
                       if getattr(enb, "cell_pci", None) == msg.target_pci), None)
        if target is None:
            return
        ue_ip = ue.get("ue_ip")
        kenb_star = security.kdf(ue["vec"]["kasme"], 0x13,
                                 msg.target_pci.to_bytes(2, "big"))
        sess = self.spgw.by_ip.get(ue_ip, {})
        req = HandoverRequest(mme_ue_id=msg.mme_ue_id, kenb_star=kenb_star,
                              ue_ip=ue_ip,
                              teid_spgw=sess.get("teid_in", 0),
                              teid_enb=sess.get("teid_out", 0))
        cmd = target[1].ho_request(req)
        self.enbs[ue["enb_id"]].ho_command(HandoverCommand(
            mme_ue_id=msg.mme_ue_id, enb_ue_id=msg.enb_ue_id,
            target_pci=msg.target_pci, new_rnti=cmd["new_rnti"],
            dedicated_preamble=cmd["preamble"], kenb_star=kenb_star))

    def path_switch(self, enb_id: int, msg: PathSwitchRequest):
        ue = self.ues.get(msg.mme_ue_id)
        if ue is None:
            return
        target = self.enbs[enb_id]
        if "ue_ip" not in ue:
            # handover completed before the EMM session was established
            # (no ERAB yet): record the new serving eNB, nothing to switch
            ue["enb_id"] = enb_id
            ue["enb_ue_id"] = msg.target_enb_ue_id
            self.metrics["ho_no_session"] = \
                self.metrics.get("ho_no_session", 0) + 1
            return
        self.spgw.path_switch(ue["ue_ip"], target.gtpu_dl)
        ue["enb_id"] = enb_id
        ue["enb_ue_id"] = msg.target_enb_ue_id
        self.metrics["handover_ok"] = self.metrics.get("handover_ok", 0) + 1

    def _service_request(self, enb_id: int, msg: InitialUEMessage, nas):
        """Registered-idle UE resuming bearers (s1ap service request proc):
        restore the EXISTING session — same IP, same S1-U tunnel — with a
        fresh KeNB; reject if the context is gone (UE then re-attaches)."""
        ue = self.ues.get(nas.guti)
        if ue is None or ue["state"] != "ATTACHED":
            self._dl_nas(enb_id, nas.guti, msg.enb_ue_id,
                         nas_msgs.ServiceReject())
            self.metrics["service_reject"] = self.metrics.get("service_reject", 0) + 1
            return
        ue["ul_nas_count"] += 1
        kenb = security.kdf_kenb(ue["vec"]["kasme"], ue["ul_nas_count"])
        prev_enb = ue["enb_id"]
        ue["enb_id"] = enb_id
        ue["enb_ue_id"] = msg.enb_ue_id
        ue["ecm_connected"] = True
        enb = self.enbs[enb_id]
        if prev_enb != enb_id:
            self.spgw.path_switch(ue["ue_ip"], enb.gtpu_dl)
        enb.ctx_setup(InitialContextSetupRequest(
            mme_ue_id=nas.guti, enb_ue_id=msg.enb_ue_id, kenb=kenb,
            ue_ip=ue["ue_ip"], teid_spgw=ue["teid_spgw"],
            teid_enb=ue["teid_enb"], eps_bearer_id=5,
            nas_pdu=ue["nas_sec"].protect(
                nas_wire.encode(nas_msgs.ServiceAccept()), downlink=True)
            if ue.get("nas_sec") else
            nas_wire.encode(nas_msgs.ServiceAccept())))
        self.metrics["service_ok"] = self.metrics.get("service_ok", 0) + 1

    def activate_dedicated_bearer(self, mme_ue_id: int, tft_bytes: bytes,
                                  qci: int = 1, eps_bearer_id: int = 6):
        """ESM dedicated-bearer activation (nas.cc + s1ap E-RAB Setup):
        sends the NAS request with the packed TFT through the eNB, which
        adds the DRB via RRC reconfiguration."""
        ue = self.ues.get(mme_ue_id)
        if ue is None or ue["state"] != "ATTACHED":
            return False
        nas = nas_msgs.ActivateDedicatedEpsBearerRequest(
            eps_bearer_id=eps_bearer_id, linked_bearer_id=5, qci=qci,
            tft=tft_bytes)
        self.enbs[ue["enb_id"]].erab_setup(ERabSetupRequest(
            mme_ue_id=mme_ue_id, enb_ue_id=ue["enb_ue_id"],
            eps_bearer_id=eps_bearer_id, qci=qci,
            nas_pdu=ue["nas_sec"].protect(
                nas_wire.encode(nas), downlink=True)
            if ue.get("nas_sec") else nas_wire.encode(nas),
            tft=tft_bytes))
        self.metrics["ded_bearer_req"] = self.metrics.get("ded_bearer_req", 0) + 1
        return True

    def ue_ctx_released(self, mme_ue_id: int):
        """S1AP UE Context Release notification from the eNB: the UE is
        ECM-IDLE — reach it by paging from now on."""
        ue = self.ues.get(mme_ue_id)
        if ue is not None:
            ue["ecm_connected"] = False

    def page_ue(self, mme_ue_id: int):
        """S1AP Paging: broadcast to every attached eNB (s1ap paging proc);
        triggered e.g. by DL data arriving for an idle UE."""
        ue = self.ues.get(mme_ue_id)
        if ue is None:
            return
        for enb in self.enbs.values():
            if hasattr(enb, "page"):
                enb.page(mme_ue_id)  # s-TMSI-targeted paging record
        self.metrics["paging"] = self.metrics.get("paging", 0) + 1

    def _dl_nas(self, enb_id, mme_ue_id, enb_ue_id, nas_msg):
        data = nas_wire.encode(nas_msg)
        ue = self.ues.get(mme_ue_id)
        sec = ue.get("nas_sec") if ue is not None else None
        if sec is not None:
            is_smc = isinstance(nas_msg, nas_msgs.NasSecurityModeCommand)
            data = sec.protect(data, downlink=True, new_ctx=is_smc,
                               cipher=not is_smc)
        self.enbs[enb_id].dl_nas(DownlinkNASTransport(
            mme_ue_id=mme_ue_id, enb_ue_id=enb_ue_id, nas_pdu=data))
