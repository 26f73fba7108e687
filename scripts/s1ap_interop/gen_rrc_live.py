import os, sys; sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
import jax; jax.config.update("jax_platforms", "cpu")
from srslte_emane_tpu.stack import rrc_msgs, rrc_wire

def emit(chan, name, data):
    print(chan, name, data.hex())

emit("ul_ccch", "conn_request_stmsi", rrc_wire.encode_ul_ccch(
    rrc_msgs.RrcConnectionRequest(ue_identity=0x1234567, is_s_tmsi=True)))
emit("ul_ccch", "conn_request_random", rrc_wire.encode_ul_ccch(
    rrc_msgs.RrcConnectionRequest(ue_identity=0xAB54A98C5)))
emit("ul_ccch", "reest_request", rrc_wire.encode_ul_ccch(
    rrc_msgs.RrcConnectionReestablishmentRequest(c_rnti=0x4711)))
emit("dl_ccch", "conn_setup", rrc_wire.encode_dl_ccch(
    rrc_msgs.RrcConnectionSetup()))
emit("dl_ccch", "conn_reject", rrc_wire.encode_dl_ccch(
    rrc_msgs.RrcConnectionReject(wait_time_s=2)))
emit("pcch", "paging_cs", rrc_wire.encode_pcch(
    rrc_msgs.Paging(ue_identity=3021, cn_domain="cs")))
emit("bcch_dl_sch", "sib1", rrc_wire.encode_bcch(rrc_msgs.Sib1()))
emit("bcch_dl_sch", "sib2", rrc_wire.encode_bcch(rrc_msgs.Sib2()))
emit("bcch_dl_sch", "sib3", rrc_wire.encode_bcch(rrc_msgs.Sib3()))
emit("ul_dcch", "setup_complete", rrc_wire.encode_ul_dcch(
    rrc_msgs.RrcConnectionSetupComplete(nas_pdu=b"\x07\x41\x01\x02")))
emit("ul_dcch", "smc_complete", rrc_wire.encode_ul_dcch(
    rrc_msgs.SecurityModeComplete()))
emit("ul_dcch", "recfg_complete", rrc_wire.encode_ul_dcch(
    rrc_msgs.RrcConnectionReconfigurationComplete()))
emit("ul_dcch", "ul_info_transfer", rrc_wire.encode_ul_dcch(
    rrc_msgs.UlInformationTransfer(nas_pdu=b"\x27\x00\x01")))
emit("ul_dcch", "meas_report", rrc_wire.encode_ul_dcch(
    rrc_msgs.MeasurementReport(rsrp_dbm=-90.0, rsrq_db=-10.0,
                               neigh=[(101, -95.0)])))
emit("ul_dcch", "ue_cap_info", rrc_wire.encode_ul_dcch(
    rrc_msgs.UECapabilityInformation(category=4)))
emit("dl_dcch", "smc", rrc_wire.encode_dl_dcch(
    rrc_msgs.SecurityModeCommand(ciph_algo=2, int_algo=2)))
emit("dl_dcch", "dl_info_transfer", rrc_wire.encode_dl_dcch(
    rrc_msgs.DlInformationTransfer(nas_pdu=b"\x07\x52" + bytes(16))))
emit("dl_dcch", "cap_enquiry", rrc_wire.encode_dl_dcch(
    rrc_msgs.UECapabilityEnquiry()))
emit("dl_dcch", "release_redirect", rrc_wire.encode_dl_dcch(
    rrc_msgs.RrcConnectionRelease(cause="cs-FallbackHighPriority",
                                  redirect_rat="geran",
                                  redirect_arfcn=514)))
emit("dl_dcch", "recfg_full", rrc_wire.encode_dl_dcch(
    rrc_msgs.RrcConnectionReconfiguration(
        drbs_to_add=[rrc_msgs.DrbToAdd(drb_id=1, lcid=3, eps_bearer_id=5)],
        nas_pdu=b"\x07\x42",
        scells_to_add=[rrc_msgs.ScellToAdd(scell_idx=1, pci=2, earfcn=1)],
        meas_config=rrc_msgs.MeasConfig(),
        sps_config=rrc_msgs.SpsConfig(sps_crnti=0x3042, interval_dl=20))))
emit("dl_dcch", "recfg_mobility", rrc_wire.encode_dl_dcch(
    rrc_msgs.RrcConnectionReconfiguration(
        mobility=rrc_msgs.MobilityControlInfo(
            target_pci=307, new_rnti=0x5A5A, dedicated_preamble=52))))
