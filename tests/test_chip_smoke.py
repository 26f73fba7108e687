"""chip_smoke.py's phase functions at tiny sizes on the CPU (the MAP kernel
in interpret mode), and the script's refusal to run without a GPU."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_phase_device_names_platform(capsys):
    rec = chip_smoke.phase_device("cache")
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "device" and line["compile_cache"] == "cache"


def test_phase_map_tiny():
    recs = chip_smoke.phase_map(n_sub=1, n_ref=2, reps=1, n_prb=25,
                                interpret=True)
    assert recs and all(r["max_abs_diff"] <= chip_smoke.MAP_ATOL
                        for r in recs)
    assert all(r["kernel"] == "interpret" for r in recs)


def test_phase_link_tiny():
    rec = chip_smoke.phase_link(batch=2, n_cmp=2, n_prb=6, reps=1)
    assert rec["crc_pass"] == 2 and rec["soft_bits_vs_cpu"]["rel"] == 0.0


def test_phase_net_message_level():
    (rec,) = chip_smoke.phase_net(
        runs=(("--ues", "2", "--prb", "6", "--ttis", "200"),))
    assert rec["summary"]["attached"] == 2


def _summary(**kw):
    s = dict(attached=8, dl_ip_bytes=10, ul_ip_bytes=10,
             block_metrics=dict(dl_tb=4, dl_ok=4, ul_tb=4, ul_ok=4))
    s.update(kw)
    return s


@pytest.mark.parametrize("summary,ok", [
    (_summary(), True),
    (_summary(attached=7), False),
    (_summary(ul_ip_bytes=0), False),
    (_summary(block_metrics=dict(dl_tb=4, dl_ok=3, ul_tb=4, ul_ok=4)), False),
])
def test_check_net_summary(summary, ok):
    if ok:
        chip_smoke.check_net_summary(summary, 8, waveform=True)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_net_summary(summary, 8, waveform=True)


@pytest.mark.parametrize("hlo,n", [
    ("%a = f32[4] all-gather(f32[2] %p), dimensions={0}", 1),
    ("%s = (f32[2], f32[4]) all-gather-start(f32[2] %p)\n"
     "%d = f32[4] all-gather-done((f32[2], f32[4]) %s)", 1),
    ("%r = f32[] all-reduce-start(f32[] %x)\n"
     "%c = f32[2] collective-permute(f32[2] %q)", 2),
    ("%f = f32[] fusion(f32[] %x), calls=%all-reduce-ish", 0),
])
def test_count_collectives_sync_and_async(hlo, n):
    assert chip_smoke.count_collectives(hlo) == n


def test_phase_multichip_on_virtual_devices():
    recs = chip_smoke.phase_multichip(n_dev=4, per_dev=1, n_prb=15,
                                      n_ues=2, block_T=2)
    assert [r["cross_device_collectives"] for r in recs[:2]] == [0, 0]
    assert all(r["output_devices"] == [0, 1, 2, 3] for r in recs)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
