"""chip_smoke.py's phases at tiny size on the CPU, and the whole script
on a card (``gpu`` marker)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu():
    info = chip_smoke.device_info("cpu")
    assert info["platform"] == "cpu" and info["count"] >= 1
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_device(info)


@pytest.mark.parametrize("count,ok", [(1, True), (4, False)])
def test_device_check_counts_cards(count, ok):
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": 1}
    if ok:
        chip_smoke.check_device(info, count)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_device(info, count)


@pytest.fixture(scope="module")
def smoke_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("smoke"))
    rep = chip_smoke.Report("cpu test")
    chip_smoke.make_data(rep, d, 3000)
    chip_smoke.run_exact(rep, d, ("A", "B", "C"))
    return rep, d


@pytest.mark.parametrize("engine", ["jax", "sharded"])
def test_serve_phase_rows_match_exact(smoke_dir, engine):
    rep, d = smoke_dir
    worst = chip_smoke.serve_phase(rep, d, engines=(engine,),
                                   platforms="cpu")
    assert worst["worst_float_rel"] <= 1e-4
    assert worst["worst_unmatched_margin"] <= 0.02


def test_serve_phase_fails_on_wrong_mesh(smoke_dir):
    rep, d = smoke_dir
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.serve_phase(rep, d, engines=("sharded",),
                               plan=(("A", 0),), platforms="cpu",
                               expect_devices=4)


def test_multi_device_path_on_virtual_devices(smoke_dir, capsys):
    """--gpus N's path on the 8 virtual CPU devices of conftest: the
    mesh over all of them and over one agree with the exact engine
    and with each other, and the collective dry run passes."""
    rep, d = smoke_dir
    info = chip_smoke.multi_gpu(
        rep, d, 8, platforms="cpu",
        one_device_env={"XLA_FLAGS":
                        "--xla_force_host_platform_device_count=1"})
    assert info == {"platform": "cpu", "kind": "cpu", "count": 8}
    out = capsys.readouterr().out
    assert "dryrun_multichip: 8 cpu devices" in out


def test_kernel_phase_small_tile():
    info = chip_smoke.kernel_phase(
        chip_smoke.Report("cpu test"), tile_len=1 << 16,
        events=1 << 11, k_excl=8, chain_m=1 << 12, chain_reps=2,
        expect_platform="cpu")
    assert info["platform"] == "cpu"


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    r = subprocess.run([sys.executable, "chip_smoke.py", "--pairs",
                        "20000"], cwd=REPO, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
