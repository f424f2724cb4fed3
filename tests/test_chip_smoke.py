"""chip_smoke.py: every phase at tiny width on the CPU, and its contract.

On the card the same phase functions run at full width (``python
chip_smoke.py``); here each must pass its own comparison at TINY sizes,
and the script must refuse to report a result without a GPU.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("phase", ["step", "fit", "composite", "streaming",
                                   "hmc"])
def test_single_card_phase_passes_at_tiny_width(phase):
    res = getattr(chip_smoke, f"phase_{phase}")(chip_smoke.TINY)
    json.dumps(res, default=str)  # printable as the phase's line


def test_step_phase_reports_each_arithmetic():
    res = chip_smoke.phase_step(chip_smoke.TINY)
    assert set(res) >= {"golden_cost", "fp32", "auto", "bf16",
                        "gemm_kernels_high", "gram_rel_err"}
    assert res["auto"]["mm_precision"] == "default"
    assert res["bf16"]["mm_dtype"] == "bfloat16"
    # The CPU has no reduced-precision f32 GEMM; bf16 inputs round.
    gram = res["gram_rel_err"]
    assert gram["highest"] == gram["default"] < 1e-6 < gram["bf16"] < 4e-3


def test_multi_device_phase_on_four_virtual_devices():
    res = chip_smoke.phase_multi(chip_smoke.TINY, 4)
    assert res["devices"] == 4
    assert res["hmc_final_positions_on"] >= 1


def test_phase_device_refuses_the_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.phase_device(1)


@pytest.mark.parametrize("argv", [[], ["--gpus", "4"]])
def test_main_on_cpu_exits_nonzero_without_result(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_result_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line("NVIDIA H100 80GB HBM3", 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_script_alone_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_full_width_phases_on_gpu(gpu):
    for phase in ("step", "fit", "composite", "streaming", "hmc"):
        getattr(chip_smoke, f"phase_{phase}")(chip_smoke.FULL)
