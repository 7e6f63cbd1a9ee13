"""chip_smoke.py's phases rehearsed on the CPU at a small size: the corpus
of n = 20,000 with its cached ground truth and projection, the fused service
in bf16 and int8 over submit() and HTTP, and a teardown that leaves no
thread. (The kernel phase and the launch and recall checks need the card.)"""

import importlib.util
import pathlib
import threading

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_rehearsal_on_cpu(chip_smoke, capsys):
    before = set(threading.enumerate())
    records = chip_smoke.main(
        "cpu", n=20000, nq=1024,
        proj_file="bench_proj_n20000_d128x32_s600_seed1.npz", targets=False)
    out = capsys.readouterr().out
    assert "ground truth: 1024/1024 rows equal" in out
    assert "1.0000 of rows equal to a direct search" in out
    assert set(records) == {"binned_scan[bfloat16]", "binned_scan[int8]",
                            "merge_topc[bfloat16,c=12]",
                            "merge_topc[int8,c=16]"}
    assert all(r["launches"] == 0 for r in records.values())  # CPU: plain
    assert set(threading.enumerate()) <= before


def test_bound_picks_the_larger_time(chip_smoke):
    ms, by = chip_smoke.bound_ms(3.35e9, 0.0, "bfloat16")
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
    ms, by = chip_smoke.bound_ms(0.0, 989e9, "bfloat16")
    assert by == "operations" and abs(ms - 1.0) < 1e-9
    assert chip_smoke.bound_ms(0.0, 1979e9, "int8")[0] == pytest.approx(1.0)


def test_check_raises(chip_smoke):
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="broken"):
        chip_smoke.check(False, "broken")
