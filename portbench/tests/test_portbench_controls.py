"""The control comes out not correct: the plain reference in bfloat16, put
in the program's place, fails a number of each cell's check at its limit
(at a size a CPU test run holds; on the chip at the cells' own sizes, see
controls.py)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import check, controls  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402

SMALL = {"render": {"width": 24, "height": 16, "ssaa": 1,
                    "iterations": 300}}


@pytest.mark.parametrize("cell", ["demo.frame"])
def test_frame_control_is_not_correct(cell):
    man = Manifest(ROOT)
    got = controls.frame_control(man, cell, 5, "cpu", config_patch=SMALL,
                                 mix_patch={"check": {"frames": 2,
                                                      "pixels": 24}})
    ok, checks = check.judge(got, check.load_limits(man.limits_file(cell)))
    assert not ok, checks


def test_fit_control_is_not_correct(tmp_path):
    man = Manifest(ROOT)
    got = controls.fit_control(man, "demo.fit", 5, "cpu",
                               config_patch={"render": {"iterations": 300}},
                               mix_patch={"render": {"width": 24,
                                                     "height": 16,
                                                     "ssaa": 1}},
                               cache_dir=tmp_path)
    got.pop("losses")
    ok, checks = check.judge(got, check.load_limits(
        man.limits_file("demo.fit")))
    assert not ok, checks
