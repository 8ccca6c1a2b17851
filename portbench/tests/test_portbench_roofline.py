"""The benchmark's count of a frame's work repeats exactly, and reads the
frozen cost table."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import roofline, traffic  # noqa: E402
from portbench.reference import scene as rs  # noqa: E402
from portbench.reference.field import Field  # noqa: E402
from portbench.reference.render import (Settings, render_pixels,  # noqa: E402
                                        tables_on)

SCENES = ROOT / "portbench" / "scenes"
MENGER4 = """Bounds 200.0
Camera Position 40.0 30.0 -5.0
Camera Direction -1.0 -0.5 -1.0
Camera Up 0.0 1.0 0.0
Camera FOV 75
Light -15.0 40.0 -20.0
Light 45.0 50.0 -35.0
Box 0.0 -1.0 -50.0 75.0 2.0 75.0
Color 1.0 1.0 1.0
MengerSponge 0.0 10.0 -50.0 20.0 4
"""


def test_field_operations_by_the_cost_table(tmp_path):
    # demo: Bounds 14+1, floor 14, DeathStar 2x11+1+1, two spheres 11
    # each, the sponge 14 + 3 x 33 + 2, a root fold a body; a sponge of
    # four levels over the floor: 15 + 14 + (14 + 4 x 33 + 2) + 3
    assert roofline.field_ops(rs.load(SCENES / "demo.txt")) == 196
    (tmp_path / "menger4.txt").write_text(MENGER4)
    assert roofline.field_ops(rs.load(tmp_path / "menger4.txt")) == 180


def count(seed):
    scene = rs.load(SCENES / "demo.txt")
    st = Settings(width=64, height=48, ssaa=2, iterations=300)
    t = tables_on(scene.tables(), "cpu", torch.float32)
    g = traffic.rng(seed, 5)
    py = torch.as_tensor(g.integers(st.height, size=24)).float()
    px = torch.as_tensor(g.integers(st.width, size=24)).float()
    _, prim, shad = render_pixels(Field(scene, "cpu"), t, st,
                                  t["cam_position"], t["cam_direction"],
                                  py, px)
    return int(roofline.ray_ops(scene, prim, shad).sum()), prim, shad


def test_count_repeats_exactly():
    a, prim, shad = count(11)
    b, _, _ = count(11)
    assert a == b
    evals = int((prim + shad + 7).sum())
    steps = int((prim + shad).sum())
    assert a == evals * 196 + steps * roofline.STEP + prim.numel() * (
        roofline.SHADE + 2 * roofline.LIGHT + roofline.COLOUR)


def test_roofline_share_takes_the_larger_bound():
    pct, by = roofline.roofline_pct(67e9, 1.0, 1e-2)
    assert by == "operations" and abs(pct - 10.0) < 1e-9
    pct, by = roofline.roofline_pct(1.0, 3.35e9, 1e-2)
    assert by == "bytes" and abs(pct - 10.0) < 1e-9


def test_window_count_is_each_poses_mean_ray_times_its_frames(tmp_path):
    """The traced frame run's count: every pose rendered in the window,
    its seeded pixels' rays marched in one batch, equals the same rays
    marched pose by pose."""
    import numpy as np
    from portbench import harness, run
    from portbench.manifest import Manifest
    man = Manifest(ROOT)
    config, mix = man.config("demo"), man.traffic("frame")
    run.apply_patch(config, {"render": {"width": 16, "height": 12, "ssaa": 2,
                                        "iterations": 200}})
    run.apply_patch(mix, {"check": {"frames": 1, "every": 3, "pixels": 8}})
    ctx = harness.Ctx("demo.frame", config, mix, 4, 0.5, True,
                      torch.device("cpu"), 0.0, ROOT, tmp_path)
    res = man.runner("frames")(ctx)
    ops, nbytes = roofline.frame_work(res.trace.seen, pixels=3)
    st = harness.ref_settings(harness.render_settings(ctx))
    scene = rs.load(SCENES / "demo.txt")
    t = tables_on(scene.tables(), "cpu", torch.float32)
    pos, dirs, order = traffic.frame_schedule(scene.tables(), mix, 4)
    counts = np.bincount([order[j % len(order)] for j in range(res.attempted)],
                         minlength=len(order))
    g, want = traffic.rng(4, 5), 0.0
    for i in np.nonzero(counts)[0]:
        py, px = traffic.pixel_sample(g, st.height, st.width, 3, "cpu")
        _, prim, shad = render_pixels(Field(scene, "cpu"), t, st,
                                      torch.as_tensor(pos[i]),
                                      torch.as_tensor(dirs[i]), py, px)
        per = roofline.ray_ops(scene, prim, shad).double().mean()
        want += counts[i] * float(per) * 16 * 12 * 4
    assert ops == pytest.approx(want, rel=1e-12)
    assert nbytes == res.attempted * roofline.frame_bytes(scene, 16 * 12 * 4)
