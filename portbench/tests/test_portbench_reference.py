"""The benchmark's plain reference against the port's CPU path, at small
sizes.  The port is imported here, by the tests; the reference itself
imports nothing of it (checked in a fresh interpreter)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import traffic  # noqa: E402
from portbench.reference import fit as rf  # noqa: E402
from portbench.reference import scene as rs  # noqa: E402
from portbench.reference.field import Field  # noqa: E402
from portbench.reference.render import (Settings, render_pixels,  # noqa: E402
                                        tables_on)

SCENES = ROOT / "portbench" / "scenes"
# The reference grammar's sponge of four levels over the demo's floor:
# 8,424 leaves, the reference's table of crosses at its deepest here.
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


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Scene files by name: the benchmark's, and menger4 written out."""
    d = tmp_path_factory.mktemp("scenes")
    (d / "menger4.txt").write_text(MENGER4)
    return {"demo": SCENES / "demo.txt", "menger4": d / "menger4.txt"}


def port_scene(path):
    from raymarching_tpu_torch.scene.compile import compile_scene
    from raymarching_tpu_torch.scene.parser import load_scene
    return compile_scene(load_scene(str(path)))


@pytest.mark.parametrize("name,leaves", [("demo", 428), ("menger4", 8424)])
def test_tables_equal_the_ports(name, leaves, scenes):
    _, tables = port_scene(scenes[name])
    ref = rs.load(scenes[name]).tables()
    assert ref["prim_pos"].shape == (leaves, 3)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(getattr(tables, k)), v)


def port_frame(path, st, pos=None, direction=None):
    from raymarching_tpu_torch import api
    from raymarching_tpu_torch.config import RenderConfig
    from raymarching_tpu_torch.tables import tables_to_torch
    plan, tables = port_scene(path)
    tt = tables_to_torch(tables, "cpu")
    if pos is not None:
        tt = tt._replace(cam_position=torch.as_tensor(pos),
                         cam_direction=torch.as_tensor(direction))
    cfg = RenderConfig(width=st.width, height=st.height, ssaa=st.ssaa,
                       iterations=st.iterations)
    return api.render_tables(plan, tt, cfg, backend="cuda", device="cpu")


def ref_frame(path, st, pos=None, direction=None):
    scene = rs.load(path)
    t = tables_on(scene.tables(), "cpu", torch.float32)
    pos = t["cam_position"] if pos is None else torch.as_tensor(pos)
    direction = (t["cam_direction"] if direction is None
                 else torch.as_tensor(direction))
    py = torch.arange(st.height).float()[:, None].expand(
        st.height, st.width).reshape(-1)
    px = torch.arange(st.width).float()[None, :].expand(
        st.height, st.width).reshape(-1)
    img, prim, _ = render_pixels(Field(scene, "cpu"), t, st, pos, direction,
                                 py, px)
    return img.reshape(st.height, st.width, 3), prim


@pytest.mark.parametrize("name,w,h,k,its,pose", [
    ("demo", 32, 24, 2, 400, None),
    ("demo", 24, 16, 1, 400, 17),
    ("menger4", 8, 6, 1, 200, None),
])
def test_frame_matches_the_ports_cpu_path(name, w, h, k, its, pose, scenes):
    st = Settings(width=w, height=h, ssaa=k, iterations=its)
    p = d = None
    if pose is not None:
        ps, ds = traffic.orbit_poses(rs.load(scenes[name]).tables(), 64)
        p, d = ps[pose], ds[pose]
    want = port_frame(scenes[name], st, p, d)
    got, prim = ref_frame(scenes[name], st, p, d)
    assert (prim > 1).all()
    err = (got - want).abs().max(dim=-1).values
    assert float((err > 1e-3).float().mean()) == 0.0
    assert float(err.max()) < 1e-5


def test_fit_matches_the_ports_fit():
    from raymarching_tpu_torch import optimize
    from raymarching_tpu_torch.config import RenderConfig
    from raymarching_tpu_torch.scene.compile import SceneTables
    st = Settings(width=20, height=14, ssaa=1, iterations=300)
    plan, tables = port_scene(SCENES / "demo.txt")
    scene = rs.load(SCENES / "demo.txt")
    ref_t = scene.tables()
    mix = traffic.load(ROOT / "portbench" / "traffic" / "fit.json")
    start = traffic.perturb(ref_t, mix, 3)
    py = torch.arange(st.height).float()[:, None].expand(
        st.height, st.width).reshape(-1)
    px = torch.arange(st.width).float()[None, :].expand(
        st.height, st.width).reshape(-1)
    t = tables_on(ref_t, "cpu", torch.float32)
    target = render_pixels(Field(scene, "cpu"), t, st, t["cam_position"],
                           t["cam_direction"], py, px)[0].reshape(
        st.height, st.width, 3)
    ref = rf.fit(scene, start, target, st, steps=2, lr=1e-2)
    grads = {}

    def cb(step, loss, tabs):
        if step == 0:
            grads.update({k: getattr(tabs, k).grad.clone()
                          for k in ("prim_pos", "prim_color", "light_pos",
                                    "cam_direction")})
    cfg = RenderConfig(width=st.width, height=st.height, ssaa=1,
                       iterations=st.iterations)
    res = optimize.fit(plan, SceneTables(**start), target, cfg,
                       device="cpu", steps=2, lr=1e-2, callback=cb)
    # the first step to rounding; the second after Adam moved the elements
    # of near-zero gradient by lr whatever their size
    np.testing.assert_allclose(res.losses[0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(res.losses[1], ref["losses"][1], rtol=1e-4)
    for k, g in grads.items():
        np.testing.assert_allclose(float(g.norm()),
                                   float(ref["grad0"][k].norm()), rtol=1e-3)
    for k in ("prim_pos", "prim_color", "light_pos"):
        moved = [np.linalg.norm(np.asarray(side[k]) - start[k])
                 for side in (res.tables._asdict(), ref["theta"])]
        np.testing.assert_allclose(*moved, rtol=2e-2)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.fit, portbench.reference.render\n"
            "import portbench.roofline, portbench.check, portbench.traffic\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'raymarching_tpu_torch', 'raymarching_tpu', 'jax'}\n"
            "assert not bad, bad\n") % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
