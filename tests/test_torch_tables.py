"""Port tables: primitive and light rows and packed plan descriptors equal
what the JAX kernels read, and the port package never loads JAX."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.ops.pallas_march import _build_table  # noqa: E402
from raymarching_tpu.scene.compile import MIN, compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
from raymarching_tpu_torch.tables import (build_table, light_rows,  # noqa: E402
                                          pack_plan, tables_to_numpy,
                                          tables_to_torch)

SCENES = ["demo", "config4", "menger4", "scatter1k"]


@pytest.fixture(scope="module", params=SCENES)
def compiled(request, scenes_dir):
    return compile_scene(load_scene(str(scenes_dir / f"{request.param}.txt")))


def test_build_table_equals_jax_body_rows(compiled):
    plan, tables = compiled
    jax_tbl = np.asarray(_build_table(tables, plan.kernel))
    P = tables.prim_pos.shape[0]
    port = build_table(tables_to_torch(tables, "cpu")).numpy()
    assert port.shape == (P, 8) and port.dtype == np.float32
    np.testing.assert_array_equal(port, jax_tbl[:P])


def test_light_rows_equal_jax_rows(compiled):
    _, tables = compiled
    nL = tables.light_pos.shape[0]
    # the [L, 8] rows pallas_render_rays builds for the kernel
    jax_rows = np.asarray(jnp.concatenate(
        [jnp.asarray(tables.light_pos), jnp.zeros((nL, 1), jnp.float32),
         jnp.asarray(tables.light_color), jnp.zeros((nL, 1), jnp.float32)],
        axis=1))
    np.testing.assert_array_equal(
        light_rows(tables_to_torch(tables, "cpu")).numpy(), jax_rows)


def test_pack_plan_flattens_groups(compiled):
    plan, _ = compiled
    kp = plan.kernel
    packed = pack_plan(kp)
    assert packed.root_op == kp.root_op
    groups, runs = packed.groups.numpy(), packed.runs.numpy()
    assert groups.dtype == np.int32 and runs.dtype == np.int32
    assert groups.shape == (len(kp.groups), 4)
    for g, (gsign, first, n, cull) in zip(kp.groups, groups):
        assert gsign == g.gsign and n == len(g.runs)
        assert [tuple(r) for r in runs[first:first + n]] == list(g.runs)
        # pallas_march._scene_sd_tile's cull rule (no fused, no lattice)
        want = (g.gsign == -1 and kp.root_op == MIN and g.count >= 8
                and any(r[3] == -1 for r in g.runs))
        assert bool(cull) == want
        if cull:   # base runs lead, as the kernel's cull assumes
            scales = [r[3] for r in g.runs]
            assert scales == sorted(scales)
    assert int(groups[:, 2].sum()) == runs.shape[0]


def test_demo_has_a_cullable_menger_group(scenes_dir):
    plan, _ = compile_scene(load_scene(str(scenes_dir / "demo.txt")))
    groups = pack_plan(plan.kernel).groups.numpy()
    assert groups[:, 3].sum() == 1      # the 422-leaf Menger DIFFERENCE


def test_tables_to_torch_dtype_and_device(compiled):
    _, tables = compiled
    tt = tables_to_torch(tables, torch.device("cpu"))
    for name, v in zip(tables._fields, tt):
        assert v.dtype == torch.float32 and v.device.type == "cpu", name
        np.testing.assert_array_equal(v.numpy(), getattr(tables, name))


def test_tables_to_torch_makes_leaf_copies_that_require_grad(compiled):
    _, tables = compiled
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",
                                                       "cam_fov"))
    for name, v in zip(tables._fields, tt):
        assert v.requires_grad == (name in ("prim_pos", "cam_fov")), name
    assert tt.prim_pos.is_leaf
    with torch.no_grad():
        tt.prim_pos.add_(1.0)        # an optimizer's in-place update
    np.testing.assert_array_equal(tt.prim_pos.detach().numpy(),
                                  tables.prim_pos + 1)
    assert not np.shares_memory(tt.prim_pos.detach().numpy(),
                                tables.prim_pos)
    with pytest.raises(ValueError, match="prim_poz"):
        tables_to_torch(tables, "cpu", requires_grad=("prim_poz",))


def test_tables_to_numpy_round_trips(compiled):
    _, tables = compiled
    back = tables_to_numpy(tables_to_torch(tables, "cpu",
                                           requires_grad=("prim_aux",)))
    assert type(back) is type(tables)
    for name, a, b in zip(tables._fields, back, tables):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_port_never_imports_jax():
    code = ("import sys; import raymarching_tpu_torch, "
            "raymarching_tpu_torch.cli, raymarching_tpu_torch.serve, "
            "raymarching_tpu_torch.ops.build, "
            "raymarching_tpu_torch.ops.render_op, "
            "raymarching_tpu_torch.ops.surface_kernel; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_port_fit_with_structured_logging_never_imports_jax():
    """The shared structured logger looks up JAX's process index on its
    first record; the port's fit_step events must not."""
    code = "\n".join([
        "import io, json, sys",
        "from raymarching_tpu.utils import structlog",
        "import raymarching_tpu_torch as rt",
        "buf = io.StringIO()",
        "structlog.configure(stream=buf)",
        "plan, tables = rt.compile_scene(rt.load_scene('scenes/config1.txt'))",
        "cfg = rt.RenderConfig(width=8, height=6, ssaa=1, iterations=40)",
        "target = rt.render_tables(plan, tables, cfg, device='cpu')",
        "rt.fit(plan, tables, target, cfg, device='cpu', steps=1,",
        "       trainable=('prim_color',))",
        "events = [json.loads(ln) for ln in buf.getvalue().splitlines()]",
        "print(json.dumps([[e['event'], e['process']] for e in events]))",
        "print(sorted(m for m in sys.modules if m.split('.')[0] "
        "in ('jax', 'jaxlib')))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parent.parent)
    events, mods = out.stdout.strip().splitlines()
    assert json.loads(events) == [["fit_step", 0]]
    assert mods == "[]", mods
