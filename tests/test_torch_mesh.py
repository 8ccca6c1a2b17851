"""Mesh export in the port (its copy of ``io/mesh.py``: marching
tetrahedra, ``default_bounds``, the OBJ and PLY writers, and
``sample_sdf_grid`` over K2's SD mode) against the JAX package, on the
CPU: twins of tests/test_mesh.py.  The grid is K2's plain twin here, held
to JAX's jnp grid at tests/test_fuzz.py's field tolerance; marching
tetrahedra is the same numpy code, so its output is identical on one
input grid."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_mesh import _edges, _sphere_grid  # noqa: E402
from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu as jrt  # noqa: E402
from raymarching_tpu.io import mesh as JM  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch import cli  # noqa: E402
from raymarching_tpu_torch.io import mesh as M  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

# tests/test_fuzz.py:96-98, the cross-package field tolerance
SD_RTOL, SD_ATOL = 5e-6, 1e-5


def _pair(name):
    path = f"scenes/{name}.txt"
    return (rt.compile_scene(rt.load_scene(path)),
            jrt.compile_scene(jrt.load_scene(path)))


@pytest.mark.parametrize("name,res", [("config3", 12), ("demo", 10),
                                      ("julia", 6)])
def test_sdf_grid_matches_jax_jnp(name, res):
    """The port's grid (K2's SD mode, its twin on the CPU, in chunks that
    do not divide the grid) against JAX's jnp grid, on the same bounds."""
    (plan, tables), (jplan, jtables) = _pair(name)
    lo, hi = M.default_bounds(plan, tables)
    jlo, jhi = JM.default_bounds(jplan, jtables)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(M.grid_points(lo, hi, res).reshape(
        res, res, res, 3)[..., 0], np.broadcast_to(
            np.linspace(lo[0], hi[0], res).astype(np.float32)[:, None, None],
            (res, res, res)))
    got = M.sample_sdf_grid(plan, tables, lo, hi, res, chunk=333,
                            device="cpu")
    want = JM.sample_sdf_grid(jplan, jtables, lo, hi, res, backend="jnp")
    assert got.shape == want.shape == (res, res, res)
    assert got.dtype == np.float32 and (got < 0).any() and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=SD_RTOL, atol=SD_ATOL)


def test_sdf_grid_launches_k2_sd_mode(monkeypatch):
    """Each chunk is one surface_eval call in SD mode (one K2 launch on a
    card); the last chunk is not padded."""
    (plan, tables), _ = _pair("config1")
    calls = []
    real = sk.surface_eval

    def spy(plan_, tables_, q, **kw):
        calls.append((q.shape[0], kw.get("mode")))
        return real(plan_, tables_, q, **kw)

    monkeypatch.setattr(sk, "surface_eval", spy)
    lo, hi = M.default_bounds(plan, tables)
    M.sample_sdf_grid(plan, tables, lo, hi, 9, chunk=300, device="cpu")
    assert calls == [(300, sk.SD), (300, sk.SD), (129, sk.SD)]


def test_marching_tetrahedra_identical_to_jax():
    """One input grid, the same numpy code: identical vertices and faces;
    and the theorems of tests/test_mesh.py on the port's output."""
    vals, lo, h = _sphere_grid()
    verts, faces = M.marching_tetrahedra(vals, lo, h)
    jverts, jfaces = JM.marching_tetrahedra(vals, lo, h)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    assert float(np.abs(np.linalg.norm(verts, axis=1) - 1.0).max()) < h / 2
    assert len(verts) - len(_edges(faces)) + len(faces) == 2
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    c = verts[faces].mean(axis=1)
    assert (np.sum(np.cross(e1, e2) * c, axis=1) > 0).all()
    for full in (np.ones((6, 6, 6), np.float32), -np.ones((6, 6, 6),
                                                           np.float32)):
        v, f = M.marching_tetrahedra(full, (0, 0, 0), 1.0)
        assert len(v) == 0 and len(f) == 0


def test_scene_mesh_equals_jax_on_one_grid():
    """extract_mesh of the demo: the port's grid and JAX's give the same
    topology when meshed by the same code (the grids agree to the field
    tolerance, far from any sign flip here), and the port's mesh is JAX's
    extract_mesh within a cell."""
    (plan, tables), (jplan, jtables) = _pair("config1")
    verts, faces = M.extract_mesh(plan, tables, resolution=16, device="cpu")
    jverts, jfaces = JM.extract_mesh(jplan, jtables, resolution=16,
                                     backend="jnp")
    np.testing.assert_array_equal(faces, jfaces)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-4)
    assert len(faces) > 100 and np.isfinite(verts).all()


def test_default_bounds_exclude_bounds_walls():
    (plan, tables), _ = _pair("demo")
    lo, hi = M.default_bounds(plan, tables)
    assert float((np.asarray(hi) - np.asarray(lo)).max()) < 150.0
    # tables as tensors give the same bounds
    tt = tables_to_torch(tables, "cpu")
    np.testing.assert_array_equal(M.default_bounds(plan, tt)[0], lo)


@pytest.mark.parametrize("ext", ["obj", "ply"])
def test_mesh_files_round_trip_and_equal_jax(tmp_path, ext):
    vals, lo, h = _sphere_grid(res=9)
    verts, faces = M.marching_tetrahedra(vals, lo, h)
    path, jpath = tmp_path / f"m.{ext}", tmp_path / f"j.{ext}"
    M.save_mesh(str(path), verts, faces)
    JM.save_mesh(str(jpath), verts, faces)
    assert path.read_bytes() == jpath.read_bytes()
    if ext == "obj":
        vs, fs = [], []
        for line in path.read_text().splitlines():
            parts = line.split()
            if parts and parts[0] == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif parts and parts[0] == "f":
                fs.append([int(x) - 1 for x in parts[1:4]])
        np.testing.assert_allclose(np.array(vs, np.float32), verts,
                                   rtol=1e-5)
        assert np.array_equal(np.array(fs), faces)
    else:
        header, _, body = path.read_bytes().partition(b"end_header\n")
        assert f"element vertex {len(verts)}".encode() in header
        vs = np.frombuffer(body[:len(verts) * 12], "<f4").reshape(-1, 3)
        np.testing.assert_array_equal(vs, verts)
    with pytest.raises(ValueError):
        M.save_mesh(str(tmp_path / "m.stl"), verts, faces)


def test_cli_mesh_export(tmp_path):
    """--mesh with no --out writes the mesh and renders nothing; the OBJ
    is extract_mesh's at --mesh-res; --mesh-bounds bounds the grid."""
    out = tmp_path / "scene.obj"
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        rc = cli.main(["--scene", os.path.join(cwd, "scenes/config1.txt"),
                       "--mesh", str(out), "--mesh-res", "14",
                       "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert rc == 0 and out.exists()
    assert not (tmp_path / "out.png").exists()
    plan, tables = rt.compile_scene(rt.load_scene("scenes/config1.txt"))
    verts, faces = M.extract_mesh(plan, tables, resolution=14, device="cpu")
    want = tmp_path / "want.obj"
    M.save_obj(str(want), verts, faces)
    assert out.read_bytes() == want.read_bytes()
    assert out.read_text().count("\nf ") > 50
    ply = tmp_path / "b.ply"
    assert cli.main(["--scene", "scenes/config1.txt", "--mesh", str(ply),
                     "--mesh-res", "8", "--mesh-bounds", "-3", "-3", "-7",
                     "3", "3", "-1", "--device", "cpu"]) == 0
    assert ply.read_bytes().startswith(b"ply\n")
    assert cli.main(["--scene", "scenes/config1.txt", "--mesh",
                     str(tmp_path / "m.stl"), "--device", "cpu"]) == 2
