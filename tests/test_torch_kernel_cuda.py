"""The four kernels on a CUDA card against their plain PyTorch twins (K1,
K2 in every mode, K3 with and without tmax and with steps, K4; K1 and K4
with FD and analytic normals), the two-phase path against the one kernel,
the multi-kernel backend against the fused one, and the differentiable
render's gradients on the card against the CPU's, in both normal regimes;
K1's and K4's extended-shading entries (soft shadows, AO, coloured lights)
and K1's raygen entries against their twins, with their gradients; K1's
mirror-bounce entries against their twins, the reflect backward's
gradients, and depth of field; the procedural views of all four kernels
(fractal scenes) in every entry and mode, with their gradients; the deep
views (trees deeper than two levels, a fractal inside) in every entry
and mode, with their gradients; the parameter scatter's segment kernel
against index_add_, alone and in every backward that ends in it.  Skips
without a card.

Imports nothing of JAX or the JAX package, so it also runs where neither
is installed:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import (chain_tree, deep_scene,  # noqa: E402,F401
                        one_torch_thread, random_scene)

import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.config import RenderConfig  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.core.march import dot3  # noqa: E402
from raymarching_tpu_torch.core.shading import normalize  # noqa: E402
from raymarching_tpu_torch.ops import march_kernel as mk  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.ops import shade_kernel as shk  # noqa: E402
from raymarching_tpu_torch.scene.compile import (SceneTables,  # noqa: E402
                                                 compile_scene, compile_tree)
from raymarching_tpu_torch.scene.csg import (Box, Julia, ListNode,  # noqa: E402
                                             Mode, Sphere, bounds)
from raymarching_tpu_torch.scene.objects import Camera, Light  # noqa: E402
from raymarching_tpu_torch.scene.parser import (load_scene,  # noqa: E402
                                                parse_scene)
from raymarching_tpu_torch.ops.render_op import FusedRender  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp  # noqa: E402
from raymarching_tpu_torch.ops import (  # noqa: E402
    segment_kernel as seg)
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

SCENES = Path(__file__).resolve().parent.parent / "scenes"
CFG = RenderConfig(width=32, height=24, ssaa=1, iterations=300)
# degenerate scenes of tests/test_degenerate_scenes.py's kind: empty,
# unbounded (no Bounds box), no lights
DEGENERATE = {"empty": "", "unbounded": "Sphere 0 0 -5 1",
              "no_lights": "Bounds 20\nBox 0 -1 -5 4 1 4\nSphere 0 0 -5 1"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_and_plain(plan, tables, cfg, device):
    tt = tables_to_torch(tables, device)
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    before = rk.render_rays.launches
    k = rk.render_rays(plan, cfg, tt, origin, dirs)
    torch.cuda.synchronize()
    assert rk.render_rays.launches == before + 1
    per_ray = rk.render_rays(plan, cfg, tt,
                             origin.expand(dirs.shape).contiguous(), dirs)
    return k, per_ray, rk.render_rays_plain(plan, cfg, tt, origin, dirs)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["demo", "config1", "config4", "menger4",
                                   "scatter1k"])
def test_kernel_matches_plain_twin_on_card(cuda_device, scene):
    plan, tables = compile_scene(load_scene(str(SCENES / f"{scene}.txt")))
    k, per_ray, plain = _kernel_and_plain(plan, tables, CFG, cuda_device)
    for name, a, b, c in zip(rk.RayOutputs._fields, k, plain, per_ray):
        assert (a == b).float().mean().item() >= 0.999, name
        assert torch.equal(a, c), name
    assert (k.light - plain.light).abs().max().item() <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_kernel_degenerate_scenes_on_card(cuda_device, name):
    plan, tables = compile_scene(parse_scene(DEGENERATE[name]))
    k, _, plain = _kernel_and_plain(plan, tables, CFG, cuda_device)
    assert bool(torch.isfinite(k.p).all() and torch.isfinite(k.light).all())
    for name_, a, b in zip(rk.RayOutputs._fields, k, plain):
        assert torch.equal(a, b), name_


def _stencil_kernel_and_plain(plan, tables, cfg, device):
    """K2 and its plain twin on the 7-point stencils of K1's hits."""
    tt = tables_to_torch(tables, device)
    origin, dirs = cam.generate_rays(tt, cfg)
    hits = rk.render_rays(plan, cfg, tt, origin, dirs.reshape(-1, 3)).p
    before = sk.surface_eval.launches
    k = scene_vjp.stencil_eval(plan, cfg, tt, hits, center=True)
    torch.cuda.synchronize()
    assert sk.surface_eval.launches == before + 1
    R = hits.shape[0]
    q = sk.stencil_points(hits, cfg.fd_h, center=True)
    plain = sk.surface_eval_plain(plan, tt, q.reshape(-1, 3))
    return k, [v.reshape((7, R) + v.shape[1:]) for v in plain]


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["demo", "config1", "config4", "menger4",
                                   "scatter1k"])
def test_surface_kernel_matches_plain_twin_on_card(cuda_device, scene):
    plan, tables = compile_scene(load_scene(str(SCENES / f"{scene}.txt")))
    k, plain = _stencil_kernel_and_plain(plan, tables, CFG, cuda_device)
    for name, a, b in zip(("sd", "widx", "g"), k, plain):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert (k[1] >= 0).float().mean().item() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_surface_kernel_degenerate_scenes_on_card(cuda_device, name):
    plan, tables = compile_scene(parse_scene(DEGENERATE[name]))
    k, plain = _stencil_kernel_and_plain(plan, tables, CFG, cuda_device)
    for a, b in zip(k, plain):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(k[2]).all())


@pytest.mark.cuda
def test_render_gradients_on_card_match_cpu(cuda_device):
    """One K1 and one K2 launch per differentiable render; on the same rays
    (made on the CPU: the card's own camera rounds a few directions an ulp
    apart, and a grazing hit turns that into a percent of a gradient) the
    gradients of every table field and of the rays agree with the plain
    twins' on the CPU at tests/test_mega.py:62's tolerance (the card's
    atomics reorder the float64 parameter sums)."""
    plan, tables = compile_scene(load_scene(str(SCENES / "demo.txt")))
    origin, dirs = cam.generate_rays(tables_to_torch(tables, "cpu"), CFG)
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        tt = tables_to_torch(tables, device,
                             requires_grad=SceneTables._fields)
        o = origin.to(device).requires_grad_()
        d = dirs.reshape(-1, 3).to(device).requires_grad_()
        k1, k2 = rk.render_rays.launches, sk.surface_eval.launches
        colors = FusedRender.apply(plan, CFG, o, d, *tt)
        g = torch.autograd.grad(torch.mean((colors - 0.25) ** 2), [*tt, o, d],
                                allow_unused=True, materialize_grads=True)
        launched = (rk.render_rays.launches - k1,
                    sk.surface_eval.launches - k2)
        assert launched == ((1, 1) if device.type == "cuda" else (0, 0))
        grads.append([v.cpu() for v in g])
    for name, a, b in zip(SceneTables._fields + ("origin", "dirs"), *grads):
        assert bool(torch.isfinite(a).all()), name
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


def _same(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        if a.is_floating_point():
            # an empty scene's FD gradient is inf - inf on both sides
            assert bool(((a == b) | (a.isnan() & b.isnan())).all()), (what, i)
        else:
            assert torch.equal(a, b), (what, i)


ALL_SCENES = {**{s: None for s in ("demo", "config1", "config4", "menger4",
                                   "scatter1k")}, **DEGENERATE}


def _compiled(name):
    text = ALL_SCENES[name]
    scene = (load_scene(str(SCENES / f"{name}.txt")) if text is None
             else parse_scene(text))
    return compile_scene(scene)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(ALL_SCENES))
def test_march_and_shade_kernels_match_plain_twins_on_card(cuda_device,
                                                           scene):
    """K3 (primary rays with steps; shadow rays with tmax) and K4 against
    their twins, bitwise, and against K1's own march and shading."""
    plan, tables = _compiled(scene)
    tt = tables_to_torch(tables, cuda_device)
    origin, dirs = cam.generate_rays(tt, CFG)
    dirs = dirs.reshape(-1, 3)
    k1 = rk.render_rays(plan, CFG, tt, origin, dirs)
    n3, n4 = mk.march_rays.launches, shk.shade_rays.launches
    res, steps = mk.march_rays(plan, CFG, tt, origin, dirs, with_steps=True)
    torch.cuda.synchronize()
    assert mk.march_rays.launches == n3 + 1
    res_p, steps_p = mk.march_rays_plain(plan, CFG, tt, origin, dirs,
                                         with_steps=True)
    _same((*res, steps), (*res_p, steps_p), "K3")
    _same(res, (k1.p, k1.sd, k1.done), "K3 vs K1")
    _, _, g = sk.surface_eval(plan, tt, k1.p, mode=sk.FD_GRAD, fd_h=CFG.fd_h)
    n = normalize(g)
    for li in range(plan.num_lights):
        lp = tt.light_pos[li]
        start = k1.p + n * (CFG.surface_precision + CFG.offset_precision)
        r = lp - start
        tmax, ray = torch.sqrt(dot3(r, r)), normalize(lp - k1.p)
        _same(mk.march_rays(plan, CFG, tt, start, ray, tmax=tmax),
              mk.march_rays_plain(plan, CFG, tt, start, ray, tmax=tmax),
              f"K3 shadow {li}")
    k4 = shk.shade_rays(plan, CFG, tt, k1.p, k1.sd, dirs)
    torch.cuda.synchronize()
    assert shk.shade_rays.launches == n4 + 1
    _same(k4, shk.shade_rays_plain(plan, CFG, tt, k1.p, k1.sd, dirs), "K4")
    _same(k4, (k1.cidx, k1.light, k1.smask), "K4 vs K1")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [sk.SD, sk.WINNER, sk.FD_GRAD, sk.ANALYTIC])
@pytest.mark.parametrize("scene", sorted(ALL_SCENES))
def test_surface_kernel_modes_match_plain_twins_on_card(cuda_device, scene,
                                                        mode):
    plan, tables = _compiled(scene)
    tt = tables_to_torch(tables, cuda_device)
    origin, dirs = cam.generate_rays(tt, CFG)
    hits = rk.render_rays(plan, CFG, tt, origin, dirs.reshape(-1, 3)).p
    before = sk.surface_eval.launches
    k = sk.surface_eval(plan, tt, hits, mode=mode, fd_h=CFG.fd_h)
    torch.cuda.synchronize()
    assert sk.surface_eval.launches == before + 1
    _same(k, sk.surface_eval_plain(plan, tt, hits, mode=mode, fd_h=CFG.fd_h),
          f"mode {mode}")


@pytest.mark.cuda
@pytest.mark.parametrize("k1", [1, 8, 48])
@pytest.mark.parametrize("scene", ["demo", "config4", "menger4"])
def test_two_phase_equals_one_kernel_on_card(cuda_device, scene, k1):
    plan, tables = _compiled(scene)
    tt = tables_to_torch(tables, cuda_device)
    origin, dirs = cam.generate_rays(tt, CFG)
    dirs = dirs.reshape(-1, 3)
    one = rk.render_rays(plan, CFG, tt, origin, dirs)
    n1, n3, n4 = (rk.render_rays.launches, mk.march_rays.launches,
                  shk.shade_rays.launches)
    two = rk.render_rays(plan, CFG.replace(two_phase_k1=k1), tt, origin, dirs)
    assert rk.render_rays.launches == n1
    assert mk.march_rays.launches - n3 in (1, 2)
    assert shk.shade_rays.launches == n4 + 1
    _same(two, one, f"two-phase k1={k1}")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["demo", "config4"])
def test_multi_backend_matches_fused_on_card(cuda_device, scene):
    plan, tables = _compiled(scene)
    cfg = CFG.replace(shade_skip_black=False)
    imgs, grads = {}, {}
    for backend in ("cuda", "multi"):
        tt = tables_to_torch(tables, cuda_device,
                             requires_grad=SceneTables._fields)
        img = rt.render_tables(plan, tt, cfg, backend=backend,
                               differentiable=True, device=cuda_device)
        grads[backend] = torch.autograd.grad(
            torch.mean((img - 0.25) ** 2), list(tt), allow_unused=True,
            materialize_grads=True)
        imgs[backend] = img.detach()
    torch.testing.assert_close(imgs["multi"], imgs["cuda"], rtol=0,
                               atol=1e-6)
    for name, a, b in zip(SceneTables._fields, grads["multi"],
                          grads["cuda"]):
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


def _value_outputs(plan, tt, cfg, origin, dirs, collapse):
    """K1, K3 (with steps), K4 on K1's hits and K2's value modes with the
    lattice collapse on or off, as one flat tuple of tensors."""
    k1 = rk.render_rays(plan, cfg, tt, origin, dirs, collapse=collapse)
    res, steps = mk.march_rays(plan, cfg, tt, origin, dirs, with_steps=True,
                               collapse=collapse)
    k4 = shk.shade_rays(plan, cfg, tt, k1.p, k1.sd, dirs, collapse=collapse)
    sd, _, _ = sk.surface_eval(plan, tt, k1.p, mode=sk.SD, collapse=collapse)
    sd_fd, _, g = sk.surface_eval(plan, tt, k1.p, mode=sk.FD_GRAD,
                                  fd_h=cfg.fd_h, collapse=collapse)
    torch.cuda.synchronize()
    return (*k1, *res, steps, *k4, sd, sd_fd, g)


def _value_twins(plan, tt, cfg, origin, dirs, collapse):
    k1 = rk.render_rays_plain(plan, cfg, tt, origin, dirs, collapse)
    res, steps = mk.march_rays_plain(plan, cfg, tt, origin, dirs,
                                     with_steps=True, collapse=collapse)
    k4 = shk.shade_rays_plain(plan, cfg, tt, k1.p, k1.sd, dirs, collapse)
    sd, _, _ = sk.surface_eval_plain(plan, tt, k1.p, mode=sk.SD,
                                     collapse=collapse)
    sd_fd, _, g = sk.surface_eval_plain(plan, tt, k1.p, mode=sk.FD_GRAD,
                                        fd_h=cfg.fd_h, collapse=collapse)
    return (*k1, *res, steps, *k4, sd, sd_fd, g)


def _moved_cross_row(plan, tables):
    """One cross row of the lattice group moved: the collapse flag drops."""
    g = next(g for g in plan.kernel.groups if g.lattice is not None)
    pos = tables.prim_pos.copy()
    pos[g.start + 5, 0] += 0.25
    return tables._replace(prim_pos=pos)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("scene", ["demo", "demo moved", "config4",
                                   "scatter1k", "menger4"])
def test_collapse_and_placement_match_twins_on_card(cuda_device, monkeypatch,
                                                    scene, placement):
    """K1, K3, K4 and K2's value modes with the lattice collapse on and
    off, the scene staged in shared memory or read from device memory:
    every output equal bitwise to the other setting's and to the plain
    twins' (with the collapse on and off too)."""
    from raymarching_tpu_torch import tables as scene_tables
    plan, tables = _compiled(scene.split()[0])
    if scene.endswith("moved"):
        tables = _moved_cross_row(plan, tables)
    tt = tables_to_torch(tables, cuda_device)
    nbytes = scene_tables.scene_operands(plan, tt, cuda_device).nbytes(
        plan.num_lights)
    if placement == "shared":
        if nbytes > scene_tables.SHARED_SCENE_BYTES:
            pytest.skip(f"{scene}: {nbytes} bytes do not fit shared memory")
    else:
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    flag = int(scene_tables.lattice_ok(plan.kernel, tt))
    has_lattice = any(scene_tables.collapses(plan.kernel, g)
                      for g in plan.kernel.groups)
    assert flag == int(has_lattice and not scene.endswith("moved"))
    assert has_lattice == (scene != "scatter1k")
    origin, dirs = cam.generate_rays(tt, CFG)
    dirs = dirs.reshape(-1, 3)
    on = _value_outputs(plan, tt, CFG, origin, dirs, True)
    off = _value_outputs(plan, tt, CFG, origin, dirs, False)
    _same(on, off, f"{scene} {placement}: collapse on vs off")
    _same(on, _value_twins(plan, tt, CFG, origin, dirs, True),
          f"{scene} {placement}: kernels vs twins, collapse on")
    _same(off, _value_twins(plan, tt, CFG, origin, dirs, False),
          f"{scene} {placement}: kernels vs twins, collapse off")


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("n", [1, 31, 33, 127, 700])
def test_ragged_ray_counts_on_card(cuda_device, monkeypatch, n, placement):
    """The persistent kernels on ray counts that are no multiple of a warp
    or a block, with per-ray origins: rays are independent, so the first n
    rays alone give the full launch's outputs on those rays."""
    from raymarching_tpu_torch import tables as scene_tables
    if placement == "device":
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    plan, tables = _compiled("demo")
    tt = tables_to_torch(tables, cuda_device)
    origin, dirs = cam.generate_rays(tt, CFG)
    dirs = dirs.reshape(-1, 3)
    R = dirs.shape[0]
    org = origin.expand(R, 3)[:n].contiguous()
    full = _value_outputs(plan, tt, CFG, origin, dirs, True)
    k1 = rk.render_rays(plan, CFG, tt, org, dirs[:n])
    res, steps = mk.march_rays(plan, CFG, tt, org, dirs[:n], with_steps=True)
    k4 = shk.shade_rays(plan, CFG, tt, k1.p, k1.sd, dirs[:n])
    torch.cuda.synchronize()
    _same((*k1, *res, steps, *k4), tuple(v[:n] for v in full[:13]),
          f"first {n} rays")


@pytest.mark.cuda
def test_scene_above_48_kb_is_staged_in_shared_memory_on_card(cuda_device):
    """A union of 1,800 spheres is 57,600 bytes of rows: under the shared
    placement's limit and above the 48 KB a kernel gets without asking for
    more, so the launch raises its dynamic shared memory limit first."""
    from raymarching_tpu_torch import tables as scene_tables
    rows = "\n".join(
        f"Sphere {(i % 45) * 0.9 - 20:.2f} {(i // 45) * 0.9 - 18:.2f} "
        f"{-30 - (i % 7)} 0.4" for i in range(1800))
    plan, tables = compile_scene(parse_scene("Bounds 90\n" + rows))
    tt = tables_to_torch(tables, cuda_device)
    nbytes = scene_tables.scene_operands(plan, tt, cuda_device).nbytes(
        plan.num_lights)
    assert 48 * 1024 < nbytes <= scene_tables.SHARED_SCENE_BYTES
    origin, dirs = cam.generate_rays(tt, CFG)
    dirs = dirs.reshape(-1, 3)
    _same(_value_outputs(plan, tt, CFG, origin, dirs, True),
          _value_twins(plan, tt, CFG, origin, dirs, True), "1,800 spheres")


def _hits(plan, tt, cfg=CFG):
    origin, dirs = cam.generate_rays(tt, cfg)
    return rk.render_rays(plan, cfg, tt, origin, dirs.reshape(-1, 3)).p


def _scene_tables(scene, device):
    """(plan, tables on ``device``) of a scene name, "<name> moved" with
    one cross row of its lattice group moved."""
    plan, tables = _compiled(scene.split()[0])
    if scene.endswith("moved"):
        tables = _moved_cross_row(plan, tables)
    return plan, tables_to_torch(tables, device)


@pytest.mark.cuda
@pytest.mark.parametrize("collapse", [True, False])
@pytest.mark.parametrize("scene", sorted(ALL_SCENES) + ["demo moved"])
def test_surface_kernel_combined_mode_matches_plain_twin_on_card(
        cuda_device, scene, collapse):
    """K2's combined mode, whose fold takes the lattice collapse with
    winner rows while the flag holds: sd, winner and gradient bitwise the
    twin's, which walks the same stream."""
    plan, tt = _scene_tables(scene, cuda_device)
    hits = _hits(plan, tt)
    before = sk.surface_eval.launches
    k = sk.surface_eval(plan, tt, hits, collapse=collapse)
    torch.cuda.synchronize()
    assert sk.surface_eval.launches == before + 1
    _same(k, sk.surface_eval_plain(plan, tt, hits, collapse=collapse),
          f"{scene} combined, collapse {collapse}")
    # the value is the value modes' own, whatever the winner fold took
    assert torch.equal(k[0], sk.surface_eval(plan, tt, hits, mode=sk.SD)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("scene", ["demo", "demo moved", "config1", "menger4",
                                   "empty"])
def test_stencil_entry_matches_plain_twin_on_card(cuda_device, monkeypatch,
                                                  scene, center, placement):
    """K2's stencil entry makes the 7 or 6 stencil points of a hit in the
    kernel: outputs in ``stencil_points``' row order, bitwise the twin's,
    with the collapse on and off, the scene staged or in device memory,
    from a transposed view of [3, R] hits and from a contiguous [R, 3]
    tensor alike, in one launch."""
    from raymarching_tpu_torch import tables as scene_tables
    plan, tt = _scene_tables(scene, cuda_device)
    nbytes = scene_tables.scene_operands(plan, tt, cuda_device).nbytes()
    if placement == "device":
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    elif nbytes > scene_tables.SHARED_SCENE_BYTES:
        pytest.skip(f"{scene}: {nbytes} bytes do not fit shared memory")
    hits = _hits(plan, tt)
    assert not hits.is_contiguous() and hits.t().is_contiguous()
    for collapse in (True, False):
        before = sk.surface_eval.launches
        k = sk.surface_stencil(plan, tt, hits, CFG.fd_h, center=center,
                               collapse=collapse)
        torch.cuda.synchronize()
        assert sk.surface_eval.launches == before + 1
        _same(k, sk.surface_stencil_plain(plan, tt, hits, CFG.fd_h,
                                          center=center, collapse=collapse),
              f"{scene} stencil, centre {center}, collapse {collapse}")
        _same(sk.surface_stencil(plan, tt, hits.contiguous(), CFG.fd_h,
                                 center=center, collapse=collapse), k,
              "contiguous hits")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 127, 700])
def test_surface_kernel_ragged_counts_on_card(cuda_device, n):
    """K2 on its persistent grid: the first n points or hits alone give
    the full launch's outputs on them, in every mode and through the
    stencil entry."""
    plan, tt = _scene_tables("demo", cuda_device)
    hits = _hits(plan, tt)
    for mode in sk.MODES:
        full = sk.surface_eval(plan, tt, hits, mode=mode, fd_h=CFG.fd_h)
        part = sk.surface_eval(plan, tt, hits[:n], mode=mode, fd_h=CFG.fd_h)
        _same(part, tuple(None if v is None else v[:n] for v in full),
              f"mode {mode}, first {n} points")
    full = sk.surface_stencil(plan, tt, hits, CFG.fd_h, center=True)
    part = sk.surface_stencil(plan, tt, hits[:n], CFG.fd_h, center=True)
    torch.cuda.synchronize()
    _same(part, tuple(v[:, :n] for v in full), f"stencils of {n} hits")


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("scene", ["demo", "demo moved", "config4", "menger4",
                                   "scatter1k", "empty"])
def test_multipoint_walk_equals_single_walks_on_card(cuda_device, monkeypatch,
                                                     scene, placement):
    """K2's FD-gradient mode with its seven points in one walk of the
    scene (fold.cuh's scene_sd_n) and in seven walks: the same bits, and
    the twin's, with the collapse on and off."""
    from raymarching_tpu_torch import tables as scene_tables
    plan, tt = _scene_tables(scene, cuda_device)
    if placement == "device":
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    elif (scene_tables.scene_operands(plan, tt, cuda_device).nbytes()
          > scene_tables.SHARED_SCENE_BYTES):
        pytest.skip(f"{scene} does not fit shared memory")
    hits = _hits(plan, tt)
    for collapse in (True, False):
        kw = dict(mode=sk.FD_GRAD, fd_h=CFG.fd_h, collapse=collapse)
        one = sk.surface_eval(plan, tt, hits, **kw)
        seven = sk.surface_eval(plan, tt, hits, multipoint=False, **kw)
        torch.cuda.synchronize()
        _same(one, seven, f"{scene}: one walk against seven")
        _same(one, sk.surface_eval_plain(plan, tt, hits, **kw),
              f"{scene}: one walk against the twin")


ANALYTIC = CFG.replace(normal_mode="analytic")


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("scene", ["demo", "demo moved", "config1", "config4",
                                   "menger4", "scatter1k", "empty",
                                   "no_lights"])
def test_analytic_kernels_match_twins_on_card(cuda_device, monkeypatch,
                                              scene, placement):
    """K1 and K4 instantiated with the analytic normal, with and without
    the winner residuals, and K2's analytic mode: every output bitwise the
    twins', with the collapse on and off and the scene staged or in device
    memory; the residuals are K2's combined mode at the hits, and K4's are
    K1's."""
    from raymarching_tpu_torch import tables as scene_tables
    plan, tt = _scene_tables(scene, cuda_device)
    nbytes = scene_tables.scene_operands(plan, tt, cuda_device).nbytes(
        plan.num_lights)
    if placement == "device":
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    elif nbytes > scene_tables.SHARED_SCENE_BYTES:
        pytest.skip(f"{scene}: {nbytes} bytes do not fit shared memory")
    origin, dirs = cam.generate_rays(tt, ANALYTIC)
    dirs = dirs.reshape(-1, 3)
    outs = {}
    for collapse in (True, False):
        c = dict(collapse=collapse)
        n1 = rk.render_rays.launches
        k1, w1 = rk.render_rays(plan, ANALYTIC, tt, origin, dirs,
                                save_winner=True, **c)
        torch.cuda.synchronize()
        assert rk.render_rays.launches == n1 + 1
        _same(rk.render_rays(plan, ANALYTIC, tt, origin, dirs, **c), k1,
              f"{scene}: K1 analytic without residuals")
        p1, pw = rk.render_rays_plain(plan, ANALYTIC, tt, origin, dirs,
                                      save_winner=True, **c)
        _same((*k1, *w1), (*p1, *pw), f"{scene}: K1 analytic vs twin")
        k4, w4 = shk.shade_rays(plan, ANALYTIC, tt, k1.p, k1.sd, dirs,
                                save_winner=True, **c)
        _same((*k4, *w4), (k1.cidx, k1.light, k1.smask, *w1),
              f"{scene}: K4 analytic vs K1")
        s4, sw = shk.shade_rays_plain(plan, ANALYTIC, tt, k1.p, k1.sd, dirs,
                                      save_winner=True, **c)
        _same((*k4, *w4), (*s4, *sw), f"{scene}: K4 analytic vs twin")
        k2 = sk.surface_eval(plan, tt, k1.p, mode=sk.ANALYTIC, **c)
        _same(k2, sk.surface_eval_plain(plan, tt, k1.p, mode=sk.ANALYTIC,
                                        **c), f"{scene}: K2 analytic")
        _same((k2[0], k2[2]), (w1.sd, w1.g), f"{scene}: K2 analytic vs K1")
        _same(sk.surface_eval(plan, tt, k1.p, **c), w1,
              f"{scene}: K2 combined vs K1's residuals")
        outs[collapse] = (*k1, w1.sd, w1.g)
    # the values and gradients do not depend on the collapse
    _same(outs[True], outs[False], f"{scene}: collapse on vs off")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["demo", "config4", "menger4"])
def test_fd_instantiation_is_unchanged_on_card(cuda_device, scene):
    """The FD instantiations of K1 and K4 beside the analytic ones: the
    same outputs as their twins, and the analytic regime really differs."""
    plan, tt = _scene_tables(scene, cuda_device)
    origin, dirs = cam.generate_rays(tt, CFG)
    dirs = dirs.reshape(-1, 3)
    fd = rk.render_rays(plan, CFG, tt, origin, dirs)
    _same(fd, rk.render_rays_plain(plan, CFG, tt, origin, dirs), "K1 FD")
    _same(shk.shade_rays(plan, CFG, tt, fd.p, fd.sd, dirs),
          (fd.cidx, fd.light, fd.smask), "K4 FD vs K1")
    an = rk.render_rays(plan, ANALYTIC, tt, origin, dirs)
    _same(an[:3], fd[:3], "the march does not depend on the normal")
    if scene == "demo":     # menger4's lights clamp to the same values
        assert not torch.equal(an.light, fd.light)
    with pytest.raises(ValueError, match="analytic"):
        rk.render_rays(plan, CFG, tt, origin, dirs, save_winner=True)


@pytest.mark.cuda
@pytest.mark.parametrize("k1", [1, 8, 48])
@pytest.mark.parametrize("scene", ["demo", "config4", "menger4"])
def test_two_phase_analytic_equals_one_kernel_on_card(cuda_device, scene,
                                                      k1):
    """K3, K3 and K4 in the analytic regime: K1's outputs and residuals."""
    plan, tt = _scene_tables(scene, cuda_device)
    origin, dirs = cam.generate_rays(tt, ANALYTIC)
    dirs = dirs.reshape(-1, 3)
    one, w1 = rk.render_rays(plan, ANALYTIC, tt, origin, dirs,
                             save_winner=True)
    n1, n4 = rk.render_rays.launches, shk.shade_rays.launches
    two, w2 = rk.render_rays(plan, ANALYTIC.replace(two_phase_k1=k1), tt,
                             origin, dirs, save_winner=True)
    assert rk.render_rays.launches == n1
    assert shk.shade_rays.launches == n4 + 1
    _same((*two, *w2), (*one, *w1), f"two-phase analytic k1={k1}")


@pytest.mark.cuda
@pytest.mark.parametrize("save", [True, False])
def test_analytic_gradients_on_card_match_cpu(cuda_device, monkeypatch, save):
    """The fused analytic step: one K1 launch and no K2 launch with the
    residuals (one K2 launch without them); card gradients against the CPU
    twins' on the same rays at tests/test_mega.py:62's tolerance."""
    from raymarching_tpu_torch.ops import render_op
    monkeypatch.setattr(render_op, "SAVE_WINNER", save)
    plan, tables = compile_scene(load_scene(str(SCENES / "demo.txt")))
    origin, dirs = cam.generate_rays(tables_to_torch(tables, "cpu"), ANALYTIC)
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        tt = tables_to_torch(tables, device,
                             requires_grad=SceneTables._fields)
        o = origin.to(device).requires_grad_()
        d = dirs.reshape(-1, 3).to(device).requires_grad_()
        k1, k2 = rk.render_rays.launches, sk.surface_eval.launches
        colors = FusedRender.apply(plan, ANALYTIC, o, d, *tt)
        g = torch.autograd.grad(torch.mean((colors - 0.25) ** 2), [*tt, o, d],
                                allow_unused=True, materialize_grads=True)
        launched = (rk.render_rays.launches - k1,
                    sk.surface_eval.launches - k2)
        assert launched == (((1, 0) if save else (1, 1))
                            if device.type == "cuda" else (0, 0))
        grads.append([v.cpu() for v in g])
    for name, a, b in zip(SceneTables._fields + ("origin", "dirs"), *grads):
        assert bool(torch.isfinite(a).all()), name
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["demo", "config4"])
def test_multi_backend_matches_fused_analytic_on_card(cuda_device, scene):
    """The multi-kernel analytic frame (K2's analytic mode for the normals,
    NormalOp's Hessian-chain backward) against the fused one."""
    plan, tables = _compiled(scene)
    cfg = ANALYTIC.replace(shade_skip_black=False)
    imgs, grads = {}, {}
    for backend in ("cuda", "multi"):
        tt = tables_to_torch(tables, cuda_device,
                             requires_grad=SceneTables._fields)
        img = rt.render_tables(plan, tt, cfg, backend=backend,
                               differentiable=True, device=cuda_device)
        grads[backend] = torch.autograd.grad(
            torch.mean((img - 0.25) ** 2), list(tt), allow_unused=True,
            materialize_grads=True)
        imgs[backend] = img.detach()
    torch.testing.assert_close(imgs["multi"], imgs["cuda"], rtol=0,
                               atol=1e-6)
    for name, a, b in zip(SceneTables._fields, grads["multi"],
                          grads["cuda"]):
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


# fused generators: the scenes with generator groups, and a DeathStar alone
FUSED_SCENES = ("demo", "config3", "config4", "menger4", "deathstar")
DEATHSTAR = "Bounds 40\nLight 5 8 4\nColor 0.3 0.4 0.9\nDeathStar 0 0 -6 2\n"


def _fused_scene_tables(scene, device):
    text = DEATHSTAR if scene == "deathstar" else None
    plan, tables = compile_scene(
        parse_scene(text) if text is not None
        else load_scene(str(SCENES / f"{scene}.txt")))
    assert any(g.fused is not None for g in plan.kernel.groups)
    return plan, tables, tables_to_torch(tables, device)


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("scene", FUSED_SCENES)
def test_fused_kernels_match_twins_on_card(cuda_device, monkeypatch, scene,
                                           placement, normal):
    """The fused-generator instantiations of all four kernels against their
    twins, bitwise: K1 (with analytic normals with and without its winner
    residuals), K3 with steps and on shadow rays, K4 on K1's hits and
    against K1, and K2's five modes at the hits; extended winner ids in
    the combined mode and the residuals, and the residuals equal to K2's
    combined mode."""
    from raymarching_tpu_torch import tables as scene_tables
    plan, _, tt = _fused_scene_tables(scene, cuda_device)
    cfg = CFG.replace(fused_generators=True, normal_mode=normal)
    nbytes = scene_tables.scene_operands(plan, tt, cuda_device, True,
                                         True).nbytes(plan.num_lights)
    if placement == "device":
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    elif nbytes > scene_tables.SHARED_SCENE_BYTES:
        pytest.skip(f"{scene}: {nbytes} bytes do not fit shared memory")
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    analytic = normal == "analytic"
    kw = dict(save_winner=True) if analytic else {}
    n1 = rk.render_rays.launches
    out = rk.render_rays(plan, cfg, tt, origin, dirs, **kw)
    torch.cuda.synchronize()
    assert rk.render_rays.launches == n1 + 1
    plain = rk.render_rays_plain(plan, cfg, tt, origin, dirs, **kw)
    k1, w1 = out if analytic else (out, ())
    p1, pw = plain if analytic else (plain, ())
    _same((*k1, *w1), (*p1, *pw), f"{scene}: K1 fused {normal}")
    if analytic:
        _same(rk.render_rays(plan, cfg, tt, origin, dirs), k1,
              f"{scene}: K1 fused analytic without residuals")
        _same(sk.surface_eval(plan, tt, k1.p, fused=True), w1,
              f"{scene}: K2 combined vs K1's residuals")
    # exact and fused fields differ on the generators' carves
    exact = rk.render_rays(plan, cfg.replace(fused_generators=False), tt,
                           origin, dirs)
    assert exact.p.shape == k1.p.shape
    res, steps = mk.march_rays(plan, cfg, tt, origin, dirs, with_steps=True)
    res_p, steps_p = mk.march_rays_plain(plan, cfg, tt, origin, dirs,
                                         with_steps=True)
    _same((*res, steps), (*res_p, steps_p), f"{scene}: K3 fused")
    _same(res, (k1.p, k1.sd, k1.done), f"{scene}: K3 fused vs K1")
    for li in range(plan.num_lights):
        n = normalize(sk.surface_eval(plan, tt, k1.p, mode=sk.FD_GRAD,
                                      fd_h=cfg.fd_h, fused=True)[2])
        lp = tt.light_pos[li]
        start = k1.p + n * (cfg.surface_precision + cfg.offset_precision)
        d = normalize(lp - k1.p)
        tmax = torch.sqrt(dot3(lp - start, lp - start))
        _same(mk.march_rays(plan, cfg, tt, start, d, tmax=tmax),
              mk.march_rays_plain(plan, cfg, tt, start, d, tmax=tmax),
              f"{scene}: K3 fused shadow rays {li}")
    o4 = shk.shade_rays(plan, cfg, tt, k1.p, k1.sd, dirs, **kw)
    k4, w4 = o4 if analytic else (o4, ())
    s4 = shk.shade_rays_plain(plan, cfg, tt, k1.p, k1.sd, dirs, **kw)
    s4, sw = s4 if analytic else (s4, ())
    _same((*k4, *w4), (*s4, *sw), f"{scene}: K4 fused {normal}")
    _same((*k4, *w4), (k1.cidx, k1.light, k1.smask, *w1),
          f"{scene}: K4 fused vs K1")
    for mode in sk.MODES:
        _same(sk.surface_eval(plan, tt, k1.p, mode=mode, fd_h=cfg.fd_h,
                              fused=True),
              sk.surface_eval_plain(plan, tt, k1.p, mode=mode, fd_h=cfg.fd_h,
                                    fused=True),
              f"{scene}: K2 fused mode {mode}")
    P = plan.num_primitives
    _, widx, _ = sk.surface_eval(plan, tt, k1.p, fused=True)
    assert int(widx.max()) < P + len([g for g in plan.kernel.groups
                                      if g.fused is not None])
    _, cidx, _ = sk.surface_eval(plan, tt, k1.p, mode=sk.WINNER, fused=True)
    assert int(cidx.max()) < P


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("scene", ["demo", "config3", "menger4"])
def test_fused_two_phase_equals_one_kernel_on_card(cuda_device, scene,
                                                   normal):
    """K3, K3 and K4 on the fused field: K1's outputs (and residuals)."""
    plan, _, tt = _fused_scene_tables(scene, cuda_device)
    cfg = CFG.replace(fused_generators=True, normal_mode=normal)
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    kw = dict(save_winner=True) if normal == "analytic" else {}
    one = rk.render_rays(plan, cfg, tt, origin, dirs, **kw)
    n1, n4 = rk.render_rays.launches, shk.shade_rays.launches
    two = rk.render_rays(plan, cfg.replace(two_phase_k1=8), tt, origin,
                         dirs, **kw)
    assert rk.render_rays.launches == n1
    assert shk.shade_rays.launches == n4 + 1
    flat = lambda o: (*o[0], *o[1]) if kw else o  # noqa: E731
    _same(flat(two), flat(one), f"{scene}: two-phase fused {normal}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 700])
def test_fused_ragged_counts_on_card(cuda_device, n):
    """The fused instantiations on the first n rays alone: the full
    launch's outputs on them."""
    plan, _, tt = _fused_scene_tables("demo", cuda_device)
    cfg = ANALYTIC.replace(fused_generators=True)
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    org = origin.expand(dirs.shape).contiguous()
    full, wf = rk.render_rays(plan, cfg, tt, org, dirs, save_winner=True)
    part, wp = rk.render_rays(plan, cfg, tt, org[:n], dirs[:n],
                              save_winner=True)
    _same((*part, *wp), tuple(v[:n] for v in (*full, *wf)), f"K1 on {n}")
    m = mk.march_rays(plan, cfg, tt, org, dirs)
    _same(mk.march_rays(plan, cfg, tt, org[:n], dirs[:n]),
          tuple(v[:n] for v in m), f"K3 on {n}")
    _same(shk.shade_rays(plan, cfg, tt, full.p[:n], full.sd[:n], dirs[:n]),
          (full.cidx[:n], full.light[:n], full.smask[:n]), f"K4 on {n}")
    for mode in sk.MODES:
        k = sk.surface_eval(plan, tt, full.p, mode=mode, fd_h=CFG.fd_h,
                            fused=True)
        _same(sk.surface_eval(plan, tt, full.p[:n], mode=mode, fd_h=CFG.fd_h,
                              fused=True),
              tuple(None if v is None else v[:n] for v in k),
              f"K2 mode {mode} on {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("normal,save", [("fd", True), ("analytic", True),
                                         ("analytic", False)])
def test_fused_gradients_on_card_match_cpu(cuda_device, monkeypatch, normal,
                                           save):
    """The fused step on the card against the CPU twins on the same rays
    (tests/test_mega.py:62's tolerance): with analytic normals one K1
    launch and no K2 launch with the residuals, one K2 launch without;
    with FD normals one K1 launch (the backward is autograd through
    scene_sd_fused)."""
    from raymarching_tpu_torch.ops import render_op
    monkeypatch.setattr(render_op, "SAVE_WINNER", save)
    plan, tables, _ = _fused_scene_tables("demo", "cpu")
    cfg = CFG.replace(fused_generators=True, normal_mode=normal)
    origin, dirs = cam.generate_rays(tables_to_torch(tables, "cpu"), cfg)
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        tt = tables_to_torch(tables, device,
                             requires_grad=SceneTables._fields)
        o = origin.to(device).requires_grad_()
        d = dirs.reshape(-1, 3).to(device).requires_grad_()
        k1, k2 = rk.render_rays.launches, sk.surface_eval.launches
        colors = FusedRender.apply(plan, cfg, o, d, *tt)
        g = torch.autograd.grad(torch.mean((colors - 0.25) ** 2), [*tt, o, d],
                                allow_unused=True, materialize_grads=True)
        launched = (rk.render_rays.launches - k1,
                    sk.surface_eval.launches - k2)
        want = (1, 0) if save or normal == "fd" else (1, 1)
        assert launched == (want if device.type == "cuda" else (0, 0))
        grads.append([v.cpu() for v in g])
    for name, a, b in zip(SceneTables._fields + ("origin", "dirs"), *grads):
        assert bool(torch.isfinite(a).all()), name
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic"])
def test_multi_backend_matches_fused_generators_on_card(cuda_device, normal):
    """The multi-kernel frame and gradients on the fused field against the
    fused backend's."""
    plan, tables, _ = _fused_scene_tables("demo", "cpu")
    cfg = CFG.replace(fused_generators=True, normal_mode=normal,
                      shade_skip_black=False)
    imgs, grads = {}, {}
    for backend in ("cuda", "multi"):
        tt = tables_to_torch(tables, cuda_device,
                             requires_grad=SceneTables._fields)
        img = rt.render_tables(plan, tt, cfg, backend=backend,
                               differentiable=True, device=cuda_device)
        grads[backend] = torch.autograd.grad(
            torch.mean((img - 0.25) ** 2), list(tt), allow_unused=True,
            materialize_grads=True)
        imgs[backend] = img.detach()
    torch.testing.assert_close(imgs["multi"], imgs["cuda"], rtol=0,
                               atol=1e-6)
    for name, a, b in zip(SceneTables._fields, grads["multi"],
                          grads["cuda"]):
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


# the shading extensions: (scene, configuration change) of the extended
# entries' cases; mirror.txt has coloured lights, a Menger sponge and a
# DeathStar
EXT_CASES = {
    "demo-soft-ao": ("demo", dict(soft_shadow_k=6.0, ao_strength=0.8)),
    "demo-soft": ("demo", dict(soft_shadow_k=6.0)),
    "config4-ao": ("config4", dict(ao_strength=0.8)),
    # past the 256 taps the entries once held in their launch parameters
    "config4-ao300": ("config4", dict(ao_strength=0.8, ao_samples=300)),
    "mirror-coloured": ("mirror", dict()),
    "mirror-coloured-soft-ao": ("mirror", dict(soft_shadow_k=6.0,
                                               ao_strength=0.8)),
}


def _flat(out):
    """A render's outputs and extras (Winner, Factors, a tuple of
    BounceOutputs) as one tuple."""
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return tuple(v for part in out for v in _flat(part))
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("case", sorted(EXT_CASES))
def test_extended_kernels_match_twins_on_card(cuda_device, monkeypatch, case,
                                              placement, normal, fused):
    """K1's and K4's extended entries (soft shadows, AO, coloured lights)
    against their twins bitwise on every output, the light term, the
    factors and the winner residuals included; K4 and K3 + K4 against K1;
    the scene in shared and in device memory."""
    from raymarching_tpu_torch import tables as scene_tables
    if placement == "device":
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    scene, change = EXT_CASES[case]
    plan, tables = compile_scene(load_scene(str(SCENES / f"{scene}.txt")))
    if fused and not any(g.fused is not None for g in plan.kernel.groups):
        pytest.skip("no generator to fuse")
    cfg = CFG.replace(normal_mode=normal, fused_generators=fused, **change)
    assert shk.extended(plan, cfg)
    tt = tables_to_torch(tables, cuda_device)
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    sw = normal == "analytic"
    n1 = rk.render_rays.entry_launches["render_ext_kernel"]
    k1 = rk.render_rays(plan, cfg, tt, origin, dirs, save_winner=sw,
                        save_factors=True)
    torch.cuda.synchronize()
    assert rk.render_rays.entry_launches["render_ext_kernel"] == n1 + 1
    _same(_flat(k1), _flat(rk.render_rays_plain(
        plan, cfg, tt, origin, dirs, save_winner=sw, save_factors=True)),
        f"{case}: K1 extended")
    n4 = shk.shade_rays.entry_launches["shade_ext_kernel"]
    k4 = shk.shade_rays(plan, cfg, tt, k1[0].p, k1[0].sd, dirs,
                        save_winner=sw, save_factors=True)
    torch.cuda.synchronize()
    assert shk.shade_rays.entry_launches["shade_ext_kernel"] == n4 + 1
    _same(_flat(k4), _flat(shk.shade_rays_plain(
        plan, cfg, tt, k1[0].p, k1[0].sd, dirs, save_winner=sw,
        save_factors=True)), f"{case}: K4 extended")
    _same(_flat(k4), (k1[0].cidx, k1[0].light, k1[0].smask,
                      *_flat(k1[1:])), f"{case}: K4 vs K1")
    two = rk.render_rays(plan, cfg.replace(two_phase_k1=8), tt, origin,
                         dirs, save_winner=sw, save_factors=True)
    _same(_flat(two), _flat(k1), f"{case}: K3 + K4 vs K1")


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("case", ["reference", "demo-soft-ao",
                                  "mirror-coloured-soft-ao", "config4-ao300"])
def test_raygen_entry_matches_k1_on_twin_directions_on_card(cuda_device,
                                                            case, normal):
    """K1's raygen entries (reference and extended shading) against K1 on
    the raygen twin's directions and against their own twin, bitwise, on a
    whole frame and on a chunk of it."""
    scene, change = EXT_CASES.get(case, ("demo", {}))
    plan, tables = compile_scene(load_scene(str(SCENES / f"{scene}.txt")))
    cfg = CFG.replace(normal_mode=normal, ssaa=2, **change)
    tt = tables_to_torch(tables, cuda_device)
    R = cfg.rays_per_image
    sw = normal == "analytic"
    n = rk.render_raygen.launches
    g = rk.render_raygen(plan, cfg, tt, 0, R, save_winner=sw,
                         save_factors=True)
    torch.cuda.synchronize()
    assert rk.render_raygen.launches == n + 1
    dirs = cam.raygen_dirs(cam.serve_cam_rows(tt, cfg), cfg, 0, R)
    _same(_flat(g), _flat(rk.render_rays(plan, cfg, tt, tt.cam_position,
                                         dirs, save_winner=sw,
                                         save_factors=True)),
          f"{case}: raygen vs K1")
    _same(_flat(g), _flat(rk.render_raygen_plain(
        plan, cfg, tt, 0, R, save_winner=sw, save_factors=True)),
        f"{case}: raygen vs twin")
    part = rk.render_raygen(plan, cfg, tt, 1001, 333)
    _same(tuple(part), tuple(v[1001:1334] for v in g[0]), f"{case}: chunk")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["demo-soft-ao", "mirror-coloured"])
@pytest.mark.parametrize("normal,fused", [("fd", False), ("analytic", False),
                                          ("analytic", True)])
def test_extended_gradients_on_card_match_cpu(cuda_device, case, normal,
                                              fused):
    """The differentiable render with the extensions on the card against
    the CPU twins on the same rays, every field (light_color included),
    tests/test_mega.py:62's tolerance; one K1 launch, and one K2 launch
    only in the exact FD backward."""
    scene, change = EXT_CASES[case]
    plan, tables = compile_scene(load_scene(str(SCENES / f"{scene}.txt")))
    cfg = CFG.replace(normal_mode=normal, fused_generators=fused, **change)
    origin, dirs = cam.generate_rays(tables_to_torch(tables, "cpu"), cfg)
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        tt = tables_to_torch(tables, device,
                             requires_grad=SceneTables._fields)
        o = origin.to(device).requires_grad_()
        d = dirs.reshape(-1, 3).to(device).requires_grad_()
        k1, k2 = rk.render_rays.launches, sk.surface_eval.launches
        colors = FusedRender.apply(plan, cfg, o, d, *tt)
        g = torch.autograd.grad(torch.mean((colors - 0.25) ** 2), [*tt, o, d],
                                allow_unused=True, materialize_grads=True)
        if device.type == "cuda":
            assert (rk.render_rays.launches - k1,
                    sk.surface_eval.launches - k2) == (
                        1, 1 if normal == "fd" else 0)
        grads.append([v.cpu() for v in g])
    for name, a, b in zip(SceneTables._fields + ("origin", "dirs"), *grads):
        assert bool(torch.isfinite(a).all()), name
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


# mirror bounces: (scene, configuration change) of the bounce entries'
# cases; mirror.txt has coloured lights
BOUNCE_CASES = {
    "demo": ("demo", dict()),
    "demo-soft-ao": ("demo", dict(soft_shadow_k=6.0, ao_strength=0.8)),
    "config4": ("config4", dict()),
    "menger4": ("menger4", dict()),
    "mirror-soft-ao": ("mirror", dict(soft_shadow_k=6.0, ao_strength=0.8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [1, 2, 3])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("case", sorted(BOUNCE_CASES))
def test_bounce_entry_matches_twin_on_card(cuda_device, case, normal, fused,
                                           bounces):
    """K1's bounce entry (csrc/render_bounce_kernel.cu) against its twin
    bitwise on every output of every shade set, one launch; with per-ray
    origins and on the first 37 rays the full launch's outputs."""
    scene, change = BOUNCE_CASES[case]
    plan, tables = compile_scene(load_scene(str(SCENES / f"{scene}.txt")))
    if fused and not any(g.fused is not None for g in plan.kernel.groups):
        pytest.skip("no generator to fuse")
    cfg = CFG.replace(normal_mode=normal, fused_generators=fused,
                      reflect_strength=0.4, reflect_bounces=bounces,
                      **change)
    tt = tables_to_torch(tables, cuda_device)
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    n = rk.render_rays.entry_launches["render_bounce_kernel"]
    k = rk.render_rays(plan, cfg, tt, origin, dirs, save_factors=True)
    torch.cuda.synchronize()
    assert rk.render_rays.entry_launches["render_bounce_kernel"] == n + 1
    assert len(k[-1]) == bounces
    flat = _flat(k)
    _same(flat, _flat(rk.render_rays_plain(
        plan, cfg, tt, origin, dirs, save_factors=True)), f"{case}: twin")
    per_ray = rk.render_rays(plan, cfg, tt,
                             origin.expand(dirs.shape).contiguous(), dirs,
                             save_factors=True)
    _same(_flat(per_ray), flat, f"{case}: per-ray origins")
    R = dirs.shape[0]
    part = _flat(rk.render_rays(plan, cfg, tt, origin, dirs[:37],
                                        save_factors=True))
    _same(part, tuple(None if v is None else
                      v[:, :37] if v.dim() == 2 and v.shape[1] == R
                      and v.shape[0] != R else v[:37] for v in flat),
          f"{case}: 37 rays")


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic"])
def test_raygen_bounce_entry_matches_twin_on_card(cuda_device, normal):
    """K1's raygen bounce entry against its twin and against the bounce
    entry on the twin's directions, bitwise, on a frame and a chunk."""
    plan, tables = compile_scene(load_scene(str(SCENES / "mirror.txt")))
    cfg = CFG.replace(normal_mode=normal, ssaa=2, reflect_strength=0.4,
                      reflect_bounces=2, soft_shadow_k=6.0)
    tt = tables_to_torch(tables, cuda_device)
    R = cfg.rays_per_image
    n = rk.render_raygen.entry_launches["render_bounce_kernel"]
    g = _flat(rk.render_raygen(plan, cfg, tt, 0, R,
                                       save_factors=True))
    torch.cuda.synchronize()
    assert rk.render_raygen.entry_launches["render_bounce_kernel"] == n + 1
    _same(g, _flat(rk.render_raygen_plain(plan, cfg, tt, 0, R,
                                                  save_factors=True)),
          "raygen bounce vs twin")
    dirs = cam.raygen_dirs(cam.serve_cam_rows(tt, cfg), cfg, 0, R)
    _same(g, _flat(rk.render_rays(plan, cfg, tt, tt.cam_position,
                                          dirs, save_factors=True)),
          "raygen bounce vs the bounce entry")
    part = _flat(rk.render_raygen(plan, cfg, tt, 1001, 333,
                                          save_factors=True))
    _same(part, tuple(None if v is None else
                      v[:, 1001:1334] if v.dim() == 2 and v.shape[1] == R
                      and v.shape[0] != R else v[1001:1334] for v in g),
          "raygen bounce chunk")


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [1, 2])
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("scene", ["demo", "mirror"])
def test_reflect_gradients_on_card_match_cpu(cuda_device, scene, normal,
                                             bounces):
    """The reflect backward (the anchored replay of the bounce chain, no
    kernel launch) on the card against the CPU twins on the same rays,
    every field and the rays, with the lens's per-ray origins;
    tests/test_mega.py:62's tolerance; one K1 bounce launch, no K2."""
    plan, tables = compile_scene(load_scene(str(SCENES / f"{scene}.txt")))
    cfg = CFG.replace(normal_mode=normal, reflect_strength=0.4,
                      reflect_bounces=bounces, ssaa=2, aperture=0.2,
                      focus_dist=8.0)
    origin, dirs = cam.generate_rays_dof(tables_to_torch(tables, "cpu"), cfg)
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        tt = tables_to_torch(tables, device,
                             requires_grad=SceneTables._fields)
        o = origin.reshape(-1, 3).to(device).requires_grad_()
        d = dirs.reshape(-1, 3).to(device).requires_grad_()
        k1, k2 = (rk.render_rays.entry_launches["render_bounce_kernel"],
                  sk.surface_eval.launches)
        colors = FusedRender.apply(plan, cfg, o, d, *tt)
        g = torch.autograd.grad(torch.mean((colors - 0.25) ** 2), [*tt, o, d],
                                allow_unused=True, materialize_grads=True)
        if device.type == "cuda":
            assert (rk.render_rays.entry_launches["render_bounce_kernel"]
                    - k1, sk.surface_eval.launches - k2) == (1, 0)
        grads.append([v.cpu() for v in g])
    for name, a, b in zip(SceneTables._fields + ("origin", "dirs"), *grads):
        assert bool(torch.isfinite(a).all()), name
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "multi"])
def test_dof_and_bounces_render_on_card(cuda_device, backend):
    """A thin-lens frame with two bounces on the card against the CPU
    twins' frame (the same backend), tests/test_reflections.py:79's 2e-3."""
    scene = load_scene(str(SCENES / "mirror.txt"))
    cfg = CFG.replace(ssaa=2, reflect_strength=0.4, reflect_bounces=2,
                      aperture=0.2, focus_dist=8.0)
    card = rt.render(scene, cfg, backend=backend, device=cuda_device)
    cpu = rt.render(scene, cfg, backend=backend, device="cpu")
    torch.testing.assert_close(card.cpu(), cpu, rtol=0.0, atol=2e-3)


# procedural fractal leaves: scenes/mandelbox.txt, mandelbulb.txt and
# julia.txt, and julia.txt with a Menger sponge beside it (the fused
# generator packing with procedural runs)
FRACTAL_SPONGE = "fractal-sponge"
FRACTAL_SCENES = ("mandelbox", "mandelbulb", "julia", FRACTAL_SPONGE)


def _fractal(scene, device):
    text = (SCENES / f"{'julia' if scene == FRACTAL_SPONGE else scene}.txt"
            ).read_text()
    if scene == FRACTAL_SPONGE:
        text += "\nColor 0.8 0.8 0.8\nMengerSponge 2.2 -0.8 -6.5 1.6 2\n"
    plan, tables = compile_scene(parse_scene(text))
    assert plan.proc
    return plan, tables, tables_to_torch(tables, device)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("scene", FRACTAL_SCENES)
def test_fractal_kernels_match_twins_on_card(cuda_device, monkeypatch, scene,
                                             normal, fused, placement):
    """The procedural views of all four kernels (csrc/proc.cuh through
    fold.cuh's Proc<S>) against their twins, bitwise: K1 (with per-ray
    origins, and with the winner residuals of the analytic normal), K3
    with steps, K4, K3 + K4, K2's five modes at K1's hits and its stencil
    entry; the scene staged in shared memory and read from device
    memory."""
    from raymarching_tpu_torch import tables as scene_tables
    if placement == "device":
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    plan, _, tt = _fractal(scene, cuda_device)
    if fused and not any(g.fused is not None for g in plan.kernel.groups):
        pytest.skip("no generator to fuse")
    assert scene_tables.scene_operands(plan, tt, cuda_device, True,
                                       fused).args()[-1] == 2 + int(fused)
    cfg = CFG.replace(normal_mode=normal, fused_generators=fused)
    sw = normal == "analytic"
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    n1 = rk.render_rays.launches
    k1 = rk.render_rays(plan, cfg, tt, origin, dirs, save_winner=sw)
    torch.cuda.synchronize()
    assert rk.render_rays.launches == n1 + 1
    _same(_flat(k1), _flat(rk.render_rays_plain(plan, cfg, tt, origin, dirs,
                                                save_winner=sw)),
          f"{scene}: K1")
    _same(_flat(rk.render_rays(plan, cfg, tt,
                               origin.expand(dirs.shape).contiguous(), dirs,
                               save_winner=sw)), _flat(k1),
          f"{scene}: K1 per-ray origins")
    ray = k1[0] if sw else k1
    assert ray.done.any() and (ray.cidx >= 0).any()
    res, steps = mk.march_rays(plan, cfg, tt, origin, dirs, with_steps=True)
    res_p, steps_p = mk.march_rays_plain(plan, cfg, tt, origin, dirs,
                                         with_steps=True)
    _same((*res, steps), (*res_p, steps_p), f"{scene}: K3")
    _same(res, (ray.p, ray.sd, ray.done), f"{scene}: K3 vs K1")
    k4 = shk.shade_rays(plan, cfg, tt, ray.p, ray.sd, dirs, save_winner=sw)
    _same(_flat(k4), _flat(shk.shade_rays_plain(plan, cfg, tt, ray.p, ray.sd,
                                                dirs, save_winner=sw)),
          f"{scene}: K4")
    _same(_flat(k4), _flat(k1)[3:], f"{scene}: K4 vs K1")
    _same(_flat(rk.render_rays(plan, cfg.replace(two_phase_k1=8), tt, origin,
                               dirs, save_winner=sw)), _flat(k1),
          f"{scene}: K3 + K4 vs K1")
    for mode in (sk.COMBINED, sk.SD, sk.WINNER, sk.FD_GRAD, sk.ANALYTIC):
        n2 = sk.surface_eval.launches
        k2 = sk.surface_eval(plan, tt, ray.p, mode=mode, fd_h=cfg.fd_h,
                             fused=fused)
        torch.cuda.synchronize()
        assert sk.surface_eval.launches == n2 + 1
        _same(k2, sk.surface_eval_plain(plan, tt, ray.p, mode=mode,
                                        fd_h=cfg.fd_h, fused=fused),
              f"{scene}: K2 mode {mode}")
    if sw:
        _same(sk.surface_eval(plan, tt, ray.p, fused=fused), k1[1],
              f"{scene}: K2 combined vs K1's residuals")
    if not fused:
        for center in (True, False):
            _same(scene_vjp.stencil_eval(plan, cfg, tt, ray.p, center=center),
                  sk.surface_stencil_plain(plan, tt, ray.p, cfg.fd_h,
                                           center=center),
                  f"{scene}: K2 stencil entry")


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("scene", ["mandelbulb", "julia", FRACTAL_SPONGE])
def test_fractal_extended_raygen_and_bounce_entries_on_card(cuda_device,
                                                            scene, normal):
    """K1's and K4's extended entries (soft shadows and AO), K1's raygen
    entries and its bounce entries (one bounce, with and without the
    extensions; the raygen form) on fractal scenes against their twins,
    bitwise on every output."""
    plan, _, tt = _fractal(scene, cuda_device)
    fused = scene == FRACTAL_SPONGE
    sw = normal == "analytic"
    cfg = CFG.replace(normal_mode=normal, fused_generators=fused)
    soft = cfg.replace(soft_shadow_k=6.0, ao_strength=0.8)
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    n = dict(rk.render_rays.entry_launches)
    k1 = rk.render_rays(plan, soft, tt, origin, dirs, save_winner=sw,
                        save_factors=True)
    _same(_flat(k1), _flat(rk.render_rays_plain(
        plan, soft, tt, origin, dirs, save_winner=sw, save_factors=True)),
        f"{scene}: K1 extended")
    k4 = shk.shade_rays(plan, soft, tt, k1[0].p, k1[0].sd, dirs,
                        save_winner=sw, save_factors=True)
    _same(_flat(k4), _flat(shk.shade_rays_plain(
        plan, soft, tt, k1[0].p, k1[0].sd, dirs, save_winner=sw,
        save_factors=True)), f"{scene}: K4 extended")
    for c in (cfg, soft):
        R = c.rays_per_image
        g = rk.render_raygen(plan, c, tt, 0, R, save_factors=True)
        _same(_flat(g), _flat(rk.render_raygen_plain(plan, c, tt, 0, R,
                                                     save_factors=True)),
              f"{scene}: K1 raygen")
        b = c.replace(reflect_strength=0.4, reflect_bounces=1)
        kb = rk.render_rays(plan, b, tt, origin, dirs, save_factors=True)
        _same(_flat(kb), _flat(rk.render_rays_plain(plan, b, tt, origin,
                                                    dirs, save_factors=True)),
              f"{scene}: K1 bounce")
        gb = rk.render_raygen(plan, b, tt, 0, R, save_factors=True)
        _same(_flat(gb), _flat(rk.render_raygen_plain(plan, b, tt, 0, R,
                                                      save_factors=True)),
              f"{scene}: K1 raygen bounce")
    torch.cuda.synchronize()
    got = {k: rk.render_rays.entry_launches[k] - n[k] for k in n}
    assert got == {"render_kernel": 0, "render_ext_kernel": 1,
                   "render_bounce_kernel": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("normal,fused", [("fd", False), ("analytic", False),
                                          ("fd", True), ("analytic", True)])
def test_fractal_gradients_on_card_match_cpu(cuda_device, normal, fused):
    """The differentiable render of julia.txt (with the sponge when fused)
    on the card against the CPU twins on the same rays, every field, at
    tests/test_mega.py:62's tolerance: the exact FD backward launches K2's
    stencil entry (the scatter's size columns), the exact analytic one
    K2's combined mode once (the replay of the normal), the fused ones no
    K2."""
    scene = FRACTAL_SPONGE if fused else "julia"
    plan, tables, _ = _fractal(scene, "cpu")
    cfg = CFG.replace(normal_mode=normal, fused_generators=fused)
    origin, dirs = cam.generate_rays(tables_to_torch(tables, "cpu"), cfg)
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        tt = tables_to_torch(tables, device,
                             requires_grad=SceneTables._fields)
        o = origin.to(device).requires_grad_()
        d = dirs.reshape(-1, 3).to(device).requires_grad_()
        k1, k2 = rk.render_rays.launches, sk.surface_eval.launches
        colors = FusedRender.apply(plan, cfg, o, d, *tt)
        g = torch.autograd.grad(torch.mean((colors - 0.25) ** 2), [*tt, o, d],
                                allow_unused=True, materialize_grads=True)
        if device.type == "cuda":
            assert (rk.render_rays.launches - k1,
                    sk.surface_eval.launches - k2) == (1, 0 if fused else 1)
        grads.append([v.cpu() for v in g])
    (leaf, *_), = plan.proc
    for name, a, b in zip(SceneTables._fields + ("origin", "dirs"), *grads):
        assert bool(torch.isfinite(a).all()), name
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)
        if name in ("prim_pos", "prim_aux"):
            assert a[leaf].abs().max() > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic"])
def test_fractal_multi_backend_on_card(cuda_device, normal):
    """scenes/mandelbox.txt through the multi-kernel backend (K3, K2 and
    the hooks) against the fused backend, and its gradients (MarchOp's and
    NormalOp's procedural backwards) finite with a signal on the fractal."""
    plan, tables, tt = _fractal("mandelbox", cuda_device)
    cfg = CFG.replace(normal_mode=normal)
    img = rt.render_tables(plan, tt, cfg, backend="multi", device=cuda_device)
    want = rt.render_tables(plan, tt, cfg, device=cuda_device)
    assert ((img - want).abs().amax(-1) < 1e-3).double().mean() > 0.99
    g = tables_to_torch(tables, cuda_device,
                        requires_grad=("prim_pos", "prim_aux"))
    out = rt.render_tables(plan, g, cfg, backend="multi", differentiable=True,
                           device=cuda_device)
    gp, ga = torch.autograd.grad(torch.mean(out * out),
                                 (g.prim_pos, g.prim_aux))
    (leaf, *_), = plan.proc
    assert torch.isfinite(gp).all() and torch.isfinite(ga).all()
    assert gp[leaf].abs().max() > 0 and ga[leaf, 0] != 0


# deep plans (no two-level form: fold.cuh's Deep<S> view over
# tables.pack_deep's program): tests/test_fuzz.py's depth-3 tree of seed 12
# (fractal leaves in nested lists) in a lit room, the demo behind a deep
# list (every leaf unculled) and julia.txt's Julia inside an intersection;
# chains of 17 and 40 nested lists, past the fold's per-thread stack of
# tables.DEEP_LEVELS (16): the DeepSpill view
DEEP_SCENES = ("deep-fuzz", "deep-demo", "deep-julia", "deep-chain17",
               "deep-chain40")


def _deep(scene, device):
    if scene.startswith("deep-chain"):
        plan, tables = compile_tree(
            chain_tree(int(scene[len("deep-chain"):])),
            [Light((5.0, 8.0, 4.0)), Light((-6.0, 5.0, 0.0))],
            Camera(position=(0.0, 1.5, 3.0), direction=(0.0, -0.3, -1.0)))
    elif scene == "deep-fuzz":
        tree = random_scene(np.random.default_rng(1012), 3)
        plan, tables = compile_tree(
            ListNode(Mode.UNION, [bounds(60.0), tree]),
            [Light((8.0, 12.0, 10.0)), Light((-9.0, 6.0, 4.0))],
            Camera(position=(0.0, 3.0, 16.0), direction=(0.0, -0.2, -1.0),
                   fov=70.0))
    elif scene == "deep-demo":
        plan, tables = compile_scene(deep_scene(load_scene(str(
            SCENES / "demo.txt"))))
    else:
        julia = load_scene(str(SCENES / "julia.txt"))
        leaf = next(c for c in julia.tree.children if isinstance(c, Julia))
        inter = ListNode(Mode.INTERSECTION, [
            ListNode(Mode.UNION, [leaf, Sphere((0.9, 0.0, -5.0), 0.6)]),
            Box((0.0, 0.2, -5.0), (2.4, 2.0, 2.4))])
        rest = [c for c in julia.tree.children if c is not leaf]
        plan, tables = compile_scene(dataclasses.replace(julia, tree=ListNode(
            julia.tree.mode, rest + [ListNode(Mode.UNION, [inter])])))
    assert plan.kernel is None
    return plan, tables, tables_to_torch(tables, device)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("scene", DEEP_SCENES)
def test_deep_kernels_match_twins_on_card(cuda_device, monkeypatch, scene,
                                          normal, fused, placement):
    """The deep views of all four kernels (fold.cuh's Deep<S>) against
    their twins (core.sdf.kernel_fold's deep form), bitwise: K1 (with
    per-ray origins, and with the winner residuals of the analytic
    normal), K3 with steps, K4, K3 + K4, K2's five modes at K1's hits and
    its stencil entry; the scene staged in shared memory and read from
    device memory; with fused generators the same exact field."""
    from raymarching_tpu_torch import tables as scene_tables
    if placement == "device":
        monkeypatch.setattr(scene_tables, "SHARED_SCENE_BYTES", 0)
    plan, _, tt = _deep(scene, cuda_device)
    ops = scene_tables.scene_operands(plan, tt, cuda_device, True, fused)
    spill = scene_tables.spill_levels(plan) > 0
    assert spill == scene.startswith("deep-chain")
    assert ops.args()[-1] == 4 + 2 * int(bool(plan.proc)) + 8 * int(spill)
    cfg = CFG.replace(normal_mode=normal, fused_generators=fused)
    sw = normal == "analytic"
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    n1 = rk.render_rays.launches
    k1 = rk.render_rays(plan, cfg, tt, origin, dirs, save_winner=sw)
    torch.cuda.synchronize()
    assert rk.render_rays.launches == n1 + 1
    _same(_flat(k1), _flat(rk.render_rays_plain(plan, cfg, tt, origin, dirs,
                                                save_winner=sw)),
          f"{scene}: K1")
    _same(_flat(rk.render_rays(plan, cfg, tt,
                               origin.expand(dirs.shape).contiguous(), dirs,
                               save_winner=sw)), _flat(k1),
          f"{scene}: K1 per-ray origins")
    ray = k1[0] if sw else k1
    assert ray.done.any() and (ray.cidx >= 0).any()
    res, steps = mk.march_rays(plan, cfg, tt, origin, dirs, with_steps=True)
    res_p, steps_p = mk.march_rays_plain(plan, cfg, tt, origin, dirs,
                                         with_steps=True)
    _same((*res, steps), (*res_p, steps_p), f"{scene}: K3")
    _same(res, (ray.p, ray.sd, ray.done), f"{scene}: K3 vs K1")
    k4 = shk.shade_rays(plan, cfg, tt, ray.p, ray.sd, dirs, save_winner=sw)
    _same(_flat(k4), _flat(shk.shade_rays_plain(plan, cfg, tt, ray.p, ray.sd,
                                                dirs, save_winner=sw)),
          f"{scene}: K4")
    _same(_flat(k4), _flat(k1)[3:], f"{scene}: K4 vs K1")
    _same(_flat(rk.render_rays(plan, cfg.replace(two_phase_k1=8), tt, origin,
                               dirs, save_winner=sw)), _flat(k1),
          f"{scene}: K3 + K4 vs K1")
    for mode in (sk.COMBINED, sk.SD, sk.WINNER, sk.FD_GRAD, sk.ANALYTIC):
        n2 = sk.surface_eval.launches
        k2 = sk.surface_eval(plan, tt, ray.p, mode=mode, fd_h=cfg.fd_h,
                             fused=fused)
        torch.cuda.synchronize()
        assert sk.surface_eval.launches == n2 + 1
        _same(k2, sk.surface_eval_plain(plan, tt, ray.p, mode=mode,
                                        fd_h=cfg.fd_h, fused=fused),
              f"{scene}: K2 mode {mode}")
    if sw:
        _same(sk.surface_eval(plan, tt, ray.p), k1[1],
              f"{scene}: K2 combined vs K1's residuals")
    for center in (True, False):
        _same(scene_vjp.stencil_eval(plan, cfg, tt, ray.p, center=center),
              sk.surface_stencil_plain(plan, tt, ray.p, cfg.fd_h,
                                       center=center),
              f"{scene}: K2 stencil entry")
    if not fused:
        # the fused flag changes nothing of a deep plan's field
        _same(_flat(rk.render_rays(plan, cfg.replace(fused_generators=True),
                                   tt, origin, dirs, save_winner=sw)),
              _flat(k1), f"{scene}: K1 fused flag")


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("scene", ["deep-fuzz", "deep-julia",
                                   "deep-chain40"])
def test_deep_extended_raygen_and_bounce_entries_on_card(cuda_device, scene,
                                                         normal):
    """K1's and K4's extended entries (soft shadows and 40 AO taps), K1's
    raygen entries and its bounce entries on deep plans against their
    twins, bitwise on every output."""
    plan, _, tt = _deep(scene, cuda_device)
    sw = normal == "analytic"
    cfg = CFG.replace(normal_mode=normal)
    soft = cfg.replace(soft_shadow_k=6.0, ao_strength=0.8, ao_samples=40)
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    n = dict(rk.render_rays.entry_launches)
    k1 = rk.render_rays(plan, soft, tt, origin, dirs, save_winner=sw,
                        save_factors=True)
    _same(_flat(k1), _flat(rk.render_rays_plain(
        plan, soft, tt, origin, dirs, save_winner=sw, save_factors=True)),
        f"{scene}: K1 extended")
    k4 = shk.shade_rays(plan, soft, tt, k1[0].p, k1[0].sd, dirs,
                        save_winner=sw, save_factors=True)
    _same(_flat(k4), _flat(shk.shade_rays_plain(
        plan, soft, tt, k1[0].p, k1[0].sd, dirs, save_winner=sw,
        save_factors=True)), f"{scene}: K4 extended")
    for c in (cfg, soft):
        R = c.rays_per_image
        g = rk.render_raygen(plan, c, tt, 0, R, save_factors=True)
        _same(_flat(g), _flat(rk.render_raygen_plain(plan, c, tt, 0, R,
                                                     save_factors=True)),
              f"{scene}: K1 raygen")
        b = c.replace(reflect_strength=0.4, reflect_bounces=1)
        kb = rk.render_rays(plan, b, tt, origin, dirs, save_factors=True)
        _same(_flat(kb), _flat(rk.render_rays_plain(plan, b, tt, origin,
                                                    dirs, save_factors=True)),
              f"{scene}: K1 bounce")
    torch.cuda.synchronize()
    got = {k: rk.render_rays.entry_launches[k] - n[k] for k in n}
    assert got == {"render_kernel": 0, "render_ext_kernel": 1,
                   "render_bounce_kernel": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "multi"])
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("scene", ["deep-julia", "deep-demo",
                                   "deep-chain40"])
def test_deep_gradients_on_card_match_cpu(cuda_device, scene, normal,
                                          backend):
    """The differentiable render of a deep plan on the card against the
    CPU twins, every geometry and colour field, at tests/test_mega.py:62's
    tolerance: the exact FD backward launches K2's stencil entry on the
    deep view, the analytic one K2 not at all (K1's residuals; a fractal
    winner's replay launches K2's combined mode once)."""
    plan, tables, _ = _deep(scene, "cpu")
    cfg = CFG.replace(normal_mode=normal)
    fields = ("prim_pos", "prim_aux", "prim_color", "light_pos")
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        tt = tables_to_torch(tables, device, requires_grad=fields)
        img = rt.render_tables(plan, tt, cfg, backend=backend,
                               differentiable=True, device=device)
        g = torch.autograd.grad(torch.mean((img - 0.25) ** 2),
                                [getattr(tt, f) for f in fields],
                                materialize_grads=True)
        grads.append([v.cpu() for v in g])
    for name, a, b in zip(fields, *grads):
        assert bool(torch.isfinite(a).all()) and a.abs().max() > 0, name
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.005 * scale,
                                   msg=name)


@pytest.mark.cuda
def test_fit_step_spans_on_card(cuda_device, tmp_path):
    """A profiled fit step on the card: ``rt.scene_operands`` inside
    ``rt.k1`` on the main thread, and the fused backward's
    ``rt.bwd.replay`` and ``rt.bwd.scatter`` inside ``rt.bwd`` on
    autograd's device thread, within ``rt.fit.backward``'s time: the
    profiler's state reaches that thread, so ``timing.span`` records
    there."""
    from torch.profiler import ProfilerActivity, profile
    plan, tables = compile_scene(load_scene(str(SCENES / "demo.txt")))
    target = torch.zeros((CFG.height, CFG.width, 3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.fit(plan, tables, target, CFG, device=cuda_device, steps=1)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    by = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("rt."):
            by.setdefault(e["name"], []).append(e)

    def inside(a, b):
        return (b["ts"] <= a["ts"]
                and a["ts"] + a["dur"] <= b["ts"] + b["dur"])

    def within(a, outer, same_thread=True):
        return any(inside(a, b) and (a["tid"] == b["tid"]) == same_thread
                   for b in by[outer])

    seen = {n: [(e["tid"], e["ts"], e["dur"]) for e in v]
            for n, v in by.items()}
    (step,) = by["rt.fit.step"]
    (k1,) = by["rt.k1"]
    # the forward's operands; K2's, in the backward, lie inside rt.bwd
    assert any(within(e, "rt.k1") for e in by["rt.scene_operands"]), seen
    assert k1["tid"] == step["tid"], seen
    (bwd,) = by["rt.bwd"]
    assert within(bwd, "rt.fit.backward", same_thread=False), seen
    for name in ("rt.bwd.replay", "rt.bwd.scatter"):
        (e,) = by[name]
        assert within(e, "rt.bwd") and e["tid"] != step["tid"], seen


# the parameter scatter (csrc/segment_kernel.cu): the generic entry at the
# colour and Hessian rows' 3 columns and at 7 and 9, the theta entry at 7
# and with procedural leaves 9
SEGMENT_CASES = [("generic", 3), ("generic", 7), ("generic", 9),
                 ("theta", 7), ("theta", 9)]
FIT_CFG = RenderConfig(width=512, height=512, ssaa=2, iterations=1000)


@pytest.fixture(scope="module")
def demo_step_rows():
    """The rows of the demo's fit step on the card (512x512 SSAA 2, 1000
    iterations, rays in the fit's block order): K2's stencil (sd7, widx7,
    g7) at K1's hits, the stencil points and the colour winners."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raymarching_tpu_torch.core.order import frame_blocks, to_blocked
    dev = torch.device("cuda")
    plan, tables = compile_scene(load_scene(str(SCENES / "demo.txt")))
    tt = tables_to_torch(tables, dev)
    origin, dirs = cam.generate_rays(tt, FIT_CFG)
    H, W, S = FIT_CFG.height, FIT_CFG.width, FIT_CFG.samples_per_pixel
    dirs = to_blocked(dirs.reshape(-1, 3), H, W, S,
                      *frame_blocks(FIT_CFG, H, "cuda"))
    out = rk.render_rays(plan, FIT_CFG.replace(shade_skip_black=False), tt,
                         origin, dirs)
    sd7, widx7, g7 = scene_vjp.stencil_eval(plan, FIT_CFG, tt, out.p,
                                            center=True)
    q7 = sk.stencil_points(out.p, FIT_CFG.fd_h, center=True)
    return out.cidx, sd7, widx7, g7, q7


@pytest.mark.cuda
@pytest.mark.parametrize("ids", ["random", "coherent", "negative", "empty"])
@pytest.mark.parametrize("P", [429, 12000])
@pytest.mark.parametrize("entry, C", SEGMENT_CASES)
def test_segment_kernel_matches_index_add_on_card(demo_step_rows, entry, C,
                                                  P, ids):
    """The segment kernel against float64 index_add_ (its plain twin) on
    the same float32 terms: P 429 keeps a block's sums in shared memory,
    P 12,000 (beyond 227 KB of them) adds the warps' sums straight to the
    output; ids random over [-1, P), the demo's stencil winners of a fit
    step (7,340,032 rows; the theta entry on K2's own g, sd and stencil
    points, g read through its strides), all negative, none.  Every
    float64 sum within 1e-12 of the sum of its terms' magnitudes: both
    sides' atomics add in their own order.  The demo's stencil rows merge
    more than 4 rows an add."""
    cidx, sd7, widx7, g7, q7 = demo_step_rows
    dev = widx7.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(C * P + len(ids))
    if ids == "coherent":
        idx = widx7.reshape(-1)
        assert 0 <= int(idx.max()) < 429
    else:
        R = 0 if ids == "empty" else 1 << 20
        lo, hi = (-3, 0) if ids == "negative" else (-1, P)
        idx = torch.randint(lo, hi, (R,), generator=gen, device=dev,
                            dtype=torch.int32)
    R = idx.shape[0]
    before = seg.segment_sum.launches
    if entry == "theta":
        if ids == "coherent":
            g, sd, q = g7.reshape(-1, 3), sd7.reshape(-1), q7.reshape(-1, 3)
            assert g.stride() == (1, R)      # K2's structure of arrays
        else:
            g, sd, q = (torch.randn(s, generator=gen, device=dev)
                        for s in ((R, 3), (R,), (R, 3)))
        u = torch.randn(R, generator=gen, device=dev)
        extra = (sd, q) if C == 9 else ()
        got = seg.theta_sum(idx, g, u, P, *extra)
        terms = seg.theta_terms(g, u, *extra)
    else:
        terms = torch.randn((R, C), generator=gen, device=dev)
        got = seg.segment_sum(idx, terms, P)
    torch.cuda.synchronize()
    assert seg.segment_sum.launches == before + (1 if R else 0)
    want = seg.segment_sum_plain(idx, terms, P)
    scale = seg.segment_sum_plain(idx, terms.abs(), P)
    assert got.dtype == torch.float64 and got.shape == (P, C)
    assert bool(((got - want).abs() <= 1e-12 * scale).all())
    if ids in ("negative", "empty"):
        assert not bool(got.any())
    if ids == "coherent":
        assert scene_vjp.merge_factor(idx) > 4
        assert scene_vjp.merge_factor(cidx) > 4


# backwards that end in the parameter scatter: (scene, configuration, the
# replay's rays a slice or None, segment kernel launches a backward)
SCATTER_PATHS = {
    # theta_cotangents over the 7 stencil rows; the colour rows
    "exact fd": ("demo", {}, None, 2),
    # theta_cotangents over the winner rows, the Hessian rows (3
    # columns); the colour rows
    "exact analytic": ("demo", {"normal_mode": "analytic"}, None, 3),
    # fused_theta_cotangents (9 columns), the fused Hessian rows; colours
    "fused analytic": ("demo", {"normal_mode": "analytic",
                                "fused_generators": True}, None, 3),
    # the stencil rows with the procedural columns (9); colours
    "fractal fd": ("julia", {}, None, 2),
    # _replay_bwd: theta_cotangents (9 columns) on each of 3 slices of 256
    # rays; the colour rows once
    "fractal analytic": ("julia", {"normal_mode": "analytic"}, 256, 4),
}


def _plain_scatter(monkeypatch):
    """Route scene_vjp's scatters to index_add_ on the card."""
    monkeypatch.setattr(scene_vjp, "segment_sum", seg.segment_sum_plain)
    monkeypatch.setattr(scene_vjp, "theta_sum", seg.theta_sum_plain)


def _same_scatter(got, want, names):
    for name, a, b in zip(names, got, want):
        assert bool(torch.isfinite(a).all()), name
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(SCATTER_PATHS))
def test_backwards_scatter_through_segment_kernel_on_card(cuda_device,
                                                          monkeypatch, path):
    """Each backward that ends in the parameter scatter launches the
    segment kernel for each of its scatters, and its gradients are those
    of the same backward with index_add_ on the card (the same rays and
    kernels; only the order of the float64 sums differs)."""
    scene, changes, replay, launches = SCATTER_PATHS[path]
    plan, tables = (_fractal(scene, "cpu")[:2] if scene == "julia" else
                    compile_scene(load_scene(str(SCENES / "demo.txt"))))
    cfg = CFG.replace(**changes)
    if replay:
        monkeypatch.setattr(scene_vjp, "REPLAY_RAYS", replay)
    origin, dirs = cam.generate_rays(tables_to_torch(tables, cuda_device),
                                     cfg)

    def grads():
        tt = tables_to_torch(tables, cuda_device,
                             requires_grad=SceneTables._fields)
        o = origin.clone().requires_grad_()
        d = dirs.reshape(-1, 3).clone().requires_grad_()
        colors = FusedRender.apply(plan, cfg, o, d, *tt)
        return torch.autograd.grad(torch.mean((colors - 0.25) ** 2),
                                   [*tt, o, d], allow_unused=True,
                                   materialize_grads=True)

    before = seg.segment_sum.launches
    got = grads()
    torch.cuda.synchronize()
    assert seg.segment_sum.launches - before == launches
    with monkeypatch.context() as m:
        _plain_scatter(m)
        before = seg.segment_sum.launches
        want = grads()
        assert seg.segment_sum.launches == before
    _same_scatter(got, want, SceneTables._fields + ("origin", "dirs"))
    assert got[0].abs().max() > 0 and got[2].abs().max() > 0


@pytest.mark.cuda
def test_sharded_step_scatters_through_segment_kernel_on_card(
        cuda_device, monkeypatch, tmp_path):
    """parallel/sharded's loss and gradients on a rank (world 1 over NCCL
    in this process, the whole frame its band): the rank's backward
    launches the segment kernel for its stencil and colour rows before
    the all-reduce, and the reduced gradients are those of the same step
    with index_add_."""
    import torch.distributed as dist
    from raymarching_tpu_torch.parallel import distributed as D
    from raymarching_tpu_torch.parallel import sharded
    plan, tables = compile_scene(load_scene(str(SCENES / "demo.txt")))
    target = torch.full((CFG.height, CFG.width, 3), 0.25)
    D.initialize(f"file://{tmp_path}/rendezvous", 1, 0, backend="nccl",
                 device="cuda")
    try:
        mesh = sharded.make_mesh()

        def grads():
            return sharded.loss_and_grads(plan, tables, target, CFG, mesh,
                                          backend="cuda")[1]

        before = seg.segment_sum.launches
        got = grads()
        torch.cuda.synchronize()
        assert seg.segment_sum.launches - before == 2
        with monkeypatch.context() as m:
            _plain_scatter(m)
            want = grads()
    finally:
        dist.destroy_process_group()
    _same_scatter(got, want, SceneTables._fields)

