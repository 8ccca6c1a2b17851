"""The four kernels on a CUDA card against their plain PyTorch twins (K1,
K2 in every mode, K3 with and without tmax and with steps, K4; K1 and K4
with FD and analytic normals), the two-phase path against the one kernel,
the multi-kernel backend against the fused one, and the differentiable
render's gradients on the card against the CPU's, in both normal regimes.
Skips without a card.

Imports nothing of JAX or the JAX package, so it also runs where neither
is installed:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.config import RenderConfig  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.core.march import dot3  # noqa: E402
from raymarching_tpu_torch.core.shading import normalize  # noqa: E402
from raymarching_tpu_torch.ops import march_kernel as mk  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.ops import shade_kernel as shk  # noqa: E402
from raymarching_tpu_torch.scene.compile import (SceneTables,  # noqa: E402
                                                 compile_scene)
from raymarching_tpu_torch.scene.parser import (load_scene,  # noqa: E402
                                                parse_scene)
from raymarching_tpu_torch.ops.render_op import FusedRender  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp  # noqa: E402
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
