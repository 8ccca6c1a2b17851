"""The four kernels on a CUDA card against their plain PyTorch twins (K1,
K2 in every mode, K3 with and without tmax and with steps, K4), the
two-phase path against the one kernel, the multi-kernel backend against
the fused one, and the differentiable render's gradients on the card
against the CPU's.  Skips without a card.

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
@pytest.mark.parametrize("mode", [sk.SD, sk.WINNER, sk.FD_GRAD])
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
