"""K1 and K2 on a CUDA card against their plain PyTorch twins, and the
differentiable render's gradients on the card against the CPU's.  Skips
without a card.

Imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.config import RenderConfig  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables, compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene, parse_scene  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
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
    q = scene_vjp.stencil_points(hits, cfg.fd_h, center=True)
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
