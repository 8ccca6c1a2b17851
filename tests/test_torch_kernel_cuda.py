"""K1 on a CUDA card against its plain PyTorch twin.  Skips without a card.

Imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.config import RenderConfig  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene, parse_scene  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
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
