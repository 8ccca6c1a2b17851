"""The port's fused path (plain twins on the CPU) reproduces the committed
golden images of the BASELINE ladder scenes, by tests/test_golden.py's
criteria.  The demo's golden is left to the JAX suite: its 428-leaf
matrix at 128x96 SSAA 2 costs minutes on the plain path."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu.io.png import read_png  # noqa: E402

from make_goldens import GOLDENS  # noqa: E402

LADDER = [g for g in GOLDENS if g[1].startswith("config")]


@pytest.mark.parametrize("scene_file,name,cfg", LADDER,
                         ids=[g[1] for g in LADDER])
def test_port_matches_golden(scenes_dir, scene_file, name, cfg):
    golden = read_png(str(scenes_dir.parent / "tests" / "golden"
                          / f"{name}.png"))
    scene = rt.load_scene(str(scenes_dir / scene_file))
    img = rt.to_uint8(rt.render(scene, cfg, device="cpu").numpy(), cfg.gamma)
    diff = np.abs(img.astype(int) - golden[..., :3].astype(int))
    assert np.median(diff) == 0
    assert (diff > 4).mean() < 0.005, f"max diff {diff.max()}"
    assert (diff == 0).mean() > 0.95
