"""fit_scene's loss trajectory: the port's ``fit`` against the JAX
package's ``fit`` (its jnp backend, the script's CPU backend) on the
example's perturbed config3 tables, at 32x24 and 150 iterations, for 30
Adam steps at the script's learning rate.  The two losses agree step by
step, and in both the loss first rises, then falls: at lr 2e-2 the fit
oscillates, so its reduction after a given number of steps is the
script's own, not a defect of either package.  (Past about 40 steps the
two drift apart, as a rounding difference grows in that oscillation.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("optax")   # the JAX package's optimizer

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu as jrt  # noqa: E402
from raymarching_tpu.api import render_tables as jrender  # noqa: E402
from raymarching_tpu.optimize import fit as jfit  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.examples import fit_scene  # noqa: E402

STEPS = 30
SMALL = dict(width=32, height=24, ssaa=1, iterations=150, shadows=True,
             normal_mode="analytic")


def test_fit_scene_loss_follows_jax():
    plan, true, start, cfg = fit_scene.setup(rt.RenderConfig(**SMALL))
    target = rt.render_tables(plan, true, cfg, device="cpu")
    port = rt.fit(plan, start, target, cfg, device="cpu", steps=STEPS,
                  lr=fit_scene.LR, trainable=fit_scene.TRAINABLE).losses

    jplan, jtrue = jrt.compile_scene(jrt.load_scene(str(fit_scene.SCENE)))
    jcfg = jrt.RenderConfig(**SMALL)
    jstart = jtrue._replace(**{f: np.asarray(getattr(start, f))
                               for f in fit_scene.TRAINABLE})
    jtarget = jrender(jplan, jtrue, jcfg, backend="jnp")
    ref = jfit(jplan, jstart, jtarget, jcfg, steps=STEPS, lr=fit_scene.LR,
               backend="jnp", trainable=fit_scene.TRAINABLE).losses

    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape == (STEPS,)
    np.testing.assert_allclose(port, ref, rtol=1e-4)
    for losses in (port, ref):
        assert losses[:15].max() > 1.3 * losses[0]   # it rises first
        assert losses[-1] < 0.5 * losses[0]          # then falls
