"""Ray-sharded rendering and fitting over ``torch.distributed`` on the CPU
(the twins of tests/test_sharding.py, test_gspmd.py and
test_multiprocess.py): real gloo process groups of two ranks
(``make_mesh``) and of four (``make_mesh_2d(2, 2)``), each spawned once
with a ``file://`` rendezvous and run to the end of its checks under a
timeout (tests/torch_shard_worker.py); the ranks write what they saw and
this process compares it with one process's renders and with the JAX
package's.

The frames are bitwise one process's on every backend (each rank's rays
are the whole frame's rows bitwise, and no ray depends on another); the
gradients meet as float32 partial sums in one all-reduce, so they agree
with one process's to reassociation."""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.api import render_tables as jax_render  # noqa: E402
from raymarching_tpu.api import render_tiled as jax_render_tiled  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import render_rays, render_tiled  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.scene.compile import SceneTables  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from test_sharding import CFG as JAX_CFG  # noqa: E402
from test_sharding import _world as jax_world  # noqa: E402
import torch_shard_worker as W  # noqa: E402

HERE = Path(__file__).resolve().parent
FIELDS = SceneTables._fields
# a whole world's spawn, every check of it included
TIMEOUT_S = 180
# against JAX's single device: tests/test_sharding.py:43 (images) and
# :64 (gradients); tests/test_multiprocess.py's tiled frame; the bundle's
# gradients, tests/test_sharding.py:232
IMG_ATOL = 2e-5
GRAD_RTOL, GRAD_ATOL_SCALE = 0.05, 0.02
TILED_ATOL = 1e-3
RAYS_RTOL, RAYS_ATOL = 1e-4, 1e-6
# the sharded step's gradients against one process's on the same path:
# the same per-ray terms, float32 partial sums (tests/test_sharding.py
# :213-215)
SUM_RTOL, SUM_ATOL_SCALE = 1e-3, 1e-5


def _spawn(tmp_path, world: int, kind: str) -> list:
    """Run ``world`` ranks of torch_shard_worker.py to the end (all within
    TIMEOUT_S, else the test fails and the ranks are killed) -> each
    rank's results."""
    init = f"file://{tmp_path}/rendezvous"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_shard_worker.py"), str(r),
         str(world), init, str(tmp_path), kind], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env) for r in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.0))
            assert p.returncode == 0, f"rank {r}:\n{out.decode()[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def single():
    """One process's results on the same world: each backend's frame, the
    JAX package's jnp frame and gradients, the fused path's gradients."""
    plan, tables = W.world()
    jplan, jtables = jax_world()
    frames = {be: rt.render_tables(plan, tables, W.CFG, backend=be,
                                   device="cpu").numpy() for be in W.BACKENDS}
    jax_frame = np.asarray(jax_render(jplan, jtables, JAX_CFG,
                                      backend="jnp"))
    zero = jnp.zeros((JAX_CFG.height, JAX_CFG.width, 3), jnp.float32)
    g = jax.grad(lambda t: jnp.mean((jax_render(
        jplan, t, JAX_CFG, backend="jnp", differentiable=True) - zero)
        ** 2))(jtables)
    jax_grads = {f: np.asarray(getattr(g, f), np.float64) for f in FIELDS}
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    img = rt.render_tables(plan, tt, W.CFG, differentiable=True, device="cpu")
    cg = torch.autograd.grad(torch.mean(img ** 2), list(tt),
                             allow_unused=True, materialize_grads=True)
    return dict(plan=plan, tables=tables, frames=frames, jax_frame=jax_frame,
                jax_grads=jax_grads,
                cuda_grads={f: v.numpy() for f, v in zip(FIELDS, cg)},
                jplan=jplan, jtables=jtables)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world2"), 2, "1d")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world4"), 4, "2x2")


@pytest.fixture(params=["two", "four"])
def ranks(request):
    return request.getfixturevalue(request.param)


@pytest.mark.parametrize("backend", W.BACKENDS)
def test_sharded_frame_is_single_process_frame(ranks, single, backend):
    """Every rank gathers the frame one process renders, bitwise, and its
    own band is its rows of it."""
    want = single["frames"][backend]
    n = len(ranks)
    rows = want.shape[0] // n
    for r, res in enumerate(ranks):
        assert res["mesh_size"] == n
        np.testing.assert_array_equal(res[f"frame_{backend}"], want)
        np.testing.assert_array_equal(res[f"band_{backend}"],
                                      want[r * rows:(r + 1) * rows])


@pytest.mark.parametrize("backend", W.BACKENDS)
def test_sharded_frame_matches_jax_single_device(ranks, single, backend):
    np.testing.assert_allclose(ranks[0][f"frame_{backend}"],
                               single["jax_frame"], rtol=0, atol=IMG_ATOL)


def test_sharded_gradients_match_jax(ranks, single):
    """The default (ref, unrolled) sharded loss's gradients, all-reduced,
    against JAX's single-device jnp gradients."""
    for field in FIELDS:
        b = single["jax_grads"][field]
        scale = max(np.abs(b).max(), 1e-8)
        for res in ranks:
            np.testing.assert_allclose(
                res[f"grad_ref_{field}"], b, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_SCALE * scale, err_msg=field)


def test_sharded_fused_gradients_match_single_process(ranks, single):
    """The fused path's sharded gradients against one process's, and the
    ranks' bitwise against each other (one all-reduce gives them all the
    same sums); the all-reduced buffer is every field, once."""
    for field in FIELDS:
        b = single["cuda_grads"][field]
        scale = max(np.abs(b).max(), 1e-8)
        for res in ranks:
            np.testing.assert_allclose(
                res[f"grad_cuda_{field}"], b, rtol=SUM_RTOL,
                atol=SUM_ATOL_SCALE * scale, err_msg=field)
            for be in ("ref", "cuda"):
                np.testing.assert_array_equal(res[f"grad_{be}_{field}"],
                                              ranks[0][f"grad_{be}_{field}"])
    nbytes = 4 * sum(np.asarray(v).size for v in single["tables"])
    assert all(res["allreduce_bytes"] == nbytes for res in ranks)
    assert all(res["loss_ref"] == ranks[0]["loss_ref"] for res in ranks)


def test_train_step_reduces_loss(ranks):
    for res in ranks:
        losses = res["train_losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]
        np.testing.assert_array_equal(losses, ranks[0]["train_losses"])


def test_uneven_rows_rejected(ranks):
    assert all(bool(res["uneven_raises"]) for res in ranks)


def test_mesh_subset(two, single):
    """A mesh over rank 0 alone renders the whole frame there; rank 1
    takes no part."""
    np.testing.assert_array_equal(two[0]["subset"], single["frames"]["ref"])
    assert bool(two[1]["subset_raises"])


def test_render_rays_sharded_odd_bundle(two, single):
    """101 rays with per-ray origins over two ranks: every rank holds the
    bundle's colours, bitwise one process's ``render_rays``, and the
    tables' gradients after the all-reduce."""
    plan, tables = single["plan"], single["tables"]
    small = W.CFG.replace(width=16, height=8)
    o, d = cam.generate_rays(tables_to_torch(tables, "cpu"), small)
    d = d.reshape(-1, 3)[:101]
    o = o.expand(d.shape).clone()
    tt = tables_to_torch(tables, "cpu", requires_grad=W.FIT_FIELDS)
    colors = render_rays(plan, tt, o, d, small, device="cpu")
    grads = torch.autograd.grad(colors.mean(),
                                [getattr(tt, f) for f in W.FIT_FIELDS])
    for res in two:
        np.testing.assert_array_equal(res["rays"], colors.detach().numpy())
        for f, g in zip(W.FIT_FIELDS, grads):
            np.testing.assert_allclose(res[f"rays_grad_{f}"], g.numpy(),
                                       rtol=RAYS_RTOL, atol=RAYS_ATOL,
                                       err_msg=f)


def test_render_tiled_multihost(two, single):
    """17 rows over two ranks (9 and 8, the short band padded for the
    gather) in blocks of 5: every rank holds the frame, bitwise
    ``render_tiled``, and within tests/test_multiprocess.py's tolerance of
    JAX's tiled frame."""
    cfg = W.CFG.replace(height=17)
    want = render_tiled(single["plan"], single["tables"], cfg, row_block=5,
                        backend="torch", device="cpu")
    jax_want = jax_render_tiled(single["jplan"], single["jtables"],
                                JAX_CFG.replace(height=17), row_block=5,
                                backend="jnp")
    for res in two:
        assert res["multihost"].shape == (17, cfg.width, 3)
        np.testing.assert_array_equal(res["multihost"], want)
        np.testing.assert_allclose(res["multihost"], jax_want, rtol=0,
                                   atol=TILED_ATOL)


def test_gather_image_and_is_primary(ranks, single):
    for r, res in enumerate(ranks):
        assert bool(res["is_primary"]) == (r == 0)
        assert res["frame_ref"].shape == single["frames"]["ref"].shape
        assert res["frame_ref"].dtype == np.float32


def test_fit_over_the_mesh(ranks, single):
    """Three Adam steps of ``fit(mesh=)``: the ranks' tables bitwise equal
    (each optimizer takes the same all-reduced gradients), and close to
    one process's ``fit`` on the same target."""
    plan, tables = single["plan"], single["tables"]
    target = rt.render_tables(plan, W.shifted(tables), W.CFG, device="cpu")
    want = rt.fit(plan, tables, target, W.CFG, device="cpu", steps=3,
                  lr=1e-2, trainable=W.FIT_FIELDS)
    for res in ranks:
        for f in W.FIT_FIELDS:
            np.testing.assert_array_equal(res[f"fit_{f}"],
                                          ranks[0][f"fit_{f}"])
            np.testing.assert_allclose(res[f"fit_{f}"],
                                       getattr(want.tables, f).numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(res["fit_losses"], want.losses,
                                   rtol=1e-5)


def test_dtensor_variant_equals_render_sharded(ranks):
    """``render_sharded_gspmd``'s DTensor: its local shard is the rank's
    band, its full tensor the gathered frame."""
    for res in ranks:
        np.testing.assert_array_equal(res["dtensor_local"], res["band_ref"])
        np.testing.assert_array_equal(res["dtensor_full"], res["frame_ref"])


def test_initialize_is_a_no_op_without_environment(monkeypatch):
    """One process and no rendezvous: no process group is formed, and the
    helpers treat the process as the only one."""
    from raymarching_tpu_torch.parallel import distributed as D
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    D.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert D.is_primary()
    band = torch.ones((2, 3, 3))
    np.testing.assert_array_equal(D.gather_image(band), band.numpy())
