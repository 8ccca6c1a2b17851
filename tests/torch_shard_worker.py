"""One rank of tests/test_torch_sharded.py's process groups: gloo on the
CPU, a ``file://`` rendezvous.  Runs every check of its world and writes
what it saw to ``<out>/rank<r>.npz`` for the test process to compare.

    python tests/torch_shard_worker.py RANK WORLD INIT_METHOD OUT MESH

MESH is "1d" (``make_mesh()`` over every rank, and the one-rank subset
mesh) or "2x2" (``make_mesh_2d(2, 2)``)."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import render_tiled_multihost  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.parallel import distributed as D  # noqa: E402
from raymarching_tpu_torch.parallel import sharded as S  # noqa: E402
from raymarching_tpu_torch.scene.compile import compile_tree  # noqa: E402
from raymarching_tpu_torch.scene.csg import (ListNode, Mode,  # noqa: E402
                                             Sphere, bounds)
from raymarching_tpu_torch.scene.objects import Camera, Light  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

BACKENDS = ("cuda", "multi", "ref", "torch")
# tests/test_sharding.py's configuration and world
CFG = rt.RenderConfig(width=32, height=16, ssaa=1, iterations=100,
                      shadows=True, normal_mode="analytic")
FIT_FIELDS = ("prim_pos", "prim_color", "light_pos")


def world():
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        Sphere((0.0, 0.0, -6.0), 2.5, color=(0.9, 0.4, 0.2)),
        Sphere((3.0, 1.0, -8.0), 1.5, color=(0.2, 0.9, 0.4)),
    ])
    return compile_tree(tree, [Light((6.0, 8.0, 4.0))],
                        Camera(position=(0, 0, 6), fov=55.0))


def shifted(tables):
    """The world with its first sphere moved +0.4 in x: the fit's
    target."""
    pos = np.array(tables.prim_pos)
    pos[1, 0] += 0.4
    return tables._replace(prim_pos=pos)


def raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def main(rank: int, world_size: int, init: str, out: str, kind: str):
    torch.set_num_threads(1)
    D.initialize(init, world_size, rank, backend="gloo", device="cpu")
    plan, tables = world()
    res = {"is_primary": D.is_primary()}
    mesh = (S.make_mesh(device_type="cpu") if kind == "1d"
            else S.make_mesh_2d(2, 2, device_type="cpu"))
    res["mesh_size"] = mesh.size()
    for be in BACKENDS:
        band = S.render_sharded(plan, tables, CFG, mesh, backend=be)
        res[f"band_{be}"] = band.numpy()
        res[f"frame_{be}"] = D.gather_image(band, mesh)
    dt = S.render_sharded_gspmd(plan, tables, CFG, mesh, backend="ref")
    res["dtensor_local"] = dt.to_local().numpy()
    res["dtensor_full"] = dt.full_tensor().numpy()
    res["uneven_raises"] = raises(lambda: S.render_sharded(
        plan, tables, CFG.replace(height=CFG.height + 1), mesh))
    zero = np.zeros((CFG.height, CFG.width, 3), np.float32)
    for be in ("ref", "cuda"):
        loss, grads = S.loss_and_grads(plan, tables, zero, CFG, mesh, be)
        res[f"loss_{be}"] = loss.item()
        for f, g in zip(grads._fields, grads):
            res[f"grad_{be}_{f}"] = g.numpy()
    res["allreduce_bytes"] = S.all_reduce_grads.bytes
    target = D.gather_image(S.render_sharded(plan, shifted(tables), CFG,
                                             mesh, backend="cuda"), mesh)
    step = S.train_step_jit(plan, CFG, mesh, lr=0.1)
    t, losses = tables, []
    for _ in range(5):
        loss, t = step(t, target)
        losses.append(loss.item())
    res["train_losses"] = np.array(losses)
    fitted = rt.fit(plan, tables, target, CFG, device="cpu", steps=3,
                    lr=1e-2, trainable=FIT_FIELDS, mesh=mesh)
    for f in FIT_FIELDS:
        res[f"fit_{f}"] = getattr(fitted.tables, f).numpy()
    res["fit_losses"] = np.array(fitted.losses)
    if kind == "1d":
        # a bundle of 101 rays with per-ray origins (not a multiple of the
        # mesh) and its gradients
        small = CFG.replace(width=16, height=8)
        o, d = cam.generate_rays(tables_to_torch(tables, "cpu"), small)
        d = d.reshape(-1, 3)[:101]
        o = o.expand(d.shape).clone()
        tt = tables_to_torch(tables, "cpu", requires_grad=FIT_FIELDS)
        colors = S.render_rays_sharded(plan, tt, o, d, small, mesh)
        res["rays"] = colors.detach().numpy()
        for f, g in zip(FIT_FIELDS, torch.autograd.grad(
                colors.mean(), [getattr(tt, f) for f in FIT_FIELDS])):
            res[f"rays_grad_{f}"] = g.numpy()
        # the frame streamed in bands of 5 rows, 17 rows over the ranks
        res["multihost"] = render_tiled_multihost(
            plan, tables, CFG.replace(height=17), row_block=5,
            backend="torch", device="cpu")
        # a mesh over rank 0 alone: it renders the whole frame, rank 1 is
        # no part of it
        sub = S.make_mesh(1, device_type="cpu")
        if rank == 0:
            res["subset"] = S.render_sharded(plan, tables, CFG, sub).numpy()
        else:
            res["subset_raises"] = raises(
                lambda: S.render_sharded(plan, tables, CFG, sub))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
