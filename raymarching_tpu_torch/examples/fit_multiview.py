"""Multi-view inverse rendering through ONE batched ray stream.

The production fitting workflow ``api.render_rays`` exists for: F posed
captures of a scene, jointly fit the scene parameters against ALL views at
once.  Every view's rays (each with its own origin) ride a single chunked
K1 stream, so the joint loss costs one kernel launch per optimizer step
instead of F — and its gradient flows through the per-ray implicit-function
backward with per-ray origin cotangents.

With ``--fit-poses`` the problem inverts: the scene is KNOWN and the
camera positions are the unknowns (camera localization / the pose half of
bundle adjustment).  Rays are generated differentiably from the pose
parameters, so the loss gradient flows through the look-at construction
and into ``render_rays``'s origin/direction cotangents.

The port of the JAX repo's ``examples/fit_multiview.py``, with
``torch.optim.Adam`` (optax's rate, betas and eps) in place of
``optax.adam``:

    python -m raymarching_tpu_torch.examples.fit_multiview [--views 4]
        [--steps 120] [--device cuda]
    python -m raymarching_tpu_torch.examples.fit_multiview --fit-poses
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..api import render_rays
from ..config import RenderConfig
from ..core import camera as cam
from ..scene.compile import SceneTables, compile_scene
from ..scene.parser import parse_scene
from ..tables import tables_to_torch

SCENE = """
Bounds 60
Light 6 10 4
Color 0.9 0.2 0.1
Sphere 0 0 -6 1.6
Color 0.2 0.8 0.3
Sphere 2.2 -0.4 -7 1.0
Color 0.9 0.9 0.9
Box 0 -2.2 -6 8 0.4 8
"""
# the views' arc: F cameras at this distance from CENTER, all looking at it
CENTER = np.array([0.5, -0.5, -6.0], np.float32)
RADIUS = 9.0
# optax.adam's defaults
BETAS, EPS = (0.9, 0.999), 1e-8


def setup(cfg: RenderConfig | None = None):
    """(plan, tables_true, tables0, cfg): the three-object scene, the same
    tables with the red sphere moved and shrunk, and the script's 64x48
    analytic frame with one K1 launch for all four views (or ``cfg``)."""
    plan, tables_true = compile_scene(parse_scene(SCENE))
    cfg = cfg or RenderConfig(width=64, height=48, ssaa=1, iterations=250,
                              normal_mode="analytic", ray_chunk=65536)
    # perturb the red sphere's position and radius, then fit them back
    pp = np.array(tables_true.prim_pos)
    aux = np.array(tables_true.prim_aux)
    pp[1] += np.array([0.7, -0.4, 0.5], np.float32)
    aux[1, 0] *= 0.7
    tables0 = tables_true._replace(prim_pos=pp, prim_aux=aux)
    return plan, tables_true, tables0, cfg


def view_positions(views: int) -> np.ndarray:
    """[F, 3] float32 camera positions on an arc around CENTER."""
    phis = np.linspace(-0.7, 0.7, views)
    return np.stack([CENTER + RADIUS * np.array(
        [np.sin(p), 0.25, np.cos(p)], np.float32) for p in phis])


def perturbed_poses(poses_true: np.ndarray) -> np.ndarray:
    """The camera positions the pose fit starts from (seed 7)."""
    rng = np.random.default_rng(7)
    return poses_true + rng.normal(scale=0.35, size=poses_true.shape).astype(
        np.float32)


def camera_rays(tables: SceneTables, cfg: RenderConfig, position, look_at):
    """Rays for one posed view -> (origins [R,3], dirs [R,3]) on the
    device of ``tables`` (tensors)."""
    pos = np.asarray(position, np.float32)
    look = np.asarray(look_at, np.float32) - pos
    look = look / np.linalg.norm(look)
    f32 = dict(dtype=torch.float32, device=tables.cam_up.device)
    t = tables._replace(cam_position=torch.as_tensor(pos, **f32),
                        cam_direction=torch.as_tensor(look, **f32))
    o, d = cam.generate_rays(t, cfg)
    flat = d.reshape(-1, 3)
    return o.expand(flat.shape), flat


def bundle(tables: SceneTables, cfg: RenderConfig, center: torch.Tensor,
           poses: torch.Tensor):
    """(origins, dirs) of every view, rebuilt from the ``poses`` [F, 3]
    tensor: differentiable through the look-at normalization and the
    camera grid."""
    R = cfg.height * cfg.width * cfg.samples_per_pixel
    os_, ds = [], []
    for i in range(poses.shape[0]):
        look = center - poses[i]
        look = look / torch.linalg.norm(look)
        t = tables._replace(cam_position=poses[i], cam_direction=look)
        o, d = cam.generate_rays(t, cfg)
        os_.append(o.expand(R, 3))
        ds.append(d.reshape(R, 3))
    return torch.cat(os_), torch.cat(ds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--fit-poses", action="store_true",
                    help="hold the scene fixed and recover perturbed "
                         "camera positions instead (pose gradients flow "
                         "through the differentiable look-at + the "
                         "origin/direction cotangents of render_rays)")
    args = ap.parse_args(argv)

    plan, tables_true, tables0, cfg = setup()
    dev = torch.device(args.device)
    t_true = tables_to_torch(tables_true, dev)
    poses_true = view_positions(args.views)
    bundles = [camera_rays(t_true, cfg, p, CENTER) for p in poses_true]
    origins = torch.cat([b[0] for b in bundles])
    dirs = torch.cat([b[1] for b in bundles])

    with torch.no_grad():
        targets = render_rays(plan, t_true, origins, dirs, cfg, device=dev)

    if args.fit_poses:
        return fit_poses(args, plan, t_true, cfg, targets, poses_true)

    # Adam over every float field of the tables, as optax.adam over the
    # whole NamedTuple: a field with no gradient is not moved
    tables = tables_to_torch(tables0, dev, requires_grad=SceneTables._fields)
    opt = torch.optim.Adam(list(tables), lr=args.lr, betas=BETAS, eps=EPS)

    def loss_fn():
        pred = render_rays(plan, tables, origins, dirs, cfg, device=dev)
        return torch.mean((pred - targets) ** 2)

    def pos_err():
        return float(np.linalg.norm(tables.prim_pos[1].detach().cpu().numpy()
                                    - tables_true.prim_pos[1]))

    err0 = pos_err()
    for i in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  joint-loss {loss.item():.3e}  "
                  f"pos-err {pos_err():.4f}", flush=True)
    err = pos_err()
    print(f"position error {err0:.3f} -> {err:.3f}; "
          f"radius {float(tables0.prim_aux[1, 0]):.3f} -> "
          f"{tables.prim_aux[1, 0].item():.3f} "
          f"(true {float(tables_true.prim_aux[1, 0]):.3f})")
    assert err < 0.5 * err0, "multi-view fit failed to converge"
    print("ok")
    return 0


def fit_poses(args, plan, tables, cfg, targets, poses_true) -> int:
    """Camera localization: recover perturbed camera POSITIONS from the
    rendered views, scene fixed.  The ray bundle is rebuilt from the pose
    parameters inside the loss, so autograd chains through the look-at
    normalization and camera grid into render_rays's origin/direction
    cotangents (the per-ray o_bar/d_bar of the fused backward)."""
    dev = tables.cam_up.device
    center = torch.as_tensor(CENTER, device=dev)
    want = torch.as_tensor(poses_true, device=dev)
    poses = torch.as_tensor(perturbed_poses(poses_true),
                            device=dev).requires_grad_()
    opt = torch.optim.Adam([poses], lr=args.lr, betas=BETAS, eps=EPS)

    def loss_fn():
        o, d = bundle(tables, cfg, center, poses)
        pred = render_rays(plan, tables, o, d, cfg, device=dev)
        return torch.mean((pred - targets) ** 2)

    def pose_err():
        return torch.linalg.norm(poses.detach() - want, dim=-1).mean().item()

    err0 = pose_err()
    for i in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {loss.item():.3e}  "
                  f"mean pose-err {pose_err():.4f}", flush=True)
    err = pose_err()
    print(f"pose error {err0:.3f} -> {err:.3f} over "
          f"{poses.shape[0]} cameras")
    assert err < 0.5 * err0, "pose fit failed to converge"
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
