"""Ray-sharded rendering and fitting over a ``torch.distributed`` mesh.

Port of ``raymarching_tpu.parallel.sharded``: data parallelism over rays,
one process a device, the image rows split over every axis of a
``torch.distributed.device_mesh.DeviceMesh`` (``make_mesh``'s
``("rays",)``, ``make_mesh_2d``'s ``("hosts", "chips")``; rank i of the
mesh, in its row-major order, owns rows [i H/n, (i + 1) H/n)).  The scene
tables are replicated: a few KB on every rank.

  * Forward: no collective.  Each rank makes its own rows' rays
    (``core.camera.generate_rays(row_range=)``, bitwise the whole frame's
    rows) and renders them through any backend (``api._render_rows``):
    on ``cuda`` one K1 launch a band.
  * Backward: each rank's gradients of the replicated tables are partial
    sums over its rays; ``_Replicated``'s backward flattens every field's
    partial into one buffer and sums it over the mesh in ONE all-reduce
    (JAX's combiner fuses its per-field psums into one tail all-reduce the
    same way, docs/collectives.md).  The camera's gradient arrives partly
    from each rank, as its rows' rays are made on each.

The float32 partial sums meet in the all-reduce, so gradients over
several ranks agree with one process's to float32 reassociation, not
bitwise; on one rank they are bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables
from ..tables import tables_to_torch
from .distributed import gather_rows

RAYS = "rays"

# the groups of the meshes that are not the whole default group, by their
# ranks in mesh order (made by make_mesh / make_mesh_2d on every rank)
_GROUPS: dict = {}


def _require_group() -> None:
    """Raise unless the default process group exists: a mesh is made over
    the group ``distributed.initialize`` forms, never over one of its
    own."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.distributed.initialize() "
            "(torchrun's environment, or an init_method for one process) "
            "before making a mesh")


def _register(mesh: DeviceMesh) -> DeviceMesh:
    """Make (on every rank, as new_group asks) the flat group of a mesh
    that is not the whole default group."""
    ranks = tuple(mesh.mesh.flatten().tolist())
    if ranks != tuple(range(dist.get_world_size())) and ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return mesh


def make_mesh(num_devices: Optional[int] = None, axis: str = RAYS, *,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the ray axis of the first ``num_devices`` ranks of the
    default group (all of them by default), one device a rank.  Every rank
    calls it; a rank outside the mesh takes no part in its renders."""
    _require_group()
    world = dist.get_world_size()
    n = world if num_devices is None else num_devices
    if not 1 <= n <= world:
        raise ValueError(f"need {n} devices, have {world}")
    return _register(DeviceMesh(device_type, list(range(n)),
                                mesh_dim_names=(axis,)))


def make_mesh_2d(hosts: int, chips: int, *,
                 device_type: str = "cuda") -> DeviceMesh:
    """(hosts, chips) mesh with BOTH axes sharding rays: ranks
    [0, hosts * chips) row-major, so a host's chips hold neighbouring
    bands (JAX's ``PartitionSpec(("hosts", "chips"))``)."""
    _require_group()
    world = dist.get_world_size()
    if hosts * chips > world or hosts < 1 or chips < 1:
        raise ValueError(f"need {hosts * chips} devices, have {world}")
    return _register(DeviceMesh(
        device_type, torch.arange(hosts * chips).reshape(hosts, chips),
        mesh_dim_names=("hosts", "chips")))


def mesh_group(mesh: Optional[DeviceMesh]):
    """(process group, size) of a mesh, every axis flattened; None means
    the whole default group, (None, 1) without one."""
    if mesh is None:
        return (None, dist.get_world_size()) if dist.is_initialized() \
            else (None, 1)
    ranks = tuple(mesh.mesh.flatten().tolist())
    if ranks == tuple(range(dist.get_world_size())):
        return None, len(ranks)
    return _GROUPS[ranks], len(ranks)


def mesh_index(mesh: DeviceMesh) -> int:
    """This rank's position in the mesh, every axis flattened row-major."""
    ranks = mesh.mesh.flatten().tolist()
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh {ranks}")
    return ranks.index(me)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank renders on: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_rows(cfg: RenderConfig, mesh: DeviceMesh) -> int:
    n = mesh.size()
    if cfg.height % n:
        raise ValueError(
            f"image height {cfg.height} must be divisible by the mesh size "
            f"{n} (rows are the sharded axis)")
    return n


def all_reduce_grads(grads: list, group) -> list:
    """Sum float32 tensors over ``group`` in ONE all-reduce of one flat
    buffer; returns the sums, each in its tensor's shape.  Counts its
    calls and the last buffer's bytes (``calls``, ``bytes``)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    all_reduce_grads.calls += 1
    all_reduce_grads.bytes = flat.numel() * flat.element_size()
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


all_reduce_grads.calls = 0
all_reduce_grads.bytes = 0


class _Replicated(torch.autograd.Function):
    """Identity on tensors replicated over a mesh; the backward sums their
    gradients over it in one all-reduce (the transpose of JAX's
    replicated ``P()`` input of shard_map)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        full = [g if g is not None else torch.zeros(s, dtype=dt, device=dv)
                for g, (s, dt, dv) in zip(grads, ctx.like)]
        return (None, *all_reduce_grads(full, ctx.group))


def _replicated(mesh: DeviceMesh, *tensors) -> tuple:
    """``tensors`` with those that require grad (grad enabled) passed
    through one ``_Replicated``; the others unchanged."""
    idx = [i for i, t in enumerate(tensors)
           if torch.is_grad_enabled() and t.requires_grad]
    if not idx:
        return tensors
    out = list(tensors)
    for i, t in zip(idx, _Replicated.apply(mesh_group(mesh)[0],
                                           *(tensors[i] for i in idx))):
        out[i] = t
    return tuple(out)


class _LossSum(torch.autograd.Function):
    """The sum of a scalar over the mesh; its gradient is the rank's own
    (each rank's backward gives its partial, which ``_Replicated`` sums)."""

    @staticmethod
    def forward(ctx, group, x):
        total = x.detach().clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherRows(torch.autograd.Function):
    """[m, C] on each rank -> [n m, C] in mesh order on every rank; the
    backward hands each rank its own rows' gradient (the loss on the
    gathered tensor is the same on every rank)."""

    @staticmethod
    def forward(ctx, group, index, local):
        ctx.m, ctx.index = local.shape[0], index
        return gather_rows(local, group)

    @staticmethod
    def backward(ctx, g):
        i = ctx.index * ctx.m
        return None, None, g[i:i + ctx.m]


def render_sharded(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                   mesh: DeviceMesh, *, differentiable: bool = False,
                   backend: str = "ref") -> torch.Tensor:
    """This rank's band [H/n, W, 3] of the frame rendered with its rows
    sharded over ``mesh`` (the addressable shard of JAX's sharded array;
    ``distributed.gather_image`` assembles the frame), on the rank's
    device, with no collective.  ``backend`` is any of ``api``'s (on
    ``cuda`` one K1 launch a band; ``cfg.serve_raygen`` is not read).
    With ``differentiable`` (and grad enabled) the band carries the graph
    to the fields of ``tables`` that require grad, whose gradients are
    summed over the mesh in one all-reduce in the backward.  Raises
    ValueError when the height does not divide by the mesh size."""
    from ..api import _render_rows, resolve_device, route_backend
    from ..ops.render_kernel import check_supported
    n = _check_rows(cfg, mesh)
    i = mesh_index(mesh)
    device = resolve_device(mesh_device(mesh))
    backend = route_backend(cfg, backend)
    check_supported(plan, cfg, backend)
    rows = cfg.height // n
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        tables = SceneTables(*_replicated(
            mesh, *tables_to_torch(tables, device)))
        return _render_rows(plan, tables, cfg, backend,
                            differentiable=differentiable,
                            row_range=(i * rows, rows))


def render_rays_sharded(plan: ScenePlan, tables: SceneTables, origins, dirs,
                        cfg: RenderConfig, mesh: DeviceMesh) -> torch.Tensor:
    """Colours [R, 3] of an arbitrary bundle of rays on every rank of the
    mesh, each rank rendering its contiguous share through
    ``api.render_rays`` (K1 with per-ray origins on CUDA): ``dirs`` [R, 3]
    unit, ``origins`` [R, 3] (sharded with their rays) or [3] (shared).
    The bundle is padded to a multiple of the mesh size by repeating the
    last ray, and the pad is cut from the gathered result.  One all-gather
    in the forward; differentiable in ``tables``, ``origins`` and
    ``dirs``, their gradients summed over the mesh in one all-reduce."""
    from ..api import render_rays, resolve_device
    n = mesh.size()
    i = mesh_index(mesh)
    device = resolve_device(mesh_device(mesh))
    f32 = dict(dtype=torch.float32, device=device)
    origins = torch.as_tensor(origins, **f32)
    dirs = torch.as_tensor(dirs, **f32)
    R = dirs.shape[0]
    tables = tables_to_torch(tables, device)
    *fields, origins, dirs = _replicated(mesh, *tables, origins, dirs)
    pad = (-R) % n
    if pad:
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, 3)])
    per_ray = origins.dim() == 2
    if per_ray and pad:
        origins = torch.cat([origins, origins[-1:].expand(pad, 3)])
    m = (R + pad) // n
    local = render_rays(plan, SceneTables(*fields),
                        origins[i * m:(i + 1) * m] if per_ray else origins,
                        dirs[i * m:(i + 1) * m], cfg, device=device)
    return _GatherRows.apply(mesh_group(mesh)[0], i, local)[:R]


def render_sharded_gspmd(plan: ScenePlan, tables: SceneTables,
                         cfg: RenderConfig, mesh: DeviceMesh,
                         backend: str = "ref"):
    """The same sharded frame as a ``DTensor`` placed ``Shard(0)`` on
    every mesh axis (``DTensor.from_local`` over ``render_sharded``'s
    band, no communication): PyTorch's idiom for JAX's sharded array, as
    JAX's GSPMD variant is its compiler-partitioned idiom.  A differential
    check: ``full_tensor()`` gathers the frame."""
    from torch.distributed.tensor import DTensor, Shard
    band = render_sharded(plan, tables, cfg, mesh, backend=backend)
    return DTensor.from_local(band, mesh, [Shard(0)] * mesh.ndim,
                              run_check=False)


def mse_loss(plan: ScenePlan, tables: SceneTables, target,
             cfg: RenderConfig, mesh: DeviceMesh,
             backend: str = "ref") -> torch.Tensor:
    """Mean squared error of the sharded frame against ``target``
    [H, W, 3] (the whole frame, on every rank): the rank's squared-error
    sum over its band, divided by H W 3, summed over the mesh.  Its value
    is the frame's loss on every rank; its backward gives the tables the
    frame's gradient (each rank's partial, summed by the all-reduce)."""
    img = render_sharded(plan, tables, cfg, mesh, differentiable=True,
                         backend=backend)
    rows = img.shape[0]
    i = mesh_index(mesh)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=img.device)[i * rows:(i + 1) * rows]
    local = ((img - target) ** 2).sum() / (cfg.height * cfg.width * 3)
    return _LossSum.apply(mesh_group(mesh)[0], local)


def loss_and_grads(plan: ScenePlan, tables: SceneTables, target,
                   cfg: RenderConfig, mesh: DeviceMesh,
                   backend: str = "ref"):
    """(loss, SceneTables of its gradients) of ``mse_loss`` with every
    field trainable, the same on every rank."""
    tt = tables_to_torch(tables, mesh_device(mesh),
                         requires_grad=SceneTables._fields)
    loss = mse_loss(plan, tt, target, cfg, mesh, backend)
    grads = torch.autograd.grad(loss, list(tt), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), SceneTables(*grads)


def train_step(plan: ScenePlan, tables: SceneTables, target,
               cfg: RenderConfig, mesh: DeviceMesh, lr: float = 1e-2,
               backend: str = "ref"):
    """One SGD step on every field against a target frame -> (loss, new
    tables), the same on every rank (the gradients are all-reduced)."""
    loss, grads = loss_and_grads(plan, tables, target, cfg, mesh, backend)
    tt = tables_to_torch(tables, mesh_device(mesh))
    return loss, SceneTables(*(t - lr * g for t, g in zip(tt, grads)))


def train_step_jit(plan: ScenePlan, cfg: RenderConfig, mesh: DeviceMesh,
                   lr: float = 1e-2, backend: str = "ref"):
    """``train_step`` as a closure of (tables, target) with plan, cfg,
    mesh and lr bound (JAX's jitted closure).  Nothing is compiled: the
    port's kernels are built once per process, and each step is eager."""
    def step(tables, target):
        return train_step(plan, tables, target, cfg, mesh, lr, backend)
    return step
