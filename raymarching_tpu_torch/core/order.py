"""Block ray order: a frame's camera-grid samples handed to the kernels as
compact pixel blocks instead of image rows.

Counterpart of ``raymarching_tpu.core.order``'s ``block_dims``,
``to_blocked``, ``from_blocked`` and ``resolve_ray_order``.  A warp of the
port's kernels marches 32 consecutive rays and waits for its slowest one;
in scan order those are a strip of one image row, in block order a
compact block of pixels whose rays tend to take similar steps.  The
reorder is a reshape and a permute, never a gather: its backward is the
inverse permute, a copy, where a gather's backward would be a scatter.
Outputs are put back in scan order, so images are bitwise those of scan
order (no ray's arithmetic depends on its neighbours).

The JAX package's cost-ordered row permutations (``row_cost_perm``,
``row_permuters``) are not ported: they measured slower on the TPU
(``ab_cost_order_r4.json``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import torch


@lru_cache(maxsize=64)
def block_dims(H: int, W: int, S: int, tile_rays: int
               ) -> Optional[Tuple[int, int]]:
    """Pixel-block shape (bh, bw) with bh | H and bw | W, about
    ``tile_rays`` samples a block and about square; None when the frame is
    too small for ordering to matter or no useful split exists (JAX's
    rule, so the permutation is JAX's)."""
    R = H * W * S
    if R < 2 * tile_rays:
        return None
    P = max(1, tile_rays // S)              # target pixels per block
    divs_h = [d for d in range(1, H + 1) if H % d == 0]
    divs_w = [d for d in range(1, W + 1) if W % d == 0]
    bh = min(divs_h, key=lambda d: abs(d - math.sqrt(P)))
    bw = min(divs_w, key=lambda d: abs(d - P / bh))
    if (bh, bw) in ((H, W), (1, W)):        # degenerate: scan already
        return None
    return bh, bw


def to_blocked(x: torch.Tensor, H: int, W: int, S: int,
               bh: int, bw: int) -> torch.Tensor:
    """[H*W*S, ...] scan-order samples -> block-major order."""
    tail = tuple(x.shape[1:])
    x = x.reshape((H // bh, bh, W // bw, bw, S) + tail)
    x = x.permute((0, 2, 1, 3, 4) + tuple(5 + i for i in range(len(tail))))
    return x.reshape((H * W * S,) + tail)


def from_blocked(x: torch.Tensor, H: int, W: int, S: int,
                 bh: int, bw: int) -> torch.Tensor:
    """The inverse of ``to_blocked``."""
    tail = tuple(x.shape[1:])
    x = x.reshape((H // bh, W // bw, bh, bw, S) + tail)
    x = x.permute((0, 2, 1, 3, 4) + tuple(5 + i for i in range(len(tail))))
    return x.reshape((H * W * S,) + tail)


def resolve_ray_order(cfg, backend: str) -> bool:
    """Whether a camera-grid path of ``backend`` takes block order:
    ``cfg.ray_order`` "block" always, "scan" never, "auto" on the fused
    backend ``cuda`` (the JAX package's ``mega``)."""
    if cfg.ray_order == "scan":
        return False
    if cfg.ray_order == "block":
        return True
    if cfg.ray_order == "auto":
        return backend == "cuda"
    raise ValueError(f"unknown ray_order {cfg.ray_order!r}")


def frame_blocks(cfg, rows: int, backend: str) -> Optional[Tuple[int, int]]:
    """The block shape of a band of ``rows`` image rows of ``cfg``'s
    frame on ``backend``: ``block_dims`` with the JAX kernels' tile
    (``cfg.tile_sublanes`` x 128 rays) when ``resolve_ray_order`` says so,
    else None (scan order)."""
    if not resolve_ray_order(cfg, backend):
        return None
    return block_dims(rows, cfg.width, cfg.samples_per_pixel,
                      cfg.tile_sublanes * 128)
