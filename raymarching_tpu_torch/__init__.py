"""raymarching_tpu_torch: the renderer ported to PyTorch and CUDA.

A second package beside the JAX reference ``raymarching_tpu``, and
independent of it: scene parsing, compilation, configuration, image IO,
checkpoints and logging are the port's own copies of the reference's
numpy-only modules (``config``, ``scene``, ``io``, ``utils``), so neither
JAX nor the JAX package is ever imported.  Rendering runs in PyTorch, with
four hand-written CUDA kernels for Hopper under ``csrc/``: the fused
forward (``render_kernel.cu``), the point evaluation of the backward
passes and the multi-kernel backend (``surface_kernel.cu``), the
standalone march (``march_kernel.cu``) and the shade kernel of the
two-phase path (``shade_kernel.cu``).

    import raymarching_tpu_torch as rt
    img = rt.render(rt.load_scene("scenes/demo.txt"), rt.RenderConfig(),
                    device="cuda")
    res = rt.fit(plan, tables, target, cfg, device="cuda",
                 trainable=("prim_pos",))     # (plan, tables) = compile_scene
"""

from .config import RenderConfig
from .io.image import to_uint8
from .io.png import decode_png
from .scene.compile import compile_scene
from .scene.parser import load_scene

from .api import render, render_ref, render_tables
from .optimize import fit

__all__ = ["RenderConfig", "compile_scene", "load_scene", "render",
           "render_ref", "render_tables", "fit", "to_uint8", "decode_png"]
