"""raymarching_tpu_torch: the renderer ported to PyTorch and CUDA.

A second package beside the JAX reference ``raymarching_tpu``.  Scene
parsing, compilation, configuration and image IO are the reference's own
numpy-only modules, imported here (they never load JAX); rendering runs in
PyTorch, with the fused forward pass (``csrc/render_kernel.cu``) and the
backward's surface evaluation (``csrc/surface_kernel.cu``) as hand-written
CUDA kernels for Hopper.

    import raymarching_tpu_torch as rt
    img = rt.render(rt.load_scene("scenes/demo.txt"), rt.RenderConfig(),
                    device="cuda")
    res = rt.fit(plan, tables, target, cfg, device="cuda",
                 trainable=("prim_pos",))     # (plan, tables) = compile_scene
"""

from raymarching_tpu.config import RenderConfig
from raymarching_tpu.io.image import to_uint8
from raymarching_tpu.io.png import decode_png
from raymarching_tpu.scene.compile import compile_scene
from raymarching_tpu.scene.parser import load_scene

from .api import render, render_ref, render_tables
from .optimize import fit

__all__ = ["RenderConfig", "compile_scene", "load_scene", "render",
           "render_ref", "render_tables", "fit", "to_uint8", "decode_png"]
