"""The JAX repo's ``examples/`` scripts, ported: each one a module with
``main(argv=None) -> int``, run as
``python -m raymarching_tpu_torch.examples.<name>``.

- ``fit_scene``: recover a perturbed config3 scene from one view;
- ``fit_multiview``: fit the scene, or with ``--fit-poses`` the camera
  positions, against four posed views in one ray stream;
- ``fit_fractal``: recover a quaternion Julia leaf's position, size and
  colour;
- ``turntable``: render an orbit of the demo scene frame by frame.

Each runs on the CUDA device by default (``--device cpu`` runs the
kernels' plain PyTorch versions) and keeps the JAX script's defaults,
sizes, seeds, perturbations, learning rates and printed lines.  Each
``setup(cfg=None)`` returns the script's ``(plan, tables_true, tables0,
cfg)`` (the turntable's ``tables0`` is its first pose), with ``cfg`` in
place of the script's own for a smaller run.
"""
