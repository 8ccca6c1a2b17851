"""Render configuration.

The port's own copy of ``raymarching_tpu.config``: the same fields and
defaults, so a configuration means the same thing in both packages (a test
holds the two equal).  It replaces the reference's two-level config system
(compile-time ``source/include/constants.h`` + runtime scene text file)
with one frozen (hashable) dataclass.  Fields the port does not act on yet
are kept so that a caller can state them and be refused by name
(``ops.render_kernel.check_supported``).

Reference values: constants.h:11-27 (1024x768, iterations=1000, gamma=1.0,
saturation=0.05, surface/offset precision 1e-3, SSAA kernel 3).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (hashable, so usable as a cache key)."""

    # Image (constants.h:11-12)
    width: int = 1024
    height: int = 768

    # March (constants.h:14, constants.h:20-22)
    iterations: int = 1000
    surface_precision: float = 1e-3
    offset_precision: float = 1e-3

    # Shading (constants.h:15-16)
    saturation: float = 0.05
    gamma: float = 1.0

    # Supersampling (constants.h:26)
    ssaa: int = 3

    # Shadow rays on/off (always on in the reference; off for the cheap
    # BASELINE config-1 ladder rung).
    shadows: bool = True

    # --- extensions (no reference equivalent) ---
    # Normal estimation: "fd" = 6-eval central differences, h=1e-3, matching
    # the reference bit-for-bit (scene.cpp:70-89); "analytic" = one
    # in-kernel winner-gradient evaluation (the ref backend: autograd).
    # The default is "fd" for bit-parity with the reference's own
    # estimator.
    normal_mode: str = "fd"
    fd_h: float = 1e-3

    # Stop the march loop early once every ray in a tile has converged
    # (semantics-preserving: converged rays are frozen either way).
    early_exit: bool = True

    # The JAX package's march backend switch; the port chooses its
    # backend by the ``backend=`` argument of ``api.render_tables``.
    backend: str = "auto"

    # Ray-to-warp assignment for the camera-grid paths ("auto" | "block" |
    # "scan"; core.order): "block" hands the kernels the samples of compact
    # pixel blocks, so a warp's 32 rays are near neighbours; "auto" does
    # so on the fused backend ``cuda``.  Bit-exact: per-ray arithmetic does
    # not depend on the order, and colours come back in scan order.
    ray_order: str = "auto"

    # Rays per tile of the JAX kernels, (tile_sublanes, 128): in the port
    # the rays a pixel block of block order holds (core.order.block_dims,
    # so the permutation is the JAX package's), and the two-phase march's
    # least capacity (tile_sublanes * 128 lanes).  Images do not depend on
    # it.
    tile_sublanes: int = 32

    # Process rays in chunks of this many (0 = whole frame at once) to bound
    # the working set: the port's fused backend renders the chunks one
    # after the other (forward and differentiable), each one launch.
    ray_chunk: int = 0

    # Serving fast path (mega backend, FORWARD-ONLY): generate primary-ray
    # directions INSIDE the kernel from the ray index (the same
    # corner-biased camera math as core.camera.generate_rays), skipping
    # the ray generation pass and the [R, 3] directions stream.  Primal
    # only by design.  Pinhole cameras only (aperture == 0); mirror
    # bounces serve in the kernel too.  Off by default; the port's server
    # turns it on, as the JAX server does.
    serve_raygen: bool = False

    # Two-phase march (mega backend): march every ray K1 steps, then
    # compact the unconverged tail (a small share of rays on the demo
    # scene; ``utils.timing.profile_march`` counts it) into a dense batch
    # and finish only those with the remaining budget.  Semantics-exact: the
    # march is memoryless given (position, done), per-ray trajectories and
    # the total evaluation cap are bit-identical, and a capacity overflow
    # (> 1/8 of rays unconverged at K1) falls back to the plain full-budget
    # march.  0 = single-phase.  Mitigates the straggler effect where one
    # slow lane keeps its whole warp stepping (the GLSL kernel's
    # divergence, shader.comp:288-297).
    two_phase_k1: int = 0

    # Evaluate procedural generators (MengerSponge) by space folding in the
    # kernels: O(iterations) per query instead of the explicit
    # 20^k cross table.  The folded field has the SAME zero set and is
    # conservative (never larger than the table field), so marches converge
    # to identical surfaces; distance VALUES differ away from surfaces, so
    # trajectories and rare edge pixels can shift within march precision.
    # Gradients attribute to the generator's own parameters (box position/
    # size) rather than to 20^k tied cross copies.  Off = exact table
    # semantics.
    fused_generators: bool = False

    # IFT backward stabilization (opt-in, 0.0 = exact clamped IFT): when
    # > 0, the per-ray 1/(grad f . d) factor becomes the Tikhonov-damped
    # denom/(denom^2 + damping^2), rolling grazing rays' weights off to
    # zero instead of 1/eps.  Essential when FITTING rough/fractal scenes,
    # where grazing rays dominate and the exact clamped gradient is ~100x
    # noise (see ops.march_op.ift_ray_weights).  A few 1e-3 works well.
    ift_damping: float = 0.0

    # Soft shadows (opt-in, 0.0 = reference-parity hard boolean): the
    # shadow march additionally tracks min over steps of
    # clamp(k * sd / t, 0, 1) (the classic SDF penumbra estimate) and the
    # Lambert term scales by that factor instead of the on/off mask; a ray
    # that actually hits an occluder still contributes exactly 0.  Like
    # the reference's boolean, the factor is treated as locally constant
    # under autodiff (stop_gradient) — gradients keep flowing through the
    # normal and light direction.  Supported on ref/jnp oracles and the
    # mega kernel.
    soft_shadow_k: float = 0.0

    # Ambient occlusion (opt-in, 0.0 = off): 5-tap SDF occlusion along the
    # normal — occ = sum_i 2^-i * (i*delta - sd(p + i*delta*n)), the final
    # light term scales by clamp(1 - strength * occ, 0, 1), stop-gradient
    # like the shadow factor.  Supported on ref/jnp oracles and the mega
    # kernel.
    ao_strength: float = 0.0
    ao_samples: int = 5
    ao_delta: float = 0.1

    # Mirror reflections (opt-in, 0.0 = reference parity): tinted-mirror
    # model — a hit's color becomes
    #     color * ((1 - s) * light  +  s * c_reflected)
    # where c_reflected re-runs the full pipeline (march + shadows + shade)
    # from the hit point along the mirrored direction, recursively for
    # ``reflect_bounces`` levels (the LAST bounce uses its plain shade).
    # Multiplying the reflected radiance by the surface's own color makes
    # black surfaces (the Bounds walls) naturally non-reflective and
    # colored surfaces tint what they mirror, so no miss masking is needed.
    # The bounce origin is pushed off the surface by
    # (surface_precision + offset_precision) along the normal, exactly like
    # shadow rays.  On every backend of the port, forward and backward.
    reflect_strength: float = 0.0
    reflect_bounces: int = 1

    # Black-lane shadow skip (mega kernel): a lane whose color winner is a
    # compile-time-black primitive (or a miss) produces a provably black
    # pixel — color * clamp(light) == 0 whatever the light term is — so
    # its per-light shadow marches start pre-converged (zero field evals;
    # the tile's while-loop no longer waits on them).  EXACT for the
    # rendered image; gated at RUNTIME on the live color table still
    # having those rows black, so fitting a black primitive's color
    # re-enables full shading automatically.  FORWARD-ONLY: under
    # differentiation the fwd rule forces the skip off (a skipped lane
    # never computed its true shadow state, and d pixel / d prim_color of
    # a black primitive = its light term — zeroing it would freeze
    # black-initialized colors under fitting), so gradients are always
    # exact and fwd+bwd workloads see no speedup from this flag.
    shade_skip_black: bool = True

    # Saturation-floor shadow skip (r5): lanes where even the ALL-LIT
    # Lambert accumulation cannot reach the [saturation, 1] clamp floor
    # (sum_l max(n.l, 0) < saturation, strict, bitwise the shade loop's
    # own arithmetic) start every shadow march pre-converged — their
    # pixel is pinned to saturation*color by the clamp whatever the
    # shadow outcomes, the clamp zeroes every upstream cotangent, and
    # the backward replay clamps to the identical floor.  EXACT for
    # forward AND gradients (unlike shade_skip_black, which is
    # forward-only); the switch exists for A/B and debugging.
    shadow_sat_skip: bool = True

    # Thin-lens depth of field (opt-in, 0.0 = reference-parity pinhole):
    # each SSAA sample's origin moves to a point on a lens disk of radius
    # ``aperture`` (world units) in the camera's right/up plane — a
    # deterministic sunflower pattern over the ssaa^2 samples — and its
    # direction is re-aimed at that sample's focal point (the pinhole
    # ray's intersection with the focus plane ``focus_dist`` along the
    # view axis).  Geometry on the focus plane stays sharp; everything
    # else defocuses with circle of confusion ~ aperture * |t - F| / t.
    # The existing SSAA average IS the lens integral, so blur quality
    # scales with ssaa.  Rides the per-ray-origin bundle machinery
    # (api.render_rays on the fused backend, the hooks on the others).
    aperture: float = 0.0
    focus_dist: float = 6.0

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def aspect_ratio(self) -> float:
        return float(self.width) / float(self.height)

    @property
    def samples_per_pixel(self) -> int:
        return self.ssaa * self.ssaa

    @property
    def rays_per_image(self) -> int:
        return self.width * self.height * self.samples_per_pixel


# The reference demo configuration (constants.h defaults).
REFERENCE_CONFIG = RenderConfig()
