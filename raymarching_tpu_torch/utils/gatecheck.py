"""Fused-gate offender classification: the port's copy of
``raymarching_tpu.utils.gatecheck`` (pure numpy; tests/test_torch_scene_copies
.py holds it equal to the original).

The fused-generator fast mode folds Menger/DeathStar carves into
conservative closed-form distances: same zero set, different fold
association.  Where a marginal SSAA sample's convergence decision flips
(an ulp-scale field difference at a silhouette crossing), the fused and
exact images can disagree by a full shade at isolated pixels — benign,
geometry-edge-confined.  A disagreement in a smooth INTERIOR region would
instead mean the folded field is wrong somewhere on the surface — a bug.

This module classifies every gate offender (pixel whose max-channel color
difference exceeds the gate threshold) against the exact path's own AOVs
(api.render_aovs: object id, depth, SSAA coverage):

  silhouette pixel :=  partial SSAA coverage (0 < hit < 1)
                    OR object id differs from a 4-neighbor
                    OR hit/miss state differs from a 4-neighbor
                    OR relative depth jump > ``depth_rel`` to a 4-neighbor
                    OR (with ``shadow``) a hard-shadow boundary: any
                       light's shadowed-sample fraction is partial or
                       differs from a 4-neighbor — cast-shadow edges are
                       LIGHT discontinuities invisible to objid/depth
                       (on the demo a cast-shadow line across the floor
                       is such an edge)
                    OR (with ``normal``) a surface CREASE: the normal
                       turns > ``crease_deg`` to a 4-neighbor — where
                       two faces of one primitive meet, the FD and
                       analytic normal estimators legitimately disagree
                       (the exact path's h=1e-3 stencil straddles the
                       edge) while objid and depth stay smooth
  … dilated by ``dilate`` pixels (an offender within 1 px of an edge is
  edge-class: the fused image's edge lands one sample over).
"""

from __future__ import annotations

import numpy as np


def silhouette_mask(objid: np.ndarray, depth: np.ndarray, hit: np.ndarray,
                    *, shadow: np.ndarray = None,
                    normal: np.ndarray = None, crease_deg: float = 15.0,
                    depth_rel: float = 0.05, dilate: int = 1
                    ) -> np.ndarray:
    """[H, W] bool: pixels on (or within ``dilate`` px of) a geometry or
    hard-shadow discontinuity of the exact render.  Edges are detected
    symmetrically (a jump marks both sides), so the pre-dilation mask is
    already two-sided; dilation adds the sub-pixel slack SSAA edge
    shifts need.  ``shadow`` ([H, W, L] per-light shadowed fraction,
    api.render_aovs) adds cast-shadow boundaries."""
    objid = np.asarray(objid)
    depth = np.asarray(depth)
    hit = np.asarray(hit)
    edge = (hit > 0.0) & (hit < 1.0)
    if shadow is not None:
        sh2 = np.asarray(shadow)
        edge |= ((sh2 > 0.0) & (sh2 < 1.0)).any(axis=-1)
    if normal is not None:
        nrm = np.asarray(normal)
        cos_thresh = float(np.cos(np.deg2rad(crease_deg)))
    fin = np.isfinite(depth)
    for ax in (0, 1):
        for sh in (1, -1):
            nb_id = np.roll(objid, sh, axis=ax)
            nb_d = np.roll(depth, sh, axis=ax)
            nb_fin = np.roll(fin, sh, axis=ax)
            edge |= nb_id != objid
            edge |= nb_fin != fin
            if shadow is not None:
                edge |= (np.roll(sh2, sh, axis=ax) != sh2).any(axis=-1)
            if normal is not None:
                dot = np.sum(np.roll(nrm, sh, axis=ax) * nrm, axis=-1)
                edge |= (hit > 0.0) & (dot < cos_thresh)
            both = fin & nb_fin
            with np.errstate(invalid="ignore"):
                rel = np.abs(nb_d - depth) / np.maximum(
                    np.minimum(np.abs(nb_d), np.abs(depth)), 1e-6)
            edge |= both & (rel > depth_rel)
    # np.roll wraps: a frame-edge pixel may compare against the opposite
    # border.  Image borders count as discontinuities anyway (the frame
    # crops geometry), so mark them rather than special-case the wrap.
    edge[0, :] = edge[-1, :] = True
    edge[:, 0] = edge[:, -1] = True
    out = edge.copy()
    for _ in range(dilate):
        d = out.copy()
        for ax in (0, 1):
            for sh in (1, -1):
                d |= np.roll(out, sh, axis=ax)
        out = d
    return out


def classify_offenders(diff: np.ndarray, thresh: float,
                       objid: np.ndarray, depth: np.ndarray,
                       hit: np.ndarray, *, shadow: np.ndarray = None,
                       normal: np.ndarray = None,
                       crease_deg: float = 15.0,
                       depth_rel: float = 0.05,
                       dilate: int = 1) -> dict:
    """Classify every gate offender (diff >= thresh) as silhouette-class
    or interior-class.  Returns a JSON-ready dict:

      offenders              total count
      offenders_on_silhouette  count on/near a geometry discontinuity
      offenders_interior       count in smooth regions (bug if > 0)
      interior_yx              up to 16 [y, x] coords of interior ones
      all_on_silhouette        the headline boolean the gate records
    """
    diff = np.asarray(diff)
    mask = silhouette_mask(objid, depth, hit, shadow=shadow,
                           normal=normal, crease_deg=crease_deg,
                           depth_rel=depth_rel, dilate=dilate)
    off = diff >= thresh
    n = int(off.sum())
    on_sil = int((off & mask).sum())
    interior = np.argwhere(off & ~mask)
    return {
        "offenders": n,
        "offenders_on_silhouette": on_sil,
        "offenders_interior": n - on_sil,
        "interior_yx": [[int(y), int(x)] for y, x in interior[:16]],
        "all_on_silhouette": bool(n == on_sil),
    }
