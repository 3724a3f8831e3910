"""Surface-distance metrics (area-weighted ASD, robust Hausdorff, surface
dice at tolerance): host-side numpy, the port's own copy of the JAX
package's `metrics/surface.py` over the port's `native.edt3d`.

Capability-parity with the metric *definitions* used by the reference's
vendored surface-distance library (`segmentation/metrics.py`), implemented
from scratch:

- Surface elements live on the dual grid of 2x2x2 voxel neighborhoods; each
  neighborhood's binary occupancy is an 8-bit code.
- Per-code surface areas are generated on demand by a from-scratch marching
  construction instead of shipping the hand-written 256-entry normals table
  (`segmentation/metrics.py:343-599`): the inside corners of each cell are
  split into edge-connected components, the isosurface contour polygon of
  each component is traced across the cell faces (crossings at edge
  midpoints — the 0.5-threshold of a binary field; diagonal "saddle" faces
  separate positive corners), and each polygon is triangulated by its
  maximum-area vertex fan.  This reproduces the reference table **exactly**
  (all 256 codes, isotropic and anisotropic spacings — see
  tests/test_metrics.py), because the classic MC triangulation that table
  encodes is area-equivalent to the max-area fan of the contour polygon.
- Distances between the two surfel clouds use the exact euclidean distance
  transform (`scipy.ndimage.distance_transform_edt`, with an optional native
  C++ fast path — see `native/`), with anisotropic spacing support.

API mirrors the reference so downstream code (`validate_dsc_asd`,
`segmentation/routine.py:205-237`) is drop-in.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

from ..native import edt3d

# ---------------------------------------------------------------------------
# per-neighborhood-code surface area via contour-polygon marching
# ---------------------------------------------------------------------------

# Unit-cell corners indexed by the bit order of the neighborhood code:
# bit k set <=> corner (k//4, (k//2)%2, k%2) is inside the mask.
_CORNERS = np.array([[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)],
                    dtype=np.float64)

# Cube faces as (axis, value); corner k lies on face (ax, v) iff its ax
# coordinate equals v.
_FACES = [(ax, v) for ax in range(3) for v in (0, 1)]


def _components(inside: frozenset) -> list:
    """Edge-connected components of a set of cube-corner indices."""
    comps, todo = [], set(inside)
    while todo:
        stack = [todo.pop()]
        comp = {stack[0]}
        while stack:
            k = stack.pop()
            for nb in range(8):
                if bin(nb ^ k).count("1") == 1 and nb in todo:
                    todo.remove(nb)
                    comp.add(nb)
                    stack.append(nb)
        comps.append(comp)
    return comps


def _contour_polygons(inside: frozenset) -> list:
    """Isosurface contour polygons of a <=4-corner inside set.

    Crossing vertices sit at edge midpoints.  Each edge-connected component
    of inside corners contributes one closed polygon: on every cube face the
    contour segment links the component's two crossing points (for <=4 inside
    corners a face never holds two *diagonal* corners of the same component,
    so the trace is unambiguous; diagonal corners of different components
    stay separated — the positive-separating marching convention).
    """
    polys = []
    for comp in _components(inside):
        cuts = {}  # (lo, hi) corner pair -> midpoint
        for a in comp:
            for b in range(8):
                if bin(a ^ b).count("1") == 1 and b not in inside:
                    cuts[tuple(sorted((a, b)))] = (
                        _CORNERS[a] + _CORNERS[b]) / 2
        segments = []
        for ax, v in _FACES:
            face = {k for k in range(8) if _CORNERS[k][ax] == v}
            mine = face & comp
            face_cuts = [e for e in cuts if set(e) <= face]
            if len(mine) == 1 or len(mine) == 3:
                # one corner (or an L of three): exactly two crossings link up
                segments.append(tuple(face_cuts))
            elif len(mine) == 2:
                a, b = sorted(mine)
                ca = [e for e in face_cuts if a in e]
                cb = [e for e in face_cuts if b in e]
                if len(ca) == 1 and len(cb) == 1:   # adjacent pair
                    segments.append((ca[0], cb[0]))
                # diagonal pair on one face belongs to two different
                # components (unreachable here for a single component)
        adj = {}
        for e1, e2 in segments:
            adj.setdefault(e1, []).append(e2)
            adj.setdefault(e2, []).append(e1)
        unvisited = set(adj)
        while unvisited:
            start = next(iter(unvisited))
            cycle = [start]
            unvisited.discard(start)
            prev, cur = None, start
            while True:
                nxt = [x for x in adj[cur] if x != prev][0]
                if nxt == start:
                    break
                cycle.append(nxt)
                unvisited.discard(nxt)
                prev, cur = cur, nxt
            polys.append(np.array([cuts[e] for e in cycle]))
    return polys


def _tri_area(p0, p1, p2) -> float:
    return 0.5 * float(np.linalg.norm(np.cross(p1 - p0, p2 - p0)))


def _fan_triangles(poly: np.ndarray, f: int):
    n = len(poly)
    return [(poly[f], poly[(f + i) % n], poly[(f + i + 1) % n])
            for i in range(1, n - 1)]


@functools.lru_cache(maxsize=None)
def _code_triangles(code: int):
    """Unit-cell triangle list for one occupancy code.

    Inside sets larger than 4 corners use the complement (same surface).
    Non-planar contour polygons are triangulated by their **maximum-area
    vertex fan at unit spacing** — the triangulation the reference's
    hand-written normals table encodes (verified exactly over all 256 codes;
    the fan is fixed here so anisotropic spacings scale the same triangles
    the reference scales).
    """
    inside = frozenset(k for k in range(8) if (code >> k) & 1)
    if len(inside) > 4:
        inside = frozenset(range(8)) - inside
    if not inside:
        return ()
    tris = []
    for poly in _contour_polygons(inside):
        best = max(range(len(poly)),
                   key=lambda f: sum(_tri_area(*t)
                                     for t in _fan_triangles(poly, f)))
        tris.extend(_fan_triangles(poly, best))
    return tuple((p0.copy(), p1.copy(), p2.copy()) for p0, p1, p2 in tris)


@functools.lru_cache(maxsize=None)
def _area_table_key(spacing: Tuple[float, float, float]) -> np.ndarray:
    scale = np.asarray(spacing, np.float64)
    table = np.zeros(256, np.float64)
    for code in range(1, 255):
        table[code] = sum(_tri_area(p0 * scale, p1 * scale, p2 * scale)
                          for p0, p1, p2 in _code_triangles(code))
    return table


def neighbour_code_to_surface_area(spacing_mm) -> np.ndarray:
    """256-entry lookup: 2x2x2 occupancy code -> isosurface area (mm^2)."""
    return _area_table_key(tuple(float(s) for s in spacing_mm))


# ---------------------------------------------------------------------------
# surfel extraction + distances
# ---------------------------------------------------------------------------

def _neighbour_codes(mask: np.ndarray) -> np.ndarray:
    """8-bit occupancy code for every 2x2x2 neighborhood (cell grid of shape
    (D-1, H-1, W-1))."""
    m = mask.astype(np.uint8)
    code = np.zeros(tuple(s - 1 for s in m.shape), np.uint8)
    for k in range(8):
        dx, dy, dz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        code |= (m[dx:dx + code.shape[0],
                   dy:dy + code.shape[1],
                   dz:dz + code.shape[2]] << k)
    return code


def compute_surface_distances(mask_gt, mask_pred, spacing_mm) -> Dict:
    """Area-weighted distances between the surfaces of two binary masks.

    Returns dict with `distances_gt_to_pred`, `distances_pred_to_gt`,
    `surfel_areas_gt`, `surfel_areas_pred` (each sorted by distance for the
    gt/pred directions respectively).
    """
    mask_gt = np.asarray(mask_gt).astype(bool)
    mask_pred = np.asarray(mask_pred).astype(bool)
    if mask_gt.shape != mask_pred.shape:
        raise ValueError(
            f"mask shapes differ: {mask_gt.shape} vs {mask_pred.shape}")
    spacing = tuple(float(s) for s in spacing_mm)
    table = neighbour_code_to_surface_area(spacing)

    codes_gt = _neighbour_codes(mask_gt)
    codes_pred = _neighbour_codes(mask_pred)
    border_gt = (codes_gt != 0) & (codes_gt != 255)
    border_pred = (codes_pred != 0) & (codes_pred != 255)

    areas_gt = table[codes_gt]
    areas_pred = table[codes_pred]

    # distance maps on the cell grid (cell centers are offset by spacing/2
    # uniformly in both masks, so center-to-center distances are unbiased);
    # exact EDT via the native C++ transform (scipy fallback inside)
    dist_to_gt = edt3d(border_gt, spacing)
    dist_to_pred = edt3d(border_pred, spacing)

    d_gt_to_pred = dist_to_pred[border_gt]
    a_gt = areas_gt[border_gt]
    d_pred_to_gt = dist_to_gt[border_pred]
    a_pred = areas_pred[border_pred]

    order = np.argsort(d_gt_to_pred)
    d_gt_to_pred, a_gt = d_gt_to_pred[order], a_gt[order]
    order = np.argsort(d_pred_to_gt)
    d_pred_to_gt, a_pred = d_pred_to_gt[order], a_pred[order]

    return dict(distances_gt_to_pred=d_gt_to_pred,
                distances_pred_to_gt=d_pred_to_gt,
                surfel_areas_gt=a_gt,
                surfel_areas_pred=a_pred)


def compute_average_surface_distance(surface_distances) -> Tuple[float, float]:
    """(avg dist gt->pred, avg dist pred->gt), area-weighted."""
    d1 = surface_distances["distances_gt_to_pred"]
    d2 = surface_distances["distances_pred_to_gt"]
    a1 = surface_distances["surfel_areas_gt"]
    a2 = surface_distances["surfel_areas_pred"]
    avg1 = np.sum(d1 * a1) / np.sum(a1) if len(d1) else np.nan
    avg2 = np.sum(d2 * a2) / np.sum(a2) if len(d2) else np.nan
    return float(avg1), float(avg2)


def _weighted_percentile(sorted_distances, areas, percent):
    if len(sorted_distances) == 0:
        return np.inf
    cum = np.cumsum(areas) / np.sum(areas)
    idx = np.searchsorted(cum, percent / 100.0)
    idx = min(idx, len(sorted_distances) - 1)
    return float(sorted_distances[idx])


def compute_robust_hausdorff(surface_distances, percent: float) -> float:
    """Symmetric robust (percentile) Hausdorff distance in mm."""
    h_gt = _weighted_percentile(surface_distances["distances_gt_to_pred"],
                                surface_distances["surfel_areas_gt"], percent)
    h_pred = _weighted_percentile(surface_distances["distances_pred_to_gt"],
                                  surface_distances["surfel_areas_pred"],
                                  percent)
    return max(h_gt, h_pred)


def compute_surface_overlap_at_tolerance(surface_distances,
                                         tolerance_mm: float):
    """(fraction of gt surface within tol of pred, and vice versa)."""
    d1 = surface_distances["distances_gt_to_pred"]
    d2 = surface_distances["distances_pred_to_gt"]
    a1 = surface_distances["surfel_areas_gt"]
    a2 = surface_distances["surfel_areas_pred"]
    rel1 = np.sum(a1[d1 <= tolerance_mm]) / np.sum(a1) if len(d1) else np.nan
    rel2 = np.sum(a2[d2 <= tolerance_mm]) / np.sum(a2) if len(d2) else np.nan
    return float(rel1), float(rel2)


def compute_surface_dice_at_tolerance(surface_distances,
                                      tolerance_mm: float) -> float:
    d1 = surface_distances["distances_gt_to_pred"]
    d2 = surface_distances["distances_pred_to_gt"]
    a1 = surface_distances["surfel_areas_gt"]
    a2 = surface_distances["surfel_areas_pred"]
    overlap = (np.sum(a1[d1 <= tolerance_mm])
               + np.sum(a2[d2 <= tolerance_mm]))
    total = np.sum(a1) + np.sum(a2)
    return float(overlap / total) if total > 0 else np.nan
