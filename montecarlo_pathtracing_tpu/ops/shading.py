"""Shading-normal reconstruction (intersection_info).

Reimplements the per-shape *_inter_geom_info dispatch
(shaders/raytracer_func.frag:783-897) as one masked dense computation: every
shape's normal formula is evaluated from the Hit record and selected by the
type code. The reference's construction is kept literally:

    N = normalize( (transfo * (pl + No_local)).xyz - Pg )

i.e. the local offset No is pushed through the prim's affine transform by
point-differencing (NOT the inverse-transpose normal matrix) — for
non-uniform scales this is the reference's behavior, so it is the spec.

Quirks preserved:
  - cone face code 1 (top "cap") yields N = vec3(0) (raytracer_func.frag:852)
  - mesh smooth normals are area-weighted barycentric blends of vertex
    normals; flat normals use cross(B-A, C-A) (:795-809); selected by the
    static flat_face flag (the reference's uniform is never set by the app,
    so GLSL default false = smooth is our default too)
  - on a miss (shape < 0) the previous N, P are kept — the GLSL leaves its
    `out` variables unwritten, which matters for the refraction inner
    re-trace (tp/montecarlo.frag:150-152)
"""
from __future__ import annotations

import jax.numpy as jnp

from .intersect import (
    Hit, CODE_MESH, CODE_SPHERE, CODE_CUBE, CODE_CYLINDER, CODE_CONE,
    CODE_ORIENTED_QUAD,
)
from ..utils.transforms import normalize, transform_point


def _axis_offset(dircode, sign_from_parity=True):
    """No for cube faces: unit vector along axis dir/2, sign from dir%2
    (raytracer_func.frag:820-827)."""
    ax = dircode // 2
    sg = jnp.where(dircode % 2 != 0, 1.0, -1.0)
    no = jnp.zeros(dircode.shape + (3,), jnp.float32)
    for c in range(3):
        no = no.at[..., c].set(jnp.where(ax == c, sg, 0.0))
    return no


def intersection_info(scene, hit: Hit, prev_n=None, prev_p=None):
    """Returns (N [*,3], P [*,3]) world shading normal and hit point.

    prev_n/prev_p: values to keep where hit.shape < 0 (stale-output GLSL
    semantics); default zero-vectors.
    """
    prim = jnp.clip(hit.prim, 0, scene.nb_prims - 1)
    trf = jnp.take(scene.transfo, prim, axis=0)          # [*,4,4]
    pl = hit.pl
    pg = hit.pg

    # --- analytic local offsets -----------------------------------------
    no_cube = _axis_offset(hit.dircode)
    # cylinder: caps -> +-z by dir%2; side -> (pl.xy, 0)
    cap = hit.dircode < 2
    no_cyl = jnp.where(
        cap[..., None],
        jnp.stack([jnp.zeros_like(pl[..., 0]), jnp.zeros_like(pl[..., 0]),
                   jnp.where(hit.dircode % 2 != 0, 1.0, -1.0)], -1),
        jnp.stack([pl[..., 0], pl[..., 1], jnp.zeros_like(pl[..., 0])], -1),
    )
    # cone: dir 0 bottom cap -> pl + (0,0,-1); dir 2 side -> (pl.xy, len/2)
    rxy = jnp.sqrt(pl[..., 0] ** 2 + pl[..., 1] ** 2)
    no_cone = jnp.where(
        (hit.dircode == 0)[..., None],
        jnp.stack([jnp.zeros_like(rxy), jnp.zeros_like(rxy),
                   jnp.full_like(rxy, -1.0)], -1),
        jnp.stack([pl[..., 0], pl[..., 1], rxy / 2.0], -1),
    )
    no_quad = jnp.stack([jnp.zeros_like(pl[..., 0]),
                         jnp.zeros_like(pl[..., 0]),
                         jnp.ones_like(pl[..., 0])], -1)

    shape = hit.shape
    # sphere uses trf*(2*pl) - Pg; the others use trf*(pl + No) - Pg
    point = jnp.where(
        (shape == CODE_SPHERE)[..., None], 2.0 * pl,
        pl + jnp.where(
            (shape == CODE_CUBE)[..., None], no_cube,
            jnp.where(
                (shape == CODE_CYLINDER)[..., None], no_cyl,
                jnp.where((shape == CODE_CONE)[..., None], no_cone, no_quad),
            ),
        ),
    )
    n_analytic = normalize(transform_point(trf, point) - pg)
    # cone top-"cap" quirk: N = 0 (raytracer_func.frag:850-853)
    cone_zero = (shape == CODE_CONE) & (hit.dircode == 1)
    n_analytic = jnp.where(cone_zero[..., None], 0.0, n_analytic)

    # --- mesh normals ----------------------------------------------------
    if scene.tri_va.shape[0] > 0:
        tri = jnp.clip(hit.tri, 0, scene.tri_va.shape[0] - 1)
        A = jnp.take(scene.tri_va, tri, axis=0)
        B = jnp.take(scene.tri_vb, tri, axis=0)
        C = jnp.take(scene.tri_vc, tri, axis=0)
        mtrf = jnp.take(scene.mesh_transfo, prim, axis=0)
        if scene.flat_face:
            no_mesh = jnp.cross(B - A, C - A)
        else:
            PA, PB, PC = A - pl, B - pl, C - pl
            tA = jnp.linalg.norm(jnp.cross(PB, PC), axis=-1, keepdims=True)
            tB = jnp.linalg.norm(jnp.cross(PA, PC), axis=-1, keepdims=True)
            tC = jnp.linalg.norm(jnp.cross(PA, PB), axis=-1, keepdims=True)
            nA = jnp.take(scene.tri_na, tri, axis=0)
            nB = jnp.take(scene.tri_nb, tri, axis=0)
            nC = jnp.take(scene.tri_nc, tri, axis=0)
            no_mesh = nA * tA + nB * tB + nC * tC
        n_mesh = normalize(transform_point(mtrf, pl + no_mesh) - pg)
        n = jnp.where((shape == CODE_MESH)[..., None], n_mesh, n_analytic)
    else:
        n = n_analytic

    # --- stale-on-miss ---------------------------------------------------
    is_hit = (shape >= 0)[..., None]
    if prev_n is None:
        prev_n = jnp.zeros_like(n)
    if prev_p is None:
        prev_p = jnp.zeros_like(pg)
    return jnp.where(is_hit, n, prev_n), jnp.where(is_hit, pg, prev_p)


# ---------------------------------------------------------------------------
# SoA intersection_info (vec3 = tuple of [M] arrays) — the SoA twin
# of the function above; used by the SoA integrator. Same formulas.
# ---------------------------------------------------------------------------

def _affine2d(rows, v):
    """Affine transform of points by per-ray GATHERED rows, entirely in
    2-D tiled space. rows: [12, M] (affine_rows gathered per ray), v:
    [3, M]. Returns [3, M].

    Why not ops.vec.apply_affine: slicing the twelve [M] rows out of the
    T(8,128)-tiled gather output forces a T(1024) relayout per row —
    measured ~0.08 ms per row at 131K rays, and the shading path had ~40
    such rows per bounce (profiled at >50% of the whole mesh-scene pass,
    round 4). Keeping every operand >= 2-D lets XLA fuse with zero
    layout conversion; the single [3, M] result is unstacked once."""
    r = rows.reshape(3, 4, rows.shape[1])
    return jnp.sum(r[:, :3, :] * v[None], axis=1) + r[:, 3, :]


def _norm2d(v, eps=1e-30):
    """Normalize [3, M] columns (2-D twin of vec.normalize)."""
    n = jnp.sqrt(jnp.sum(v * v, axis=0, keepdims=True))
    return v / jnp.maximum(n, jnp.float32(eps))


def _cross2d(a, b):
    """Cross product of [3, M] columns via a row roll (2-D, no slices
    back to 1-D)."""
    a1 = jnp.roll(a, -1, axis=0)
    a2 = jnp.roll(a, -2, axis=0)
    b1 = jnp.roll(b, -1, axis=0)
    b2 = jnp.roll(b, -2, axis=0)
    return a1 * b2 - a2 * b1


def intersection_info_soa(scene, hit, prev=None):
    """hit: ops.trace.HitS. Returns (n vec3, p vec3); keeps prev on miss.

    All row-matrix math (gathered transforms, triangle corners/normals)
    runs in 2-D tiled [k, M] space — see _affine2d for why."""
    from . import vec

    prim = jnp.clip(hit.prim, 0, scene.nb_prims - 1)
    # ONE per-prim gather for both transform tables (each gather is a
    # fixed ~0.25 ms custom-call at 131K rays regardless of table size —
    # merging tables halves the count)
    if scene.tri_va.shape[0] > 0:
        both = jnp.concatenate([vec.affine_rows(scene.transfo),
                                vec.affine_rows(scene.mesh_transfo)],
                               axis=0)                   # [24, P]
        rows24 = jnp.take(both, prim, axis=1)
        trf_rows, mrows = rows24[0:12], rows24[12:24]
    else:
        trf_rows = jnp.take(vec.affine_rows(scene.transfo), prim, axis=1)
    pl, pg = hit.pl, hit.pg
    shape = hit.shape
    dircode = hit.dircode
    m = pl[0].shape[0]
    pl2 = jnp.stack(pl)                  # [3, M] (one 1D->2D conversion)
    pg2 = jnp.stack(pg)
    rowi = jnp.arange(3, dtype=jnp.int32)[:, None]          # [3, 1]
    e_z = (rowi == 2).astype(jnp.float32)                   # [3, 1]
    mask_xy = (rowi < 2).astype(jnp.float32)

    # cube: axis = dir//2, sign from dir%2 -> sg on row ax, 0 elsewhere
    sg = jnp.where(dircode % 2 != 0, 1.0, -1.0)[None, :]    # [1, M]
    no_cube = jnp.where((dircode // 2)[None, :] == rowi, sg, 0.0)
    # cylinder: caps (0, 0, +-1); side (pl.xy, 0)
    cap = (dircode < 2)[None, :]
    no_cyl = jnp.where(cap, e_z * sg, pl2 * mask_xy)
    # cone: bottom cap (0,0,-1); side (pl.xy, |pl.xy|/2)
    rxy = jnp.sqrt(jnp.sum((pl2 * mask_xy) ** 2, axis=0, keepdims=True))
    bot = (dircode == 0)[None, :]
    no_cone = jnp.where(bot, -e_z, pl2 * mask_xy + e_z * (rxy / 2.0))
    no_quad = e_z

    sh = shape[None, :]
    no = jnp.where(sh == CODE_CUBE, no_cube,
                   jnp.where(sh == CODE_CYLINDER, no_cyl,
                             jnp.where(sh == CODE_CONE, no_cone, no_quad)))
    point = jnp.where(sh == CODE_SPHERE, 2.0 * pl2, pl2 + no)
    n2 = _norm2d(_affine2d(trf_rows, point) - pg2)
    cone_zero = (shape == CODE_CONE) & (dircode == 1)
    n2 = jnp.where(cone_zero[None, :], 0.0, n2)

    if scene.tri_va.shape[0] > 0:
        tri = jnp.clip(hit.tri, 0, scene.tri_va.shape[0] - 1)
        # ONE row-form gather per table ([9, T] take along axis 1)
        # instead of 18 separate 1-D takes (see device.py)
        if scene.flat_face:
            pr = jnp.take(scene.tri_pos_rows, tri, axis=1)   # [9, M]
            A, B, C = pr[0:3], pr[3:6], pr[6:9]              # [3, M]
            no_mesh = _cross2d(B - A, C - A)
        else:
            # one merged [18, T] gather for corners + vertex normals
            pn = jnp.take(jnp.concatenate(
                [scene.tri_pos_rows, scene.tri_norm_rows], axis=0),
                tri, axis=1)                                 # [18, M]
            A, B, C = pn[0:3], pn[3:6], pn[6:9]
            PA, PB, PC = A - pl2, B - pl2, C - pl2
            def _len(v):
                return jnp.sqrt(jnp.sum(v * v, axis=0, keepdims=True))
            tA = _len(_cross2d(PB, PC))
            tB = _len(_cross2d(PA, PC))
            tC = _len(_cross2d(PA, PB))
            no_mesh = pn[9:12] * tA + pn[12:15] * tB + pn[15:18] * tC
        n_mesh2 = _norm2d(_affine2d(mrows, pl2 + no_mesh) - pg2)
        n2 = jnp.where((shape == CODE_MESH)[None, :], n_mesh2, n2)

    n = (n2[0], n2[1], n2[2])            # one 2D->1D conversion
    is_hit = shape >= 0
    if prev is None:
        z = jnp.zeros((m,), jnp.float32)
        zz = (z, z, z)
        prev = (zz, zz)
    return vec.where(is_hit, n, prev[0]), vec.where(is_hit, pg, prev[1])
