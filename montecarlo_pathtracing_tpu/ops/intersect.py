"""Ray/primitive intersection — the dense formulation.

Semantics match the reference GLSL intersectors
(shaders/raytracer_func.frag:354-705): every primitive is intersected in
its canonical local frame (ray mapped by the inverse transform, direction
re-normalized), and the winning hit is chosen by WORLD-space distance
|O_world - P_world| because local scales differ per primitive.

The dense formulation replaces the per-thread BVH stack walk with
[ray_tile, prim_chunk] batch intersection: primitives are grouped by type
(so each test is branch-free), transforms are applied as batched einsums,
and chunks are folded with a running arg-min via lax.scan — see SURVEY.md
§7 "Hard parts". The SoA forms below (SOA_FNS) are the same tests over
separate component arrays, which the whole-pass kernel folds with.

Reference quirks preserved on purpose (the quirks are the spec):
  - OrientedQuad is one-sided (rejects D.z > -EPS) and has NO a>0 check
    (raytracer_func.frag:443-470).
  - Cylinder side uses only the near quadratic root (:549).
  - Cone has the fixed 0.8 half-angle factor and no t>EPS check on the
    side roots (:599-621).
  - EPSILON = 1e-10, strict/nonstrict comparisons as in the GLSL.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.transforms import normalize, PRECISION

EPSILON = np.float32(1e-10)
FLT_MAX = np.float32(3.402823e38)


def _safe_sqrt(x, pos):
    """sqrt guarded for reverse-mode: d(sqrt)/dx is infinite at x == 0
    and jnp.where passes untaken-branch NaNs through AD. `pos` is the
    validity mask under which the sqrt value is actually consumed;
    forward values are identical (guarded lanes return 0, exactly what
    sqrt(max(x, 0)) produced there). Needed because the dense trace IS
    differentiated — the IOR gradient's geometric term flows through
    refraction exit points into these intersectors."""
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def _safe_div(num, den, ok):
    """num/den with the denominator where-guarded to 1 outside `ok`
    (the validity mask that already excludes den ~ 0). Forward-identical
    where consumed; keeps 1/0 = inf out of the AD graph."""
    return num / jnp.where(ok, den, 1.0)

# primitive type codes (raytracer_func.frag:38-43)
CODE_MESH = 0
CODE_SPHERE = 1
CODE_CUBE = 2
CODE_CYLINDER = 3
CODE_CONE = 4
CODE_ORIENTED_QUAD = 5


class Hit(NamedTuple):
    """Closest-intersection record, one per ray (sInter analog,
    raytracer_func.frag:257-267). All arrays share leading ray dims."""
    dist: jnp.ndarray      # world distance, FLT_MAX if miss
    pl: jnp.ndarray        # local-frame hit point [..., 3]
    pg: jnp.ndarray        # world-frame hit point [..., 3]
    prim: jnp.ndarray      # primitive index, -1 if miss (int32)
    shape: jnp.ndarray     # type code, -1 if miss (int32)
    dircode: jnp.ndarray   # face code for cube/cyl/cone (int32)
    tri: jnp.ndarray       # global triangle index for mesh hits (int32)

    @property
    def is_hit(self):
        return self.shape >= 0


def miss_hit(shape_prefix):
    z3 = jnp.zeros(shape_prefix + (3,), jnp.float32)
    mi = jnp.full(shape_prefix, -1, jnp.int32)
    return Hit(
        dist=jnp.full(shape_prefix, FLT_MAX, jnp.float32),
        pl=z3, pg=z3, prim=mi, shape=mi,
        dircode=mi, tri=mi,
    )


# ---------------------------------------------------------------------------
# Local-frame shape tests. Each takes local O, D ([..., 3], D normalized)
# and returns (a, valid, dircode): ray parameter along D, hit mask, face code.
# ---------------------------------------------------------------------------

def sphere_local(O, D):
    """Unit sphere, both roots (raytracer_func.frag:398-441)."""
    OO = jnp.sum(O * O, -1)
    OD = jnp.sum(O * D, -1)
    D2 = jnp.sum(D * D, -1)
    delta4 = OD * OD - D2 * (OO - 1.0)
    ok = delta4 > 0.0
    sq = _safe_sqrt(delta4, ok)
    a1 = -(OD + sq) / D2
    a2 = -(OD - sq) / D2
    v1 = ok & (a1 > EPSILON)
    v2 = ok & (a2 > EPSILON)
    a = jnp.where(v1, a1, jnp.where(v2, a2, FLT_MAX))
    return a, v1 | v2, jnp.zeros(a.shape, jnp.int32)


def quad_local(O, D):
    """One-sided unit quad at z=0 (raytracer_func.frag:443-470).
    Quirk: no positivity check on a."""
    facing = D[..., 2] <= -EPSILON
    a = _safe_div(-O[..., 2], D[..., 2], facing)
    px = O[..., 0] + a * D[..., 0]
    py = O[..., 1] + a * D[..., 1]
    inside = (jnp.abs(px) <= 1.0) & (jnp.abs(py) <= 1.0)
    valid = facing & inside
    return jnp.where(valid, a, FLT_MAX), valid, jnp.zeros(a.shape, jnp.int32)


def _slab6(O, D):
    """Shared 6-face slab test for the unit cube (also used by the BV test).
    Returns (a_min, face, any_valid)."""
    al = jnp.full(O.shape[:-1], FLT_MAX, jnp.float32)
    face = jnp.zeros(O.shape[:-1], jnp.int32)
    for c in range(6):
        c0 = c // 2
        c1 = (c0 + 1) % 3
        c2 = (c0 + 2) % 3
        cd = np.float32(-1.0 + 2.0 * (c % 2))
        dc = D[..., c0]
        dc_ok = jnp.abs(dc) > EPSILON
        a = _safe_div(cd - O[..., c0], dc, dc_ok)
        v = (
            dc_ok
            & (a > EPSILON)
            & (jnp.abs(O[..., c1] + a * D[..., c1]) <= 1.0)
            & (jnp.abs(O[..., c2] + a * D[..., c2]) <= 1.0)
            & (a < al)
        )
        al = jnp.where(v, a, al)
        face = jnp.where(v, c, face)
    return al, face, al < FLT_MAX


def cube_local(O, D):
    """Unit cube via 6 slabs (raytracer_func.frag:472-512)."""
    al, face, valid = _slab6(O, D)
    return al, valid, face


def cylinder_local(O, D):
    """Unit z-cylinder: caps then side, near root only
    (raytracer_func.frag:515-577)."""
    al = jnp.full(O.shape[:-1], FLT_MAX, jnp.float32)
    cl = jnp.full(O.shape[:-1], -1, jnp.int32)
    dz_ok = jnp.abs(D[..., 2]) > EPSILON
    for code, zplane in ((0, -1.0), (1, 1.0)):
        a = _safe_div(np.float32(zplane) - O[..., 2], D[..., 2], dz_ok)
        rx = O[..., 0] + a * D[..., 0]
        ry = O[..., 1] + a * D[..., 1]
        v = dz_ok & (a > EPSILON) & (rx * rx + ry * ry < 1.0) & (a < al)
        al = jnp.where(v, a, al)
        cl = jnp.where(v, code, cl)
    O2 = O[..., 0] ** 2 + O[..., 1] ** 2
    OD = O[..., 0] * D[..., 0] + O[..., 1] * D[..., 1]
    D2 = D[..., 0] ** 2 + D[..., 1] ** 2
    delta4 = OD * OD - D2 * (O2 - 1.0)
    pos = delta4 > 0.0
    a = _safe_div(-(OD + _safe_sqrt(delta4, pos)), D2, pos)
    z = O[..., 2] + a * D[..., 2]
    v = pos & (a > EPSILON) & (a < al) & (jnp.abs(z) < 1.0)
    al = jnp.where(v, a, al)
    cl = jnp.where(v, 2, cl)
    return al, al < FLT_MAX, cl


def cone_local(O, D):
    """Unit cone, apex at z=1, 0.8 slope factor
    (raytracer_func.frag:579-640). Quirk: side roots have no t>EPS check."""
    tl = jnp.full(O.shape[:-1], FLT_MAX, jnp.float32)
    cl = jnp.full(O.shape[:-1], -1, jnp.int32)
    # bottom cap
    dz_ok = jnp.abs(D[..., 2]) > EPSILON
    t0 = _safe_div(-1.0 - O[..., 2], D[..., 2], dz_ok)
    rx = O[..., 0] + t0 * D[..., 0]
    ry = O[..., 1] + t0 * D[..., 1]
    v = (
        dz_ok
        & (t0 > EPSILON)
        & (rx * rx + ry * ry < 1.0)
        & (t0 < tl)
    )
    tl = jnp.where(v, t0, tl)
    cl = jnp.where(v, 0, cl)
    # side
    coz = O[..., 2] - 1.0
    dco = D[..., 0] * O[..., 0] + D[..., 1] * O[..., 1] + D[..., 2] * coz
    coco = O[..., 0] ** 2 + O[..., 1] ** 2 + coz * coz
    a = D[..., 2] * D[..., 2] - np.float32(0.8)
    b = 2.0 * (D[..., 2] * coz - dco * np.float32(0.8))
    c = coz * coz - coco * np.float32(0.8)
    det = b * b - 4.0 * a * c
    pos = det > 0.0
    sq = _safe_sqrt(det, pos)
    # guard only on det > 0: the reference divides by 2a unguarded (a == 0
    # means dz^2 == 0.8 exactly), so keep that forward behavior bit-exact
    t1 = _safe_div(-b - sq, 2.0 * a, pos)
    t2 = _safe_div(-b + sq, 2.0 * a, pos)
    t1 = jnp.where(jnp.abs(O[..., 2] + t1 * D[..., 2]) > 1.0, FLT_MAX, t1)
    t2 = jnp.where(jnp.abs(O[..., 2] + t2 * D[..., 2]) > 1.0, FLT_MAX, t2)
    t = jnp.minimum(t1, t2)
    v = pos & (t < tl)
    tl = jnp.where(v, t, tl)
    cl = jnp.where(v, 2, cl)
    return tl, tl < FLT_MAX, cl


SHAPE_FNS = {
    CODE_SPHERE: sphere_local,
    CODE_CUBE: cube_local,
    CODE_CYLINDER: cylinder_local,
    CODE_CONE: cone_local,
    CODE_ORIENTED_QUAD: quad_local,
}


# ---------------------------------------------------------------------------
# SoA shape tests: the same intersectors over separate x/y/z component
# arrays (any matching shapes). Each returns (a, valid, dircode) given
# local-frame ray components. Mirrors the AoS tests above exactly, minus
# the reverse-mode guards (the SoA forms are never differentiated).
# ---------------------------------------------------------------------------

def sphere_soa(ox, oy, oz, dx, dy, dz):
    OO = ox * ox + oy * oy + oz * oz
    OD = ox * dx + oy * dy + oz * dz
    D2 = dx * dx + dy * dy + dz * dz
    delta4 = OD * OD - D2 * (OO - 1.0)
    sq = jnp.sqrt(jnp.maximum(delta4, 0.0))
    a1 = -(OD + sq) / D2
    a2 = -(OD - sq) / D2
    ok = delta4 > 0.0
    v1 = ok & (a1 > EPSILON)
    v2 = ok & (a2 > EPSILON)
    a = jnp.where(v1, a1, jnp.where(v2, a2, FLT_MAX))
    return a, v1 | v2, jnp.zeros_like(a, jnp.int32)


def quad_soa(ox, oy, oz, dx, dy, dz):
    facing = dz <= -EPSILON
    a = -oz / dz
    px = ox + a * dx
    py = oy + a * dy
    inside = (jnp.abs(px) <= 1.0) & (jnp.abs(py) <= 1.0)
    valid = facing & inside
    return jnp.where(valid, a, FLT_MAX), valid, jnp.zeros_like(a, jnp.int32)


def cube_soa(ox, oy, oz, dx, dy, dz):
    o = (ox, oy, oz)
    d = (dx, dy, dz)
    al = jnp.full_like(ox, FLT_MAX)
    face = jnp.zeros_like(ox, jnp.int32)
    for c in range(6):
        c0 = c // 2
        c1 = (c0 + 1) % 3
        c2 = (c0 + 2) % 3
        cd = np.float32(-1.0 + 2.0 * (c % 2))
        a = (cd - o[c0]) / d[c0]
        v = (
            (jnp.abs(d[c0]) > EPSILON)
            & (a > EPSILON)
            & (jnp.abs(o[c1] + a * d[c1]) <= 1.0)
            & (jnp.abs(o[c2] + a * d[c2]) <= 1.0)
            & (a < al)
        )
        al = jnp.where(v, a, al)
        face = jnp.where(v, c, face)
    return al, al < FLT_MAX, face


def cylinder_soa(ox, oy, oz, dx, dy, dz):
    al = jnp.full_like(ox, FLT_MAX)
    cl = jnp.full_like(ox, -1, jnp.int32)
    dz_ok = jnp.abs(dz) > EPSILON
    for code, zplane in ((0, -1.0), (1, 1.0)):
        a = (np.float32(zplane) - oz) / dz
        rx = ox + a * dx
        ry = oy + a * dy
        v = dz_ok & (a > EPSILON) & (rx * rx + ry * ry < 1.0) & (a < al)
        al = jnp.where(v, a, al)
        cl = jnp.where(v, code, cl)
    O2 = ox * ox + oy * oy
    OD = ox * dx + oy * dy
    D2 = dx * dx + dy * dy
    delta4 = OD * OD - D2 * (O2 - 1.0)
    a = -(OD + jnp.sqrt(jnp.maximum(delta4, 0.0))) / D2
    z = oz + a * dz
    v = (delta4 > 0.0) & (a > EPSILON) & (a < al) & (jnp.abs(z) < 1.0)
    al = jnp.where(v, a, al)
    cl = jnp.where(v, 2, cl)
    return al, al < FLT_MAX, cl


def cone_soa(ox, oy, oz, dx, dy, dz):
    tl = jnp.full_like(ox, FLT_MAX)
    cl = jnp.full_like(ox, -1, jnp.int32)
    t0 = (-1.0 - oz) / dz
    rx = ox + t0 * dx
    ry = oy + t0 * dy
    v = ((jnp.abs(dz) > EPSILON) & (t0 > EPSILON)
         & (rx * rx + ry * ry < 1.0) & (t0 < tl))
    tl = jnp.where(v, t0, tl)
    cl = jnp.where(v, 0, cl)
    coz = oz - 1.0
    dco = dx * ox + dy * oy + dz * coz
    coco = ox * ox + oy * oy + coz * coz
    a_ = dz * dz - np.float32(0.8)
    b_ = 2.0 * (dz * coz - dco * np.float32(0.8))
    c_ = coz * coz - coco * np.float32(0.8)
    det = b_ * b_ - 4.0 * a_ * c_
    sq = jnp.sqrt(jnp.maximum(det, 0.0))
    t1 = (-b_ - sq) / (2.0 * a_)
    t2 = (-b_ + sq) / (2.0 * a_)
    t1 = jnp.where(jnp.abs(oz + t1 * dz) > 1.0, FLT_MAX, t1)
    t2 = jnp.where(jnp.abs(oz + t2 * dz) > 1.0, FLT_MAX, t2)
    t = jnp.minimum(t1, t2)
    v = (det > 0.0) & (t < tl)
    tl = jnp.where(v, t, tl)
    cl = jnp.where(v, 2, cl)
    return tl, tl < FLT_MAX, cl


SOA_FNS = {
    CODE_SPHERE: sphere_soa,
    CODE_CUBE: cube_soa,
    CODE_CYLINDER: cylinder_soa,
    CODE_CONE: cone_soa,
    CODE_ORIENTED_QUAD: quad_soa,
}


def triangle_batch(O, D, va, vb, vc):
    """Moller-Trumbore over a triangle chunk
    (raytracer_func.frag:354-396). O, D: [N, 3] mesh-local (D normalized);
    va/vb/vc: [C, 3]. Returns (a [N, C], valid [N, C])."""
    edge1 = vb - va            # [C,3]
    edge2 = vc - va
    h = jnp.cross(D[:, None, :], edge2[None, :, :])      # [N,C,3]
    det = jnp.sum(edge1[None] * h, -1)                   # [N,C]
    det_ok = jnp.abs(det) >= EPSILON
    inv_det = _safe_div(jnp.ones_like(det), det, det_ok)
    s = O[:, None, :] - va[None]                         # [N,C,3]
    u = jnp.sum(s * h, -1) * inv_det
    q = jnp.cross(s, edge1[None, :, :])
    v = jnp.sum(D[:, None, :] * q, -1) * inv_det
    a = jnp.sum(edge2[None] * q, -1) * inv_det
    valid = (
        (jnp.abs(det) >= EPSILON)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (a > EPSILON)
    )
    return jnp.where(valid, a, FLT_MAX), valid


# ---------------------------------------------------------------------------
# Dense typed-batch trace
# ---------------------------------------------------------------------------

def _local_rays(inv_c, O, D):
    """Map world rays into each primitive's local frame.

    inv_c: [C,4,4]; O, D: [N,3]. Returns Oi, Di (normalized): [N,C,3].
    Batched einsum (intersect_prim analog, raytracer_func.frag:686-688).
    """
    Oi = jnp.einsum("cij,nj->nci", inv_c[:, :3, :3], O, precision=PRECISION) + inv_c[None, :, :3, 3]
    Di = jnp.einsum("cij,nj->nci", inv_c[:, :3, :3], D, precision=PRECISION)
    return Oi, normalize(Di)


def _better(best: Hit, cand: Hit) -> Hit:
    take = cand.dist < best.dist
    t3 = take[..., None]
    return Hit(
        dist=jnp.where(take, cand.dist, best.dist),
        pl=jnp.where(t3, cand.pl, best.pl),
        pg=jnp.where(t3, cand.pg, best.pg),
        prim=jnp.where(take, cand.prim, best.prim),
        shape=jnp.where(take, cand.shape, best.shape),
        dircode=jnp.where(take, cand.dircode, best.dircode),
        tri=jnp.where(take, cand.tri, best.tri),
    )


def trace_analytic_group(best: Hit, O, D, shape_code: int,
                         transfo, inv, prim_idx, chunk: int) -> Hit:
    """Fold one homogeneous type group into the running best hit.

    transfo/inv: [P,4,4] (P a multiple of `chunk`), prim_idx: [P] int32
    with -1 padding. O, D: [N,3] world rays.
    """
    fn = SHAPE_FNS[shape_code]
    P = transfo.shape[0]
    nchunks = P // chunk
    trf_s = transfo.reshape(nchunks, chunk, 4, 4)
    inv_s = inv.reshape(nchunks, chunk, 4, 4)
    idx_s = prim_idx.reshape(nchunks, chunk)

    def body(carry, xs):
        trf_c, inv_c, idx_c = xs
        Oi, Di = _local_rays(inv_c, O, D)              # [N,C,3]
        a, valid, dircode = fn(Oi, Di)                 # [N,C]
        valid = valid & (idx_c >= 0)[None, :]
        pl = Oi + a[..., None] * Di
        pg = jnp.einsum("cij,ncj->nci", trf_c[:, :3, :3], pl, precision=PRECISION) \
            + trf_c[None, :, :3, 3]
        dist = jnp.linalg.norm(O[:, None, :] - pg, axis=-1)
        dist = jnp.where(valid, dist, FLT_MAX)
        # arg-min across the chunk
        j = jnp.argmin(dist, axis=1)                   # [N]
        n_ix = jnp.arange(O.shape[0])
        cand = Hit(
            dist=dist[n_ix, j],
            pl=pl[n_ix, j],
            pg=pg[n_ix, j],
            prim=idx_c[j],
            shape=jnp.full(j.shape, shape_code, jnp.int32),
            dircode=dircode[n_ix, j],
            tri=jnp.full(j.shape, -1, jnp.int32),
        )
        return _better(carry, cand), None

    if nchunks == 1:
        best, _ = body(best, (trf_s[0], inv_s[0], idx_s[0]))
        return best
    best, _ = jax.lax.scan(body, best, (trf_s, inv_s, idx_s))
    return best


def trace_mesh_instance(best: Hit, O, D, inv, mesh_transfo, prim_index: int,
                        va, vb, vc, tri_offset: int, chunk: int) -> Hit:
    """Fold one mesh instance (all its triangles) into the running best.

    inv / mesh_transfo: [4,4] single matrices for this instance
    (Mesh_intersect analog, raytracer_func.frag:642-678 — rays move to
    mesh-local space once, hits map back through the mesh transform, and
    the distance compare stays in world space).
    va/vb/vc: [T,3] padded to chunk multiple (padding = degenerate tris).
    """
    Oi = jnp.matmul(O, inv[:3, :3].T, precision=PRECISION) + inv[:3, 3]
    Di = normalize(jnp.matmul(D, inv[:3, :3].T, precision=PRECISION))
    T = va.shape[0]
    nchunks = T // chunk
    va_s = va.reshape(nchunks, chunk, 3)
    vb_s = vb.reshape(nchunks, chunk, 3)
    vc_s = vc.reshape(nchunks, chunk, 3)

    def body(carry, xs):
        va_c, vb_c, vc_c, cidx = xs
        a, valid = triangle_batch(Oi, Di, va_c, vb_c, vc_c)   # [N,C]
        pl = Oi[:, None, :] + a[..., None] * Di[:, None, :]
        pg = jnp.einsum("ij,ncj->nci", mesh_transfo[:3, :3], pl, precision=PRECISION) \
            + mesh_transfo[:3, 3]
        dist = jnp.linalg.norm(O[:, None, :] - pg, axis=-1)
        dist = jnp.where(valid, dist, FLT_MAX)
        j = jnp.argmin(dist, axis=1)
        n_ix = jnp.arange(O.shape[0])
        cand = Hit(
            dist=dist[n_ix, j],
            pl=pl[n_ix, j],
            pg=pg[n_ix, j],
            prim=jnp.full(j.shape, prim_index, jnp.int32),
            shape=jnp.full(j.shape, CODE_MESH, jnp.int32),
            dircode=jnp.zeros(j.shape, jnp.int32),
            tri=(tri_offset + cidx * chunk + j).astype(jnp.int32),
        )
        return _better(carry, cand), None

    cidx = jnp.arange(nchunks, dtype=jnp.int32)
    if nchunks == 1:
        best, _ = body(best, (va_s[0], vb_s[0], vc_s[0], cidx[0]))
        return best
    best, _ = jax.lax.scan(body, best, (va_s, vb_s, vc_s, cidx))
    return best
