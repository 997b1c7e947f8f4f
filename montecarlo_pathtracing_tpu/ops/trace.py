"""Scene-level trace: fold every primitive group into a closest Hit.

The dense replacement for traverse_all_bvh / intersect_bvh
(shaders/raytracer_func.frag:731-781): instead of a per-ray stack walk over
the BVH heap, every ray is intersected against every primitive, grouped by
type so each shape test is branch-free, with transforms applied as batched
einsums and chunks folded by a running arg-min. This is the reference
route: it runs on every backend, is differentiable, and serves meshes.

Tie-breaking: a candidate replaces the best hit only if strictly closer in
WORLD distance (the GLSL compares `dist < closest.dist` per intersector);
fold order is group-by-type then chunk-ascending, first-lowest-index within
a chunk. The CPU oracle (testing/cpu_ref.py) uses the identical rule so
framework-vs-oracle parity is exact.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import vec
from .intersect import (
    Hit, FLT_MAX, SOA_FNS, miss_hit, trace_analytic_group, trace_mesh_instance)


def trace(scene, O, D) -> Hit:
    """Closest hit of world rays O, D: [N,3] against the whole scene."""
    best = miss_hit(O.shape[:-1])
    for gi, code in enumerate(scene.group_codes):
        best = trace_analytic_group(
            best, O, D, code,
            scene.group_transfo[gi], scene.group_inv[gi],
            scene.group_prim[gi], scene.group_chunk[gi],
        )
    for mi, prim_index in enumerate(scene.mesh_prim_index):
        off = scene.mesh_tri_offset[mi]
        cnt = scene.mesh_tri_padded[mi]
        chunk = min(scene.tri_chunk, cnt)
        best = trace_mesh_instance(
            best, O, D,
            scene.inv_transfo[prim_index], scene.mesh_transfo[prim_index],
            prim_index,
            scene.tri_va[off:off + cnt], scene.tri_vb[off:off + cnt],
            scene.tri_vc[off:off + cnt],
            tri_offset=off, chunk=chunk,
        )
    return best


def hit_any(scene, O, D):
    """Occlusion query (just_hit_bvh analog): True where any prim is hit."""
    return trace(scene, O, D).shape >= 0


# ---------------------------------------------------------------------------
# SoA hit record (vec3 = tuple of [M] arrays, see ops/vec.py), the layout
# the SoA integrator shades from.
# ---------------------------------------------------------------------------

class HitS(NamedTuple):
    """SoA closest-intersection record (Hit twin)."""
    dist: jnp.ndarray
    prim: jnp.ndarray
    shape: jnp.ndarray
    dircode: jnp.ndarray
    tri: jnp.ndarray
    pl: tuple       # vec3, local frame
    pg: tuple       # vec3, world frame

    @property
    def is_hit(self):
        return self.shape >= 0


def _miss_soa(m):
    z = jnp.zeros((m,), jnp.float32)
    mi = jnp.full((m,), -1, jnp.int32)
    return HitS(jnp.full((m,), FLT_MAX, jnp.float32), mi, mi, mi, mi,
                (z, z, z), (z, z, z))


def _better_soa(best: HitS, cand: HitS) -> HitS:
    take = cand.dist < best.dist
    return HitS(
        jnp.where(take, cand.dist, best.dist),
        jnp.where(take, cand.prim, best.prim),
        jnp.where(take, cand.shape, best.shape),
        jnp.where(take, cand.dircode, best.dircode),
        jnp.where(take, cand.tri, best.tri),
        vec.where(take, cand.pl, best.pl),
        vec.where(take, cand.pg, best.pg),
    )


def _small_group_soa(best: HitS, o, d, code, trf, inv, pid) -> HitS:
    """SoA fold over one analytic group: python loop over primitives,
    per-prim scalar matrix coefficients broadcast over [M] ray rows — the
    structure of the whole-pass kernel's fold (models/megakernel.py) in
    plain XLA. Same winners/ordering as trace_analytic_group
    (strictly-closer, group order); the tests use it to hold SOA_FNS to
    the AoS intersectors."""
    fn = SOA_FNS[code]
    m = o[0].shape[0]
    for i in range(trf.shape[0]):
        iv = inv[i]
        tf_ = trf[i]
        oi = (iv[0, 0] * o[0] + iv[0, 1] * o[1] + iv[0, 2] * o[2] + iv[0, 3],
              iv[1, 0] * o[0] + iv[1, 1] * o[1] + iv[1, 2] * o[2] + iv[1, 3],
              iv[2, 0] * o[0] + iv[2, 1] * o[1] + iv[2, 2] * o[2] + iv[2, 3])
        di = vec.normalize(
            (iv[0, 0] * d[0] + iv[0, 1] * d[1] + iv[0, 2] * d[2],
             iv[1, 0] * d[0] + iv[1, 1] * d[1] + iv[1, 2] * d[2],
             iv[2, 0] * d[0] + iv[2, 1] * d[1] + iv[2, 2] * d[2]),
            eps=1e-30)
        a, valid, dircode = fn(oi[0], oi[1], oi[2], di[0], di[1], di[2])
        valid = valid & (pid[i] >= 0)
        pl = vec.axpy(a, di, oi)
        pg = (tf_[0, 0] * pl[0] + tf_[0, 1] * pl[1] + tf_[0, 2] * pl[2] + tf_[0, 3],
              tf_[1, 0] * pl[0] + tf_[1, 1] * pl[1] + tf_[1, 2] * pl[2] + tf_[1, 3],
              tf_[2, 0] * pl[0] + tf_[2, 1] * pl[1] + tf_[2, 2] * pl[2] + tf_[2, 3])
        dist = jnp.where(valid, vec.length(vec.sub(o, pg)), FLT_MAX)
        cand = HitS(
            dist,
            jnp.where(valid, pid[i], -1).astype(jnp.int32),
            jnp.where(valid, code, -1).astype(jnp.int32),
            dircode,
            jnp.full((m,), -1, jnp.int32),
            pl, pg,
        )
        best = _better_soa(best, cand)
    return best
