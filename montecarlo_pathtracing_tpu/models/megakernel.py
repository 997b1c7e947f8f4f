"""Whole-pass path-tracing kernel: the full bounce loop in one Pallas call.

The dense route (models/montecarlo.py over ops/trace.py) runs every
bounce as a chain of XLA fusions, so the ~20 per-ray state arrays and the
winner attributes of each closest-hit fold round-trip through device
memory many times per bounce. This kernel fuses the ENTIRE pass:

    rgb = megakernel(d, uv)      # one pallas_call, rays in, rgb out

It is written for Pallas through Triton and runs one ray per GPU thread,
the shape of the reference's fragment shader (tp/montecarlo.frag): a 1-D
block of BLOCK rays per program, a grid over ray blocks, and every
per-ray value (xxhash32 counters, hemisphere sampling, the closest-hit
fold, normal reconstruction, the material cases, the progressive-seed
schedule) held in registers as loop carries. Device-memory traffic is
rays in (5 f32/ray) plus rgb out (3 f32/ray) plus the scene tables,
which every ray of a block reads at the same address (broadcast loads
served from L1/L2).

Scene representation: a flattened [38, P] table of per-prim scalars
(12 inverse-transform rows, 12 forward rows, shin/rough/emis, rgba, an
ok flag masking group-padding columns, and the prim's world AABB) with a
static (shape_code, start, count, super_start) descriptor per homogeneous
group. The closest-hit fold is scalar-over-prims x vector-over-rays (a
lax.fori_loop of ~120 ops per prim), and on scenes with
>= MEGA_CULL_MIN_PRIMS each prim is guarded by an AABB slab test against
the whole ray block (a block-uniform lax.cond skip), with a two-level
hierarchy of MEGA_SUPER-prim super boxes above it visited nearest-first —
frontier culling in place of the reference's per-ray BVH walk
(intersect_bvh, raytracer_func.frag:734-769).

The fold carries the winner's ATTRIBUTES (normal, hit point, material,
color) instead of its index, so shading needs no gathers — the analog of
the GLSL's global `closest_intersection` struct
(shaders/raytracer_func.frag:257-271,171-233).

Semantics are tp/montecarlo.frag:100-188 exactly, with the identical
masked-counter draw schedule as models/montecarlo.py — see that module
and models/montecarlo_aos.py for quirk commentary. Parity is asserted in
tests/test_megakernel.py against the dense route (interpret mode) and by
chip_smoke.py on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..ops.intersect import (
    FLT_MAX, CODE_SPHERE, CODE_CUBE, CODE_CYLINDER, CODE_CONE, SOA_FNS,
)
from ..ops import rng as _rng

# Measured on an H100 through Renderer.advance (benchmarks/kernel_sweep.py,
# PERF.md). Rays per program, one ray per thread: one warp. Smaller
# blocks cull more precisely (the block-uniform AABB skips) and diverge
# less: 32/1 is 1.65x faster than 128/4 on colonnes and ties on box_diffuse.
BLOCK = 32
NUM_WARPS = 1
N_ROWS = 38                # rows of the per-prim table (see _mega_table)
# AABB culling measured slower on the 9- and 14-prim boxes and 4x / 9x
# faster at 122 / 895 prims; the crossover lies between 14 and 122.
MEGA_CULL_MIN_PRIMS = 64
# prims per super box (the outer culling level): 16 beat 8 and 32 on
# materials and colonnes
MEGA_SUPER = 16

U32 = jnp.uint32
_ADV0 = np.uint32(_rng.ADVANCE[0])
_ADV1 = np.uint32(_rng.ADVANCE[1])
_ADV2 = np.uint32(_rng.ADVANCE[2])
_MANT = np.uint32(0x007FFFFF)
_ONEF = np.uint32(0x3F800000)
INF = np.float32(3e38)

PI = np.float32(2.0 * np.arccos(0.0))
BIAS = np.float32(1e-2)            # raytracer_func.frag:14
SKY_LOW = (0.5, 0.5, 0.9)          # tp/montecarlo.frag:119
SKY_HIGH = (1.0, 1.0, 0.8)


# --------------------------------------------------------------------------
# per-ray vec3 helpers (vec3 = tuple of [BLOCK] arrays)
# --------------------------------------------------------------------------

def _vwhere(m, a, b):
    return tuple(jnp.where(m, x, y) for x, y in zip(a, b))


def _vnorm(v, eps=0.0):
    n = jnp.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    if eps:
        n = jnp.maximum(n, np.float32(eps))
    return (v[0] / n, v[1] / n, v[2] / n)


def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _reflect(i, n):
    d2 = 2.0 * _vdot(n, i)
    return (i[0] - d2 * n[0], i[1] - d2 * n[1], i[2] - d2 * n[2])


def _refract_glsl(i, n, eta):
    ndi = _vdot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    c = eta * ndi + jnp.sqrt(jnp.maximum(k, 0.0))
    out = (eta * i[0] - c * n[0], eta * i[1] - c * n[1],
           eta * i[2] - c * n[2])
    z = jnp.zeros_like(out[0])
    return _vwhere(k < 0.0, (z, z, z), out)


def _block_any(mask):
    """Block-uniform OR of a per-ray mask (Triton lowers no reduce_or)."""
    return jnp.max(mask.astype(jnp.int32)) > 0


# --------------------------------------------------------------------------
# in-register xxhash32 RNG (bit-identical to ops/rng.py)
# --------------------------------------------------------------------------

def _hash_blocks(s0, s1, s2):
    P2, P3, P4, P5 = (np.uint32(2246822519), np.uint32(3266489917),
                      np.uint32(668265263), np.uint32(374761393))
    h = s2 + P5 + s0 * P3
    h = P4 * ((h << U32(17)) | (h >> U32(15)))
    h = h + s1 * P3
    h = P4 * ((h << U32(17)) | (h >> U32(15)))
    h = P2 * (h ^ (h >> U32(15)))
    h = P3 * (h ^ (h >> U32(13)))
    return h ^ (h >> U32(16))


def _draw(state, mask):
    """One masked draw: value for every lane, counter advance where mask."""
    s0, s1, s2 = state
    m = _hash_blocks(s0, s1, s2)
    m = (m & _MANT) | _ONEF
    f = jax.lax.bitcast_convert_type(m, jnp.float32) - np.float32(1.0)
    new = (s0 + _ADV0, s1 + _ADV1, s2 + _ADV2)
    state = tuple(jnp.where(mask, n, s) for n, s in zip(new, state))
    return f, state


def _random_ray(state, d, roughness, mask):
    """random_ray (tp/montecarlo.frag:49-89): ONB about d + Beckmann-ish
    hemisphere sample; exactly 2 masked draws."""
    w = _vnorm((d[0], d[1] + 5.0, d[2] + 3.0))
    u = _vnorm(_vcross(d, w))
    v = _vnorm(_vcross(d, u))
    alpha = roughness * roughness
    u1, state = _draw(state, mask)
    beta = 2.0 * PI * u1
    u2, state = _draw(state, mask)
    tan_theta2 = -(alpha * alpha) * jnp.log(1.0 - u2)
    cos_theta = 1.0 / jnp.sqrt(1.0 + tan_theta2)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    lx = jnp.cos(beta) * sin_theta
    ly = jnp.sin(beta) * sin_theta
    lz = cos_theta
    ln = jnp.sqrt(lx * lx + ly * ly + lz * lz)
    lx, ly, lz = lx / ln, ly / ln, lz / ln
    out = (u[0] * lx + v[0] * ly + d[0] * lz,
           u[1] * lx + v[1] * ly + d[1] * lz,
           u[2] * lx + v[2] * ly + d[2] * lz)
    return _vnorm(out), state


# --------------------------------------------------------------------------
# in-kernel closest-hit fold (scalar prims x vector rays)
# --------------------------------------------------------------------------

def _safe_rcp(x):
    """1/x with exact zeros clamped to a huge finite value (no inf*0=NaN
    in the AABB slab test; TIR refract rays carry exact-zero components)."""
    tiny = np.float32(1e-30)
    sgn = jnp.where(x < 0.0, np.float32(-1.0), np.float32(1.0))
    return sgn / jnp.maximum(jnp.abs(x), tiny)


def _slab(lo, hi, o, rd, best):
    """Per-ray: does the ray enter box [lo, hi] no farther than `best`?"""
    t0 = [(lo[k] - o[k]) * rd[k] for k in range(3)]
    t1 = [(hi[k] - o[k]) * rd[k] for k in range(3)]
    tmin = jnp.maximum(
        jnp.maximum(jnp.minimum(t0[0], t1[0]), jnp.minimum(t0[1], t1[1])),
        jnp.maximum(jnp.minimum(t0[2], t1[2]), 0.0))
    tmax = jnp.minimum(
        jnp.minimum(jnp.maximum(t0[0], t1[0]), jnp.maximum(t0[1], t1[1])),
        jnp.maximum(t0[2], t1[2]))
    return (tmax >= tmin) & (tmin <= best)


def _prim_candidate(code, tab, c, o, d):
    """World distance, shading normal and hit point of prim column c."""
    iv = [tab(r, c) for r in range(12)]
    tf = [tab(r + 12, c) for r in range(12)]
    # local-frame ray (scalar affine coefficients over the ray block)
    oi = (iv[0] * o[0] + iv[1] * o[1] + iv[2] * o[2] + iv[3],
          iv[4] * o[0] + iv[5] * o[1] + iv[6] * o[2] + iv[7],
          iv[8] * o[0] + iv[9] * o[1] + iv[10] * o[2] + iv[11])
    di = _vnorm((iv[0] * d[0] + iv[1] * d[1] + iv[2] * d[2],
                 iv[4] * d[0] + iv[5] * d[1] + iv[6] * d[2],
                 iv[8] * d[0] + iv[9] * d[1] + iv[10] * d[2]),
                eps=1e-30)
    a, valid, dircode = SOA_FNS[code](oi[0], oi[1], oi[2],
                                      di[0], di[1], di[2])
    plv = (oi[0] + a * di[0], oi[1] + a * di[1], oi[2] + a * di[2])
    pg = (tf[0] * plv[0] + tf[1] * plv[1] + tf[2] * plv[2] + tf[3],
          tf[4] * plv[0] + tf[5] * plv[1] + tf[6] * plv[2] + tf[7],
          tf[8] * plv[0] + tf[9] * plv[1] + tf[10] * plv[2] + tf[11])
    ex, ey, ez = o[0] - pg[0], o[1] - pg[1], o[2] - pg[2]
    dist = jnp.where(valid, jnp.sqrt(ex * ex + ey * ey + ez * ez), FLT_MAX)

    # shading normal (intersection_info, raytracer_func.frag:783-897);
    # dircode >= 0 wherever it is read, so // 2 and % 2 are bit ops
    odd = (dircode & 1) != 0
    if code == CODE_SPHERE:
        point = (2.0 * plv[0], 2.0 * plv[1], 2.0 * plv[2])
    elif code == CODE_CUBE:
        ax = dircode >> 1
        sg = jnp.where(odd, 1.0, -1.0)
        point = (plv[0] + jnp.where(ax == 0, sg, 0.0),
                 plv[1] + jnp.where(ax == 1, sg, 0.0),
                 plv[2] + jnp.where(ax == 2, sg, 0.0))
    elif code == CODE_CYLINDER:
        cap = dircode < 2
        zsg = jnp.where(odd, 1.0, -1.0)
        point = (plv[0] + jnp.where(cap, 0.0, plv[0]),
                 plv[1] + jnp.where(cap, 0.0, plv[1]),
                 plv[2] + jnp.where(cap, zsg, 0.0))
    elif code == CODE_CONE:
        rxy = jnp.sqrt(plv[0] * plv[0] + plv[1] * plv[1])
        bot = dircode == 0
        point = (plv[0] + jnp.where(bot, 0.0, plv[0]),
                 plv[1] + jnp.where(bot, 0.0, plv[1]),
                 plv[2] + jnp.where(bot, -1.0, rxy / 2.0))
    else:  # oriented quad
        point = (plv[0], plv[1], plv[2] + 1.0)
    tp = (tf[0] * point[0] + tf[1] * point[1] + tf[2] * point[2]
          + tf[3] - pg[0],
          tf[4] * point[0] + tf[5] * point[1] + tf[6] * point[2]
          + tf[7] - pg[1],
          tf[8] * point[0] + tf[9] * point[1] + tf[10] * point[2]
          + tf[11] - pg[2])
    nv = _vnorm(tp, eps=1e-30)
    if code == CODE_CONE:
        # cone top-"cap" quirk: N = 0 (raytracer_func.frag:850-853)
        z = jnp.zeros_like(nv[0])
        nv = _vwhere(dircode == 1, (z, z, z), nv)
    return dist, nv, pg


def _trace_fold(groups, tab, sbb, order, o, d, n_prev, p_prev, cull):
    """Fold every analytic prim into per-ray winner ATTRIBUTES.

    groups: static ((shape_code, start, count, super_start), ...);
    tab(r, c): the [38, P] prim table (rows 0-11 inv affine, 12-23 trf
    affine, 24 shin, 25 rough, 26 emis, 27-30 rgba, 31 ok flag — 0 marks
    group-padding columns, which must never hit — 32-37 world AABB
    min/max). Same winners as ops.trace._small_group_soa (strictly
    closer) up to exact distance ties, where the nearest-first super
    order may pick a different, equally close, winner. Returns (is_hit,
    N, P, shin, rough, emis, col3, alpha); on miss N, P keep (n_prev,
    p_prev) — the GLSL stale-output semantics that the refraction inner
    re-trace relies on (tp/montecarlo.frag:150-152).

    cull (static): skip a prim when no ray of the block can beat its
    current best inside the prim's world AABB — conservative, so winners
    are identical; directions must be unit (slab t == world distance).
    sbb(r, s) holds MEGA_SUPER-prim super boxes and order(k) this block's
    nearest-first visit order of them (_mega_super_order). Visiting near
    supers first tightens the running best early, so the prune rejects
    occluded far supers — the front-to-back effect of the reference's
    BVH walk. The order is a heuristic only: every super is still slab
    tested, so winners do not depend on it.
    """
    z = jnp.zeros_like(o[0])
    # winner: best dist, N (3), P (3), shin, rough, emis, rgba (4)
    win = (z + FLT_MAX, *n_prev, *p_prev, z, z, z, z, z, z, z + 1.0)
    if cull:
        rd = tuple(_safe_rcp(c) for c in d)

    def make_body(code, start):
        def prim_work(c, w):
            dist, nv, pg = _prim_candidate(code, tab, c, o, d)
            # the ok flag also guards the update, so a pad column never
            # wins even if a skip branch misbehaves
            take = (tab(31, c) > 0.0) & (dist < w[0])
            cand = (dist, *nv, *pg, *(tab(r, c) for r in range(24, 31)))
            return tuple(jnp.where(take, x, y) for x, y in zip(cand, w))

        def body(p, w):
            # p may be a clamped re-test of the group's last real prim
            # (super-loop edge); equal candidates never replace the
            # strictly-closer winner, so that is harmless by design
            c = start + p
            pred = tab(31, c) > 0.0        # group-padding columns never hit
            if cull:
                lo = tuple(tab(32 + k, c) for k in range(3))
                hi = tuple(tab(35 + k, c) for k in range(3))
                pred = pred & _block_any(_slab(lo, hi, o, rd, w[0]))
            return jax.lax.cond(pred, functools.partial(prim_work, c),
                                lambda w: w, w)

        return body

    for code, start, count, sstart in groups:
        body = make_body(code, start)
        if not cull:
            win = jax.lax.fori_loop(0, count, body, win)
            continue

        def super_body(spi, w, sstart=sstart, count=count, body=body):
            sp = order(sstart + spi)
            sc = sstart + sp
            lo = tuple(sbb(k, sc) for k in range(3))
            hi = tuple(sbb(3 + k, sc) for k in range(3))

            def visit(w):
                return jax.lax.fori_loop(
                    0, MEGA_SUPER,
                    lambda j, w: body(
                        jnp.minimum(sp * MEGA_SUPER + j, count - 1), w),
                    w)

            return jax.lax.cond(_block_any(_slab(lo, hi, o, rd, w[0])),
                                visit, lambda w: w, w)

        win = jax.lax.fori_loop(0, -(-count // MEGA_SUPER), super_body, win)
    is_hit = win[0] < FLT_MAX
    return (is_hit, win[1:4], win[4:7], win[7], win[8], win[9],
            win[10:13], win[13])


# --------------------------------------------------------------------------
# the per-bounce shading/material/RNG step
# --------------------------------------------------------------------------

def _bounce_step(trace_fn, has_transparent, ior,
                 o, d, attenu, total, result, done_i, state):
    """One bounce of tp/montecarlo.frag:109-176 on per-ray state.
    trace_fn(o, d, n_prev, p_prev) returns (is_hit, N, P, shin, rough,
    emis, col3, alpha) with GLSL stale-(N, P)-on-miss semantics; it is
    called a second time for the refraction march-through on transparent
    scenes. RNG draw schedule (2 + 1 + 2 masked draws) is bit-identical
    to models/montecarlo.py."""
    z = jnp.zeros_like(d[0])
    one = jnp.ones_like(d[0])
    unit_z = (z, z, one)
    done = done_i != 0
    is_hit, N, P, shin, rough, emis, col3, alpha = trace_fn(
        o, d, unit_z, (o[0] + d[0], o[1] + d[1], o[2] + d[2]))

    active = ~done
    miss_now = active & ~is_hit
    live = active & is_hit

    # sky fallback (:117-119)
    k = jnp.maximum(0.0, d[2])
    sky = tuple((1.0 - k) * lo + k * hi
                for lo, hi in zip(SKY_LOW, SKY_HIGH))
    result = _vwhere(
        miss_now,
        (total[0] + attenu[0] * sky[0], total[1] + attenu[1] * sky[1],
         total[2] + attenu[2] * sky[2]),
        result)
    done = done | miss_now

    # draws 1-2: the diffuse sample, every hit lane (:127)
    ray, state = _random_ray(state, N, 1.0 - rough, live)

    # Schlick from the IOR slider (:129)
    r0 = (ior - 1.0) / (ior + 1.0)
    r0 = r0 * r0
    xs = 1.0 - _vdot(N, d)
    x5 = xs * xs * xs * xs * xs
    rs = jnp.clip(r0 + (1.0 - r0) * x5, 0.0, 1.0)

    R = _reflect((-ray[0], -ray[1], -ray[2]), N)        # (:131)
    E = _vnorm((o[0] - P[0], o[1] - P[1], o[2] - P[2]), eps=1e-30)
    se = (1.0 - rough) * 100.0 + rough * 2.0            # (:133)
    spec = jnp.power(jnp.maximum(0.0, _vdot(E, R)), se)

    # ambient leak + emissive gather (:136)
    emit = emis * (1.0 - shin) * alpha
    total = _vwhere(
        live,
        (total[0] + col3[0] * 0.1 + attenu[0] * emit,
         total[1] + col3[1] * 0.1 + attenu[1] * emit,
         total[2] + col3[2] * 0.1 + attenu[2] * emit),
        total)

    # emissive termination (:139,174-175)
    emissive = emis > 0.5
    result = _vwhere(live & emissive, total, result)
    done = done | (live & emissive)
    cont = live & ~emissive

    refl_case = (shin > 0.0) & (alpha == 1.0)
    refr_case = (alpha < 1.0) & (shin == 0.0)
    mixed_case = (alpha < 1.0) & (shin > 0.0)

    # draw 3: the mixed-case coin (:155)
    coin, state = _draw(state, cont & mixed_case)
    choose_refl = refl_case | (mixed_case & (coin > 0.5))
    refr_lane = cont & (refr_case | (mixed_case & ~(coin > 0.5)))

    # draws 4-5: the reflect-branch sample (:143,158)
    rray, state = _random_ray(state, _reflect(d, N),
                              1.0 - shin * rough, cont & choose_refl)

    if has_transparent:
        # refraction march-through (:146-153); mixed keeps un-refracted D
        d_in = _vwhere(cont & refr_case, _refract_glsl(d, N, ior), d)
        d_in = _vwhere(refr_lane, d_in, unit_z)
        # park non-refracting lanes far above every prim AABB: their
        # inner-fold results are discarded below, and with culling on a
        # block whose lanes all parked fails every super/prim box test —
        # the second fold costs ~nothing unless rays actually refract
        o_in = _vwhere(refr_lane,
                       (P[0] - BIAS * N[0], P[1] - BIAS * N[1],
                        P[2] - BIAS * N[2]),
                       (o[0], o[1], z + np.float32(2.0e8)))
        _, N2r, P2r, *_unused = trace_fn(o_in, d_in, N, P)
        N2 = _vwhere(refr_lane, N2r, unit_z)
        P2 = _vwhere(refr_lane, P2r, P)
        d_exit = _refract_glsl(d_in, (-N2[0], -N2[1], -N2[2]), 1.0 / ior)
    else:
        N2, P2 = N, P
        d_exit = unit_z

    # attenuation updates (:142,147,161,170)
    base = (col3[0] * attenu[0], col3[1] * attenu[1],
            col3[2] * attenu[2])
    sm = tuple((1.0 - shin) * a_ + shin * c_
               for a_, c_ in zip(attenu, col3))
    arefl = tuple(b_ + (a_ * (alpha * rs * spec)) * m_
                  for b_, a_, m_ in zip(base, attenu, sm))
    arefr = tuple(b_ + (a_ * ((1.0 - alpha) * (1.0 - rs) * spec)) * m_
                  for b_, a_, m_ in zip(base, attenu, sm))
    adiff = tuple(b_ + (a_ * spec) * m_
                  for b_, a_, m_ in zip(base, attenu, sm))

    new_attenu = _vwhere(refr_lane, arefr,
                         _vwhere(choose_refl, arefl, adiff))
    new_o = _vwhere(
        refr_lane,
        (P2[0] + BIAS * N2[0], P2[1] + BIAS * N2[1],
         P2[2] + BIAS * N2[2]),
        (P[0] + BIAS * N[0], P[1] + BIAS * N[1], P[2] + BIAS * N[2]))
    new_d = _vwhere(refr_lane, d_exit, _vwhere(choose_refl, rray, ray))

    o = _vwhere(cont, new_o, o)
    d = _vwhere(cont, new_d, d)
    attenu = _vwhere(cont, new_attenu, attenu)
    return o, d, attenu, total, result, done.astype(jnp.int32), state


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def _mega_kernel(groups, nb_bounces, has_transparent, cull, n_cols, n_sup,
                 dx_ref, dy_ref, dz_ref, u_ref, v_ref,
                 fpar_ref, seed_ref, tab_ref, sbb_ref, ord_ref,
                 r_ref, g_ref, b_ref):
    # normalized here, not in XLA around the call, so the result does not
    # depend on how the surrounding program is fused (bit-stable under
    # shard_map and jit nesting)
    d = _vnorm((dx_ref[...], dy_ref[...], dz_ref[...]))
    z = jnp.zeros_like(d[0])
    o = (z + fpar_ref[0], z + fpar_ref[1], z + fpar_ref[2])
    ior = fpar_ref[3]
    row0 = pl.program_id(0) * n_sup

    def tab(r, c):
        return tab_ref[r * n_cols + c]

    def sbb(r, s):
        return sbb_ref[r * n_sup + s]

    def order(k):
        return ord_ref[row0 + k]

    # srand (integer-exact seed; ops/rng.srand_soa)
    state = (jax.lax.bitcast_convert_type(u_ref[...], U32),
             jnp.zeros_like(d[0], U32) + seed_ref[0],
             jax.lax.bitcast_convert_type(v_ref[...], U32))

    attenu = (z + 0.8, z + 0.8, z + 0.8)   # vec3(0.8) (:106-107)
    total = (z, z, z)
    result = (z, z, z)
    done_i = jnp.zeros_like(d[0], jnp.int32)

    def trace_fn(o, d, n_prev, p_prev):
        return _trace_fold(groups, tab, sbb, order, o, d, n_prev, p_prev,
                           cull)

    def bounce(_, c):
        return _bounce_step(trace_fn, has_transparent, ior, *c)

    carry = (o, d, attenu, total, result, done_i, state)
    carry = jax.lax.fori_loop(0, nb_bounces, bounce, carry)
    result, done_i = carry[4], carry[5]

    # bounce-cap exhaustion returns black (:178)
    done = done_i != 0
    r_ref[...] = jnp.where(done, result[0], 0.0)
    g_ref[...] = jnp.where(done, result[1], 0.0)
    b_ref[...] = jnp.where(done, result[2], 0.0)


# --------------------------------------------------------------------------
# host wrappers
# --------------------------------------------------------------------------

def mega_eligible(scene) -> bool:
    """Scenes the kernel can render: analytic prims only."""
    return not scene.mesh_prim_index


def _mega_meta(scene):
    """Static ((code, start, count, super_start), ...) over the scene's
    typed groups; super_start indexes the per-group MEGA_SUPER-prim
    super-box table (built by _mega_super_boxes, aligned with this
    layout). Returns (groups, total columns)."""
    groups = []
    start = 0
    sstart = 0
    for gi, code in enumerate(scene.group_codes):
        count = int(scene.group_prim[gi].shape[0])
        groups.append((int(code), start, count, sstart))
        start += count
        sstart += -(-count // MEGA_SUPER)
    return tuple(groups), start


def _mega_super_boxes(scene):
    """[6, n_supers] world AABBs over MEGA_SUPER-prim windows of each
    (Morton-ordered) group — the outer level of the kernel's frontier
    culling. Padding prims contribute empty boxes."""
    cols = []
    for gi in range(len(scene.group_codes)):
        pid = scene.group_prim[gi]
        ok = (pid >= 0)[:, None]
        bmn = jnp.where(ok, jnp.take(scene.prim_bb_min, pid, axis=0), INF)
        bmx = jnp.where(ok, jnp.take(scene.prim_bb_max, pid, axis=0), -INF)
        n = bmn.shape[0]
        pad = -(-n // MEGA_SUPER) * MEGA_SUPER
        bmn = jnp.concatenate([bmn, jnp.full((pad - n, 3), INF)])
        bmx = jnp.concatenate([bmx, jnp.full((pad - n, 3), -INF)])
        smn = bmn.reshape(-1, MEGA_SUPER, 3).min(axis=1)   # [S,3]
        smx = bmx.reshape(-1, MEGA_SUPER, 3).max(axis=1)
        cols.append(jnp.concatenate([smn, smx], axis=1))   # [S,6]
    return jnp.concatenate(cols, axis=0).T                 # [6, S_total]


def _cond_interval(a, b):
    """Feasible t >= 0 interval of a*t <= b (broadcastable arrays):
    returns (lo, hi); empty encoded as lo > hi."""
    pos = a > 0
    neg = a < 0
    zer = ~(pos | neg)
    ratio = b / jnp.where(zer, np.float32(1.0), a)
    lo = jnp.where(neg, jnp.maximum(ratio, 0.0), np.float32(0.0))
    hi = jnp.where(pos, ratio, INF)
    # a == 0: all t if b >= 0 else empty
    hi = jnp.where(zer & (b < 0), np.float32(-1.0), hi)
    return lo, hi


def _bundle_box_entry(bundles, boxes):
    """Conservative entry distance t_lo [ntiles, S] of each ray bundle
    into each box, INF where the bundle cannot reach the box.

    bundles: (olo, ohi, dlo, dhi), componentwise origin and direction
    intervals, each [3, ntiles]; boxes: [6, S] (rows 0-2 min, 3-5 max).
    Per axis c a contained ray's position interval at t >= 0 is
    [olo_c + t*dlo_c, ohi_c + t*dhi_c]; it can overlap [blo_c, bhi_c] iff
    dlo_c * t <= bhi_c - olo_c and -dhi_c * t <= ohi_c - blo_c. t_lo
    lower-bounds every contained ray's slab entry. Degenerate (padding)
    boxes with min > max are forced to INF."""
    olo, ohi, dlo, dhi = bundles
    t_lo = jnp.zeros((olo.shape[1], boxes.shape[1]), jnp.float32)
    t_hi = jnp.full_like(t_lo, INF)
    for c in range(3):
        blo = boxes[c][None, :]
        bhi = boxes[3 + c][None, :]
        lo1, hi1 = _cond_interval(dlo[c][:, None], bhi - olo[c][:, None])
        lo2, hi2 = _cond_interval(-dhi[c][:, None], ohi[c][:, None] - blo)
        t_lo = jnp.maximum(t_lo, jnp.maximum(lo1, lo2))
        t_hi = jnp.minimum(t_hi, jnp.minimum(hi1, hi2))
    real = jnp.all(boxes[0:3] <= boxes[3:6], axis=0)[None, :]
    return jnp.where((t_hi >= t_lo) & real, t_lo, INF)


def _mega_super_order(d_rows, o3, sbb, groups):
    """[ntiles, n_supers] i32: per ray-block visit order of each group's
    supers, nearest-first by the block's conservative bundle entry
    distance into the super box (primary rays share the pinhole origin,
    so the origin interval is degenerate). Order is group-relative within
    each group's slice of the table so the kernel's per-group fori_loop
    stays statically bound to its shape code. Unreachable supers sort
    last (their in-kernel slab tests fail anyway). Heuristic only — see
    _trace_fold."""
    nt = d_rows.shape[1] // BLOCK
    dt = d_rows.reshape(3, nt, BLOCK)
    olo = jnp.broadcast_to(o3[:, None], (3, nt))
    entry = _bundle_box_entry((olo, olo, dt.min(axis=2), dt.max(axis=2)),
                              sbb)                      # [nt, n_supers]
    cols = []
    for _, _, count, sstart in groups:
        nsup = -(-count // MEGA_SUPER)
        cols.append(jnp.argsort(entry[:, sstart:sstart + nsup], axis=1))
    return jnp.concatenate(cols, axis=1).astype(jnp.int32)


def _mega_table(scene):
    """[38, P] f32 prim-scalar table (device-side; cheap, built under jit).
    Rows 0-11 inverse affine, 12-23 forward affine, 24 shin, 25 rough,
    26 emis, 27-30 rgba, 31 ok (0 = group-padding column, never hit),
    32-34 world AABB min, 35-37 max (empty box for padding) — materials
    resolved per GLOBAL prim id."""
    cols = []
    for gi in range(len(scene.group_codes)):
        pid = scene.group_prim[gi]
        inv = scene.group_inv[gi][:, :3, :4].reshape(-1, 12)
        trf = scene.group_transfo[gi][:, :3, :4].reshape(-1, 12)
        m = jnp.take(scene.mat, pid, axis=0)       # [P,4]
        c = jnp.take(scene.color, pid, axis=0)     # [P,4]
        okr = (pid >= 0).astype(jnp.float32)[:, None]
        bmn = jnp.take(scene.prim_bb_min, pid, axis=0)
        bmx = jnp.take(scene.prim_bb_max, pid, axis=0)
        bmn = jnp.where(okr > 0, bmn, np.float32(1.0))
        bmx = jnp.where(okr > 0, bmx, np.float32(-1.0))
        cols.append(jnp.concatenate(
            [inv, trf, m[:, 0:1], m[:, 1:2], m[:, 2:3], c, okr, bmn, bmx],
            axis=1))
    return jnp.concatenate(cols, axis=0).T         # [38, P]


def _pad_rays(D, screen_tc, npad):
    """Direction rows [3, npad] (normalized inside the kernel) and u, v
    [npad]; padding rays point along +z with a zero seed (their results
    are dropped)."""
    n = D.shape[0]
    unit_z = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32),
                              (npad - n, 3))
    d_rows = jnp.concatenate([jnp.asarray(D, jnp.float32), unit_z]).T
    tc = jnp.concatenate([screen_tc, jnp.zeros((npad - n, 2), jnp.float32)])
    return d_rows, tc[:, 0], tc[:, 1]


@functools.partial(
    jax.jit, static_argnames=("groups", "nb_bounces", "has_transparent",
                              "cull", "interpret"))
def _mega_call(d_rows, u, v, fpar, seed, tab, sbb, ordr, groups,
               nb_bounces, has_transparent, cull=False, interpret=False):
    npad = d_rows.shape[1]
    ray = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = pl.no_block_spec
    kernel = functools.partial(_mega_kernel, groups, nb_bounces,
                               has_transparent, cull, tab.shape[1],
                               sbb.shape[1])
    r, g, b = pl.pallas_call(
        kernel,
        grid=(npad // BLOCK,),
        in_specs=[ray, ray, ray, ray, ray, whole, whole, whole, whole,
                  whole],
        out_specs=[ray, ray, ray],
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32)] * 3,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="megakernel",
    )(d_rows[0], d_rows[1], d_rows[2], u, v, fpar, seed, tab.reshape(-1),
      sbb.reshape(-1), ordr.reshape(-1))
    return r, g, b


def raytrace_mega(scene, O, D, screen_tc, pass_index, *, nb_bounces: int,
                  refract_ind, date=0.0, interpret: bool = False):
    """Whole-pass kernel twin of models.montecarlo.raytrace.

    O: [3] camera origin (the reference's pinhole model), D: [N,3] ray
    dirs (normalized inside the kernel), screen_tc: [N,2]. Returns rgb
    [N,3]. The super-box visit order is computed from D as given (a
    heuristic: camera rays are unit already).
    Bit-identical RNG schedule to the dense route; float results match to
    a few ulp (the kernel contracts multiply-adds differently from XLA).

    The kernel compiles only for a GPU. interpret=True runs it in the
    Pallas interpreter instead (tests on the CPU); asking for the
    compiled kernel on another backend raises.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the megakernel compiles only for a GPU backend (found "
            f"{jax.default_backend()!r}); pass interpret=True to run it "
            "in the Pallas interpreter")
    if not mega_eligible(scene):
        raise ValueError("the megakernel renders analytic scenes only")
    n = D.shape[0]
    npad = -(-n // BLOCK) * BLOCK
    d_rows, u, v = _pad_rays(D, screen_tc, npad)

    o3 = jnp.broadcast_to(jnp.asarray(O, jnp.float32), (3,))
    fpar = jnp.concatenate([o3, jnp.asarray(refract_ind, jnp.float32)[None]])
    # seed y = pass * GOLDEN + bits(date)  (ops/rng.srand_soa)
    seed = (jnp.asarray(pass_index).astype(U32) * U32(_rng.GOLDEN)
            + jax.lax.bitcast_convert_type(jnp.float32(date), U32))[None]

    groups, total = _mega_meta(scene)
    cull = total >= MEGA_CULL_MIN_PRIMS
    tab = _mega_table(scene)
    if cull:
        sbb = _mega_super_boxes(scene)
        ordr = _mega_super_order(d_rows, o3, sbb, groups)
    else:   # unread placeholders
        sbb = jnp.zeros((6, 1), jnp.float32)
        ordr = jnp.zeros((npad // BLOCK, 1), jnp.int32)
    r, g, b = _mega_call(d_rows, u, v, fpar, seed, tab, sbb, ordr, groups,
                         int(nb_bounces), scene.has_transparent, cull=cull,
                         interpret=interpret)
    return jnp.stack([r, g, b], axis=-1)[:n]
