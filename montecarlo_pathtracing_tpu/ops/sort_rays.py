"""Inter-bounce ray re-sorting: wavefront compaction for secondary rays.

The reference's BVH walk is per-ray, so incoherent bounce rays still get
log-depth traversal (shaders/raytracer_func.frag:734-769). A route that
culls per block of rays instead needs neighbouring rays to be coherent,
and after one diffuse bounce they are not. Between bounces this module
sorts the whole wavefront by a spatial key

    key = direction_octant (3 bits) << 27 | morton9(origin) (27 bits)

so each block holds rays leaving the same region of space in the same
direction octant. Terminated rays get key 0xFFFFFFFF and are PARKED on an
origin far outside every scene AABB pointing away (+z above everything),
so they compact into tail blocks that hit nothing.

Sorting is pure lane permutation: every per-ray carry (ray, throughput,
RNG counters, pixel id) rides the same permutation and the per-lane math
is unchanged, so results match the unsorted wavefront up to fma
contraction. Off by default (models/montecarlo.random_path_soa
sort_rays); whether compaction pays on the GPU is an open question.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32

# Parking spot for terminated rays: far above every demo scene (scene
# radii are O(100)), pointing further up — every slab test gives
# tmax < 0 <= tmin, so parked tiles skip all primitive work.
PARK_Z = np.float32(2.0e8)
DEAD_KEY = np.uint32(0xFFFFFFFF)


def _spread3(x):
    """Interleave the low 9 bits of x (u32) with two zero bits each
    (Morton spread; masks are the standard 10-bit pattern)."""
    x = x & U32(0x3FF)
    x = (x | (x << U32(16))) & U32(0x030000FF)
    x = (x | (x << U32(8))) & U32(0x0300F00F)
    x = (x | (x << U32(4))) & U32(0x030C30C3)
    x = (x | (x << U32(2))) & U32(0x09249249)
    return x


def ray_sort_key(o, d, done, lo, hi):
    """uint32 sort key per lane. o, d: vec3 of [N] (d need not be unit),
    done: [N] bool, lo/hi: [3] world bounds of the scene's primitive
    AABBs. Dead lanes get DEAD_KEY (sort to the tail)."""
    octant = ((d[0] > 0).astype(U32) * U32(4)
              + (d[1] > 0).astype(U32) * U32(2)
              + (d[2] > 0).astype(U32))
    span = jnp.maximum(hi - lo, np.float32(1e-12))
    key = octant << U32(27)
    for c in range(3):
        q = jnp.clip((o[c] - lo[c]) / span[c], 0.0, 1.0)
        qi = (q * np.float32(511.0)).astype(jnp.int32).astype(U32)
        key = key | (_spread3(qi) << U32(c))
    return jnp.where(done, DEAD_KEY, key)


def sort_wavefront(key, arrays):
    """argsort by key and gather every array in `arrays` (a flat list of
    [N] arrays) by the permutation. Returns (perm, gathered list).

    One row-form gather of a stacked [K, N] array along axis 1 per dtype
    instead of K separate 1-D gathers. Arrays are stacked by dtype (f32
    as-is, everything else widened to uint32), gathered in two takes,
    and unstacked — order preserved."""
    perm = jnp.argsort(key)
    f32_idx = [i for i, a in enumerate(arrays) if a.dtype == jnp.float32]
    other_idx = [i for i in range(len(arrays)) if i not in f32_idx]
    out = [None] * len(arrays)
    if f32_idx:
        g = jnp.take(jnp.stack([arrays[i] for i in f32_idx]), perm, axis=1)
        for k, i in enumerate(f32_idx):
            out[i] = g[k]
    if other_idx:
        cast = [arrays[i].astype(jnp.uint32) if arrays[i].dtype != jnp.uint32
                else arrays[i] for i in other_idx]
        g = jnp.take(jnp.stack(cast), perm, axis=1)
        for k, i in enumerate(other_idx):
            out[i] = g[k].astype(arrays[i].dtype)
    return perm, out
