"""Scene compile: host ScenePrimitives -> device pytree of arrays.

The replacement for BVH_GPU_Scene::finalize (bvh_gpu/gpu_bvh_scene.cpp:
121-187). Instead of serializing PrimData records into RGBA32F textures, the
scene becomes a pytree of dense arrays:

  - per-prim tables indexed by global primitive id (after the reference's
    emissives-first sort, scene.cpp:70-88): color [N,4], mat [N,4]
    (shininess, roughness, emissivity, area), transfo / inv_transfo /
    mesh_transfo [N,4,4]
  - per-shape-type homogeneous groups (transfo/inv/prim-id, padded to a
    chunk multiple, Morton-ordered) so each intersector is branch-free
    over the type switch (intersect_prim, raytracer_func.frag:690-704)
  - per-mesh-instance pre-gathered triangle corner/normal arrays (padded
    with degenerate triangles), replacing tex_tri_/tex_p_/tex_n_
  - per-prim world AABBs, which the whole-pass kernel's frontier culling
    reads. The reference's heap BVH (exact bvh.cpp:34-93 format) is built
    on demand by models/debug_views.scene_bvh; no trace path consumes it
    yet

Static metadata (group codes, offsets, counts) lives in meta fields so the
whole thing jits cleanly; `color` and `mat` are the differentiable leaves
for the inverse-rendering path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .scene import (
    ScenePrimitives, CODE_MESH, CODE_SPHERE, CODE_CUBE, CODE_CYLINDER,
    CODE_CONE, CODE_ORIENTED_QUAD,
)

F32 = np.float32

ANALYTIC_CODES = (CODE_SPHERE, CODE_CUBE, CODE_CYLINDER, CODE_CONE,
                  CODE_ORIENTED_QUAD)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _morton3(center, lo, hi) -> int:
    """30-bit Morton code of a point within the scene bounds."""
    span = np.maximum(hi - lo, 1e-12)
    q = np.clip((center - lo) / span, 0.0, 1.0)
    q = (q * 1023.0).astype(np.int64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return int(spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DeviceScene:
    # --- per-prim tables (global prim id) ---
    color: jnp.ndarray          # [N,4] f32 (differentiable)
    mat: jnp.ndarray            # [N,4] f32 (differentiable)
    transfo: jnp.ndarray        # [N,4,4]
    inv_transfo: jnp.ndarray    # [N,4,4]
    mesh_transfo: jnp.ndarray   # [N,4,4]
    # --- typed analytic groups (tuple aligned with group_codes) ---
    group_transfo: Tuple[jnp.ndarray, ...]   # each [P,4,4]
    group_inv: Tuple[jnp.ndarray, ...]       # each [P,4,4]
    group_prim: Tuple[jnp.ndarray, ...]      # each [P] i32, -1 pad
    # --- mesh triangle pools (concatenated across instances) ---
    tri_va: jnp.ndarray         # [T,3] mesh-local corner A
    tri_vb: jnp.ndarray
    tri_vc: jnp.ndarray
    tri_na: jnp.ndarray         # [T,3] vertex normals
    tri_nb: jnp.ndarray
    tri_nc: jnp.ndarray
    # row-major twins of the corner/normal pools: [9, T] (ax ay az bx ..
    # cz), so shading gathers a hit triangle's corners with ONE take
    # along axis 1 (ops/shading.py mesh branch)
    tri_pos_rows: jnp.ndarray   # [9, T]
    tri_norm_rows: jnp.ndarray  # [9, T]
    # per-prim world AABBs (prim_bb x1.005 padding, scene.cpp:18-42) —
    # the whole-pass kernel's frontier culling and ray sorting read these
    prim_bb_min: jnp.ndarray    # [N,3]
    prim_bb_max: jnp.ndarray    # [N,3]
    # --- static metadata ---
    group_codes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    group_chunk: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    mesh_prim_index: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    mesh_tri_offset: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    mesh_tri_padded: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    tri_chunk: int = dataclasses.field(metadata=dict(static=True))
    nb_prims: int = dataclasses.field(metadata=dict(static=True))
    nb_emissives: int = dataclasses.field(metadata=dict(static=True))
    flat_face: bool = dataclasses.field(metadata=dict(static=True))
    has_transparent: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def nb_meshes(self) -> int:
        return len(self.mesh_prim_index)


def compile_scene(scene: ScenePrimitives, *, analytic_chunk: int = 64,
                  tri_chunk: int = 256,
                  flat_face: bool = False) -> DeviceScene:
    """finalize() analog: emissive sort -> BVH build -> dense device arrays."""
    nb_emissives = scene.sort_emissive_first()
    n = scene.nb
    if n == 0:
        raise ValueError("empty scene")

    color = np.stack([p.color for p in scene.prims]).astype(F32)
    mat = np.stack([p.mat for p in scene.prims]).astype(F32)
    transfo = np.stack([p.transfo for p in scene.prims]).astype(F32)
    inv_transfo = np.stack([p.inv_transfo for p in scene.prims]).astype(F32)
    mesh_transfo = np.stack([p.mesh_transfo for p in scene.prims]).astype(F32)

    # world AABBs (prim_bb padding x1.005, scene.cpp:18-42); the heap
    # BVH itself is built on demand by the debug views only
    # (models/debug_views.scene_bvh) — no trace path consumes it
    centers, bbmin, bbmax = scene.all_prim_bbs()

    # typed analytic groups. Prims inside a group are MORTON-ORDERED by
    # world-AABB center so that neighbouring prims are spatially coherent
    # — the kernel's super boxes over consecutive prims then cull well.
    group_codes, g_trf, g_inv, g_prim, g_chunk = [], [], [], [], []
    for code in ANALYTIC_CODES:
        idx = [i for i, p in enumerate(scene.prims) if p.type == code]
        if not idx:
            continue
        idx = sorted(idx, key=lambda i: _morton3(centers[i], bbmin.min(0),
                                                 bbmax.max(0)))
        chunk = min(analytic_chunk, _round_up(len(idx), 8))
        pad = _round_up(len(idx), chunk)
        trf = np.zeros((pad, 4, 4), F32)
        inv = np.zeros((pad, 4, 4), F32)
        trf[:] = np.eye(4, dtype=F32)
        inv[:] = np.eye(4, dtype=F32)
        pid = np.full(pad, -1, np.int32)
        for k, i in enumerate(idx):
            trf[k] = scene.prims[i].transfo
            inv[k] = scene.prims[i].inv_transfo
            pid[k] = i
        group_codes.append(code)
        g_trf.append(jnp.asarray(trf))
        g_inv.append(jnp.asarray(inv))
        g_prim.append(jnp.asarray(pid))
        g_chunk.append(chunk)

    # mesh instances: pre-gather triangle corners/normals in mesh-local
    # space, MORTON-ORDERED by centroid (Mesh_intersect /
    # gpu_bvh_scene.cpp:51-118 analog).
    mesh_prim_index, mesh_tri_offset, mesh_tri_padded = [], [], []
    va_l, vb_l, vc_l, na_l, nb_l, nc_l = [], [], [], [], [], []
    offset = 0
    for i, p in enumerate(scene.prims):
        if p.type != CODE_MESH:
            continue
        geom = scene.meshes[p.mesh_id]
        t = geom.triangles
        ntris = t.shape[0]
        cent = (geom.vertices[t[:, 0]] + geom.vertices[t[:, 1]]
                + geom.vertices[t[:, 2]]) / 3.0
        lo, hi = cent.min(axis=0), cent.max(axis=0)
        order = sorted(range(ntris), key=lambda k: _morton3(cent[k], lo, hi))
        t = t[order]
        chunk = min(tri_chunk, _round_up(ntris, 8))
        pad = _round_up(ntris, chunk)
        va = np.zeros((pad, 3), F32)
        vb = np.zeros((pad, 3), F32)
        vc = np.zeros((pad, 3), F32)
        na = np.zeros((pad, 3), F32)
        nb_ = np.zeros((pad, 3), F32)
        nc = np.zeros((pad, 3), F32)
        va[:ntris] = geom.vertices[t[:, 0]]
        vb[:ntris] = geom.vertices[t[:, 1]]
        vc[:ntris] = geom.vertices[t[:, 2]]
        na[:ntris] = geom.normals[t[:, 0]]
        nb_[:ntris] = geom.normals[t[:, 1]]
        nc[:ntris] = geom.normals[t[:, 2]]
        mesh_prim_index.append(i)
        mesh_tri_offset.append(offset)
        mesh_tri_padded.append(pad)
        va_l.append(va); vb_l.append(vb); vc_l.append(vc)
        na_l.append(na); nb_l.append(nb_); nc_l.append(nc)
        offset += pad

    def cat(parts):
        if not parts:
            return jnp.zeros((0, 3), jnp.float32)
        return jnp.asarray(np.concatenate(parts, axis=0))

    def rows9(a_parts, b_parts, c_parts):
        """[T,3] pools -> [9, T] rows (ax ay az bx .. cz)."""
        if not a_parts:
            return jnp.zeros((9, 0), jnp.float32)
        a = np.concatenate(a_parts, axis=0)
        b = np.concatenate(b_parts, axis=0)
        c = np.concatenate(c_parts, axis=0)
        return jnp.asarray(np.concatenate([a.T, b.T, c.T], axis=0))

    has_transparent = bool(np.any(color[:, 3] < 1.0))

    return DeviceScene(
        color=jnp.asarray(color),
        mat=jnp.asarray(mat),
        transfo=jnp.asarray(transfo),
        inv_transfo=jnp.asarray(inv_transfo),
        mesh_transfo=jnp.asarray(mesh_transfo),
        group_transfo=tuple(g_trf),
        group_inv=tuple(g_inv),
        group_prim=tuple(g_prim),
        tri_va=cat(va_l), tri_vb=cat(vb_l), tri_vc=cat(vc_l),
        tri_na=cat(na_l), tri_nb=cat(nb_l), tri_nc=cat(nc_l),
        tri_pos_rows=rows9(va_l, vb_l, vc_l),
        tri_norm_rows=rows9(na_l, nb_l, nc_l),
        prim_bb_min=jnp.asarray(bbmin.astype(F32)),
        prim_bb_max=jnp.asarray(bbmax.astype(F32)),
        group_codes=tuple(group_codes),
        group_chunk=tuple(g_chunk),
        mesh_prim_index=tuple(mesh_prim_index),
        mesh_tri_offset=tuple(mesh_tri_offset),
        mesh_tri_padded=tuple(mesh_tri_padded),
        tri_chunk=tri_chunk,
        nb_prims=n,
        nb_emissives=nb_emissives,
        flat_face=flat_face,
        has_transparent=has_transparent,
    )
