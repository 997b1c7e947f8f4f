"""SoA vec3 math: vectors as (x, y, z) tuples of [N] arrays.

The ray layout of the dense route (SURVEY.md §7 "ray SoA"): each vec3
component is its own contiguous [N] array, so every elementwise op reads
and writes unit-stride rows with no 3-wide minor dimension. The dense
integrator, sampling, shading and RNG run on these; [N, 3] appears only
at API boundaries.

All helpers are shape-polymorphic over the component arrays.
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import utils  # noqa: F401  (package anchor)


def v3(x, y, z):
    return (x, y, z)


def splat(c, like):
    """Constant vec3 broadcast to the shape of `like`'s components."""
    return tuple(jnp.full_like(like[0], ci) for ci in c)


def from_aos(a):
    """[N, 3] -> ((N,), (N,), (N,)). Boundary-only."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_aos(v):
    """((N,),)*3 -> [N, 3]. Boundary-only."""
    return jnp.stack(v, axis=-1)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    """Hadamard product of two vec3s."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(v, s):
    """v * s with s a scalar or [N] array."""
    return (v[0] * s, v[1] * s, v[2] * s)


def axpy(s, a, b):
    """s*a + b."""
    return (s * a[0] + b[0], s * a[1] + b[1], s * a[2] + b[2])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length(v):
    return jnp.sqrt(dot(v, v))


def normalize(v, eps=0.0):
    n = length(v)
    if eps:
        n = jnp.maximum(n, eps)
    return (v[0] / n, v[1] / n, v[2] / n)


def neg(v):
    return (-v[0], -v[1], -v[2])


def where(m, a, b):
    """Per-lane select; m is [N] bool (no [..., None] dance)."""
    return (
        jnp.where(m, a[0], b[0]),
        jnp.where(m, a[1], b[1]),
        jnp.where(m, a[2], b[2]),
    )


def mix(a, b, k):
    """GLSL mix over vec3s; k scalar or [N]."""
    return (
        (1.0 - k) * a[0] + k * b[0],
        (1.0 - k) * a[1] + k * b[1],
        (1.0 - k) * a[2] + k * b[2],
    )


def reflect(i, n):
    """GLSL reflect(I, N) = I - 2 dot(N, I) N."""
    d2 = 2.0 * dot(n, i)
    return (i[0] - d2 * n[0], i[1] - d2 * n[1], i[2] - d2 * n[2])


def refract_glsl(i, n, eta):
    """GLSL built-in refract: vec3(0) on TIR (see transforms.refract_glsl).

    The sqrt operand is where-guarded away from 0 on non-refracting
    lanes: d(sqrt)/dk is infinite at k == 0 and reverse-mode propagates
    the untaken-branch NaN through the TIR jnp.where — eta (the IOR
    slider) is a differentiable input, so the gradient path is live.
    Forward values are identical (guarded lanes output vec3(0) anyway)."""
    ndi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = k > 0.0
    k_safe = jnp.where(refr, k, 1.0)
    c = eta * ndi + jnp.where(refr, jnp.sqrt(k_safe), 0.0)
    out = (eta * i[0] - c * n[0], eta * i[1] - c * n[1],
           eta * i[2] - c * n[2])
    tir = k < 0.0
    z = jnp.zeros_like(out[0])
    return where(tir, (z, z, z), out)


def affine_rows(m):
    """[P,4,4] -> [12,P] affine rows (r00 r01 r02 tx r10 ... tz).
    The SoA transform-table layout shared with the Pallas kernels."""
    return jnp.transpose(m[:, :3, :4].reshape(m.shape[0], 12), (1, 0))


def apply_affine(rows, v):
    """Affine point transform by gathered rows: rows [12, N], v vec3."""
    return (
        rows[0] * v[0] + rows[1] * v[1] + rows[2] * v[2] + rows[3],
        rows[4] * v[0] + rows[5] * v[1] + rows[6] * v[2] + rows[7],
        rows[8] * v[0] + rows[9] * v[1] + rows[10] * v[2] + rows[11],
    )


def apply_linear(rows, v):
    """Linear (direction) transform by gathered rows."""
    return (
        rows[0] * v[0] + rows[1] * v[1] + rows[2] * v[2],
        rows[4] * v[0] + rows[5] * v[1] + rows[6] * v[2],
        rows[8] * v[0] + rows[9] * v[1] + rows[10] * v[2],
    )
