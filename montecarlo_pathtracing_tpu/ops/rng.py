"""Counter-based stateless RNG: bit-exact xxhash32 construction.

Reimplements the reference's GLSL RNG (shaders/raytracer_func.frag:90-135):
  - xxhash32 of a uvec3 counter
  - seed derived from (pixel uv, pass number, date)
    (srand, raytracer_func.frag:105-110)
  - each draw advances the counter by uvec3(11, 43, 67)
  - mantissa-bit trick maps the hash to a float in [0, 1)

The state is an explicit uint32 [..., 3] array, one counter per ray lane,
so any sharding of the ray batch yields bit-identical streams (the seed is
a pure function of pixel uv + pass index). `date` is a deterministic input
(the reference mixes wall-clock time in; for reproducibility and CPU-parity
we expose it as a config value, default 0.0).

Deliberate deviation from the reference: its srand derives the counter by
FLOAT multiplications of (uv, pass, date) and floatBitsToUint
(raytracer_func.frag:106-109). Float rounding there is not bit-stable
across compilation contexts (XLA fuses the multiply-add chain differently
eager vs jit vs shard_map — observed 1-ulp seed differences, which
avalanche through xxhash into fully different streams). Because identical
counters on every backend ARE the determinism/parity contract, the seed
derivation here is integer-exact with the same structure: the uv float
BITS enter x/z unchanged and the pass/date mix in y via a Weyl step
(golden-ratio constant). xxhash32's avalanche gives the same
decorrelation the float scaling was for.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

UINT = jnp.uint32

# xxhash32 primes (raytracer_func.frag:92-93)
_P2 = np.uint32(2246822519)
_P3 = np.uint32(3266489917)
_P4 = np.uint32(668265263)
_P5 = np.uint32(374761393)

# per-draw counter advance (raytracer_func.frag:121)
ADVANCE = np.array([11, 43, 67], dtype=np.uint32)

_MANTISSA = np.uint32(0x007FFFFF)
_ONE_F32 = np.uint32(0x3F800000)


def _rotl17(x):
    return (x << UINT(17)) | (x >> UINT(32 - 17))


def xxhash32(p):
    """xxhash32 of a uint32 [..., 3] counter (raytracer_func.frag:90-101)."""
    p = p.astype(UINT)
    h = p[..., 2] + UINT(_P5) + p[..., 0] * UINT(_P3)
    h = UINT(_P4) * _rotl17(h)
    h = h + p[..., 1] * UINT(_P3)
    h = UINT(_P4) * _rotl17(h)
    h = UINT(_P2) * (h ^ (h >> UINT(15)))
    h = UINT(_P3) * (h ^ (h >> UINT(13)))
    return h ^ (h >> UINT(16))


# Weyl/golden-ratio step mixing the pass index into the seed (integer-exact
# replacement for the reference's float scaling — see module docstring).
GOLDEN = np.uint32(0x9E3779B9)


def srand(screen_tc, pass_index, date=0.0):
    """Initial per-lane counter from (uv, pass, date) — integer-exact.

    seed = (bits(tc.x), pass * GOLDEN + bits(date), bits(tc.y))

    screen_tc: float32 [..., 2]; pass_index: int scalar (traced ok);
    returns uint32 [..., 3]. Bit-identical under eager / jit / shard_map /
    any backend (pure uint32 ops).
    """
    tcb = jax.lax.bitcast_convert_type(screen_tc.astype(jnp.float32), UINT)
    p = jnp.asarray(pass_index).astype(UINT)
    db = jax.lax.bitcast_convert_type(jnp.float32(date), UINT)
    y = p * UINT(GOLDEN) + db
    return jnp.stack(
        [
            tcb[..., 0],
            jnp.broadcast_to(y, screen_tc.shape[:-1]),
            tcb[..., 1],
        ],
        axis=-1,
    )


def uniform(state):
    """One draw per lane: (value in [0,1) float32, new state).

    raytracer_func.frag:112-124 — mantissa trick + counter advance.
    """
    m = xxhash32(state)
    m = (m & UINT(_MANTISSA)) | UINT(_ONE_F32)
    f = jax.lax.bitcast_convert_type(m, jnp.float32) - jnp.float32(1.0)
    return f, state + jnp.asarray(ADVANCE)


def uniform_masked(state, mask):
    """Draw for every lane but only advance the counter where `mask` is True.

    This reproduces the sequential GLSL draw schedule under masked SIMD:
    a lane that would not execute a random_float() call keeps its counter
    unchanged, so subsequent draws stay bit-identical to the scalar program.
    Values at masked-off lanes are garbage and must not be used.
    """
    f, new_state = uniform(state)
    return f, jnp.where(mask[..., None], new_state, state)


def uniform2(state):
    f1, state = uniform(state)
    f2, state = uniform(state)
    return jnp.stack([f1, f2], axis=-1), state


def uniform3(state):
    f1, state = uniform(state)
    f2, state = uniform(state)
    f3, state = uniform(state)
    return jnp.stack([f1, f2, f3], axis=-1), state


# ---------------------------------------------------------------------------
# SoA variants: state as a tuple (s0, s1, s2) of [N] uint32 arrays — the
# SoA twin of the [N, 3] API above (see ops/vec.py). Bit-
# identical streams to the AoS functions.
# ---------------------------------------------------------------------------

def xxhash32_soa(s0, s1, s2):
    h = s2 + UINT(_P5) + s0 * UINT(_P3)
    h = UINT(_P4) * _rotl17(h)
    h = h + s1 * UINT(_P3)
    h = UINT(_P4) * _rotl17(h)
    h = UINT(_P2) * (h ^ (h >> UINT(15)))
    h = UINT(_P3) * (h ^ (h >> UINT(13)))
    return h ^ (h >> UINT(16))


def srand_soa(u, v, pass_index, date=0.0):
    """u, v: [N] float32 screen coords. Returns state tuple of [N] uint32."""
    bu = jax.lax.bitcast_convert_type(u.astype(jnp.float32), UINT)
    bv = jax.lax.bitcast_convert_type(v.astype(jnp.float32), UINT)
    p = jnp.asarray(pass_index).astype(UINT)
    db = jax.lax.bitcast_convert_type(jnp.float32(date), UINT)
    y = jnp.broadcast_to(p * UINT(GOLDEN) + db, u.shape)
    return (bu, y, bv)


def uniform_soa(state):
    s0, s1, s2 = state
    m = xxhash32_soa(s0, s1, s2)
    m = (m & UINT(_MANTISSA)) | UINT(_ONE_F32)
    f = jax.lax.bitcast_convert_type(m, jnp.float32) - jnp.float32(1.0)
    return f, (s0 + UINT(ADVANCE[0]), s1 + UINT(ADVANCE[1]),
               s2 + UINT(ADVANCE[2]))


def uniform_masked_soa(state, mask):
    f, new = uniform_soa(state)
    return f, tuple(jnp.where(mask, n, s) for n, s in zip(new, state))


# ---------------------------------------------------------------------------
# Pure-python oracle (for tests; no jax)
# ---------------------------------------------------------------------------

def xxhash32_py(x: int, y: int, z: int) -> int:
    M = 0xFFFFFFFF

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & M

    h = (z + 374761393 + x * 3266489917) & M
    h = (668265263 * rotl(h, 17)) & M
    h = (h + y * 3266489917) & M
    h = (668265263 * rotl(h, 17)) & M
    h = (2246822519 * ((h ^ (h >> 15)))) & M
    h = (3266489917 * ((h ^ (h >> 13)))) & M
    return (h ^ (h >> 16)) & M


def srand_py(u: float, v: float, pass_index: int, date: float = 0.0):
    bu = int(np.float32(u).view(np.uint32))
    bv = int(np.float32(v).view(np.uint32))
    bd = int(np.float32(date).view(np.uint32))
    y = (int(pass_index) * 0x9E3779B9 + bd) & 0xFFFFFFFF
    return np.array([bu, y, bv], dtype=np.uint64)


def uniform_py(state):
    """state: length-3 array-like of python ints/uint64. Returns (f, state)."""
    st = [int(state[0]) & 0xFFFFFFFF, int(state[1]) & 0xFFFFFFFF, int(state[2]) & 0xFFFFFFFF]
    m = xxhash32_py(*st)
    m = (m & 0x007FFFFF) | 0x3F800000
    f = float(np.array([m], dtype=np.uint32).view(np.float32)[0]) - 1.0
    new = [(st[0] + 11) & 0xFFFFFFFF, (st[1] + 43) & 0xFFFFFFFF, (st[2] + 67) & 0xFFFFFFFF]
    return np.float32(f), new
