"""The SoA intersectors (ops/intersect.SOA_FNS, the ones the whole-pass
kernel folds with) against the AoS dense intersectors (SHAPE_FNS):
_small_group_soa vs trace_analytic_group per shape type, on random groups
and rays — identical winners up to exact-distance ties."""
import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo_pathtracing_tpu.ops import intersect as xs
from montecarlo_pathtracing_tpu.ops.trace import _miss_soa, _small_group_soa
from montecarlo_pathtracing_tpu.utils import transforms as tf


def _random_group(code, n_prims, seed):
    rs = np.random.RandomState(seed)
    trf = np.zeros((n_prims, 4, 4), np.float32)
    inv = np.zeros((n_prims, 4, 4), np.float32)
    for i in range(n_prims):
        m = (tf.translate(*rs.uniform(-50, 50, 3))
             @ tf.rotate(rs.uniform(0, 360), rs.uniform(0.1, 1, 3))
             @ tf.scale(*rs.uniform(0.5, 8.0, 3)))
        trf[i] = m
        inv[i] = tf.inverse(m)
    pid = np.arange(n_prims, dtype=np.int32) * 3 + 1   # scene ids, sparse
    return jnp.asarray(trf), jnp.asarray(inv), jnp.asarray(pid)


def _random_rays(n, seed, centers):
    """Random rays; every other one aims near a random prim center so
    small groups are hit too."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-80, 80, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    aim = centers[rs.randint(0, len(centers), n)] + rs.normal(size=(n, 3))
    d[::2] = (aim - o)[::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("code", [xs.CODE_SPHERE, xs.CODE_CUBE,
                                  xs.CODE_CYLINDER, xs.CODE_CONE,
                                  xs.CODE_ORIENTED_QUAD])
@pytest.mark.parametrize("n_prims", [3, 60, 150])
def test_soa_matches_dense(code, n_prims):
    trf, inv, pid = _random_group(code, n_prims, code * 100 + n_prims)
    O, D = _random_rays(700, code + n_prims, np.asarray(trf)[:, :3, 3])

    # the dense path needs chunk-multiple padding (-1 prim ids)
    chunk = 64
    pad = ((n_prims + chunk - 1) // chunk) * chunk
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                           (pad - n_prims, 4, 4))
    trf_p = jnp.concatenate([trf, eye])
    inv_p = jnp.concatenate([inv, eye])
    pid_p = jnp.concatenate([pid, jnp.full((pad - n_prims,), -1, jnp.int32)])

    dense = xs.trace_analytic_group(
        xs.miss_hit((700,)), O, D, code, trf_p, inv_p, pid_p, chunk=chunk)
    o = (O[:, 0], O[:, 1], O[:, 2])
    d = (D[:, 0], D[:, 1], D[:, 2])
    soa = _small_group_soa(_miss_soa(700), o, d, code, trf_p, inv_p, pid_p)

    d_hit = np.asarray(dense.prim)
    s_hit = np.asarray(soa.prim)
    dd = np.asarray(dense.dist)
    sd = np.asarray(soa.dist)
    # identical winners except possible exact-distance ties
    tie_or_same = (d_hit == s_hit) | np.isclose(dd, sd, rtol=1e-6)
    assert tie_or_same.all(), (
        f"winner mismatch at {np.where(~tie_or_same)[0][:5]}")
    assert ((d_hit < 0) == (s_hit < 0)).all()            # misses agree
    assert (d_hit >= 0).any(), "vacuous: no ray hits the group"
    hit = (d_hit >= 0) & (d_hit == s_hit)
    # unrolled scalar multiply-adds round differently than the einsum
    # path — agreement is to f32 noise, not bit-exact
    np.testing.assert_allclose(sd[hit], dd[hit], rtol=5e-4, atol=1e-3)
    np.testing.assert_allclose(np.stack(soa.pg, -1)[hit],
                               np.asarray(dense.pg)[hit],
                               rtol=1e-3, atol=5e-2)
    np.testing.assert_array_equal(np.asarray(soa.dircode)[hit],
                                  np.asarray(dense.dircode)[hit])
    np.testing.assert_array_equal(np.asarray(soa.shape)[hit],
                                  np.asarray(dense.shape)[hit])
