"""Canonical intersector cases per shape (raytracer_func.frag:354-705
semantics) + world-distance group-trace behavior."""
import numpy as np
import jax.numpy as jnp

from montecarlo_pathtracing_tpu.ops import intersect as xs
from montecarlo_pathtracing_tpu.utils import transforms as tf


def _row(*v):
    return jnp.array([v], jnp.float32)


def test_sphere_outside_both_roots():
    O = _row(0.0, 0.0, -3.0)
    D = _row(0.0, 0.0, 1.0)
    a, valid, _ = xs.sphere_local(O, D)
    assert bool(valid[0])
    assert np.isclose(float(a[0]), 2.0, atol=1e-5)


def test_sphere_inside_uses_far_root():
    a, valid, _ = xs.sphere_local(_row(0.0, 0.0, 0.0), _row(0.0, 0.0, 1.0))
    assert bool(valid[0])
    assert np.isclose(float(a[0]), 1.0, atol=1e-5)


def test_sphere_miss():
    a, valid, _ = xs.sphere_local(_row(2.0, 0.0, -3.0), _row(0.0, 0.0, 1.0))
    assert not bool(valid[0])


def test_quad_one_sided():
    # front side: D.z < 0 hits
    a, valid, _ = xs.quad_local(_row(0.2, -0.3, 1.0), _row(0.0, 0.0, -1.0))
    assert bool(valid[0]) and np.isclose(float(a[0]), 1.0, atol=1e-6)
    # back side rejected even though geometrically crossing
    _, valid, _ = xs.quad_local(_row(0.2, -0.3, -1.0), _row(0.0, 0.0, 1.0))
    assert not bool(valid[0])
    # quirk: NO positivity check on a (hit behind the origin accepted)
    a, valid, _ = xs.quad_local(_row(0.0, 0.0, -1.0), _row(0.0, 0.0, -1.0))
    assert bool(valid[0]) and float(a[0]) == -1.0


def test_cube_faces_and_codes():
    # -x face from outside: face c where c0=0, cd=-1 => c=0
    a, valid, face = xs.cube_local(_row(-3.0, 0.0, 0.0), _row(1.0, 0.0, 0.0))
    assert bool(valid[0])
    assert np.isclose(float(a[0]), 2.0, atol=1e-5)
    assert int(face[0]) == 0
    # +z face: c0=2, cd=+1 => c=5
    a, valid, face = xs.cube_local(_row(0.0, 0.0, 3.0), _row(0.0, 0.0, -1.0))
    assert int(face[0]) == 5 and np.isclose(float(a[0]), 2.0, atol=1e-5)


def test_cylinder_cap_and_side():
    # from +z down: top cap code 1
    a, valid, code = xs.cylinder_local(
        _row(0.0, 0.0, 3.0), _row(0.0, 0.0, -1.0))
    assert bool(valid[0]) and int(code[0]) == 1
    assert np.isclose(float(a[0]), 2.0, atol=1e-5)
    # from the side: code 2
    a, valid, code = xs.cylinder_local(
        _row(-3.0, 0.0, 0.0), _row(1.0, 0.0, 0.0))
    assert bool(valid[0]) and int(code[0]) == 2
    assert np.isclose(float(a[0]), 2.0, atol=1e-5)


def test_cone_bottom_cap_and_side():
    a, valid, code = xs.cone_local(_row(0.0, 0.0, -3.0), _row(0.0, 0.0, 1.0))
    assert bool(valid[0]) and int(code[0]) == 0
    assert np.isclose(float(a[0]), 2.0, atol=1e-5)
    a, valid, code = xs.cone_local(_row(-3.0, 0.0, -0.5), _row(1.0, 0.0, 0.0))
    assert bool(valid[0]) and int(code[0]) == 2


def test_triangle_batch():
    va = jnp.array([[0.0, 0.0, 0.0]], jnp.float32)
    vb = jnp.array([[1.0, 0.0, 0.0]], jnp.float32)
    vc = jnp.array([[0.0, 1.0, 0.0]], jnp.float32)
    O = jnp.array([[0.2, 0.2, 1.0], [0.9, 0.9, 1.0]], jnp.float32)
    D = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], jnp.float32)
    a, valid = xs.triangle_batch(O, D, va, vb, vc)
    assert bool(valid[0, 0]) and not bool(valid[1, 0])
    assert np.isclose(float(a[0, 0]), 1.0, atol=1e-6)


def test_group_trace_world_distance_wins():
    """Two spheres with different scales: the winner must be chosen by
    WORLD distance, not local ray parameter (intersect_prim semantics,
    raytracer_func.frag:686-705)."""
    t_near = tf.translate(0, 0, 5.0) @ tf.scale(1.0)
    t_far = tf.translate(0, 0, 20.0) @ tf.scale(10.0)
    trf = jnp.asarray(np.stack([t_far, t_near]))
    inv = jnp.asarray(np.stack([tf.inverse(t_far), tf.inverse(t_near)]))
    pid = jnp.array([0, 1], jnp.int32)
    O = jnp.array([[0.0, 0.0, 0.0]], jnp.float32)
    D = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
    best = xs.miss_hit((1,))
    best = xs.trace_analytic_group(best, O, D, xs.CODE_SPHERE, trf, inv,
                                   pid, chunk=2)
    assert int(best.prim[0]) == 1          # near sphere wins
    assert np.isclose(float(best.dist[0]), 4.0, atol=1e-4)
    # world hit point
    np.testing.assert_allclose(
        np.asarray(best.pg[0]), [0, 0, 4.0], atol=1e-4)


def test_group_trace_padding_ignored():
    t = tf.translate(0, 0, 5.0)
    trf = jnp.asarray(np.stack([t, np.eye(4, dtype=np.float32)]))
    inv = jnp.asarray(np.stack([tf.inverse(t), np.eye(4, dtype=np.float32)]))
    pid = jnp.array([0, -1], jnp.int32)   # second slot is padding
    O = jnp.array([[0.0, 0.0, 0.0]], jnp.float32)
    D = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
    best = xs.trace_analytic_group(
        xs.miss_hit((1,)), O, D, xs.CODE_SPHERE, trf, inv, pid, chunk=2)
    assert int(best.prim[0]) == 0
    assert np.isclose(float(best.dist[0]), 4.0, atol=1e-4)


def test_mesh_local_transform_pins_f32_precision():
    """The mesh-local ray transform is a matmul: at default precision a
    GPU may run it in TF32 (~3 digits) and bend rays. Every contraction
    in the mesh fold must ask for HIGHEST."""
    import jax
    from montecarlo_pathtracing_tpu.utils.transforms import PRECISION

    O = jnp.zeros((4, 3), jnp.float32)
    D = jnp.ones((4, 3), jnp.float32)
    tri = jnp.asarray(np.random.RandomState(0).normal(size=(8, 3)),
                      jnp.float32)
    eye = jnp.eye(4, dtype=jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda O, D: xs.trace_mesh_instance(
            xs.miss_hit((4,)), O, D, eye, eye, 0, tri, tri + 1.0,
            tri + 2.0, tri_offset=0, chunk=8))(O, D)

    def dots(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from dots(sub)

    found = list(dots(jaxpr.jaxpr))
    assert len(found) >= 3          # O and D transforms + hit point map
    for eqn in found:
        prec = eqn.params["precision"]
        assert prec is not None and all(p == PRECISION for p in prec), prec
