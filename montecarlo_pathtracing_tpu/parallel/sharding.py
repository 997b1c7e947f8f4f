"""Multi-device parallelism: ray sharding + sample-axis DP over a mesh.

The reference is strictly single-GPU (SURVEY.md §2.3) — its only
"collective" is framebuffer additive blending. This framework has two
distribution axes over a `jax.sharding.Mesh`:

  1. PIXEL/RAY SHARDING (primary): the flattened ray batch is sharded over
     the mesh's "rays" axis; each device traces its own pixels against the
     replicated scene. Zero communication per pass — the sharded
     accumulator IS the distributed framebuffer; only the final image
     assembly gathers.

  2. SAMPLE-AXIS DP (`shard_map` + psum): every device renders the SAME
     pixels with a different pass index and the per-device partial sums
     are psum-reduced — the progressive-accumulation analog of gradient
     all-reduce, and the axis that scales SPP throughput for the 1024-SPP
     convergence configs (BASELINE.json config 5).

Both run each device's share through shard_map, so every device runs the
route the integrator chooses (a pallas_call cannot be partitioned by
GSPMD). The mesh is a flat list of devices: the cards of one host are
joined all to all, so no axis layout is preferred.

Determinism: the RNG seed is a pure function of (pixel uv, pass index)
(ops/rng.srand), so ANY sharding of pixels or samples yields bit-identical
images to the single-device render — asserted in tests/test_sharding.py.
"""
from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.registry import get_integrator, route_kwargs


def make_mesh(n_devices: int | None = None, axis_name: str = "rays") -> Mesh:
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"asked for {n_devices} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_devices]), (axis_name,))


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def shard_rays(mesh: Mesh, dirs, tc, axis_name: str = "rays"):
    """Pad the flattened ray batch to the mesh size and shard it.
    Returns (dirs, tc, n_padded) with leading dim sharded over `axis_name`."""
    n = dirs.shape[0]
    nd = mesh.shape[axis_name]
    pad = _round_up(n, nd)
    if pad != n:
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32),
                                    (pad - n, 3))])
        tc = jnp.concatenate([tc, jnp.zeros((pad - n, 2), jnp.float32)])
    sh = NamedSharding(mesh, P(axis_name))
    return jax.device_put(dirs, sh), jax.device_put(tc, sh), pad


def make_sharded_pass(mesh: Mesh, integrator_name: str = "montecarlo", *,
                      nb_bounces: int = 3, detach_sampling: bool = False,
                      axis_name: str = "rays", date: float = 0.0,
                      route: str | None = None,
                      pallas_interpret: bool = False):
    """Pixel-sharded progressive pass: acc/dirs/tc sharded over the ray
    axis, scene replicated. Returns a jitted fn(scene, acc, dirs, tc,
    origin, pass_index, refract_ind) -> acc.

    route / pallas_interpret are forwarded to the integrator (None =
    models.montecarlo.choose_route). Each device runs the chosen route on
    its ray shard under shard_map; per-pixel seeds are pure functions of
    (uv, pass), so results are bit-identical to one device."""
    integrator = get_integrator(integrator_name)
    kw = route_kwargs(integrator, route, pallas_interpret)

    def one_pass(scene, acc, dirs, tc, origin, pass_index, refract_ind):
        rgb = integrator(scene, origin, dirs, tc, pass_index,
                         nb_bounces=nb_bounces, refract_ind=refract_ind,
                         date=date, detach_sampling=detach_sampling, **kw)
        return acc + rgb

    fn = jax.shard_map(
        one_pass, mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name), P(axis_name),
                  P(), P(), P()),
        out_specs=P(axis_name),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(1,))


def make_sample_sharded_pass(mesh: Mesh, integrator_name: str = "montecarlo",
                             *, nb_bounces: int = 3,
                             detach_sampling: bool = False,
                             axis_name: str = "spp", date: float = 0.0,
                             route: str | None = None,
                             pallas_interpret: bool = False):
    """Sample-axis DP via shard_map: device k renders pass (base + k) of
    the SAME pixels; partial images psum over the mesh axis. One call
    advances the accumulator by mesh_size passes. Returns
    fn(scene, dirs, tc, origin, base_pass, refract_ind) -> summed rgb."""
    integrator = get_integrator(integrator_name)
    nd = mesh.shape[axis_name]
    kw = route_kwargs(integrator, route, pallas_interpret)

    def per_device(scene, dirs, tc, origin, base_pass, refract_ind):
        k = jax.lax.axis_index(axis_name)
        rgb = integrator(scene, origin, dirs, tc, base_pass + k,
                         nb_bounces=nb_bounces, refract_ind=refract_ind,
                         date=date, detach_sampling=detach_sampling, **kw)
        return jax.lax.psum(rgb, axis_name)

    fn = jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    jitted = jax.jit(fn)
    jitted.n_passes_per_call = nd
    return jitted
