"""Progressive renderer: accumulation as a running sum in device memory.

The replacement for the reference's FBO additive-blend protocol
(MontecarloGPU/montecarlo.cpp:420-476): each pass renders 1 spp per pixel
with a pass-indexed RNG seed and adds into an f32 accumulator
(GL_ONE/GL_ONE blending analog); the resolve divides by the pass count
(inline fs_frag, montecarlo.cpp:59-70 / shaders/average.frag). The
accumulator buffer is donated back to the jitted pass so XLA updates it
in place.

Unlike the reference — whose accumulation state lives only in the FBO and
dies on any interaction (montecarlo.cpp:238-246) — the accumulator, pass
count and RNG pass index serialize to an .npz so long renders checkpoint
and resume (SURVEY.md §5).

Large images are processed in ray tiles (a static loop inside the jitted
pass) so device memory stays bounded on the dense route.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, asdict

import numpy as np
import jax
import jax.numpy as jnp

from ..models.registry import get_integrator, route_kwargs
from ..scene.device import DeviceScene, compile_scene
from ..utils.image import write_png
from .camera import default_rt_camera, camera_rays


@dataclass(frozen=True)
class RenderConfig:
    """The reference's knobs (ImGui sliders + defaults,
    montecarlo.cpp:128-130,584-606,801) as a config dataclass."""
    width: int = 1280
    height: int = 1000
    nb_bounces: int = 3          # slider 0-9
    paths_per_pass: int = 1      # slider 1-8
    subsampling: int = 0         # power-of-2 resolution divisor, 0-5
    refract_ind: float = 1.0     # slider 1.0-2.5
    light_intensity: float = 1.2
    date: float = 0.0            # deterministic stand-in for wall clock
    integrator: str = "montecarlo"
    flat_face: bool = False
    detach_sampling: bool = False
    # "megakernel" | "dense"; None = models.montecarlo.choose_route
    route: str | None = None
    pallas_interpret: bool = False  # run the kernel interpreted (tests)
    pixel_order: str = "block32"  # ray layout: "block32" tiles the image
    # into 32x32 pixel blocks so each kernel ray block is screen-compact
    # (tight frustum -> AABB culls bite); "scanline" = row-major
    passes_per_call: int = 8     # passes folded into one jitted call
    shard_devices: int = 0       # >1: shard rays over a device mesh
    tile_rays: int = 1 << 16

    @property
    def render_width(self) -> int:
        return max(1, self.width >> self.subsampling)

    @property
    def render_height(self) -> int:
        return max(1, self.height >> self.subsampling)


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _block_perm(w: int, h: int, bs: int = 32) -> np.ndarray:
    """Permutation putting pixels in bs x bs screen blocks (row-major
    blocks, row-major within a block), so consecutive rays — one block of
    the whole-pass kernel — are screen-compact, which is what makes its
    AABB frontier culls effective."""
    idx = np.arange(w * h).reshape(h, w)
    parts = []
    for by in range(0, h, bs):
        for bx in range(0, w, bs):
            parts.append(idx[by:by + bs, bx:bx + bs].ravel())
    return np.concatenate(parts)


class Renderer:
    """Progressive path-tracing renderer over a compiled device scene."""

    def __init__(self, scene: DeviceScene, config: RenderConfig,
                 proj: np.ndarray | None = None,
                 view: np.ndarray | None = None):
        self.scene = scene
        self.config = config
        w, h = config.render_width, config.render_height
        if proj is None or view is None:
            proj, view = default_rt_camera(w, h)
        self.proj, self.view = proj, view
        origin, dirs, tc = camera_rays(proj, view, w, h)
        npix = w * h
        pad = _round_up(npix, min(config.tile_rays, _round_up(npix, 256)))
        self._npix = npix
        self._tile = min(config.tile_rays, pad)
        self._ntiles = pad // self._tile
        if config.pixel_order == "block32":
            perm = _block_perm(w, h)
        else:
            perm = np.arange(npix)
        self._inv_perm = np.argsort(perm)
        d = jnp.concatenate(
            [jnp.asarray(np.asarray(dirs.reshape(npix, 3))[perm]),
             jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32),
                              (pad - npix, 3))])
        t = jnp.concatenate(
            [jnp.asarray(np.asarray(tc.reshape(npix, 2))[perm]),
             jnp.zeros((pad - npix, 2), jnp.float32)])
        self._origin = origin
        self._dirs = d.reshape(self._ntiles, self._tile, 3)
        self._tc = t.reshape(self._ntiles, self._tile, 2)
        self._sharding = None
        if config.shard_devices > 1:
            # pixel/ray DP: shard the within-tile ray axis over the mesh;
            # each device traces its own rays with zero collectives
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..parallel.sharding import make_mesh
            mesh = make_mesh(config.shard_devices)
            self._mesh = mesh
            self._sharding = NamedSharding(mesh, P(None, "rays", None))
            self._dirs = jax.device_put(self._dirs, self._sharding)
            self._tc = jax.device_put(self._tc, self._sharding)
        self._integrator = get_integrator(config.integrator)
        self._pass_fn = self._build_pass_fn(1)
        self._multi_fn = None   # built lazily for batched runs
        self._multi_n = None
        self.reset()

    # -- pass compilation --------------------------------------------------

    def _build_pass_fn(self, n_passes: int):
        """Jitted accumulate step folding n_passes progressive passes into
        one device call, so per-call dispatch is amortised over the batch.
        The passes are folded by a lax.fori_loop over pass indices wrapping
        a static python loop over ray tiles (accumulating in pass order
        into the donated accumulator). Accumulation is bit-identical to
        sequential single passes.

        With shard_devices > 1 each tile's integrator call runs under
        shard_map over the ray axis: every device renders its own rays on
        the same route (a pallas_call cannot be partitioned by GSPMD), and
        per-pixel seeds make the result identical to one device."""
        cfg = self.config
        integrator = self._integrator
        ntiles = self._ntiles
        kw = route_kwargs(integrator, cfg.route, cfg.pallas_interpret)

        def render_tile(scene, dirs, tc, origin, pass_index, refract_ind):
            return integrator(
                scene, origin, dirs, tc, pass_index,
                nb_bounces=cfg.nb_bounces, refract_ind=refract_ind,
                date=cfg.date, detach_sampling=cfg.detach_sampling, **kw)

        if self._sharding is not None:
            from jax.sharding import PartitionSpec as P
            render_tile = jax.shard_map(
                render_tile, mesh=self._mesh,
                in_specs=(P(), P("rays"), P("rays"), P(), P(), P()),
                out_specs=P("rays"), check_vma=False)

        def multi_pass(scene, acc, dirs, tc, origin, base_pass, refract_ind):
            def one_pass(k, acc):
                for t in range(ntiles):
                    rgb = render_tile(scene, dirs[t], tc[t], origin,
                                      base_pass + k, refract_ind)
                    acc = acc.at[t].add(rgb)
                return acc

            if n_passes == 1:
                return one_pass(jnp.int32(0), acc)
            return jax.lax.fori_loop(0, n_passes, one_pass, acc)

        return jax.jit(multi_pass, donate_argnums=(1,))

    # -- accumulation protocol --------------------------------------------

    def reset(self):
        """Camera move / slider / scene switch analog: clear the FBO and
        pass counter (montecarlo.cpp:238-246)."""
        self._acc = jnp.zeros((self._ntiles, self._tile, 3), jnp.float32,
                              device=self._sharding)
        self.nb_passes = 0

    def render_pass(self):
        """One progressive pass (paths_per_pass sub-passes, each with its
        own pass index — montecarlo.cpp:454-466)."""
        for _ in range(self.config.paths_per_pass):
            self._acc = self._pass_fn(
                self.scene, self._acc, self._dirs, self._tc, self._origin,
                jnp.int32(self.nb_passes),
                jnp.float32(self.config.refract_ind))
            self.nb_passes += 1

    def advance(self, spp: int) -> None:
        """Render up to spp passes with batched multi-pass calls, WITHOUT
        resolving an image — the resolve copies the whole accumulator to
        the host, so progressive loops and benchmarks call this and
        resolve once at the end. Returns once the device has finished.

        The paths_per_pass knob (the reference's paths-per-frame slider,
        montecarlo.cpp:454-466) folds into the same batched builder: a
        "frame" of k paths is just k consecutive pass indices, so batching
        them into one device call is accumulation-identical to k
        sequential dispatches and gets the same dispatch amortization as
        spp batching."""
        ppc = max(max(1, self.config.passes_per_call),
                  max(1, self.config.paths_per_pass))
        while self.nb_passes + ppc <= spp:
            if self._multi_fn is None or self._multi_n != ppc:
                self._multi_n = ppc
                self._multi_fn = self._build_pass_fn(ppc)
            self._acc = self._multi_fn(
                self.scene, self._acc, self._dirs, self._tc, self._origin,
                jnp.int32(self.nb_passes),
                jnp.float32(self.config.refract_ind))
            self.nb_passes += ppc
        while self.nb_passes < spp:
            self.render_pass()
        jax.block_until_ready(self._acc)

    def run(self, spp: int):
        """advance(spp) + resolve: returns the [H, W, 3] image."""
        self.advance(spp)
        return self.image()

    def resolve(self, acc=None, passes: int | None = None) -> np.ndarray:
        """Resolve an accumulator into an image: undo the pixel-block
        layout permutation, divide by the pass count (average.frag
        analog). `acc` defaults to this renderer's accumulator; passing an
        externally-summed accumulator (e.g. the cross-process sum in
        parallel/launcher.run_multihost_render) keeps the inverse
        permutation in ONE place so every resolve path agrees."""
        w, h = self.config.render_width, self.config.render_height
        if passes is None:
            passes = self.nb_passes
        a = np.asarray(self._acc if acc is None else acc)
        a = a.reshape(-1, 3)[: self._npix]
        a = a[self._inv_perm]              # undo the pixel-block layout
        return (a / max(1, passes)).reshape(h, w, 3)

    def image(self) -> np.ndarray:
        """Resolve: accumulated sum / pass count (average.frag analog).
        Returns [H, W, 3] float32, row 0 = bottom."""
        return self.resolve()

    def save_png(self, path: str):
        write_png(path, self.image())

    # -- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self, path: str):
        np.savez_compressed(
            path,
            acc=np.asarray(self._acc),
            nb_passes=self.nb_passes,
            config=json.dumps(asdict(self.config)),
        )

    def load_checkpoint(self, path: str):
        """Resume from an .npz checkpoint. Configs are compared with
        forward/backward compatibility: keys absent from the saved config
        (written by an older build, before a RenderConfig field existed)
        are filled with the field's DATACLASS default — not the current
        run's value, which would let a new non-default setting slip past
        the check — and unknown saved keys are ignored, so upgrading the
        framework does not orphan in-flight checkpoints. Any remaining
        mismatch still rejects, because every compared field affects
        either the accumulator layout (width/height/subsampling/
        pixel_order/tile_rays) or the accumulated radiance itself
        (bounces/IOR/integrator/...). The engine-routing knobs (route,
        pallas_interpret) are exempt with a warning: their radiance effect is
        negligible EXCEPT on exact float distance ties, where the
        kernel's nearest-first super order may pick a different — equally
        closest — winner prim than the ascending-order dense fold. The
        accepted tolerance is explicit: resumed accumulators may mix
        samples from both winners on tied rays."""
        z = np.load(path, allow_pickle=False)
        saved = json.loads(str(z["config"]))
        current = asdict(self.config)
        defaults = asdict(type(self.config)())
        routing_only = {"route", "pallas_interpret"}
        merged = {k: saved.get(k, defaults[k]) for k in current}
        diff = {k: (merged[k], current[k]) for k in current
                if merged[k] != current[k] and k not in routing_only}
        if diff:
            raise ValueError(
                f"checkpoint config mismatch (saved, current): {diff}")
        route_diff = {k: (merged[k], current[k]) for k in routing_only
                      if merged[k] != current[k]}
        if route_diff:
            import warnings
            warnings.warn(
                "resuming under a different engine route "
                f"{route_diff}: radiance identical except on exact "
                "distance ties (different winner prim possible there)",
                stacklevel=2)
        self._acc = jnp.asarray(z["acc"])
        self.nb_passes = int(z["nb_passes"])


def render_scene(scene_prims, config: RenderConfig, spp: int,
                 proj=None, view=None) -> np.ndarray:
    """Convenience one-shot: compile + render spp passes + resolve."""
    dev = compile_scene(scene_prims, flat_face=config.flat_face)
    r = Renderer(dev, config, proj, view)
    return r.run(spp)
