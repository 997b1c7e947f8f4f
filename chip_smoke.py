"""Prove the path tracer's main path on one GPU, end to end.

    python chip_smoke.py [--out DIR]      # one card: every phase below
    python chip_smoke.py --four [--out DIR]   # four cards: sharding only

Phases (one process; the CLI is called in-process, because a second JAX
process could not get the card's memory):

  device   the first JAX device must be a GPU; prints the card's name and
           power limit (nvidia-smi) and the JAX version
  oracle   dense route and compiled kernel vs the scalar CPU oracle
           (testing/cpu_ref.py) on box_diffuse and box_balls, at
           tests/test_parity.py's sizes and thresholds
  kernel   the compiled whole-pass kernel (models/megakernel.py) vs the
           dense route at 800x600, 3 bounces, 4 passes, on four scenes
  main     `render` through cli.main and Renderer.run at 800x600,
           3 bounces, 64 spp on box_diffuse, box_balls and mesh_demo;
           writes the PNGs to --out
  timing   cold compile seconds and the median of 5 timed windows for
           each route and scene, every window printed
  four     (--four only) pixel sharding and sample-axis psum over four
           cards vs the one-card results

Any failed phase makes the script exit non-zero without the final line.
The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

W, H, BOUNCES = 800, 600, 3
KERNEL_SCENES = ("box_diffuse", "box_balls", "materials", "colonnes")
MAIN_SCENES = ("box_diffuse", "box_balls", "mesh_demo")
# pixels within atol + rtol*|dense| of the dense route: the RNG schedule
# is identical, so only contraction order (the kernel fuses multiply-adds
# differently) can flip a branch on a few grazing rays
KERNEL_ATOL, KERNEL_RTOL, KERNEL_MIN_SHARE = 1e-4, 1e-3, 0.999
# (scene, w, h, spp, bounces, ior, min_match, atol): tests/test_parity.py's
# cases and thresholds, plus an exact 1-bounce case for box_balls. Every
# case also holds the image mean to test_parity's 5e-3.
ORACLE_CASES = (("box_diffuse", 16, 12, 1, 1, 1.0, 1.0, 1e-4),
                ("box_balls", 12, 10, 1, 1, 1.3, 1.0, 1e-4),
                ("box_diffuse", 16, 12, 2, 4, 1.0, 0.94, 2e-2),
                ("box_balls", 12, 10, 2, 5, 1.3, 0.92, 2e-2))
ORACLE_MEAN_TOL = 5e-3
SHARD_RTOL = SHARD_ATOL = 1e-6       # tests/test_sharding.py
N_WINDOWS, WINDOW_PASSES = 5, 8


def phases_for(four: bool) -> tuple[str, ...]:
    """The phases a run executes: --four runs the four-card path and
    what it is compared with, and nothing else."""
    if four:
        return ("device", "four")
    return ("device", "oracle", "kernel", "main", "timing")


def card_line() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi printed nothing"


def _renderer(scene_name, route=None, *, w=W, h=H, bounces=BOUNCES,
              ior=1.0, passes_per_call=WINDOW_PASSES, shard_devices=0,
              pallas_interpret=False):
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)
    dev = compile_scene(scenes.build(scene_name))
    return Renderer(dev, RenderConfig(
        width=w, height=h, nb_bounces=bounces, refract_ind=ior,
        route=route, passes_per_call=passes_per_call, tile_rays=1 << 17,
        shard_devices=shard_devices, pallas_interpret=pallas_interpret))


# -- phases -------------------------------------------------------------

def phase_device(card):
    import jax
    d0 = jax.devices()[0]
    print(f"device: platform={d0.platform} kind={d0.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__}")
    print(f"card: {card}")
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {d0.platform!r}")


def seed_bits_line() -> str:
    """How many screen coordinates (x+.5)/W would seed another RNG stream
    if divided on the device instead of on the host (render/camera.py)."""
    import jax.numpy as jnp
    bad = {}
    for n in sorted({W, H, 16, 12, 10}):
        dev = np.asarray((jnp.arange(n, dtype=jnp.float32) + 0.5) / n)
        host = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / \
            np.float32(n)
        bad[n] = int((dev.view(np.uint32) != host.view(np.uint32)).sum())
    return (f"oracle seed bits: (x+.5)/n divided on the device differs "
            f"from IEEE float32 in {bad} of the n values per size n; "
            f"camera_rays divides on the host")


def phase_oracle(card):
    """Both routes vs the CPU oracle at test_parity's sizes and bounds."""
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)
    from montecarlo_pathtracing_tpu.testing.cpu_ref import CPUReference
    print(seed_bits_line())
    failed = []
    for name, w, h, spp, bounces, ior, min_match, atol in ORACLE_CASES:
        prims = scenes.build(name)
        dev = compile_scene(prims)          # sorts emissives in place
        ref = None
        for route in ("dense", "megakernel"):
            r = Renderer(dev, RenderConfig(
                width=w, height=h, nb_bounces=bounces, refract_ind=ior,
                route=route))
            img = r.run(spp)
            if ref is None:
                ref = CPUReference(prims).render(r.proj, r.view, w, h, spp,
                                                 bounces, ior)
            close = np.all(np.abs(img - ref) <= atol + 1e-3 * np.abs(ref),
                           -1)
            mean_diff = float(img.mean()) - float(ref.mean())
            ok = close.mean() >= min_match and abs(mean_diff) < \
                ORACLE_MEAN_TOL
            print(f"oracle {name} {route} {w}x{h} spp={spp} "
                  f"bounces={bounces} ior={ior}: share {close.mean():.6f} "
                  f"(need >= {min_match}, atol {atol} rtol 1e-3), "
                  f"{int((~close).sum())} diverged pixels "
                  f"{np.argwhere(~close).tolist()}, mean diff "
                  f"{mean_diff:.3g} (need |.| < {ORACLE_MEAN_TOL}), max diff "
                  f"{np.abs(img - ref).max():.3g}")
            if not ok:
                failed.append(f"{name}/{route}/{bounces}")
    assert not failed, failed


def phase_kernel(card):
    import jax
    for name in KERNEL_SCENES:
        rk = _renderer(name, "megakernel", passes_per_call=4)
        img_k = rk.run(4)
        with jax.default_matmul_precision("highest"):
            img_d = _renderer(name, "dense", passes_per_call=4).run(4)
        close = np.all(np.abs(img_k - img_d)
                       <= KERNEL_ATOL + KERNEL_RTOL * np.abs(img_d), -1)
        share = float(close.mean())
        print(f"kernel {name} prims={rk.scene.nb_prims} {W}x{H}x{BOUNCES} "
              f"4 passes: share {share:.6f} within atol {KERNEL_ATOL} "
              f"rtol {KERNEL_RTOL} (need >= {KERNEL_MIN_SHARE}); max diff "
              f"{np.abs(img_k - img_d).max():.4g}; means "
              f"{img_k.mean():.6f} / {img_d.mean():.6f}")
        assert np.isfinite(img_k).all(), name
        assert share >= KERNEL_MIN_SHARE, name


def phase_main(card, out):
    from montecarlo_pathtracing_tpu import cli
    from montecarlo_pathtracing_tpu.models.montecarlo import choose_route
    from montecarlo_pathtracing_tpu.utils.image import read_png
    os.makedirs(out, exist_ok=True)
    for name in MAIN_SCENES:
        png = os.path.join(out, f"cli_{name}.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--scene", name, "--width", str(W),
                       "--height", str(H), "--bounces", str(BOUNCES),
                       "--spp", "64", "--out", png])
        dt = time.perf_counter() - t0
        img = read_png(png)
        print(f"main cli {name}: rc={rc} shape={img.shape} "
              f"mean={img.mean():.3f} ({dt:.1f}s incl. compile) -> {png}")
        assert rc == 0 and img.shape[:2] == (H, W) and img.mean() > 0, name

        r = _renderer(name)
        t0 = time.perf_counter()
        img = r.run(64)
        dt = time.perf_counter() - t0
        route = choose_route(r.scene)
        r.save_png(os.path.join(out, f"run_{name}.png"))
        print(f"main Renderer.run {name}: route={route} shape={img.shape} "
              f"finite={bool(np.isfinite(img).all())} mean={img.mean():.6f} "
              f"({dt:.1f}s incl. compile)")
        assert img.shape == (H, W, 3) and np.isfinite(img).all(), name
        assert img.mean() > 0, name


def time_route(scene_name, route, card, passes=WINDOW_PASSES):
    """Cold compile + N_WINDOWS timed windows of `passes` passes through
    Renderer.advance (which ends in block_until_ready)."""
    r = _renderer(scene_name, route, passes_per_call=passes)
    t0 = time.perf_counter()
    r.advance(passes)
    cold = time.perf_counter() - t0
    wins = []
    for _ in range(N_WINDOWS):
        t0 = time.perf_counter()
        r.advance(r.nb_passes + passes)
        wins.append(time.perf_counter() - t0)
    med = statistics.median(wins)
    rays = W * H * passes * BOUNCES
    print(f"timing {scene_name} route={r.config.route} {W}x{H}x{BOUNCES} "
          f"window={passes} passes: cold {cold:.3f} s, median {med:.6f} s "
          f"= {rays / med:.6g} rays/s, windows {[f'{x:.6f}' for x in wins]}"
          f" [{card}]")
    return med


def phase_timing(card):
    for name in KERNEL_SCENES:
        time_route(name, "megakernel", card)
        time_route(name, "dense", card)
    time_route("mesh_demo", "dense", card, passes=1)


def check_four_cards(n_devices=4, w=W, h=H, passes=4,
                     pallas_interpret=False):
    """Pixel sharding (Renderer(shard_devices=n)) on the route the
    renderer picks vs the one-device accumulator, and
    make_sample_sharded_pass vs n sequential one-device passes, on
    box_diffuse. Returns a list of printable result lines."""
    import jax
    import jax.numpy as jnp
    from montecarlo_pathtracing_tpu.models.registry import get_integrator
    from montecarlo_pathtracing_tpu.parallel.sharding import (
        make_mesh, make_sample_sharded_pass)
    from montecarlo_pathtracing_tpu.render.camera import (
        default_rt_camera, camera_rays)

    route = "megakernel" if pallas_interpret else None
    lines = []
    one = _renderer("box_diffuse", route, w=w, h=h, passes_per_call=passes,
                    pallas_interpret=pallas_interpret)
    img1 = one.run(passes)
    shard = _renderer("box_diffuse", route, w=w, h=h,
                      passes_per_call=passes, shard_devices=n_devices,
                      pallas_interpret=pallas_interpret)
    imgn = shard.run(passes)
    devs = shard._acc.sharding.device_set
    shard_rows = {s.device.id: s.data.shape[1]
                  for s in shard._acc.addressable_shards}
    err = np.abs(imgn - img1).max()
    lines.append(f"four pixel-sharded box_diffuse {w}x{h} {passes} passes "
                 f"on {len(devs)} devices, rays per device per tile "
                 f"{shard_rows}: max |diff| vs one device {err:.3g} "
                 f"(rtol {SHARD_RTOL}, atol {SHARD_ATOL})")
    np.testing.assert_allclose(imgn, img1, rtol=SHARD_RTOL, atol=SHARD_ATOL)
    assert len(devs) == n_devices
    assert len(set(shard_rows.values())) == 1, "unbalanced ray shards"

    scene = one.scene
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    dirs, tc = jnp.asarray(dirs.reshape(-1, 3)), jnp.asarray(tc.reshape(-1, 2))
    kw = dict(route=route, pallas_interpret=pallas_interpret)
    fn = make_sample_sharded_pass(make_mesh(n_devices, axis_name="spp"),
                                  nb_bounces=BOUNCES, **kw)
    got = np.asarray(fn(scene, dirs, tc, origin, jnp.int32(0),
                        jnp.float32(1.0)))
    integrator = get_integrator("montecarlo")
    want = sum(np.asarray(integrator(
        scene, origin, dirs, tc, jnp.int32(k), nb_bounces=BOUNCES,
        refract_ind=jnp.float32(1.0), **kw)) for k in range(n_devices))
    err = np.abs(got - want).max()
    lines.append(f"four sample-sharded psum box_diffuse {w}x{h}: "
                 f"{n_devices} passes on {n_devices} devices vs sequential "
                 f"on one: max |diff| {err:.3g} (rtol {SHARD_RTOL}, atol "
                 f"{SHARD_ATOL})")
    np.testing.assert_allclose(got, want, rtol=SHARD_RTOL, atol=SHARD_ATOL)
    stats = []
    for d in jax.devices()[:n_devices]:
        m = d.memory_stats() or {}
        stats.append((d.id, m.get("peak_bytes_in_use")))
    lines.append(f"four peak bytes in use per device: {stats}")
    return lines


def phase_four(card):
    import jax
    n = len(jax.devices())
    if n < 4:
        raise SystemExit(f"--four needs 4 devices, JAX sees {n}")
    for line in check_four_cards(4):
        print(f"{line} [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharding path")
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the rendered PNGs")
    args = ap.parse_args(argv)

    import jax
    from montecarlo_pathtracing_tpu.utils.profiling import (
        enable_compilation_cache)

    card = card_line()
    phase_device(card)                  # exits before anything else
    print(f"compile cache: {enable_compilation_cache()}")
    runners = {
        "oracle": lambda: phase_oracle(card),
        "kernel": lambda: phase_kernel(card),
        "main": lambda: phase_main(card, args.out),
        "timing": lambda: phase_timing(card),
        "four": lambda: phase_four(card),
    }
    failed = []
    for name in phases_for(args.four)[1:]:
        t0 = time.perf_counter()
        try:
            runners[name]()
        except Exception:                   # report, run the rest, fail
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    d0 = jax.devices()[0]
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
