"""Multi-host launcher: 2-process jax.distributed CPU simulation.

SURVEY.md §4's planned distributed test: run_multihost_render across two
real OS processes with gloo CPU collectives, asserting (a) the
distributed image matches a single-process render, and (b) a crash +
relaunch resumes from checkpoints to a BIT-IDENTICAL image (per-pixel
seeds are pure functions of (uv, pass), so the pass partition and the
resume point are invisible to the result)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(__file__), "launcher_worker.py")
SPP = 8


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp, out, port, crash_at=None, checkpoint=None):
    procs = []
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    for pid in (0, 1):
        cmd = [sys.executable, WORKER, "--process-id", str(pid),
               "--num-processes", "2", "--port", str(port),
               "--spp", str(SPP), "--out", out,
               "--checkpoint-every", "2"]
        if checkpoint:
            cmd += ["--checkpoint", checkpoint]
        if crash_at is not None:
            cmd += ["--crash-at", str(crash_at)]
        procs.append(subprocess.Popen(
            cmd, cwd=str(tmp), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out_b, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out_b.decode(errors="replace")))
    return outs


def _single_process_reference():
    import jax
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)
    dev = compile_scene(scenes.build("box_diffuse"))
    # 64x48 (must match launcher_worker.py): width > 32 makes block32 a
    # real permutation, so this test catches a launcher that forgets the
    # inverse permutation (the round-2 scrambled-image bug).
    cfg = RenderConfig(width=64, height=48, nb_bounces=6,
                       passes_per_call=1, tile_rays=1 << 10)
    r = Renderer(dev, cfg)
    return r.run(SPP)


def test_single_process_launcher_matches_renderer_image(tmp_path):
    """run_multihost_render with nproc=1 must equal Renderer.image()
    BIT-identically at a width > 32 — the in-process pin for the round-2
    scrambled-image bug (launcher resolve skipped the inverse block32
    permutation). No subprocesses, so it runs in the fast suite."""
    import jax
    from montecarlo_pathtracing_tpu.parallel.launcher import (
        run_multihost_render)
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)
    if jax.process_count() != 1:
        pytest.skip("needs a single-process backend")
    dev = compile_scene(scenes.build("box_diffuse"))
    cfg = RenderConfig(width=64, height=48, nb_bounces=3,
                       passes_per_call=1, tile_rays=1 << 10)
    r = Renderer(dev, cfg)
    img = run_multihost_render(r, 2)
    ref = r.image()
    assert r.nb_passes == 2
    np.testing.assert_array_equal(img, ref)
    # and the permutation really is non-trivial at this size
    assert not np.array_equal(r._inv_perm, np.arange(r._npix))


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    out = str(tmp_path / "dist.npy")
    results = _launch(tmp_path, out, _free_port())
    for rc, log in results:
        assert rc == 0, log[-2000:]
    img = np.load(out)
    ref = _single_process_reference()
    # partitioned accumulation reorders f32 adds across the process
    # boundary; everything else is bit-identical
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_crash_resume_bit_identical(tmp_path):
    ck = str(tmp_path / "state.npz")
    out_a = str(tmp_path / "uninterrupted.npy")
    results = _launch(tmp_path, out_a, _free_port())
    for rc, log in results:
        assert rc == 0, log[-2000:]

    # crashed run: processes die after 2 local passes. The first
    # os._exit(3) also kills the peer through the coordination service
    # (socket closed -> nonzero exit), possibly before the peer saved its
    # own checkpoint — both are legitimate failure shapes; resume must
    # handle a missing checkpoint by restarting that process's block.
    out_b = str(tmp_path / "crashed.npy")
    results = _launch(tmp_path, out_b, _free_port(), crash_at=2,
                      checkpoint=ck)
    assert all(rc != 0 for rc, _ in results), results
    from montecarlo_pathtracing_tpu.parallel.launcher import (
        process_checkpoint_path)
    assert (os.path.exists(process_checkpoint_path(ck, 0))
            or os.path.exists(process_checkpoint_path(ck, 1)))
    assert not os.path.exists(out_b)

    # relaunch: resumes from the checkpoints and completes
    results = _launch(tmp_path, out_b, _free_port(), checkpoint=ck)
    for rc, log in results:
        assert rc == 0, log[-2000:]
    a = np.load(out_a)
    b = np.load(out_b)
    np.testing.assert_array_equal(a, b)   # BIT-identical, not just close
