"""The one routing rule (models/montecarlo.choose_route) and what the
renderer does with it: the whole-pass kernel for analytic scenes on a GPU,
the dense route for meshes, gradients and every other backend; no silent
fallback when the kernel cannot run."""
import jax
import numpy as np
import pytest

from montecarlo_pathtracing_tpu.models import megakernel
from montecarlo_pathtracing_tpu.models.montecarlo import choose_route
from montecarlo_pathtracing_tpu.render.renderer import RenderConfig, Renderer
from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene


@pytest.fixture(scope="module")
def box():
    return compile_scene(scenes.build("box_diffuse"))


@pytest.fixture(scope="module")
def mesh():
    return compile_scene(scenes.build("mesh_demo"))


@pytest.fixture
def on_gpu(monkeypatch):
    """Pretend the default backend is a GPU (routing only: nothing here
    compiles the kernel)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_analytic_scene_on_gpu_takes_kernel(box, on_gpu):
    assert choose_route(box) == "megakernel"


def test_mesh_scene_takes_dense(mesh, on_gpu):
    assert choose_route(mesh) == "dense"


def test_gradients_take_dense(box, on_gpu):
    assert choose_route(box, differentiable=True) == "dense"


def test_cpu_backend_takes_dense(box):
    assert jax.default_backend() == "cpu"
    assert choose_route(box) == "dense"


def test_kernel_on_cpu_without_interpret_raises(box):
    r = Renderer(box, RenderConfig(width=16, height=8, nb_bounces=2,
                                   route="megakernel"))
    with pytest.raises(ValueError, match="compiles only for a GPU"):
        r.run(1)


def test_kernel_compile_error_propagates(box, monkeypatch):
    """A kernel that fails to compile raises out of the renderer; nothing
    re-runs the pass on another route."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel lowering failed")

    monkeypatch.setattr(megakernel, "_mega_call", broken)
    r = Renderer(box, RenderConfig(width=16, height=8, nb_bounces=2,
                                   route="megakernel",
                                   pallas_interpret=True))
    with pytest.raises(RuntimeError, match="kernel lowering failed"):
        r.run(1)
    assert r.nb_passes == 0


def test_unknown_route_rejected(box):
    r = Renderer(box, RenderConfig(width=16, height=8, route="pallas"))
    with pytest.raises(ValueError, match="unknown route"):
        r.run(1)


def test_renderer_kernel_route_matches_dense(box):
    """Renderer with the kernel (interpreted) accumulates the same image
    as the dense route: identical seeds, reassociation-level diffs."""
    kw = dict(width=24, height=16, nb_bounces=3, passes_per_call=2)
    k = Renderer(box, RenderConfig(route="megakernel",
                                   pallas_interpret=True, **kw)).run(2)
    d = Renderer(box, RenderConfig(route="dense", **kw)).run(2)
    np.testing.assert_allclose(k, d, rtol=1e-4, atol=1e-4)


def test_checkpoint_ignores_old_routing_keys(box, tmp_path):
    """Checkpoints written with the removed engine knobs still load."""
    import json
    r = Renderer(box, RenderConfig(width=16, height=8, nb_bounces=2))
    r.run(2)
    ck = str(tmp_path / "old.npz")
    r.save_checkpoint(ck)
    z = dict(np.load(ck))
    cfg = json.loads(str(z["config"]))
    for k in ("route", "pallas_interpret"):
        cfg.pop(k)
    cfg.update(use_pallas=True, use_megakernel=None, cull_chunks=None)
    z["config"] = json.dumps(cfg)
    np.savez_compressed(ck, **z)
    r2 = Renderer(box, RenderConfig(width=16, height=8, nb_bounces=2))
    r2.load_checkpoint(ck)
    assert r2.nb_passes == 2
    np.testing.assert_array_equal(r2.image(), r.image())


@pytest.mark.parametrize("flag", ["detach_sampling", "sort_rays"])
def test_kernel_refuses_dense_only_options(box, flag):
    """The kernel has no gradient rule and no wavefront sort: asking for
    either on the kernel route raises instead of silently dropping it."""
    import jax.numpy as jnp
    from montecarlo_pathtracing_tpu.models.montecarlo import raytrace
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 4, jnp.float32)
    tc = jnp.full((4, 2), 0.5, jnp.float32)
    with pytest.raises(ValueError, match="need route='dense'"):
        raytrace(box, jnp.zeros(3), d, tc, 0, nb_bounces=1, refract_ind=1.0,
                 route="megakernel", pallas_interpret=True, **{flag: True})
