"""montecarlo_pathtracing_tpu — a differentiable Monte Carlo path tracer in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
OpenGL path tracer (ksaintmarc/Montecarlo-PathTracing): progressive Monte
Carlo path tracing of analytic-primitive + triangle-mesh scenes with the
4-case material model (diffuse / reflective / refractive / mixed), BVH
acceleration, multi-device ray sharding over a `jax.sharding.Mesh`, and an
end-to-end differentiable render path.

Layer map (not a port):
  ops/       device math: RNG, intersectors, sampling, trace fold, shading
  models/    integrators (the reference's tp/*.frag carousel) and the
             whole-pass Pallas-Triton kernel for analytic scenes on a GPU
  scene/     host scene builder, BVH builder, demo scenes, device compile
  render/    camera + progressive renderer + checkpointing
  parallel/  device-mesh sharding of the ray batch
  utils/     transforms, PNG IO
  native/    optional C++ host components (BVH builder)
"""

__version__ = "0.1.0"

from .scene.scene import Material, ScenePrimitives  # noqa: F401
from .scene import scenes  # noqa: F401
