"""Restartable multi-host launcher.

The reference is a single-process GL app with no failure handling beyond
shader-compile errors (SURVEY.md §5). For multi-host renders the framework
provides: `jax.distributed` initialization from env/flags, a render loop
that checkpoints the accumulation state every K passes, and crash-resume —
a relaunched process picks up at the last checkpointed pass, so losing a
host costs at most K passes of work.

One process per host: a single JAX process drives all the GPUs of its
host (shard over them with `Renderer(shard_devices=N)` or
parallel/sharding.py). A JAX process reserves most of a card's memory
when it first uses it, so several processes on one host must each own
their own card (e.g. CUDA_VISIBLE_DEVICES=k per process) or a share of
it (XLA_PYTHON_CLIENT_MEM_FRACTION); two processes on one card otherwise
fail for want of memory.

Launch (per host):
  python -m montecarlo_pathtracing_tpu render --distributed \\
      --coordinator host0:8476 --num-processes 4 --process-id $ID \\
      --checkpoint state.npz --checkpoint-every 64 ...

Determinism makes this safe: per-pixel seeds are pure functions of
(uv, pass), so re-rendering a partially-completed pass range after a
restart yields bit-identical contributions.
"""
from __future__ import annotations

import os

import jax


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """jax.distributed.initialize from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns this process's id. Safe to call when already initialized."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes > 1:
        if (jax.config.jax_platforms or "").startswith("cpu"):
            # CPU multi-process (tests / simulation): cross-process
            # collectives need the gloo transport. (Checked via the
            # config, not default_backend(), which would initialize the
            # backend before the collectives choice lands.)
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return process_id


def process_checkpoint_path(checkpoint: str, pid: int) -> str:
    """Per-process checkpoint name: rank tag before the extension."""
    root, ext = os.path.splitext(checkpoint)
    return f"{root}.p{pid}{ext or '.npz'}"


def run_multihost_render(renderer, spp: int, checkpoint: str | None = None,
                         checkpoint_every: int = 64):
    """Sample-axis data parallelism across PROCESSES (the multi-host
    scaling axis of SURVEY.md §2.3): process k of P renders the
    contiguous pass block [k*spp//P, (k+1)*spp//P) into its local
    accumulator, checkpointing every checkpoint_every passes; the final
    image is the cross-process sum of accumulators / spp (the
    psum-of-partial-sums accumulation protocol — average.frag analog at
    pod scale). Per-pixel seeds are pure functions of (uv, pass)
    (ops/rng.srand_soa), so the partitioning is invisible to the result
    and a crashed process resumes from its own checkpoint losing at most
    checkpoint_every passes.

    Each process checkpoints to '<checkpoint-root>.p<k>.npz' (np.savez
    appends .npz to suffix-less paths, so the rank tag goes before the
    extension). Returns the resolved [H, W, 3] image (every process
    returns the same array).
    """
    import numpy as np

    pid, nproc = jax.process_index(), jax.process_count()
    base = pid * spp // nproc
    end = (pid + 1) * spp // nproc
    ckpt = process_checkpoint_path(checkpoint, pid) if checkpoint else None
    if ckpt and os.path.exists(ckpt):
        renderer.load_checkpoint(ckpt)
    else:
        renderer.nb_passes = base          # pass-indexed seeds start here
    while renderer.nb_passes < end:
        target = min(end, renderer.nb_passes + max(1, checkpoint_every))
        renderer.run(target)
        if ckpt:
            renderer.save_checkpoint(ckpt)
    if nproc > 1:
        from jax.experimental import multihost_utils
        parts = multihost_utils.process_allgather(renderer._acc)
        acc = np.asarray(parts).sum(axis=0)       # process-ascending order
    else:
        acc = np.asarray(renderer._acc)
    # Resolve through the renderer so the block32 pixel permutation is
    # inverted exactly as in Renderer.image() (round-2 bug: reshaping the
    # raw accumulator scrambled any image wider than one 32-px block).
    return renderer.resolve(acc, passes=spp)


def run_distributed_render(renderer, spp: int, checkpoint: str | None,
                           checkpoint_every: int = 64,
                           is_coordinator: bool | None = None):
    """Progressive render with periodic checkpointing; resumes from
    `checkpoint` if present. Only the coordinator writes checkpoints and
    the final image (single-writer; the accumulator state is replicated
    or sharded identically on every host by construction)."""
    if is_coordinator is None:
        is_coordinator = jax.process_index() == 0
    if checkpoint and os.path.exists(checkpoint):
        renderer.load_checkpoint(checkpoint)
    while renderer.nb_passes < spp:
        target = min(spp, renderer.nb_passes + max(1, checkpoint_every))
        renderer.run(target)
        if checkpoint and is_coordinator:
            renderer.save_checkpoint(checkpoint)
    return renderer.image()
