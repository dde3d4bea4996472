"""Production meshes of the port and the card's constants.

Single pod: (data=16, model=16) = 256 ranks; multi-pod: (pod=2, data=16,
model=16) = 512 ranks, the pod axis extending data parallelism (weights
replicated across pods; gradients cross pods once per step).  The shapes
are the JAX package's (``repro.launch.mesh``), so that records of the two
compare; a rank is one card here, one chip there.

A ``DeviceMesh`` needs a process group of at least its size.  The dry run
starts the ``fake`` backend at 256 or 512 ranks (:func:`start_fake_world`)
before it builds a mesh -- the counterpart of setting ``XLA_FLAGS`` before
the JAX import -- and a trainer starts gloo (CPU) or NCCL (cards) ranks.
Defined as functions, so importing this module starts nothing.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM 80GB data sheet, dense, 700 W power limit (per card)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12              # B/s
LINK_BW = 450e9               # B/s, NVLink, each way
PEAK_FLOPS_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, TF32 tensor cores
HBM_BYTES = 80e9              # device memory

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod"."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = 1
    for s in shape:
        n *= s
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; the process group has "
            f"{have} -- the dry run must call start_fake_world({n}) before "
            "it builds a mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device="cpu"):
    """1 x 1 ("data", "model") mesh over a world of one rank, for smoke
    tests and local runs (the process group must already exist)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, (1, 1),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    """The batch-sharding axes for this mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def start_fake_world(n: int) -> None:
    """A process group of ``n`` ranks on the ``fake`` backend, this process
    rank 0: collectives return at once and move nothing, so a step traced
    under ``FakeTensorMode`` on it allocates nothing and touches no device.
    A world of another size is torn down first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


# -- a world of CPU ranks ----------------------------------------------------------


def _gloo_rank(rank, n, init_file, fn, args, queue):
    """One spawned rank: join the gloo world, run ``fn(rank, *args)``, put
    (rank, result or failure) on ``queue``, leave the world."""
    import traceback

    import torch.distributed as dist
    # a rank's ops are small and its time is the host's dispatch: one
    # thread each keeps n ranks from oversubscribing the cores
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=n)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException as e:
        queue.put((rank, RuntimeError(
            f"rank {rank}: {type(e).__name__}: {e}\n"
            + traceback.format_exc(limit=-12))))
        raise


def start_gloo_world(n: int, fn, args, tmp):
    """Start ``fn(rank, *args)`` in ``n`` spawned processes joined by a gloo
    process group over a file store in the directory ``tmp`` (no network);
    :func:`join_gloo_world` collects the results, so the caller can work
    while the ranks run.  ``fn`` must be importable by name."""
    import multiprocessing as mp
    import os
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init_file = os.path.join(str(tmp), "store")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, n, init_file, fn, args, q))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs, q


def join_gloo_world(world, timeout=None):
    """Each rank's result in rank order, or the first rank's failure; every
    process is joined (or killed) on the way out."""
    import queue as queue_mod
    import time
    procs, q = world
    results = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(results) < len(procs):
            try:
                rank, out = q.get(timeout=2)
            except queue_mod.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"world of {len(procs)} ranks: "
                                       f"{len(results)} answered in "
                                       f"{timeout} s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError("a rank died: exit codes "
                                       f"{[p.exitcode for p in procs]}")
                continue
            if isinstance(out, BaseException):
                raise out
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(len(procs))]
