"""Meshes over ``torch.distributed`` ranks, and local ranks to make them.

Ports ``make_production_mesh``, ``make_host_mesh``, ``parse_mesh`` and
``host_mesh`` of ``repro/launch/mesh.py``: a mesh is a ``DeviceMesh``
with axes ``("data", "model")`` (``("pod", "data", "model")`` multi-pod)
over the initialised world, one rank a card (``cuda:LOCAL_RANK``, NCCL,
under ``torchrun``) or a CPU process (gloo).  :func:`spawn` is the
counterpart of the reference's forced host devices: it starts N local
ranks on the CPU, which the mesh round's tests and the training CLI's
``--devices N`` run on, and :func:`init_world` joins the world that
``torchrun`` describes, or makes a world of one.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

_HINT = ("start more ranks: on the CPU, train.py --devices N (or "
         "launch.mesh.spawn(fn, N)); on cards, torchrun --nproc-per-node N")


def _mesh(shape, names):
    """A DeviceMesh of ``shape`` over the initialised world: device type
    ``cuda`` on NCCL, else ``cpu`` (gloo; its collectives take the
    tensors of either device)."""
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production shapes: 16 x 16 (data, model), or 2 x 16
    x 16 with a leading ``pod`` axis; the world must have 256 or 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A small (data, model) mesh over the ranks that exist, clamped to
    them (examples that should run anywhere).  Launch paths that need the
    requested shape (``--mesh``) go through :func:`host_mesh`, which
    raises."""
    n = max(_world(), 1)
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _mesh((data, model), ("data", "model"))


def parse_mesh(spec: str):
    """``"4"`` → ``(4, 1)``; ``"4x2"`` → ``(4, 2)`` — (data, model) sizes."""
    parts = str(spec).lower().split("x")
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"bad mesh spec {spec!r}; expected DATA or "
                         "DATAxMODEL, e.g. '4' or '4x2'")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}; expected DATA or "
                         "DATAxMODEL, e.g. '4' or '4x2'") from None
    if any(d < 1 for d in dims):
        raise ValueError(f"mesh spec {spec!r} has non-positive axis sizes")
    return dims if len(dims) == 2 else (dims[0], 1)


def host_mesh(spec: str):
    """The (data, model) mesh of a ``--mesh`` spec over the initialised
    world.  Raises when the world has other than the ``DATA x MODEL``
    ranks the spec needs, with a hint on how to start them: a clamped mesh
    would make a '--mesh 4' run a single rank."""
    data, model = parse_mesh(spec)
    need, have = data * model, _world()
    if have < need:
        raise RuntimeError(
            f"mesh {spec!r} needs {need} ranks but only {have} are "
            f"running; {_HINT}")
    if have != need:
        raise RuntimeError(f"mesh {spec!r} needs {need} ranks; {have} are "
                           "running")
    return _mesh((data, model), ("data", "model"))


def init_world(device):
    """Join a ``torch.distributed`` world for a mesh round on ``device``
    (``cuda`` or ``cpu``): none if one is initialised; the one ``torchrun``
    describes (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``...; each rank on
    ``cuda:LOCAL_RANK``); else a world of one, through a ``FileStore`` in
    a temporary directory.  NCCL on cards, gloo on the CPU.  Returns None,
    or (where it made the world) the function that ends it."""
    if dist.is_initialized():
        return None
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    tmp = None
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        tmp = tempfile.mkdtemp(prefix="repro_world_")
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)

    def end():
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return end


def _rank_main(rank, world, store, out, fn, args, threads):
    """One spawned rank: join the gloo world through the FileStore, run
    ``fn(*args)``, rank 0 saves its result; the world ends either way."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        result = fn(*args)
        if rank == 0:
            torch.save(result, os.path.join(out, "result.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, threads=None, timeout=None):
    """Run ``fn(*args)`` in ``world`` local ranks and return rank 0's
    result.  The ranks are new processes (the ``spawn`` start method: a
    forked child would inherit the caller's threads and accelerator state)
    that join one gloo world through a ``FileStore`` in a temporary
    directory, so no TCP port is chosen and two callers cannot collide;
    ``fn`` and ``args`` must pickle (``fn`` importable in a new process).
    ``threads`` sets each rank's intra-op threads.  A rank that fails
    fails the call, with its traceback; past ``timeout`` seconds the ranks
    are killed and ``TimeoutError`` raised."""
    tmp = tempfile.mkdtemp(prefix="repro_spawn_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, os.path.join(tmp, "store"), tmp, fn,
                              args, threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                   f"past {timeout} s")
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
