"""Process groups for tensor parallelism and the training mesh (port of
``repro.launch.mesh``).

The reference builds a ``jax`` mesh over the devices one process sees.
The port is one process per rank: ``make_host_mesh`` joins this process
to a ``torch.distributed`` group as one rank and returns the
``distributed.ctx.TP`` the engine takes as its mesh, or, given a data
axis, the ``distributed.ctx.Mesh`` of a data x model training mesh (each
model row and each data column a group of its own); ``spawn`` and
``spawn_mesh`` start the ranks.  ``make_production_mesh`` is the
reference's 16 x 16 (or 2 x 16 x 16) pod mesh as a shape only, for the
sharding arithmetic: one card does not hold 256 ranks.

The groups use the gloo backend, whatever the card count: several ranks
may share one card (NCCL refuses that), and every collective then goes
through host memory.  NCCL across cards comes with a multi-card cell.
The rendezvous is a ``file://`` store in a temporary directory and gloo
is held to the loopback interface: nothing leaves the host.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..distributed.ctx import TP, Mesh
from ..distributed.sharding import ShapeOnlyMesh

# gloo binds its pairs to this interface: loopback only
GLOO_IFNAME = "lo"


def make_production_mesh(*, multi_pod: bool = False) -> ShapeOnlyMesh:
    """16 x 16 = 256 chips a pod ("data", "model"); ``multi_pod`` adds a
    2-pod axis in front.  A shape only."""
    if multi_pod:
        return ShapeOnlyMesh({"pod": 2, "data": 16, "model": 16})
    return ShapeOnlyMesh({"data": 16, "model": 16})


def make_host_mesh(model_parallel: int, rank: int, init_file: str,
                   device="cuda", data_parallel: int | None = None):
    """Join the gloo group at ``init_file`` (a path every rank shares) as
    ``rank``; the rank works on ``device``.  Without ``data_parallel``:
    a group of ``model_parallel`` ranks, returned as its ``TP``.  With it:
    a ``data_parallel`` x ``model_parallel`` training mesh, returned as
    this rank's ``Mesh``: rank ``d * model_parallel + m`` sits at (d, m);
    every rank creates each model row's group, then each data column's,
    in the same order.  A tensor on the card goes through a host copy in
    every collective (``TP.stage``)."""
    from .serve import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    os.environ.setdefault("GLOO_SOCKET_IFNAME", GLOO_IFNAME)
    world = model_parallel * (data_parallel or 1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    if data_parallel is None:
        return TP(group=dist.group.WORLD, rank=rank, size=model_parallel,
                  device=device)
    d, m = divmod(rank, model_parallel)
    rows = [dist.new_group([i * model_parallel + j
                            for j in range(model_parallel)])
            for i in range(data_parallel)]
    cols = [dist.new_group([i * model_parallel + j
                            for i in range(data_parallel)])
            for j in range(model_parallel)]
    return Mesh(shape={"data": data_parallel, "model": model_parallel},
                rank=rank,
                data=TP(group=cols[m], rank=d, size=data_parallel,
                        device=device),
                model=TP(group=rows[d], rank=m, size=model_parallel,
                         device=device),
                world=TP(group=dist.group.WORLD, rank=rank, size=world,
                         device=device),
                device=device)


def _rank_main(fn, rank, n, init_file, device, args, results,
               data_parallel=None):
    try:
        world = n * (data_parallel or 1)
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
        tp = make_host_mesh(n, rank, init_file, device, data_parallel)
        try:
            out = fn(tp, *args)
        finally:
            dist.destroy_process_group()
        # plain pickle bytes: a tensor is copied into them, where the
        # queue's own pickler would share its storage through a handle
        # that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                      # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_mesh(fn, shape: tuple, *args, device="cuda",
               timeout: float = 3600.0) -> list:
    """``spawn`` over a ``shape`` = (data, model) training mesh: ``fn(mesh,
    *args)`` in data x model processes, each with its ``Mesh``; the
    results in world-rank order."""
    data_parallel, model_parallel = shape
    return spawn(fn, model_parallel, *args, device=device, timeout=timeout,
                 data_parallel=data_parallel)


def spawn(fn, n: int, *args, device="cuda", timeout: float = 3600.0,
          data_parallel: int | None = None) -> list:
    """Run ``fn(tp, *args)`` in ``n`` new processes, rank r with its
    ``TP``; returns the ranks' results in rank order (each must pickle).
    Raises if any rank fails, with its traceback.  ``data_parallel``:
    ``data_parallel`` x ``n`` processes, each given its ``Mesh``.

    The ``spawn`` start method: a fork after CUDA is initialised breaks.
    On the card the parent builds the kernels first, so that the ranks
    load one library instead of racing to build it.  Free the parent's
    engines first (``gc.collect()``): the ranks share the card.
    """
    if torch.device(device).type == "cuda":
        from ..kernels import _build
        _build.build()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        world = n * (data_parallel or 1)
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, n, init_file, str(device), args, results, data_parallel))
            for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world and not errors:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"ranks {dead} died (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                    elif time.monotonic() > deadline:
                        errors.append(f"no result within {timeout} s")
                    continue
                if ok:
                    got[rank] = pickle.loads(out)
                else:
                    errors.append(f"rank {rank}:\n{out}")
        finally:
            for p in procs:
                p.join(timeout=5 if errors else None)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("tensor-parallel rank failed: " + "\n".join(errors))
    return [got[r] for r in range(world)]
