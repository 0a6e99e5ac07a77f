"""The tensor-parallel group (port of ``repro.launch.mesh``).

The reference builds a ``jax`` mesh over the devices one process sees.
The port is one process per rank: ``make_host_mesh`` joins this process
to a ``torch.distributed`` group as one rank and returns the
``distributed.ctx.TP`` the engine takes as its mesh; ``spawn`` starts the
ranks.

The group uses the gloo backend, whatever the card count: two ranks may
share one card (NCCL refuses that), and every collective then goes
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

from ..distributed.ctx import TP

# gloo binds its pairs to this interface: loopback only
GLOO_IFNAME = "lo"


def make_host_mesh(model_parallel: int, rank: int, init_file: str,
                   device="cuda") -> TP:
    """Join the gloo group of ``model_parallel`` ranks at ``init_file``
    (a path every rank shares) as ``rank``; the rank works on
    ``device``.  A tensor on the card goes through a host copy in every
    collective (``TP.stage``)."""
    from .serve import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    os.environ.setdefault("GLOO_SOCKET_IFNAME", GLOO_IFNAME)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=model_parallel, rank=rank)
    return TP(group=dist.group.WORLD, rank=rank, size=model_parallel,
              device=device)


def _rank_main(fn, rank, n, init_file, device, args, results):
    try:
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * n)))
        tp = make_host_mesh(n, rank, init_file, device)
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


def spawn(fn, n: int, *args, device="cuda", timeout: float = 3600.0) -> list:
    """Run ``fn(tp, *args)`` in ``n`` new processes, rank r with its
    ``TP``; returns the ranks' results in rank order (each must pickle).
    Raises if any rank fails, with its traceback.

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
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, n, init_file, str(device), args, results))
            for r in range(n)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n and not errors:
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
    return [got[r] for r in range(n)]
