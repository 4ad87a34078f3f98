"""Run a function on the ranks of a gloo (CPU) process group, one process a rank.

``run(world, target, *args, **kwargs)`` spawns `world` processes.  Each sets
``torch.set_num_threads(1)``, joins a gloo group through a ``file://``
rendezvous in a fresh temporary directory (no port, so runs side by side do
not collide), optionally builds a mesh (``mesh=(shape, names)``: the
target then gets ``make_mesh(shape, names, device="cpu")`` as its ``mesh``
keyword), calls ``target(*args, **kwargs)`` and sends the result back, its
tensors as numpy arrays.  `target` must be importable by name (a function at
the top level of a module): spawned processes start from a fresh import.
Returns the ranks' results in rank order; raises if any rank failed, with
its traceback.

This is how the multi-rank paths run on one machine without cards: the
tests and ``dryrun_multichip``.  One card cannot hold two NCCL ranks.
"""
from __future__ import annotations

import multiprocessing
import queue
import tempfile
import time
import traceback

import torch

_TIMEOUT_S = 900.0   # the longest a run waits for its ranks' results


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank(rank: int, world: int, init_method: str, target, args, kwargs, mesh, results) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
        try:
            if mesh is not None:
                from .mesh import make_mesh

                kwargs = dict(kwargs, mesh=make_mesh(*mesh, device="cpu"))
            out = _to_host(target(*args, **kwargs))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run(world: int, target, *args, mesh: tuple | None = None, **kwargs) -> list:
    """``target(*args, **kwargs)`` on `world` gloo ranks; their results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    errors: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_rank, args=(r, world, init, target, args, kwargs, mesh, results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + _TIMEOUT_S
        try:
            # drain the queue before joining: a child blocks in put until its result is read
            while len(out) < world and not errors:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"ranks {dead} exited with {[procs[r].exitcode for r in dead]} and no result")
                    elif time.monotonic() > deadline:
                        errors.append(f"no result from {sorted(set(range(world)) - set(out))} in {_TIMEOUT_S} s")
                    continue
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank} failed:\n{value}")
        finally:
            for p in procs:   # after a failure the others may wait in a collective: end them
                p.join(timeout=10 if not errors else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]

