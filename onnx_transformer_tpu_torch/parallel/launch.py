"""Run one function on N ranks of a process group, one process each.

The JAX package drives every device from one controller; the port runs one
process per rank.  :func:`launch` starts the ranks with
``torch.multiprocessing.start_processes(..., start_method="spawn")``, joins
them in one process group that meets through a ``file://`` store in a
temporary directory (no TCP port: several launches may run side by side on
one host), and waits:

- a rank that raises ends the launch: every other rank is killed and the
  caller gets a ``RuntimeError`` with the traceback of each rank that
  raised, the first to fail first (a rank's failure makes the others fail
  in their next collective);
- past ``timeout_s`` every rank is killed and ``TimeoutError`` is raised;
- on the CPU each rank runs ``torch.set_num_threads`` threads at most, its
  share of the host's cores;
- rank 0's return value (pickled, so tensors on the CPU) is handed back.

``fn`` must be importable by name (a module's top-level function), since a
spawned process starts from a fresh interpreter and unpickles it.  The ranks
read their coordinates from ``torch.distributed`` (``make_mesh``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, args: tuple, world: int, init: str, backend: str,
               result: str, threads: int, timeout_s: float) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    out = fn(*args)
    if rank == 0:
        torch.save(out, result + ".tmp")
        os.replace(result + ".tmp", result)
    # only after success: a rank that raises writes its traceback before
    # its exit closes the group under the others
    dist.destroy_process_group()


def _rank_errors(ctx) -> str:
    """The tracebacks that the failed ranks wrote, oldest first; the files
    are removed."""
    found = sorted((os.path.getmtime(path), rank, path)
                   for rank, path in enumerate(ctx.error_files) if os.path.exists(path))
    msg = ""
    for _, rank, path in found:
        with open(path, "rb") as f:
            msg += f"\n-- rank {rank} raised:\n{pickle.load(f)}"
        os.remove(path)
    return msg


def launch(fn: Callable, nprocs: int, *args, backend: str = "gloo",
           timeout_s: float = 600.0) -> Any:
    """``fn(*args)`` on ``nprocs`` ranks of a ``backend`` process group;
    returns rank 0's result.  See the module docstring for failures."""
    threads = max(1, min(4, (os.cpu_count() or 1) // nprocs))
    with tempfile.TemporaryDirectory(prefix="launch-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        result = os.path.join(tmp, "result.pt")
        ctx = mp.start_processes(_rank_main, nprocs=nprocs, join=False, start_method="spawn",
                                 args=(fn, args, nprocs, init, backend, result, threads,
                                       timeout_s))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} "
                                       f"ran past {timeout_s} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"a rank of {getattr(fn, '__name__', fn)} failed:"
                               f"{_rank_errors(ctx) or e}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            _rank_errors(ctx)
        return torch.load(result, weights_only=False)
