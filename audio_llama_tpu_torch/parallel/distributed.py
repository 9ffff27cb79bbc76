"""The process world: `torch.distributed` set-up and a spawn helper.

Counterpart of `audio_llama_tpu/parallel/distributed.py`, where
`jax.distributed.initialize` wires one process per host and the mesh spans
every host's devices. Here one process runs per mesh position (see
`parallel/mesh.py`), and the backend is the caller's choice, never changed
quietly:
  - "gloo" on the CPU (the tests), and on the card when several ranks share
    one device (NCCL refuses two ranks on one device);
  - "nccl" when each rank has a card of its own.

`spawn(fn, world, backend, device)` starts a world of fresh processes on
this host (the `spawn` start method), wires it through a TCP store that the
calling process serves on a port the system picks and holds for the
world's whole life (so two worlds started at once never meet), runs
fn(rank, world, *args) in each and returns the results by rank; an
exception in any rank fails the whole world.
"""

from __future__ import annotations

import logging
import pickle
import datetime
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BACKENDS = ("gloo", "nccl")


def initialize(backend: str, init_method: str = "env://", world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None, store=None) -> tuple[int, int]:
    """`dist.init_process_group` with an explicit backend -> (rank, world).
    `device` (a CUDA device, for nccl) binds the rank to its card. With
    env:// the world size and rank may come from WORLD_SIZE / RANK. A
    `store` (a `dist.Store`) replaces `init_method`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            if backend == "nccl":
                kw["device_id"] = device
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    dist.init_process_group(backend, **kw)
    r, w = dist.get_rank(), dist.get_world_size()
    logger.info("distributed: rank %d of %d (%s)", r, w, backend)
    return r, w


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) when no world is running."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_coordinator() -> bool:
    return process_info()[0] == 0


def rank_device(device: str, rank: int) -> torch.device:
    """"cuda" alone means one card per rank (cuda:rank); any other device
    string ("cpu", "cuda:0") is shared by every rank."""
    return torch.device("cuda", rank) if device == "cuda" else torch.device(device)


def _to_host(obj):
    """Tensors of a result -> CPU tensors (detached), recursively."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _report(results, item) -> None:
    """Put one message and wait until it is whole in the pipe: a rank that
    is stopped later (its peers failed) leaves no half message behind."""
    results.put(item)
    results.close()
    results.join_thread()


def _worker(rank, fn, world, backend, device, port, args, results, threads):
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                          timeout=datetime.timedelta(seconds=300))
    initialize(backend, world_size=world, rank=rank, device=dev, store=store)
    try:
        try:
            out = fn(rank, world, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except BaseException:
            # the cause, for the parent: the other ranks then fail too, in
            # their next collective, and may be the first to be noticed
            _report(results, (rank, None, traceback.format_exc()))
            raise
        # pickled here by value: the parent may read it after this rank exits
        _report(results, (rank, pickle.dumps(_to_host(out)), None))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str = "gloo", device: str = "cpu",
          args: Sequence[Any] = (), timeout: float = 900.0,
          threads: Optional[int] = None) -> list:
    """Run fn(rank, world, *args) in `world` new processes joined into one
    `torch.distributed` world -> [result of rank 0, ..., rank world-1].

    fn must be importable (a module-level function); its result is returned
    with its tensors moved to the CPU. `device`: "cpu", one device shared by
    every rank ("cuda:0", with gloo), or "cuda" (rank r on cuda:r, for
    nccl). `threads` caps each rank's intra-op threads. A rank that raises
    ends the world: the others are terminated and its traceback is raised
    here, as is a world still running after `timeout` seconds."""
    if backend == "nccl" and device != "cuda":
        raise ValueError("nccl needs a card per rank: device='cuda'")
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # served here for the world's life: the port is bound before any rank
    # starts, so no other world can take it in between
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False)
    pctx = mp.start_processes(_worker, args=(fn, world, backend, device, store.port,
                                             tuple(args), results, threads),
                              nprocs=world, join=False, start_method="spawn")
    got, errors = {}, {}
    deadline = time.monotonic() + timeout

    def drain():
        while True:
            try:
                rank, blob, err = results.get_nowait()
            except queue_mod.Empty:
                return
            if err is None:
                got[rank] = pickle.loads(blob)
            else:
                errors[rank] = err

    try:
        # a failed rank's peers get 10 s to fail on their own before SIGTERM
        while not pctx.join(timeout=0.2, grace_period=10):
            drain()
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: the world of {world} ran past {timeout} s")
        drain()
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        time.sleep(0.5)  # let a rank's report of its own error arrive
        drain()
        if errors:
            first = min(errors)
            raise RuntimeError(f"spawn: rank {first} raised:\n{errors[first]}") from e
        raise
    finally:
        for p in pctx.processes:
            if p.is_alive():
                p.terminate()
        for p in pctx.processes:
            p.join(timeout=10)
        del store
    missing = [r for r in range(world) if r not in got]
    if missing:
        raise RuntimeError(f"spawn: ranks {missing} returned no result")
    return [got[r] for r in range(world)]
