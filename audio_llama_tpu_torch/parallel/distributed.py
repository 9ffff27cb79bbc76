"""The process world: `torch.distributed` set-up and a spawn helper.

Counterpart of `audio_llama_tpu/parallel/distributed.py`, where
`jax.distributed.initialize` wires one process per host and the mesh spans
every host's devices. Here one process runs per mesh position (see
`parallel/mesh.py`), and the backend is the caller's choice, never changed
quietly:
  - "gloo" on the CPU (the tests), and on the card when several ranks share
    one device (NCCL refuses two ranks on one device);
  - "nccl" when each rank has a card of its own (not yet run for training).

`spawn(fn, world, backend, device)` starts a world of fresh processes on
this host (the `spawn` start method), wires it through a TCP store that the
calling process serves on a port the system picks and holds for the
world's whole life (so two worlds started at once never meet), runs
fn(rank, world, *args) in each and returns the results by rank; an
exception in any rank fails the whole world.

`initialize_from_flags` is the trainer's `--distributed` (JAX's
`initialize(coordinator_address, num_processes, process_id)`, :30-85): the
coordinator's host:port serves the store. JAX's `make_global_batch`
(:87-106), which assembles the processes' rows into one global array, has
no counterpart: each rank's step takes its own rows.
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
               rank: Optional[int] = None, device=None, store=None,
               timeout: Optional[float] = None) -> tuple[int, int]:
    """`dist.init_process_group` with an explicit backend -> (rank, world).
    `device` (a CUDA device, for nccl) binds the rank to its card. With
    env:// the world size and rank may come from WORLD_SIZE / RANK. A
    `store` (a `dist.Store`) replaces `init_method`. `timeout` (seconds)
    bounds every collective's wait (the backend's default otherwise)."""
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
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    dist.init_process_group(backend, **kw)
    r, w = dist.get_rank(), dist.get_world_size()
    logger.info("distributed: rank %d of %d (%s)", r, w, backend)
    return r, w


def initialize_from_flags(coordinator_address: Optional[str], num_processes: int,
                          process_id: int, backend: str, device=None,
                          timeout: Optional[float] = None) -> tuple[int, int]:
    """Join the world the trainer's flags name -> (rank, world). With no
    coordinator address the world comes from the environment (env://:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them);
    num_processes 0 and process_id -1 likewise. A world that already runs
    (this process was spawned into it) is kept if it is the one named."""
    if dist.is_initialized():
        r, w = dist.get_rank(), dist.get_world_size()
        if (num_processes > 0 and w != num_processes) or (process_id >= 0 and r != process_id):
            raise ValueError(f"a world of {w} (rank {r}) already runs; the flags name "
                             f"{num_processes} (rank {process_id})")
        return r, w
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    return initialize(backend, init_method=init,
                      world_size=num_processes if num_processes > 0 else None,
                      rank=process_id if process_id >= 0 else None, device=device,
                      timeout=timeout)


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


def _worker(rank, fn, world, backend, device, port, args, results, threads, timeout):
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    # no wait of a rank outlasts its world: a hung world fails its own call
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout))
    initialize(backend, world_size=world, rank=rank, device=dev, store=store, timeout=timeout)
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
          args: Sequence[Any] = (), timeout: float = 240.0,
          threads: Optional[int] = None) -> list:
    """Run fn(rank, world, *args) in `world` new processes joined into one
    `torch.distributed` world -> [result of rank 0, ..., rank world-1].

    fn must be importable (a module-level function); its result is returned
    with its tensors moved to the CPU. `device`: "cpu", one device shared by
    every rank ("cuda:0", with gloo), or "cuda" (rank r on cuda:r, for
    nccl). `threads` caps each rank's intra-op threads. A rank that raises
    ends the world: the others are terminated and its traceback is raised
    here, as is a world still running after `timeout` seconds (every
    rank's store and collectives wait no longer than that either)."""
    if backend == "nccl" and device != "cuda":
        raise ValueError("nccl needs a card per rank: device='cuda'")
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # served here for the world's life: the port is bound before any rank
    # starts, so no other world can take it in between
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False)
    pctx = mp.start_processes(_worker, args=(fn, world, backend, device, store.port,
                                             tuple(args), results, threads, timeout),
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
