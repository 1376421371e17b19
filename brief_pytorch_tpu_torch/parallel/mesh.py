"""Ranks: the process group, the fleet's placement, host gathers.

Torch port of brief_pytorch_tpu/parallel/mesh.py.  The JAX package puts
every device of a host (and, through jax.distributed, of every host) into
one mesh driven by one program.  The port runs one process per rank,
PyTorch's idiom: each rank owns one device (a card, or the CPU when asked)
and joins a torch.distributed group, NCCL on cards and gloo on the host.

  * `multihost_init` joins the group: from an explicit coordinator (the
    CLI's -coordinator / -nprocs / -procid, JAX cli/main.py:80-104), from
    torchrun's environment (`WORLD_SIZE`), or not at all (one rank);
  * `rank`, `world`, `is_main` read it (one rank without a group);
  * `plan_fleet` places every block of a DivideTask fleet on exactly one
    rank, as JAX `_plan_meshes` and the solo slots do
    (block_trainer.py:754-791, 1116-1125);
  * `all_addressable` gives every rank every rank's host object
    (all_gather_object: gloo gathers no CUDA tensors, so what is gathered
    is numpy or CPU tensors);
  * `free_port` and `wait_ranks` start and watch local rank processes (the
    CLI's launcher, tests, chip_smoke.py).

A rank that dies must not hang the others: the group has a finite
timeout, and `wait_ranks` kills the remaining ranks once one fails.
"""
from __future__ import annotations

import datetime
import os
import random
import socket
import subprocess
import time
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from brief_pytorch_tpu_torch.core.device import DeviceLike

# a collective that waits longer fails: a rank died or hangs
TIMEOUT = datetime.timedelta(minutes=10)


def multihost_init(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   device: DeviceLike = None) -> bool:
    """Join the ranks' process group; returns whether a group exists.

    coordinator 'host:port' (rank 0's address) with num_processes and
    process_id: a tcp:// group of num_processes ranks, whose failure
    propagates (the caller asked for a cluster: training a fraction of
    it alone would be wrong).  Without one: env:// when torchrun's
    WORLD_SIZE is set, else nothing (one rank).  A group the caller set
    up already is used as it is.  device: this rank's device; a card
    becomes the current device before the group starts (NCCL needs it).
    backend: NCCL for a card, gloo for the CPU, unless given (several
    ranks on one card need gloo: NCCL refuses a card twice)."""
    if dist.is_initialized():
        return True
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev is not None and dev.type == "cuda" \
            else "gloo"
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("-coordinator needs -nprocs and -procid")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"-procid {process_id} is not in "
                             f"[0, {num_processes})")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=TIMEOUT)
        return True
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
        return True
    return False


def shutdown() -> None:
    """Leave the group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, the one rank that writes files."""
    return rank() == 0


def all_addressable(obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order, on every rank (a collective:
    every rank calls it, in the same order).  obj holds host values
    (numpy arrays, CPU tensors, plain Python)."""
    if world() == 1:
        return [obj]
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def plan_fleet(bucket_sizes: Sequence[int], n_solo: int, n_ranks: int
               ) -> Tuple[List[List[int]], List[int]]:
    """The rank of every block: (per bucket, the rank of each of its
    blocks; the rank of each solo block).

    A bucket of B >= n_ranks blocks is split evenly over all ranks, in
    contiguous runs.  Smaller buckets get B ranks of their own, one block
    each, packed first-fit-decreasing onto disjoint ranks; a bucket that
    fits no wave starts a new one at rank 0 (JAX `_plan_meshes`).  Solo
    blocks go round-robin (the JAX solo slots)."""
    plans: List[List[int]] = []
    for size in bucket_sizes:
        plans.append([j * n_ranks // size for j in range(size)]
                     if size >= n_ranks else [])
    waves: List[int] = []       # per wave: the next free rank
    small = sorted((i for i, s in enumerate(bucket_sizes) if s < n_ranks),
                   key=lambda i: -bucket_sizes[i])
    for i in small:
        size = bucket_sizes[i]
        w = next((w for w, off in enumerate(waves) if off + size <= n_ranks),
                 None)
        if w is None:
            waves.append(0)
            w = len(waves) - 1
        plans[i] = list(range(waves[w], waves[w] + size))
        waves[w] += size
    return plans, [k % n_ranks for k in range(n_solo)]


def free_port() -> int:
    """A free TCP port on this host for a coordinator, drawn at random
    below the kernel's ephemeral range (/proc/sys/net/ipv4/
    ip_local_port_range).  A port that bind(("", 0)) hands out is closed
    again before rank 0's store binds it, seconds later once its
    interpreter has started, and in between any other process's bind to
    port 0 or outgoing connection may take it (a test suite's other
    ranks, their gloo or gRPC connections); a port below the range is
    taken only by a bind that names it.  Where the range is unknown,
    the kernel's choice."""
    low = _ephemeral_low()
    if low is not None and low > PORT_SPAN + 1024:
        rng = random.SystemRandom()
        for _ in range(64):
            port = rng.randrange(low - PORT_SPAN, low)
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    continue
                return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PORT_SPAN = 8192     # free_port's ports: the 8,192 below the ephemeral range


def _ephemeral_low() -> Optional[int]:
    """The first port of the kernel's ephemeral range, or None."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None


def wait_ranks(procs: Sequence[subprocess.Popen],
               timeout: Optional[float] = None) -> None:
    """Wait for every rank process to exit 0.  The first that exits
    otherwise, or the timeout (seconds), kills the others and raises
    RuntimeError naming the rank."""
    t0 = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in procs]
            for r, code in enumerate(codes):
                if code not in (None, 0):
                    raise RuntimeError(f"rank {r} exited with code {code}")
            if all(code == 0 for code in codes):
                return
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise RuntimeError(
                    f"ranks {[r for r, c in enumerate(codes) if c is None]} "
                    f"still running after {timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
