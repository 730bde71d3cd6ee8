"""The process mesh, distributed bring-up, and spawned worlds.

Counterpart of ``cpuperformanceraytracer_tpu.parallel.mesh``. JAX's mesh
is a single-controller ``jax.sharding.Mesh`` with axes "px" (pixel rows)
and "spp" (samples); the port's is a world of n_px * n_spp processes
under ``torch.distributed``, one rank a mesh cell. Rank r sits at
(px, spp) = divmod(r, n_spp), the cell order of JAX's mesh over its
device list. Each rank knows its coordinate, the axis sizes, the process
group of its "spp" column (the sample reduction) and its device.

The collective backend is the caller's choice and is never switched:
``nccl`` where each rank has a card of its own, ``gloo`` for the CPU, and
``gloo`` for ranks that share one card (NCCL refuses two ranks on one
device; gloo stages CUDA tensors through the host). A world of one rank
forms no process group: ``init_distributed`` is then a no-op, as in JAX.

``spawn_world(fn, n)`` starts a world of n ranks on this host with
``torch.multiprocessing`` (spawn: a fork after CUDA is initialised
fails), runs ``fn`` in each and returns their results. A child builds
nothing: the caller builds the kernel library first, or n ranks would
race to compile it.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

AXES = ("px", "spp")


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the mesh: ``shape`` maps each axis name to its
    size (``mesh.shape["px"]`` as in JAX), ``spp_group`` is the process
    group of the rank's "spp" column (None when spp is not sharded)."""
    shape: dict
    rank: int
    device: torch.device
    spp_group: Optional[object] = field(default=None, repr=False)

    @property
    def size(self) -> int:
        return self.shape.get("px", 1) * self.shape.get("spp", 1)

    @property
    def px(self) -> int:
        """The rank's coordinate on "px"."""
        return self.rank // self.shape.get("spp", 1)

    @property
    def spp(self) -> int:
        """The rank's coordinate on "spp"."""
        return self.rank % self.shape.get("spp", 1)


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(shape: Tuple[int, ...], axis_names: Sequence[str] = AXES,
              device=None) -> Mesh:
    """The mesh of ``shape`` over the world of processes, which must hold
    exactly prod(shape) ranks. Every rank calls it, in the same order as
    its other collectives (it creates the "spp" groups). ``device``: the
    rank's device; by default card ``rank % device_count`` where there is
    a GPU, else the CPU."""
    names = tuple(axis_names[: len(shape)])
    if any(n not in AXES for n in names) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names}: want a subset of {AXES}")
    sizes = dict(zip(names, (int(n) for n in shape)))
    n_px, n_spp = sizes.get("px", 1), sizes.get("spp", 1)
    rank, size = world()
    if n_px * n_spp != size:
        raise ValueError(f"mesh {tuple(shape)} needs {n_px * n_spp} "
                         f"processes; the world has {size}")
    group = None
    if n_spp > 1:
        # every rank creates every column's group, in order
        for p in range(n_px):
            g = dist.new_group(ranks=list(range(p * n_spp, (p + 1) * n_spp)))
            if p == rank // n_spp:
                group = g
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(sizes, rank, torch.device(device), group)


def default_mesh(spp_shards: int = 1, device=None) -> Mesh:
    """Every rank on "px", optionally splitting off an "spp" axis of the
    given size."""
    n = world()[1]
    if n % spp_shards:
        raise ValueError(f"{n} processes not divisible by "
                         f"spp_shards={spp_shards}")
    return make_mesh((n // spp_shards, spp_shards), AXES, device=device)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo") -> None:
    """Join a world of ``num_processes`` ranks as ``process_id``, the
    store at ``coordinator`` ("host:port"; rank 0 serves it). No-op when
    running as one process or when a process group already exists. Where
    there is a GPU the rank's current card becomes ``process_id %
    device_count``."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _free_port() -> int:
    """A free TCP port on 127.0.0.1 (bound and released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n, port, backend, args, out_dir, threads):
    if threads:
        torch.set_num_threads(threads)
    init_distributed(f"127.0.0.1:{port}", n, rank, backend)
    try:
        result = fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"{rank}.pt"))


def spawn_world(fn, n: int, args: tuple = (), backend: str = "gloo",
                timeout: float = 600.0, threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` in each rank of a new world of ``n`` spawned
    processes on this host (its process group on a free local port;
    ``n = 1`` forms none) and return the ranks' results, in rank order.
    ``fn`` must be importable by name in a child, and its arguments and
    result picklable (move tensors to the CPU). A rank that raises, or a
    world still running after ``timeout`` seconds, raises here, and every
    rank left is killed. ``threads`` sets each rank's intra-op threads."""
    with tempfile.TemporaryDirectory(prefix="cprt_world_") as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, _free_port(), backend, args, out_dir,
                              threads),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {n} ranks ran past "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(n)]
