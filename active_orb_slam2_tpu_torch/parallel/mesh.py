"""Process meshes over ``torch.distributed``, and an array axis sharded
over them.

Port of ``active_orb_slam2_tpu/parallel/mesh.py``.  A rank is one
process; a mesh is a ``DeviceMesh`` of ranks.  Two shapes, as in the
JAX package:

  * 1-D ``("shard",)``;
  * 2-D ``("host", "chip")`` in host-major order (rank = host * n_chips
    + chip): an axis sharded over both takes contiguous blocks on each
    host, and a sum over both reduces within each host (the chip group)
    and then across hosts (the host group).

The backend is the caller's choice and is never switched: ``nccl`` for
ranks on cards, one card a rank; ``gloo`` for CPU tensors, or for
several ranks on one card, which NCCL refuses.
"""

import math
import multiprocessing
import os
import queue
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def join_group(backend: str, init_method: str, world_size: int, rank: int,
               local_rank: int = 0):
    """``init_process_group``; with ``nccl`` the rank is bound to
    ``cuda:local_rank`` first."""
    device_id = None
    if backend == "nccl":
        device_id = torch.device("cuda", local_rank)
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            device_id=device_id)


def initialize_distributed(backend: str, init_method: str = None,
                           world_size: int = None, rank: int = None) -> bool:
    """Join the process group, with torchrun's environment (``MASTER_ADDR``
    and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) as the
    defaults.  Does nothing in a single process.  Returns True if a group
    of several processes was joined."""
    n = world_size if world_size is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    if not init_method or n <= 1:
        return False
    r = rank if rank is not None else int(os.environ.get("RANK", "0"))
    join_group(backend, init_method, n, r,
               int(os.environ.get("LOCAL_RANK", r)))
    return True


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(n_devices: int = None, axis: str = "shard"):
    """1-D mesh over the first ``n_devices`` ranks (default: all).  Every
    rank of the group calls it."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def make_host_chip_mesh(n_hosts: int = None, n_chips: int = None):
    """2-D ``("host", "chip")`` mesh, host-major.

    Defaults: ``n_hosts`` = the hosts of the group (``WORLD_SIZE`` over
    torchrun's ``LOCAL_WORLD_SIZE``), or 2 when the group has one host and
    at least 4 ranks, so that the two-level reduction runs on one host
    too; ``n_chips`` = the ranks a host."""
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if n_hosts == 1 and world >= 4:
            n_hosts = 2
    if n_chips is None:
        n_chips = world // n_hosts
    return init_device_mesh(_device_type(), (n_hosts, n_chips),
                            mesh_dim_names=("host", "chip"))


class MeshShards:
    """An array axis split into equal contiguous blocks over ``axis`` of
    ``mesh`` (one axis name, or a tuple of names taken host-major, as
    JAX's ``PartitionSpec(axis)``): this rank's block, reductions over the
    blocks and the blocks gathered in order.

    A reduction is one ``all_reduce`` per mesh axis, the innermost first
    (within a host, then across hosts).  ``calls`` and ``bytes`` count
    the reductions' collectives and the bytes each reduces.
    """

    def __init__(self, mesh, axis="shard"):
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        dims = [mesh.mesh_dim_names.index(a) for a in axes]
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.count = math.prod(mesh.size(d) for d in dims)
        self.index = 0
        for d in dims:
            self.index = self.index * mesh.size(d) + coord[d]
        # per axis, innermost first: its group and the ranks along it in
        # mesh order (a group's members are in rank order, not mesh order)
        self._levels = []
        for d in reversed(dims):
            at = list(coord)
            at[d] = slice(None)
            self._levels.append((mesh.get_group(d),
                                 mesh.mesh[tuple(at)].tolist()))
        self.calls = 0
        self.bytes = 0

    def block(self, n: int):
        """(start, stop) of this rank's block of an axis of length n."""
        if n % self.count:
            raise ValueError(f"{n} rows do not split into {self.count} "
                             f"equal shards")
        size = n // self.count
        return self.index * size, (self.index + 1) * size

    def reduce(self, t, op=dist.ReduceOp.SUM):
        """``t`` reduced over the blocks, in place (and returned)."""
        for group, _ in self._levels:
            dist.all_reduce(t, op=op, group=group)
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
        return t

    def gather(self, t):
        """Every rank's block of ``t`` concatenated in block order."""
        for group, along in self._levels:
            parts = [torch.empty_like(t) for _ in along]
            dist.all_gather(parts, t.contiguous(), group=group)
            member = dist.get_process_group_ranks(group)
            t = torch.cat([parts[member.index(r)] for r in along])
        return t


def _rank_main(rank, fn, world_size, backend, init_method, args, results):
    join_group(backend, init_method, world_size, rank, rank)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def spawn_ranks(fn, world_size: int, backend: str, args=(),
                timeout: float = 600.0):
    """``fn(rank, *args)`` on ``world_size`` spawned processes of one host,
    joined in one process group over a ``FileStore`` in a temporary
    directory (with ``nccl``, rank r on ``cuda:r``).  ``fn`` must be a
    module-level function and return what pickles without tensors (numpy
    arrays).  Returns the results by rank; raises if a rank raises or the
    ranks outlast ``timeout`` seconds, and leaves no process behind."""
    results = multiprocessing.get_context("spawn").Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, backend,
                  "file://" + os.path.join(tmp, "store"), args, results))
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size or not ctx.join(timeout=0.1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks outlasted "
                                       f"{timeout} s")
                try:
                    rank, value = results.get(timeout=0.5)
                    out[rank] = value
                except queue.Empty:
                    ctx.join(timeout=0)       # raises if a rank failed
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
