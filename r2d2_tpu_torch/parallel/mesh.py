"""Data-parallel process groups, the JAX package's ``parallel/mesh.py`` and
``parallel/loopback.py`` in the PyTorch idiom.

JAX drives every chip of a mesh from one process. Here each data-parallel
rank is a process of its own, rank r on ``devices[r]``, joined in a
``torch.distributed`` process group: NCCL on CUDA, gloo on the CPU (and on
one card shared by several ranks, which NCCL refuses). Rank 0 is the
single controller that JAX's one process is; the others follow it
(runtime/learner_loop.py ``Learner.follow``).

A ``Mesh`` carries two groups: ``group`` for the collectives on the
learner's tensors (the gradient all-reduce, the block broadcast) and
``ctrl_group``, always gloo, for host messages (rank 0's commands, the
gathered stats and reports), so a follower waiting for its next command
holds no device stream.

With tensor parallelism (``mesh.mp`` > 1) the world is a dp x mp grid,
JAX's row-major ``(dp, mp)`` reshape of the devices: rank r has dp index
``r // mp`` and mp index ``r % mp``. ``mp_group`` holds the ranks of one
dp row (the tensor-parallel collectives, parallel/tensor_parallel.py),
``dp_group`` the ranks with one mp index (the gradient mean over the data
shards). At mp = 1 no group is made: ``dp_group`` is ``group``.

A multi-host job (parallel/multihost.py) has no single controller: each
controller process joins with ``init_distributed`` over a tcp rendezvous,
as ``jax.distributed.initialize`` does.

The launcher (``RankProcesses``, ``run_ranks``) follows loopback.py: pick a
rendezvous, spawn the ranks with the ``spawn`` context from an importable
function, wait on one shared deadline, and kill the survivors on any exit
path, so no rank is left blocked in a collective.
"""

import dataclasses
import datetime
import multiprocessing
import os
import queue
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from r2d2_tpu_torch.config import MeshConfig

# a collective that waits longer than this raises (the warm-up before the
# first block is the longest wait a follower sees)
COLLECTIVE_TIMEOUT_S = 600.0
KILL_GRACE_S = 5.0          # a killed rank's join


@dataclasses.dataclass
class Mesh:
    """One rank's view of the dp x mp world."""

    dp: int
    rank: int
    device: torch.device
    backend: str
    group: Any = None           # the tensors' collectives (None = WORLD)
    ctrl_group: Any = None      # gloo, host messages (None = WORLD)
    mp: int = 1
    mp_group: Any = None        # this rank's dp row (mp > 1 only)
    dp_group: Any = None        # this rank's mp index over the dp rows

    def __post_init__(self):
        if self.mp == 1:
            self.dp_group = self.group

    @property
    def leader(self) -> bool:
        return self.rank == 0

    @property
    def world(self) -> int:
        return self.dp * self.mp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp

    # a multi-host job's names: one controller process a rank
    @property
    def process_id(self) -> int:
        return self.rank

    @property
    def num_processes(self) -> int:
        return self.dp


def cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None, *, rank: int = 0,
              init_method: Optional[str] = None,
              timeout_s: float = COLLECTIVE_TIMEOUT_S) -> Mesh:
    """This rank's ``Mesh``: ``cfg.dp`` resolved against ``devices`` (every
    visible GPU by default), times ``cfg.mp``, which ``devices`` must hold;
    rank r runs on ``devices[r]``. ``backend``: "nccl" on CUDA and "gloo"
    on the CPU by default. Explicit ``devices`` and ``backend`` are for
    tests and checks that place several ranks on one device (over gloo:
    NCCL refuses two ranks on one GPU). Joins the process group at
    ``init_method`` (a ``file://`` or ``tcp://`` rendezvous) unless one is
    already up."""
    cfg = cfg or MeshConfig()
    devices = [torch.device(d) for d in
               (cuda_devices() if devices is None else devices)]
    mp = max(cfg.mp, 1)
    dp = cfg.resolved_dp(len(devices))
    world = dp * mp
    if world > len(devices):
        raise ValueError(
            f"mesh.dp={cfg.dp} x mesh.mp={cfg.mp} needs {world} devices but "
            f"only {len(devices)} are available")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a mesh of dp={dp} x mp={mp}")
    devices = devices[:world]
    device = devices[rank]
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and len(set(devices)) < world:
        raise ValueError(
            f"NCCL needs one GPU a rank; devices {[str(d) for d in devices]}"
            " repeat one: use backend='gloo' to share a device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise ValueError(
                f"the process group has world size {dist.get_world_size()} "
                f"and rank {dist.get_rank()}; the mesh wants {world} and "
                f"{rank}")
    else:
        if init_method is None:
            raise ValueError("no process group is up: pass init_method "
                             "(rendezvous())")
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    ctrl = None if backend == "gloo" else dist.new_group(backend="gloo")
    mesh = Mesh(dp=dp, rank=rank, device=device, backend=backend,
                ctrl_group=ctrl, mp=mp)
    if mp > 1:
        # every rank makes every group, in one order
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if d == mesh.dp_rank:
                mesh.mp_group = g
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if m == mesh.mp_rank:
                mesh.dp_group = g
    return mesh


def pick_coordinator() -> str:
    """A free loopback ``host:port`` for a job's tcp rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def init_distributed(cfg: MeshConfig, device, backend: Optional[str] = None,
                     timeout_s: float = COLLECTIVE_TIMEOUT_S) -> Mesh:
    """Join a multi-host job as controller ``cfg.process_id`` of
    ``cfg.num_processes`` over ``tcp://{cfg.coordinator_address}`` (a free
    loopback port for a job of one) and return its ``Mesh``: one rank a
    controller, on ``device``. ``backend``: NCCL on CUDA and gloo on the
    CPU by default; gloo on CUDA only when asked for (several controllers
    sharing one card). A CUDA device that is not there raises."""
    if not cfg.multihost:
        raise ValueError("init_distributed joins a multi-host job: set "
                         "mesh.multihost")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"controller {cfg.process_id} was given "
                               f"{device} but finds no CUDA device")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    address = cfg.coordinator_address
    if address is None:
        if cfg.num_processes > 1:
            raise ValueError("mesh.coordinator_address is required for "
                             f"mesh.num_processes={cfg.num_processes}")
        address = pick_coordinator()
    if dist.is_initialized():
        raise RuntimeError("this process is already in a process group")
    dist.init_process_group(
        backend, init_method=f"tcp://{address}",
        world_size=cfg.num_processes, rank=cfg.process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    ctrl = None if backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(dp=cfg.num_processes, rank=cfg.process_id, device=device,
                backend=backend, ctrl_group=ctrl)


def close_mesh() -> None:
    """Leave the process group (every group of this process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rendezvous(directory: Optional[str] = None) -> str:
    """A fresh ``file://`` rendezvous in ``directory`` (the temp dir by
    default): no port to race for."""
    fd, path = tempfile.mkstemp(prefix="r2d2_dp_", dir=directory)
    os.close(fd)
    os.remove(path)
    return "file://" + path


class RankProcesses:
    """Ranks ``ranks`` as spawned processes, each running
    ``target(rank, *args_of(rank))``; a context manager that kills every
    survivor on exit, whatever ends the block."""

    def __init__(self, target: Callable, args_of: Callable[[int], tuple],
                 ranks: Sequence[int]):
        self.ctx = multiprocessing.get_context("spawn")
        self.procs = [self.ctx.Process(target=target, args=(r,) + args_of(r),
                                       daemon=True, name=f"dp-rank{r}")
                      for r in ranks]

    def __enter__(self) -> "RankProcesses":
        for p in self.procs:
            p.start()
        return self

    def __exit__(self, *exc) -> None:
        self.kill()

    def join(self, deadline: float) -> List[Optional[int]]:
        """Exit codes by the shared ``deadline`` (time.monotonic); None =
        still running (killed later by ``kill``)."""
        for p in self.procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        return [p.exitcode for p in self.procs]

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=KILL_GRACE_S)


def _rank_entry(rank: int, fn: Callable, dp: int, mp: int,
                init_method: str, devices, backend, args: tuple,
                results) -> None:
    """A spawned rank of ``run_ranks``: one intra-op thread (several ranks
    share the host's cores), the mesh, ``fn(mesh, *args)``, and its result
    or traceback on the results queue."""
    torch.set_num_threads(1)
    try:
        mesh = make_mesh(MeshConfig(dp=dp, mp=mp), devices, backend,
                         rank=rank, init_method=init_method)
        try:
            out = fn(mesh, *args)
        finally:
            close_mesh()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, dp: int, *args, mp: int = 1, devices=None,
              backend: Optional[str] = None, timeout_s: float = 300.0,
              rendezvous_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``dp * mp`` spawned ranks (``fn``
    importable, its result picklable) and return the results by rank.
    Raises if a rank fails or the shared deadline passes; every rank is
    gone when this returns or raises."""
    world = dp * mp
    devices = list(devices if devices is not None else ["cpu"] * world)
    init = rendezvous(rendezvous_dir)
    results = multiprocessing.get_context("spawn").Queue()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        with RankProcesses(_rank_entry, lambda r: (fn, dp, mp, init,
                                                   devices, backend, args,
                                                   results),
                           range(world)) as ranks:
            # the results come before the joins: a child that wrote to a
            # queue exits only once the queue is read
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=0.5)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"ranks {sorted(set(range(world)) - set(got))}"
                            f" gave no result within {timeout_s:.0f} s")
                    dead = [r for r, p in enumerate(ranks.procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"ranks {dead} exited with "
                            f"{[ranks.procs[r].exitcode for r in dead]}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
            ranks.join(deadline)
    finally:
        path = init[len("file://"):]
        if os.path.exists(path):
            os.remove(path)
    return [got[r] for r in range(world)]
