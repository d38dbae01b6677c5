"""Starting a data- or tensor-parallel run (``mesh.dp`` x ``mesh.mp`` > 1)
from its rank 0.

The process that calls ``orchestrator.train`` (``cli.train``) is rank 0:
it keeps the actors, the weight service, the metrics and stdout, and
drives the run (under host placement it also holds the host replay).
``data_parallel`` spawns ranks 1..dp*mp-1 (``follower_main``, each a
``Learner`` in ``follow()``, or the fused loop's follower), joins the
process group with them and yields rank 0's ``Mesh``; on any exit it
waits for the followers, which leave at rank 0's stop, and kills those
still running. With one rank it yields None and starts nothing: the
unsharded path runs as before.
"""

import contextlib
import signal
import time
from typing import Iterator, List, Optional, Sequence

import torch

from r2d2_tpu_torch.config import Config, MeshConfig
from r2d2_tpu_torch.parallel.mesh import (Mesh, RankProcesses, close_mesh,
                                          cuda_devices, make_mesh,
                                          rendezvous)

FOLLOWER_EXIT_S = 60.0      # followers' exit after rank 0's stop


def mesh_devices(cfg: Config, device: torch.device,
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices the ranks run on: ``devices`` as given, every visible
    GPU on CUDA, or ``mesh.dp`` x ``mesh.mp`` copies of a CPU device."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device.type == "cuda":
        return cuda_devices()
    return [device] * (max(cfg.mesh.dp, 1) * max(cfg.mesh.mp, 1))


def resolved_dp(cfg: Config, devices: Sequence) -> int:
    """The run's dp: ``mesh.dp`` resolved against the devices, 1 under host
    placement at mesh.mp = 1 (which takes no dp path, as in the JAX
    package); the rules Config checks for an explicit dp, checked again
    here for dp=-1."""
    if cfg.replay.placement == "host" and cfg.mesh.mp <= 1:
        return 1
    dp = cfg.mesh.resolved_dp(len(devices))
    if dp > 1 and cfg.actor.on_device:
        lanes = cfg.actor.anakin_lanes
        if lanes % dp != 0:
            raise ValueError(
                f"actor.anakin_lanes ({lanes}) must be divisible by the "
                f"resolved mesh.dp ({dp}): each shard owns an equal lane "
                "group (anakin_lanes % dp == 0); adjust actor.anakin_lanes "
                "or mesh.dp")
        if lanes // dp > cfg.num_blocks:
            raise ValueError(
                f"actor.anakin_lanes ({lanes}) / the resolved mesh.dp "
                f"({dp}) must be <= num_blocks ({cfg.num_blocks})")
    return dp


@contextlib.contextmanager
def data_parallel(cfg: Config, device: torch.device,
                  devices: Optional[Sequence] = None,
                  backend: Optional[str] = None) -> Iterator[Optional[Mesh]]:
    """Rank 0's side of a run: yields its ``Mesh`` with the followers
    started, or None for one rank. ``devices``/``backend``: as
    ``make_mesh`` takes them (several ranks on one card over gloo, for
    checks and tests); by default every visible GPU over NCCL, or CPU
    ranks over gloo."""
    devices = mesh_devices(cfg, device, devices)
    dp, mp = resolved_dp(cfg, devices), max(cfg.mesh.mp, 1)
    if dp * mp == 1:
        yield None
        return
    devices = devices[:dp * mp]
    init = rendezvous()
    names = [str(d) for d in devices]
    with RankProcesses(follower_main,
                       lambda r: (cfg.to_dict(), dp, mp, init, names,
                                  backend),
                       range(1, dp * mp)) as followers:
        try:
            yield make_mesh(MeshConfig(dp=dp, mp=mp), devices, backend,
                            rank=0, init_method=init)
            rcs = followers.join(time.monotonic() + FOLLOWER_EXIT_S)
            if any(rc != 0 for rc in rcs):
                raise RuntimeError(f"data-parallel followers exited with "
                                   f"{rcs} (None: killed at the deadline)")
        finally:
            close_mesh()


def follower_main(rank: int, cfg_dict: dict, dp: int, mp: int,
                  init_method: str, devices: List[str],
                  backend: Optional[str]) -> None:
    """Rank ``rank`` of a run: its mesh, then rank 0's commands until its
    stop (the fused loop's follower with ``actor.on_device``). One
    intra-op thread: the ranks share the host's cores. SIGINT is ignored:
    rank 0 owns the stop."""
    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    from r2d2_tpu_torch.utils.device import configure_numerics

    # rank 0 owns the run's stop: a terminal's Ctrl-C reaches it as a
    # signal and the followers as its stop command
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    torch.set_num_threads(1)
    configure_numerics()
    cfg = Config.from_dict(cfg_dict)
    mesh = make_mesh(MeshConfig(dp=dp, mp=mp), devices, backend, rank=rank,
                     init_method=init_method)
    try:
        if cfg.actor.on_device:
            from r2d2_tpu_torch.runtime.anakin_loop import follow_anakin
            follow_anakin(cfg, mesh)
            return
        probe = create_env(cfg.env, seed=cfg.runtime.seed)
        action_dim = probe.action_space.n
        probe.close()
        net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                           cfg.env.frame_height, cfg.env.frame_width,
                           mesh.device)
        learner = Learner(cfg, net, mesh=mesh)
        try:
            learner.follow()
        finally:
            learner.stop_background()
    finally:
        close_mesh()
