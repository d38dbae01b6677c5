"""Learner supervision and auto-resume, the JAX package's
``runtime/supervisor.py``.

With ``runtime.auto_resume`` the training run is a child process of a
thin supervisor (``supervise_train``; ``cli/train.py`` routes here):

  * a child that dies is relaunched from its newest checkpoint
    (``latest_checkpoint``); with ``runtime.snapshot_interval`` on, the
    relaunch also restores the replay (``runtime.restore_replay``), so
    learning resumes at most one snapshot interval behind;
  * SIGTERM and SIGINT are forwarded to the child, whose clean stop
    writes the final checkpoint and snapshot; the supervisor then exits
    without relaunching: a requested stop is not a crash;
  * relaunches ride the actors' ``WorkerHealth`` policy with one slot:
    the backoff ladder between relaunches, and the crash-loop breaker,
    which raises.

The child is a spawned process (``spawn``: no CUDA state crosses the
fork); the supervisor never initializes CUDA, the child picks its device.
The restart count crosses into the child as ``R2D2_SUPERVISOR_RESTARTS``
(the learner's ``recovery`` block reports it), and the child's pid is
written to ``{save_dir}/learner.pid`` at each launch, so a drill can kill
the training process itself.
"""

import logging
import os
import signal
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)

RESTARTS_ENV = "R2D2_SUPERVISOR_RESTARTS"


def _pid_path(save_dir: str) -> str:
    return os.path.join(save_dir or ".", "learner.pid")


def _child_entry(cfg_dict: dict, actor_mode: str, max_steps: Optional[int],
                 max_seconds: Optional[float], restarts: int,
                 device: Optional[str]) -> None:
    """One training incarnation (module level: spawn pickles the target by
    reference). The restart count is exported before the port is
    imported."""
    os.environ[RESTARTS_ENV] = str(restarts)
    from r2d2_tpu_torch.cli.train import run
    from r2d2_tpu_torch.config import Config
    run(Config.from_dict(cfg_dict), actor_mode=actor_mode,
        max_steps=max_steps, max_seconds=max_seconds, device=device)


def supervise_train(cfg, *, actor_mode: str = "process",
                    max_steps: Optional[int] = None,
                    max_seconds: Optional[float] = None,
                    device: Optional[str] = None) -> int:
    """Run training under supervision; returns the relaunches made. Blocks
    until the run completes, a stop signal arrives or the crash-loop
    breaker trips (which raises). ``device``: the child's (None = CUDA)."""
    import multiprocessing as mp

    if cfg.mesh.multihost and cfg.mesh.num_processes > 1:
        raise NotImplementedError(
            "runtime.auto_resume supervises the single-host train() child; "
            "multihost jobs are supervised by their cluster scheduler — "
            "rely on runtime.resume + the rank-0 snapshot twin instead")
    ctx = mp.get_context("spawn")
    # the breaker (one slot and no heartbeat board: the child's liveness is
    # its process), made once the first child is started: its module
    # imports torch, which this process needs for nothing else, so the
    # first child's start-up does not wait for that import
    health = None
    save_dir = cfg.runtime.save_dir or "."
    deadline = time.time() + max_seconds if max_seconds else None
    state = {"child": None, "stopping": False}

    def _forward(signum, frame):
        state["stopping"] = True
        child = state["child"]
        if child is not None and child.pid is not None:
            try:
                os.kill(child.pid, signal.SIGTERM)
            except (ProcessLookupError, OSError):
                pass

    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _forward)
            except (ValueError, OSError):
                pass

    cfg_dict = cfg.to_dict()
    restarts = 0
    pid_file = _pid_path(save_dir)
    try:
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
            # not a daemon: the child starts actor processes of its own
            child = ctx.Process(
                target=_child_entry,
                args=(cfg_dict, actor_mode, max_steps, remaining, restarts,
                      device),
                name=f"learner-child-{restarts}")
            child.start()
            state["child"] = child
            os.makedirs(save_dir, exist_ok=True)
            with open(pid_file, "w") as f:
                f.write(str(child.pid))
            if health is None:
                from r2d2_tpu_torch.runtime.feeder import WorkerHealth
                health = WorkerHealth.from_runtime(1, None, cfg.runtime)
            while child.is_alive():
                child.join(timeout=0.25)
            code = child.exitcode
            if state["stopping"]:
                log.info("supervisor: stop requested; child exited %s, not "
                         "relaunching", code)
                break
            if code == 0:
                break
            now = time.time()
            log.warning("supervisor: learner child died (exit code %s) "
                        "after %d restart(s); relaunching", code, restarts)
            health.on_failure(0, now)
            if health.is_parked(0):
                raise RuntimeError(
                    f"learner crash-loop breaker tripped: {restarts + 1} "
                    f"failures within {cfg.runtime.restart_window_s:.0f}s "
                    f"(last exit code {code})")
            while not health.respawn_due(0, time.time()):
                if state["stopping"]:
                    break
                time.sleep(0.05)
            if state["stopping"]:
                break
            health.on_spawn(0)
            restarts += 1
            # the newest checkpoint, and with it the replay snapshot; none
            # yet (a death during warm-up) is a fresh start
            from r2d2_tpu_torch.runtime.checkpoint import latest_checkpoint
            ckpt = latest_checkpoint(save_dir, cfg.env.game_name, 0)
            cfg_dict = cfg.to_dict()
            cfg_dict["runtime"]["resume"] = ckpt or ""
            cfg_dict["runtime"]["pretrain"] = ""
            log.warning("supervisor: relaunch %d resuming from %s",
                        restarts, ckpt or "<no checkpoint: a fresh start>")
    finally:
        child = state["child"]
        if child is not None and child.is_alive():
            child.terminate()
            child.join(timeout=10.0)
            if child.is_alive():
                child.kill()
                child.join(timeout=2.0)
        try:
            os.remove(pid_file)
        except OSError:
            pass
        for sig, handler in prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
    return restarts
