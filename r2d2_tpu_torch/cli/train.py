"""Training CLI of the PyTorch port, the twin of the JAX package's
``cli/train.py``: the orchestrated trainer (runtime/orchestrator.py), with
actors in spawned processes (default) or threads feeding the learner, or
with ``--actor.on_device=true`` the fused act+train loop, which acts on the
card (runtime/anakin_loop.py; --actor-mode has no meaning there).

    python -m r2d2_tpu_torch.cli.train --env.game_name=Fake --max-seconds=60
    python -m r2d2_tpu_torch.cli.train --env.game_name=Fake --device=cpu \
        --actor-mode=thread --max-steps=20 --env.frame_height=24 ...
    python -m r2d2_tpu_torch.cli.train --env.game_name=Fake \
        --actor.on_device=true --replay.block_length=120 --max-seconds=60
    python -m r2d2_tpu_torch.cli.train --env.game_name=Fake --mesh.dp=8 \
        --max-seconds=60

``--mesh.dp=N`` trains data-parallel on N GPUs (-1: every visible one):
this process is rank 0 and spawns the other ranks
(runtime/data_parallel.py); with ``--device=cpu`` the ranks are CPU
processes over gloo. The summary's ``shards`` holds every rank's final
report.

Extra (non-config) flags:
    --actor-mode=thread|process   actor execution mode (default: process;
                                  thread under --mesh.multihost)
    --max-steps=N                 stop after N learner steps
    --max-seconds=S               wall-clock bound
    --device=NAME                 "cuda" (default; raises without one) or
                                  "cpu"

``--mesh.multihost=true --mesh.num_processes=N`` runs this process as one
controller of a multi-host job (parallel/multihost.py): start the same
command once a card, each with its ``--mesh.process_id`` and ``--device``
(``cuda:N``), all with one ``--mesh.coordinator_address=HOST:PORT``
(rank 0's host); thread actors by default there. The summary is this
controller's.

``--runtime.auto_resume=true`` trains in a child process of a supervisor
(runtime/supervisor.py) that relaunches a dead child from its newest
checkpoint, with ``--runtime.snapshot_interval=N`` restoring the replay
from ``{save_dir}/replay_player0.npz`` too; the child prints the summary,
the supervisor then ``{"supervised": true, "restarts": N}``.

Checkpoints land in ``runtime.save_dir`` as ``{game}{k}_player0`` (k =
step // save_interval; the step-0 one first, the final one on any clean
stop), the log in ``train_player0.log`` beside them. The last line printed
is a JSON summary, which ``main`` also returns (with every flushed loss).
The synchronous collect:learn loop is ``r2d2_tpu_torch.tools.sync_train``.
"""

import json
import math
import os
import sys
import time


def _summary(stack, device, seconds: float) -> dict:
    from r2d2_tpu_torch.runtime.checkpoint import list_checkpoints
    learner = stack.learner
    losses = learner.losses
    snaps = stack.snapshots
    workers = stack.processes or stack.threads
    server = getattr(stack, "serve_server", None)
    served = None
    if server is not None:
        served = {"batches": server.batches_dispatched,
                  "rows": server.rows_served,
                  "forward_ms_by_bucket": server.forward_ms_by_bucket(),
                  "weight_version": server.weight_version}
    return {
        "steps": learner.training_steps,
        "env_steps": learner.env_steps,
        "device": str(device),
        "final_loss": losses[-1] if losses else math.nan,
        "seconds": seconds,
        "blocks_ingested": stack.metrics.ingest_blocks_total,
        "publishes": snaps.publishes if snaps else 0,
        "publish_ms": (sum(learner.publish_ms) / len(learner.publish_ms)
                       if learner.publish_ms else None),
        "publish_write_ms": (snaps.write_ms / snaps.publishes
                             if snaps and snaps.publishes else None),
        "save_ms": list(learner.save_ms),
        "checkpoints": [os.path.basename(p) for _, p in list_checkpoints(
            stack.cfg.runtime.save_dir, stack.cfg.env.game_name,
            stack.player_idx)],
        "actor_exitcodes": [getattr(w, "exitcode", None) for w in workers],
        "actors_alive": sum(1 for w in workers if w.is_alive()),
        "shm_segments": stack.segment_names,
        "served": served,
        # data parallel: every rank's final report (steps, blocks in its
        # shard, the train state's digest, launch counts); None on one
        # device
        "shards": learner.shard_reports,
        "losses": losses,
    }


def run(cfg, *, actor_mode: str = "process", max_steps=None,
        max_seconds=None, device=None, dispatch_hook=None) -> dict:
    """Train ``cfg`` on ``device`` (None = CUDA) and print the summary as
    the last line; returns it, with every flushed loss."""
    from r2d2_tpu_torch.runtime.orchestrator import train
    from r2d2_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)

    def log(record: dict) -> None:
        print(" | ".join(f"{k}={v}" for k, v in record.items()
                         if v is not None), flush=True)

    t0 = time.time()
    stack = train(cfg, max_training_steps=max_steps, max_seconds=max_seconds,
                  actor_mode=actor_mode, device=device, log_fn=log,
                  dispatch_hook=dispatch_hook)
    summary = _summary(stack, device, time.time() - t0)
    print(json.dumps({k: v for k, v in summary.items() if k != "losses"}),
          flush=True)
    return summary


def run_multihost(cfg, *, actor_mode: str = "thread", max_steps=None,
                  max_seconds=None, device=None) -> dict:
    """This process as one controller of a multi-host job; prints its
    summary as the last line and returns it."""
    from r2d2_tpu_torch.parallel.multihost import train_multihost

    def log(record: dict) -> None:
        print(" | ".join(f"{k}={v}" for k, v in record.items()
                         if v is not None), flush=True)

    out = train_multihost(cfg, max_training_steps=max_steps,
                          max_seconds=max_seconds, actor_mode=actor_mode,
                          log_fn=log, device=device)
    summary = {"multihost": True,
               **{k: v for k, v in out.items()
                  if k not in ("train_state", "losses", "collective_ms")}}
    losses = out["losses"]
    summary["final_loss"] = losses[-1] if losses else None
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None, dispatch_hook=None) -> dict:
    from r2d2_tpu_torch.config import Config, parse_overrides

    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"actor-mode": None, "max-steps": None,
             "max-seconds": None, "device": None}
    rest = []
    for arg in argv:
        name, _, value = arg[2:].partition("=")
        if arg.startswith("--") and name in flags:
            flags[name] = value
        else:
            rest.append(arg)
    cfg = parse_overrides(Config(), rest)
    max_steps = int(flags["max-steps"]) if flags["max-steps"] else None
    max_seconds = (float(flags["max-seconds"]) if flags["max-seconds"]
                   else None)
    if cfg.runtime.auto_resume:
        # a supervised child trains; this process never touches CUDA
        from r2d2_tpu_torch.runtime.supervisor import supervise_train
        restarts = supervise_train(cfg,
                                   actor_mode=flags["actor-mode"] or "process",
                                   max_steps=max_steps,
                                   max_seconds=max_seconds,
                                   device=flags["device"])
        summary = {"supervised": True, "restarts": restarts}
        print(json.dumps(summary), flush=True)
        return summary
    if cfg.mesh.multihost and cfg.mesh.num_processes > 1:
        return run_multihost(cfg, actor_mode=flags["actor-mode"] or "thread",
                             max_steps=max_steps, max_seconds=max_seconds,
                             device=flags["device"])
    return run(cfg, actor_mode=flags["actor-mode"] or "process",
               max_steps=max_steps,
               max_seconds=max_seconds, device=flags["device"],
               dispatch_hook=dispatch_hook)


if __name__ == "__main__":
    main()
