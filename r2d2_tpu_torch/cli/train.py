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

Extra (non-config) flags:
    --actor-mode=thread|process   actor execution mode (default: process)
    --max-steps=N                 stop after N learner steps
    --max-seconds=S               wall-clock bound
    --device=NAME                 "cuda" (default; raises without one) or
                                  "cpu"

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
        "losses": losses,
    }


def main(argv=None, dispatch_hook=None) -> dict:
    from r2d2_tpu_torch.config import Config, parse_overrides
    from r2d2_tpu_torch.runtime.orchestrator import train
    from r2d2_tpu_torch.utils.device import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"actor-mode": "process", "max-steps": None,
             "max-seconds": None, "device": None}
    rest = []
    for arg in argv:
        name, _, value = arg[2:].partition("=")
        if arg.startswith("--") and name in flags:
            flags[name] = value
        else:
            rest.append(arg)
    cfg = parse_overrides(Config(), rest)
    device = resolve_device(flags["device"])

    def log(record: dict) -> None:
        print(" | ".join(f"{k}={v}" for k, v in record.items()
                         if v is not None), flush=True)

    t0 = time.time()
    stack = train(cfg,
                  max_training_steps=(int(flags["max-steps"])
                                      if flags["max-steps"] else None),
                  max_seconds=(float(flags["max-seconds"])
                               if flags["max-seconds"] else None),
                  actor_mode=flags["actor-mode"], device=device,
                  log_fn=log, dispatch_hook=dispatch_hook)
    summary = _summary(stack, device, time.time() - t0)
    print(json.dumps({k: v for k, v in summary.items() if k != "losses"}),
          flush=True)
    return summary


if __name__ == "__main__":
    main()
