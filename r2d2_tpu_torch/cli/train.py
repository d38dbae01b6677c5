"""Training CLI of the PyTorch port: the synchronous collect:learn loop.

    python -m r2d2_tpu_torch.cli.train --env.game_name=Fake --max-steps=100
    python -m r2d2_tpu_torch.cli.train --env.game_name=Fake --max-steps=5 \
        --device=cpu --env.frame_height=24 --env.frame_width=24 ...

Extra (non-config) flags:
    --max-steps=N       learner steps to take (default optim.training_steps)
    --device=NAME       "cuda" (default; raises if there is none) or "cpu"
    --seed=N            env, weights and sampling seed (default 0)
    --collect-eps=E     epsilon of the collecting policy (default 0.4)

The collect:learn ratio is ``replay.max_env_steps_per_train_step`` env
steps per dispatch of ``runtime.steps_per_dispatch`` learner steps (-1, the
default: 1 on the CPU, the bench's winner on CUDA; one CUDA graph of K
steps there); values below 1 run one env step per dispatch. Each log line
holds a dispatch's losses.
"""

import json
import math
import sys


def main(argv=None) -> dict:
    import torch
    from r2d2_tpu_torch.config import Config, parse_overrides
    from r2d2_tpu_torch.tools.sync_train import sync_train
    from r2d2_tpu_torch.utils.device import configure_numerics

    configure_numerics()
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"max-steps": None, "device": None, "seed": "0",
             "collect-eps": "0.4"}
    rest = []
    for arg in argv:
        name, _, value = arg[2:].partition("=")
        if arg.startswith("--") and name in flags:
            flags[name] = value
        else:
            rest.append(arg)
    cfg = parse_overrides(Config(), rest)
    if cfg.replay.max_env_steps_per_train_step < 1:
        cfg = cfg.replace(**{"replay.max_env_steps_per_train_step": 1})
    max_steps = (int(flags["max-steps"]) if flags["max-steps"]
                 else cfg.optim.training_steps)

    def log(step, metrics):
        print(json.dumps({"step": step, "loss": metrics["loss"].tolist()}),
              flush=True)

    net, learner = sync_train(cfg, max_steps, float(flags["collect-eps"]),
                              seed=int(flags["seed"]),
                              device=flags["device"], log_fn=log)
    losses = (torch.cat([x.reshape(-1) for x in learner.losses]).tolist()
              if learner.losses else [])
    summary = {"steps": learner.training_steps,
               "env_steps": learner.env_steps,
               "device": str(net.device),
               "final_loss": losses[-1] if losses else math.nan}
    print(json.dumps(summary), flush=True)
    summary["losses"] = losses
    return summary


if __name__ == "__main__":
    main()
