"""How far a learner step's update moves under a change of summation order
alone: the unsharded external-batch step run twice on the CPU from the
same weights and host batches, once on one intra-op thread and once on
several (other reduction orders in the matrix products and convolutions),
then per leaf the relative L2 distance of the two updates (final - initial
params, as ``chip_smoke.py`` 13a's ``update_rel``) and of the first step's
gradients. A leaf whose update moves far more than its gradient is
ill-conditioned under Adam (entries with near-zero gradients normalized to
about one learning rate), so a distance there says nothing of a sharded
step's semantics.

    python -m r2d2_tpu_torch.tools.update_order [--hidden 512] [--steps 3]

Prints one JSON line.
"""

import argparse
import json
import sys

import numpy as np


def updates(cfg, threads: int, steps: int):
    """(initial params, final params, first step's gradients) of the
    external step on ``threads`` intra-op threads."""
    import torch

    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_external_batch_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.structs import ReplaySpec, SampleBatch
    from r2d2_tpu_torch.tools import bench, dp_check
    torch.set_num_threads(threads)
    dev = torch.device("cpu")
    net = NetworkApply(bench.ACTION_DIM, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, dev)
    spec = ReplaySpec.from_config(cfg, dev)
    ts = create_train_state(net, cfg.optim, 0, cfg.network.use_double)
    init = {n: p.double().numpy() for n, p in ts.params.state_dict().items()}
    step = make_external_batch_step(net, spec, cfg.optim,
                                    cfg.network.use_double)
    grads = None
    for fields in dp_check.host_batches(spec, 8, steps, 13):
        ts, _ = step(ts, SampleBatch(**{n: torch.from_numpy(a)
                                        for n, a in fields.items()}))
        if grads is None:
            grads = {n: p.grad.double().numpy().copy()
                     for n, p in ts.params.named_parameters()}
    final = {n: p.double().numpy() for n, p in ts.params.state_dict().items()}
    return init, final, grads


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--threads", type=int, default=8)
    args = p.parse_args(argv)
    from r2d2_tpu_torch.config import Config
    # the reference network's LSTM and head, a small torso (f32, the
    # fused scan with double DQN, as 13a)
    cfg = Config().replace(**{
        "env.frame_height": 42, "env.frame_width": 42,
        "network.hidden_dim": args.hidden, "network.cnn_out_dim": 128,
        "network.conv_layers": ((16, 4, 2), (32, 3, 2)),
        "replay.batch_size": args.batch, "network.use_double": True,
        "network.pallas_lstm": "on", "network.bf16": "off",
        "replay.capacity": 8 * 400})
    init, one, g_one = updates(cfg, 1, args.steps)
    _, many, g_many = updates(cfg, args.threads, args.steps)
    rows = {}
    for name in g_many:
        du, dw = one[name] - init[name], many[name] - init[name]
        rows[name] = {
            "update_rel": float(np.linalg.norm(du - dw)
                                / max(np.linalg.norm(dw), 1e-30)),
            "grad_rel": float(np.linalg.norm(g_one[name] - g_many[name])
                              / max(np.linalg.norm(g_many[name]), 1e-30))}
    worst = max(rows, key=lambda n: rows[n]["update_rel"])
    print(json.dumps({"hidden": args.hidden, "batch": args.batch,
                      "steps": args.steps, "threads": [1, args.threads],
                      "worst_update_leaf": worst, "leaves": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
