"""``cli.train --mesh.mp=2`` on CPU ranks (gloo) under device and host
placement, and ``--mesh.dp=2 --mesh.mp=2``: the tensor-parallel trainer
end to end (its JAX parity is tests/test_torch_tensor_parallel.py's)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.runtime.checkpoint import (list_checkpoints,
                                               restore_checkpoint)
from tests.test_torch_train import TINY_ARGS

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("placement,dp", [("device", 1), ("host", 1),
                                          ("device", 2)])
def test_cli_train_mesh_mp2(tmp_path, placement, dp):
    """``cli.train --mesh.dp=DP --mesh.mp=2`` on CPU ranks: every rank
    takes the steps, the dp replicas hold equal states and the mp ranks
    different shards (at the tiny widths the LSTM's 4H = 64 shards), and
    the checkpoint holds the full network, which a one-device learner's
    shapes take."""
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.cli.train", *TINY_ARGS,
         "--device=cpu", "--actor-mode=thread", "--max-steps=4",
         f"--mesh.dp={dp}", "--mesh.mp=2",
         f"--replay.placement={placement}",
         "--runtime.save_interval=2", f"--runtime.save_dir={tmp_path}"],
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    shards = summary["shards"]
    assert [s["rank"] for s in shards] == list(range(2 * dp))
    assert {s["steps"] for s in shards} == {summary["steps"]} == {4}
    digests = [s["state_sha256"] for s in shards]
    assert digests[0] != digests[1]
    assert digests[:2] == digests[-2:]
    assert np.isfinite(summary["final_loss"])
    ckpt = restore_checkpoint(list_checkpoints(str(tmp_path), "Fake",
                                               0)[-1][1])
    cfg = parse_overrides(Config(), TINY_ARGS)
    actions = ckpt["params"]["head.adv_out.bias"].shape[0]
    net = NetworkApply(actions, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    for name, shape in net.param_specs:
        assert tuple(ckpt["params"][name].shape) == tuple(shape), name
    assert int(ckpt["step"]) == 4
    state = ckpt["opt_state"]["state"]
    for i, (name, shape) in enumerate(net.param_specs):
        assert tuple(state[i]["exp_avg"].shape) == tuple(shape), name
    assert torch.all(torch.isfinite(ckpt["params"]["lstm.recurrent_kernel"]))
