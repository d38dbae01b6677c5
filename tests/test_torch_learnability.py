"""System-level learnability of the port, the twin of the JAX package's
tests/test_learnability.py: the configuration, budget and thresholds of
``r2d2_tpu_torch/tools/learnability.py`` through the port's deterministic
synchronous loop (tools/sync_train.py) on the CPU. The Fake env shows the
target action in every frame, so the oracle return is episode_len = 120
and a uniform-random policy expects episode_len / action_dim = 20; the
greedy policy must land every evaluation seed at 2x random and the mean
at 3x.

Runs in a subprocess, as the JAX test does. ``chip_smoke.py`` runs the
same module with the learner on the card."""

import json
import os
import subprocess
import sys

import pytest

from r2d2_tpu_torch.tools.learnability import TRAIN_STEPS, check_returns

pytestmark = [pytest.mark.slow, pytest.mark.torch_port]


def test_full_system_improves_policy(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.tools.learnability",
         str(tmp_path), "--device=cpu"],
        capture_output=True, text=True, timeout=1500,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["training_steps"] >= TRAIN_STEPS
    check_returns(result["returns"])
