"""``cli.train --mesh.dp=2`` with thread actors on two CPU ranks (gloo):
lockstep steps and train states, round-robin blocks per block and through
the stager, and no rank left after a stop or a raised error (the JAX
parity of the data-parallel path is tests/test_torch_parallel.py's)."""

import json
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import Config, parse_overrides
from tests.test_torch_train import TINY_ARGS

pytestmark = pytest.mark.torch_port


def _dp_children() -> list:
    return [p for p in mp.active_children() if p.name.startswith("dp-rank")]


@pytest.mark.parametrize("ingest", [1, 4])
def test_cli_train_dp2_thread_actors_on_cpu(tmp_path, ingest):
    """python -m r2d2_tpu_torch.cli.train --mesh.dp=2 on the CPU, per
    block and through the stager (replay.ingest_batch_blocks=4, whose
    batches rank 0 commits with make_sharded_replay_add_many): two gloo
    ranks train in lockstep (equal steps, the same train state digest),
    the blocks go round-robin (shard counts differ by <= 1), and the
    command ends with every rank gone."""
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.cli.train", *TINY_ARGS,
         "--device=cpu", "--actor-mode=thread", "--max-steps=6",
         "--mesh.dp=2", f"--replay.ingest_batch_blocks={ingest}",
         f"--runtime.save_dir={tmp_path}"],
        capture_output=True, text=True, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    shards = summary["shards"]
    assert [s["rank"] for s in shards] == [0, 1]
    assert {s["steps"] for s in shards} == {summary["steps"]} == {6}
    assert len({s["state_sha256"] for s in shards}) == 1
    counts = [s["shard_blocks"] for s in shards]
    assert abs(counts[0] - counts[1]) <= 1
    assert sum(counts) == summary["blocks_ingested"]
    assert np.isfinite(summary["final_loss"])


def test_a_raised_error_leaves_no_rank_behind(tmp_path):
    """Rank 0 raising mid-run (its dispatch hook) ends the run with the
    error and no follower process left."""
    from r2d2_tpu_torch.runtime import orchestrator
    cfg = parse_overrides(Config(), TINY_ARGS + [
        "--mesh.dp=2", f"--runtime.save_dir={tmp_path}",
        "--runtime.save_interval=0"])

    def boom(stack):
        raise RuntimeError("injected")

    with pytest.raises(RuntimeError, match="injected"):
        orchestrator.train(cfg, max_training_steps=4, device="cpu",
                           dispatch_hook=boom)
    assert not _dp_children()
    assert not torch.distributed.is_initialized()
