"""The multi-host trainer (r2d2_tpu_torch/parallel/multihost.py) end to
end on the CPU: two controllers, each its own interpreter on a loopback
coordinator over gloo, at ``_demo_config``'s tiny shapes, with thread
actors, process actors and host placement; rank 0's checkpoint restored
by a single-process learner and a resumed job (the JAX package's
tests/test_parallel.py multihost contracts). Each controller's collectives
time out after ``TIMEOUT_S``, so a hung rank fails fast. The stop, the
failure and the CLI's routing are tests/test_torch_multihost_stop.py's."""

import os

import numpy as np
import pytest

from r2d2_tpu_torch.parallel.multihost import _demo_config, launch_demo
from r2d2_tpu_torch.runtime.checkpoint import (list_checkpoints,
                                               restore_checkpoint)

pytestmark = pytest.mark.torch_port

TIMEOUT_S = 60.0            # a collective's wait in each controller
RUN_S = 240.0               # a launch's deadline


def _check_records(records, steps: int) -> None:
    """Every controller at ``steps`` with one train state, blocks in each
    controller's own shard, finite losses on rank 0."""
    assert [r["rank"] for r in records] == [0, 1]
    assert {r["step"] for r in records} == {steps}
    assert len({r["digest"] for r in records}) == 1
    assert all(r["shard_blocks"] > 0 for r in records)
    assert records[0]["losses_finite"] is True
    assert {r["env_steps"] for r in records} == {records[0]["env_steps"]}
    assert sum(r["local_env_steps"] for r in records) <= \
        records[0]["env_steps"]


def test_two_controllers_thread_actors_checkpoint_and_resume(tmp_path):
    """Two controllers with thread actors train to 8 steps in lockstep
    (equal digests); rank 0's step-8 checkpoint holds both ranks' sampling
    generators and restores into an ordinary single-process learner; a
    resumed job, every controller from that checkpoint, reaches 12 with
    more env steps."""
    import torch

    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    save_dir = str(tmp_path / "mh")
    records = launch_demo(2, save_dir, 8, RUN_S,
                          device="cpu", collective_timeout=TIMEOUT_S)
    _check_records(records, 8)
    ckpts = list_checkpoints(save_dir, "Fake", 0)
    assert ckpts, "rank 0 wrote no checkpoints"
    ck = restore_checkpoint(ckpts[-1][1])
    assert int(ck["step"]) == 8 and int(ck["env_steps"]) > 0
    assert len(ck["generators"]) == 2
    assert not torch.equal(ck["generators"][0], ck["generators"][1])
    assert os.path.exists(os.path.join(save_dir, "train_player0.log"))

    single = _demo_config(save_dir).replace(**{
        "mesh.multihost": False, "runtime.resume": ckpts[-1][1],
        "runtime.save_interval": 0})
    probe = create_env(single.env)
    net = NetworkApply(probe.action_space.n, single.network,
                       single.env.frame_stack,
                       single.env.frame_height, single.env.frame_width,
                       "cpu")
    probe.close()
    learner = Learner(single, net)
    assert learner.training_steps == 8
    assert learner.env_steps == int(ck["env_steps"])
    assert torch.equal(learner.train_state.generator.get_state(),
                       ck["generators"][0])

    resumed = launch_demo(2, save_dir, 12, RUN_S, resume=ckpts[-1][1],
                          device="cpu", collective_timeout=TIMEOUT_S)
    _check_records(resumed, 12)
    ck2 = restore_checkpoint(list_checkpoints(save_dir, "Fake", 0)[-1][1])
    assert int(ck2["step"]) == 12
    assert int(ck2["env_steps"]) > int(ck["env_steps"])


def test_two_controllers_process_actors(tmp_path):
    """Spawned actor processes a controller, fed through the shm ring:
    lockstep to 8 steps with equal digests and rank 0's checkpoints; every
    actor process exited. Replay snapshots asked for in a job of two are
    skipped with a warning (rank 0's shard is not the whole replay)."""
    from r2d2_tpu_torch.replay.snapshot import read_manifest
    save_dir = str(tmp_path / "mh_proc")
    records = launch_demo(2, save_dir, 8, RUN_S, actor_mode="process",
                          device="cpu", collective_timeout=TIMEOUT_S,
                          overrides=["--runtime.snapshot_interval=4"])
    _check_records(records, 8)
    assert read_manifest(save_dir, 0) is None
    assert all(code is not None for r in records
               for code in r["actor_exitcodes"])
    ck = restore_checkpoint(list_checkpoints(save_dir, "Fake", 0)[-1][1])
    assert int(ck["step"]) == 8 and int(ck["env_steps"]) > 0


def test_two_controllers_host_placement(tmp_path):
    """Host placement: a HostReplay a controller, the consensus in place of
    the ingest and the sharded external-batch step, one step a dispatch:
    lockstep to 8 steps with equal digests, no gather launched."""
    save_dir = str(tmp_path / "mh_host")
    records = launch_demo(2, save_dir, 8, RUN_S, placement="host",
                          device="cpu", collective_timeout=TIMEOUT_S)
    _check_records(records, 8)
    assert all(r["dispatches"] == 8 for r in records)
    ck = restore_checkpoint(list_checkpoints(save_dir, "Fake", 0)[-1][1])
    assert int(ck["step"]) == 8
    assert np.isfinite(float(ck["env_steps"]))


def test_two_controllers_int8_thread_actors(tmp_path):
    """Quantized inference: the controllers publish the int8 bundle and
    their thread actors act with it; lockstep to 8 steps with equal
    digests, and rank 0's records carry the quant block."""
    import json
    save_dir = str(tmp_path / "mh_int8")
    records = launch_demo(2, save_dir, 8, RUN_S,
                          device="cpu", collective_timeout=TIMEOUT_S,
                          overrides=["--network.inference_dtype=int8",
                                     "--runtime.log_interval=0.2"])
    _check_records(records, 8)
    with open(os.path.join(save_dir, "metrics_player0.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert logged and all("quant" in r for r in logged)
    assert logged[-1]["quant"]["dtype"] == "int8"


def test_one_controller_job_keeps_the_snapshot_twin(tmp_path):
    """A job of one controller (a world of one, in this process) with
    replay snapshots: the rank-0 twin writes the final cut at the stop
    step; a resumed job restores it (the ring's adds carry on from the
    cut) and trains on."""
    import torch

    from r2d2_tpu_torch.parallel.multihost import train_multihost
    from r2d2_tpu_torch.replay.snapshot import load_snapshot
    cfg = _demo_config(str(tmp_path)).replace(**{
        "runtime.snapshot_interval": 4})
    out = train_multihost(cfg, max_training_steps=8, device="cpu",
                          timeout_s=TIMEOUT_S)
    assert not torch.distributed.is_initialized()
    snap = load_snapshot(str(tmp_path), 0)
    assert snap["kind"] == "plain" and snap["step"] == out["step"] == 8
    adds = snap["shards"][0]["ring"]["total_adds"]
    assert adds == out["shard_blocks"] > 0
    ckpt = list_checkpoints(str(tmp_path), "Fake", 0)[-1][1]
    resumed = train_multihost(cfg.replace(**{"runtime.resume": ckpt}),
                              max_training_steps=12, device="cpu",
                              timeout_s=TIMEOUT_S)
    snap2 = load_snapshot(str(tmp_path), 0)
    assert snap2["step"] == resumed["step"] == 12
    assert snap2["shards"][0]["ring"]["total_adds"] == \
        adds + resumed["shard_blocks"]
