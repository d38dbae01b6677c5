"""The replay service's host timings and the service probe
(r2d2_tpu_torch/tools/service_probe.py) at a small shape on the CPU: each
operation's calls, lock waits and holds are counted where they happen (a
promotion inside a sample is the promotion's, not the sample's), a reset
empties them, and the probe's parts run end to end and report what they
promise. The probe's numbers mean something only on the card."""

import math

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.fleet.replay_service import HOST_OPS, ReplayService
from r2d2_tpu_torch.tools import service_probe as probe
from tests.test_torch_replay import specs, synthetic_blocks

pytestmark = pytest.mark.torch_port

SMALL = {
    "env.frame_height": 12, "env.frame_width": 12, "env.frame_stack": 2,
    "network.hidden_dim": 8, "network.cnn_out_dim": 16,
    "network.conv_layers": ((4, 3, 2),),
    "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
    "sequence.forward_steps": 3, "replay.block_length": 20,
    "replay.capacity": 80, "replay.batch_size": 4,
    "replay.learning_starts": 40, "network.pallas_lstm": "off",
}


def test_host_timings_count_each_operation():
    _, spec = specs(num_blocks=2)
    svc = ReplayService(spec, 1, "cpu", spill_blocks=2, promote_per_sample=1)
    blocks = synthetic_blocks(spec, 4, seed=1)
    for block in blocks:
        svc.add_block(block)
    batch, shard, snap = svc.sample(uniform=torch.full(
        (spec.batch_size,), 0.5))
    svc.update_priorities(shard, batch.idxes.numpy(),
                          np.ones(spec.batch_size, np.float32),
                          adds_snapshot=snap)
    svc.trace_lookup(shard, batch.idxes.numpy())
    t = svc.host_timings()
    assert set(t) == set(HOST_OPS)
    assert [t[op]["calls"] for op in HOST_OPS] == [4, 1, 1, 1, 1]
    for op in HOST_OPS:
        assert t[op]["wait_ms"] >= 0 and t[op]["held_ms"] >= 0
        assert math.isclose(t[op]["held_ms_per_call"],
                            t[op]["held_ms"] / t[op]["calls"], rel_tol=1e-3,
                            abs_tol=1e-3)
    # the sample's hold excludes the promotion it ran
    assert t["sample"]["held_ms"] >= 0
    assert svc.shards[0].spill.promotions == 1
    svc.host_timings(reset=True)
    assert all(r["calls"] == 0 and r["held_ms_per_call"] is None
               for r in svc.host_timings().values())


@pytest.mark.parametrize("staging", [False, True], ids=["sync", "staged"])
def test_service_args_parse_to_the_service_path(staging):
    args = probe.service_args(3, staging)
    cfg = parse_overrides(Config(), [a for a in args
                                     if not a.startswith("--actor-mode")])
    assert cfg.fleet.replay_shards == probe.SHARDS
    assert cfg.fleet.spill_blocks == 3
    assert cfg.fleet.sample_staging is staging
    assert cfg.replay.capacity == probe.SHARDS * 3 * cfg.replay.block_length
    assert cfg.fleet.active


def test_probe_parts_run_at_a_small_shape():
    cpu = torch.device("cpu")
    ops = probe.part_ops(cpu, 2, SMALL, repeats=2)
    assert all(ops[k] > 0 for k in ("sample_ms", "promote_ms",
                                    "writeback_host_ms",
                                    "writeback_device_ms", "page_mb"))
    idle = probe.part_idle(cpu, 2, SMALL, window=2)
    assert idle["graph_alone_ms_per_step"] > 0
    for staging in ("off", "on"):
        for promote in (1, 0):
            r = idle[f"staging={staging} promote={promote}"]
            assert len(r["seq_updates_per_s"]) == 2 * probe.WINDOWS
            assert all(x > 0 for x in r["seq_updates_per_s"])
            turns = r["host_timings_by_turn"]
            assert len(turns) == 2
            assert all(t["sample"]["calls"] > 0 for t in turns)
            assert all(t["writeback"]["calls"] > 0 for t in turns)
            assert all((t["promote"]["calls"] > 0) == (promote > 0)
                       for t in turns)
