"""Replay snapshots of a data-parallel Learner (``mesh.dp`` > 1, one host):
every dp row's shard cut into one snapshot in the JAX package's layout
(leaves stacked on a leading dp axis, the RingAccountant over every shard,
``next_shard``), each rank restoring its own shard and its row's
generator; the JAX side on conftest's fake CPU devices, the port's ranks
as gloo processes running ``tools/dp_check.py``'s ``rank_snapshot_twin``.
Under ``mesh.multihost`` a job of several controllers keeps JAX's
warn-and-skip."""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from r2d2_tpu.config import MeshConfig as JMeshConfig
from r2d2_tpu.parallel import make_mesh as j_make_mesh
from r2d2_tpu.parallel import (make_sharded_replay_add as j_sharded_add,
                               sharded_replay_init as j_sharded_init)
from r2d2_tpu.replay.snapshot import capture_plain as j_capture
from r2d2_tpu.replay.structs import Block as JBlock
from r2d2_tpu.replay.structs import RingAccountant as JRing
from r2d2_tpu_torch.config import Config, RuntimeConfig, parse_overrides
from r2d2_tpu_torch.parallel.mesh import run_ranks
from r2d2_tpu_torch.parallel.multihost import snapshot_twin_on
from r2d2_tpu_torch.replay import device_replay as tdr
from r2d2_tpu_torch.replay.snapshot import (capture_sharded, restore_plain,
                                            shard_leaves)
from r2d2_tpu_torch.replay.structs import (DIAG_LEAVES, ReplaySpec,
                                           RingAccountant)
from r2d2_tpu_torch.tools import dp_check
from tests.test_torch_recovery import LEAVES
from tests.test_torch_replay import specs, synthetic_blocks
from tests.test_torch_train import TINY_ARGS

pytestmark = pytest.mark.torch_port

DP = 2
BLOCKS = 5          # odd: the next block goes to shard 1


def _cfg(save_dir) -> Config:
    return parse_overrides(Config(), TINY_ARGS + [
        f"--runtime.save_dir={save_dir}", "--runtime.save_interval=0",
        "--runtime.snapshot_interval=100000",
        "--runtime.steps_per_dispatch=1", f"--mesh.dp={DP}"])


def _jax_sharded_capture(spec, blocks):
    """JAX's Learner cut of a dp=2 mesh replay after the same round-robin
    blocks: the sharded state and its RingAccountant over both shards."""
    fields = {k: v for k, v in dataclasses.asdict(spec).items()
              if k != "exact_gather"}
    jspec, _ = specs(**fields)
    mesh = j_make_mesh(JMeshConfig(dp=DP))
    state, ring = j_sharded_init(jspec, mesh), JRing(jspec.num_blocks * DP)
    add = j_sharded_add(jspec, mesh)
    for i, blk in enumerate(blocks):
        state = add(state, JBlock(**dataclasses.asdict(blk)), i % DP)
        ring.advance(int(blk.learning_steps.sum()), int(blk.weight_version))
    return j_capture(jspec, state, ring, 0, {"next_shard": len(blocks) % DP})


def test_dp2_snapshot_matches_jax_and_restores_bit_for_bit(tmp_path):
    """Two Learner ranks: the cut after five round-robin blocks holds
    JAX's sharded capture leaf for leaf (rings, stamps, lanes and the
    replay diagnostics' leaves exact,
    the sum tree within pow's last ulp as tests/test_torch_recovery.py
    allows), its ring and ``next_shard``; a learner resumed from a
    checkpoint and a later snapshot adopts ``next_shard`` (the same extra
    block then lands in the same shard) and takes the twin's next three
    losses bit for bit."""
    cfg = _cfg(tmp_path)
    spec = ReplaySpec.from_config(cfg, "cpu")
    blocks = synthetic_blocks(spec, BLOCKS + 1, seed=4)
    out = run_ranks(dp_check.rank_snapshot_twin, DP,
                    {"cfg": cfg.to_dict(), "action_dim": 18,
                     "blocks": blocks[:BLOCKS], "extra_block": blocks[-1],
                     "steps": 2}, rendezvous_dir=str(tmp_path))[0]
    cut = out["cut"]
    want = _jax_sharded_capture(spec, blocks[:BLOCKS])
    leaves, jleaves = cut["shards"][0]["state"], want["shards"][0]["state"]
    # the default config's replay diagnostics add their five leaves
    names = set(LEAVES) | set(DIAG_LEAVES)
    assert set(leaves) == set(jleaves) == names
    for name in sorted(names):
        assert leaves[name].shape == jleaves[name].shape, name
        assert leaves[name].dtype == jleaves[name].dtype, name
        if name == "tree":
            np.testing.assert_allclose(leaves[name], jleaves[name],
                                       rtol=1e-6, atol=2.4e-7)
        else:
            np.testing.assert_array_equal(leaves[name], jleaves[name],
                                          err_msg=name)
    assert cut["shards"][0]["ring"] == {
        k: want["shards"][0]["ring"][k]
        for k in ("ptr", "total_adds", "buffer_steps", "slot_steps",
                  "slot_versions")}
    assert cut["extra"]["next_shard"] == want["extra"]["next_shard"] == 1
    assert len(cut["extra"]["generator_states"]) == DP
    assert out["restores"] == 1 and out["next_shard"] == 1
    assert out["resumed"] == out["twin"]


@pytest.mark.parametrize("placement", ["device", "host"])
def test_tp_learner_publishes_saves_and_resumes(placement, tmp_path):
    """dp=1 x mp=2 Learner ranks, the trainer's tensor-parallel wiring
    (rank 0 drives; under host placement it scatters each batch): the
    published network is the full one while the ranks hold shards, the
    gathered checkpoint restores it bit for bit into a fresh pair of
    ranks, and every step's loss is finite. Device placement also
    snapshots one replica of the row, and the resumed learner's next
    three losses equal the twin's bit for bit."""
    device = placement == "device"
    cfg = parse_overrides(Config(), TINY_ARGS + [
        f"--runtime.save_dir={tmp_path}", "--runtime.save_interval=0",
        "--runtime.steps_per_dispatch=1", "--mesh.dp=1", "--mesh.mp=2",
        f"--replay.placement={placement}"]
        + (["--runtime.snapshot_interval=100000"] if device else []))
    spec = ReplaySpec.from_config(cfg, "cpu")
    blocks = synthetic_blocks(spec, BLOCKS + 1, seed=4)
    outs = run_ranks(dp_check.rank_snapshot_twin, 1,
                     {"cfg": cfg.to_dict(), "action_dim": 18,
                      "blocks": blocks[:BLOCKS], "extra_block": blocks[-1],
                      "steps": 2, "cut": False}, mp=2,
                     rendezvous_dir=str(tmp_path))
    out = outs[0]
    full = out["full_shapes"]
    sharded = [n for n, s in outs[1]["shapes"].items() if s != full[n]]
    assert sharded and outs[0]["shapes"] == outs[1]["shapes"]
    assert out["resumed_sha"] == out["published_sha"]
    assert all(np.isfinite(out[k]).all()
               for k in ("losses", "twin", "resumed"))
    if device:
        assert out["restores"] == 1 and out["resumed"] == out["twin"]
    else:
        assert out["restores"] == 0 and "cut" not in out


def test_sharded_snapshot_restores_each_shard_and_refuses_another_dp():
    """``capture_sharded`` of two shards restores shard d into a fresh
    replay bit for bit; a sharded cut refuses an unsharded replay and one
    of another dp, and an unsharded cut refuses a shard."""
    spec = ReplaySpec(**dataclasses.asdict(specs(num_blocks=4)[1]))
    states = []
    for seed in (1, 2):
        state = tdr.replay_init(spec, "cpu")
        for blk in synthetic_blocks(spec, 3, seed=seed):
            tdr.replay_add(spec, state, blk)
        states.append(state)
    ring = RingAccountant(spec.num_blocks * DP)
    snap = capture_sharded(spec, [shard_leaves(s) for s in states], ring, 3)
    for d, state in enumerate(states):
        fresh = tdr.replay_init(spec, "cpu")
        restore_plain(spec, fresh, RingAccountant(spec.num_blocks * DP),
                      snap, shard=d, dp=DP)
        for name in LEAVES:
            want, got = getattr(state, name), getattr(fresh, name)
            assert (torch.equal(got, want) if torch.is_tensor(want)
                    else got == want), name
    fresh = tdr.replay_init(spec, "cpu")
    with pytest.raises(ValueError, match="same mesh dp"):
        restore_plain(spec, fresh, RingAccountant(spec.num_blocks), snap)
    with pytest.raises(ValueError, match="same mesh dp"):
        restore_plain(spec, fresh, ring, snap, shard=0, dp=4)


def test_snapshots_under_dp_parse_and_multihost_warns_and_skips(caplog):
    """``runtime.snapshot_interval`` with ``mesh.dp`` > 1 is a setting now;
    under ``mesh.multihost`` a job of several controllers (or dp > 1)
    keeps the JAX package's warning and skips the rank-0 twin, which a
    job of one keeps."""
    cfg = parse_overrides(Config(), ["--mesh.dp=2",
                                     "--runtime.snapshot_interval=10"])
    assert (cfg.mesh.dp, cfg.runtime.snapshot_interval) == (2, 10)
    rt = RuntimeConfig(snapshot_interval=10)
    with caplog.at_level(logging.WARNING):
        assert not snapshot_twin_on(rt, 0, 2, 2, False)
    assert "replay snapshots are skipped" in caplog.text
    assert "nprocs=2 dp=2" in caplog.text
    assert snapshot_twin_on(rt, 0, 1, 1, False)
    assert not snapshot_twin_on(rt, 1, 1, 1, False)
    assert not snapshot_twin_on(rt, 0, 1, 1, True)
    assert not snapshot_twin_on(RuntimeConfig(), 0, 1, 1, False)
