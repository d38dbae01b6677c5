"""The port's pipelined block ingest (runtime/learner_loop.py's stager and
commit, ``replay.ingest_batch_blocks``) on the CPU, the cases of the JAX
package's tests/test_ingest.py: stacked drains of BlockQueue and the shm
ring against the stacked blocks, exact; a pipelined Learner against the
per-block Learner after the same blocks (replay state, ring, env steps,
exact); the port's pipelined replay against JAX's pipelined Learner on the
same blocks (integer fields exact; the sum tree's leaves within 2.4e-7,
the 1-ulp ``pow`` difference of ROADMAP C, or exact at
prio_exponent=1); the rate
limiter back-pressuring the stager; a stager exception raised on the main
thread; the knob's validation and the record's ``ingest`` block. Every
wait on a thread is bounded."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.replay.structs import ReplaySpec, stack_blocks
from r2d2_tpu_torch.runtime.feeder import BlockQueue
from r2d2_tpu_torch.runtime.learner_loop import Learner
from r2d2_tpu_torch.runtime.metrics import TrainMetrics
from tests.test_torch_replay import SPEC, synthetic_blocks
from tests.test_torch_train import TINY_ARGS

pytestmark = pytest.mark.torch_port

WAIT = 30.0         # seconds any wait on the stager may take here
INT_FIELDS = ("obs", "last_action", "action", "burn_in_steps",
              "learning_steps", "forward_steps", "seq_start",
              "weight_version", "lane")
FLOAT_FIELDS = ("hidden", "reward", "gamma")


def blocks_equal(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)),
                                      err_msg=f.name)


def learner(k: int, *extra) -> Learner:
    cfg = parse_overrides(Config(), TINY_ARGS + [
        f"--replay.ingest_batch_blocks={k}", "--runtime.steps_per_dispatch=1",
        "--replay.max_env_steps_per_train_step=0", *extra])
    net = NetworkApply(18, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    return Learner(cfg, net)


def drain_until(lr, q, want: int, timeout: float = WAIT) -> int:
    n = 0
    deadline = time.monotonic() + timeout
    while n < want and time.monotonic() < deadline:
        n += lr.drain(q)
        time.sleep(0.005)
    return n


def filled_queue(blocks) -> BlockQueue:
    q = BlockQueue(use_mp=False)
    for blk in blocks:
        q.put(blk)
    return q


def test_blockqueue_drain_stacked_and_groups():
    """The queue.Queue transport's stacked drain equals stack_blocks of
    the popped blocks, FIFO, into fresh arrays or the caller's buffers;
    a partial tail, the empty queue, and drain_groups."""
    spec = ReplaySpec(**SPEC)
    blocks = synthetic_blocks(spec, 7, seed=3)
    q = filled_queue(blocks)
    stacked, k = q.drain_stacked(3)
    assert k == 3
    blocks_equal(stacked, stack_blocks(blocks[:3]))
    out = {f.name: np.zeros((4,) + np.shape(getattr(blocks[0], f.name)),
                            np.asarray(getattr(blocks[0], f.name)).dtype)
           for f in dataclasses.fields(blocks[0])}
    stacked, k = q.drain_stacked(4, out=out)
    assert k == 4
    blocks_equal(stacked, stack_blocks(blocks[3:7]))
    assert np.shares_memory(stacked.obs_row, out["obs_row"])
    assert q.drain_stacked(2) == (None, 0)
    for blk in blocks[:5]:
        q.put(blk)
    groups = q.drain_groups(2, max_groups=4)
    assert [k for _, k in groups] == [2, 2, 1]
    blocks_equal(groups[2][0], stack_blocks(blocks[4:5]))
    assert q.drain_groups(2) == []


def test_shm_ring_drain_stacked():
    """Straight from the ring's slots into one contiguous array per field,
    or into the caller's buffers: equal to the stacked blocks, FIFO, a
    partial tail, the empty ring; the ring stays usable."""
    from r2d2_tpu_torch.runtime.shm_feeder import ShmBlockRing
    spec = ReplaySpec(**SPEC)
    blocks = synthetic_blocks(spec, 5, seed=4)
    ring = ShmBlockRing(spec, maxsize=8)
    try:
        for blk in blocks:
            ring.put(blk, timeout=1.0)
        stacked, k = ring.drain_stacked(3)
        assert k == 3
        blocks_equal(stacked, stack_blocks(blocks[:3]))
        assert all(getattr(stacked, f.name).flags["C_CONTIGUOUS"]
                   for f in dataclasses.fields(stacked))
        out = {name: np.zeros((4,) + np.shape(a), np.asarray(a).dtype)
               for name, a in dataclasses.asdict(blocks[0]).items()}
        stacked, k = ring.drain_stacked(4, out=out)
        assert k == 2
        blocks_equal(stacked, stack_blocks(blocks[3:]))
        assert np.shares_memory(stacked.hidden, out["hidden"])
        assert ring.drain_stacked(4) == (None, 0)
        ring.put(blocks[0], timeout=1.0)
        blocks_equal(ring.get_nowait(), blocks[0])
    finally:
        ring.close()


def test_pipelined_learner_equals_per_block_learner():
    """K=4 through the stager and the commit against the per-block drain,
    the same 46 blocks (the 40-block ring wraps): every replay tensor, the
    pointer, the ring accountant, env steps and the ingest counters
    exactly; the staged counters back at zero; then one step from each,
    equal losses."""
    a, b = learner(4), learner(1)
    try:
        assert a._ingest_k == 4 and b._ingest_k == 1
        blocks = synthetic_blocks(a.spec, 23, seed=1) * 2
        qa, qb = filled_queue(blocks), filled_queue(blocks)
        assert drain_until(a, qa, len(blocks)) == len(blocks)
        while qb.qsize():
            b.drain(qb)
        for name, value in vars(b.replay_state).items():
            got = getattr(a.replay_state, name)
            assert (torch.equal(got, value) if torch.is_tensor(value)
                    else got == value), name
        for name in ("ptr", "total_adds", "buffer_steps", "slot_steps",
                     "slot_versions"):
            assert getattr(a.ring, name) == getattr(b.ring, name), name
        assert a.env_steps == b.env_steps == len(blocks) * a.spec.block_length
        assert a._staged_blocks == a._staged_env_steps == 0
        assert a.metrics.ingest_blocks_total == len(blocks)
        a.step(), b.step()
        assert a.losses == b.losses
    finally:
        a.stop_background()
        b.stop_background()


@pytest.mark.parametrize("prio_exponent", [0.9, 1.0])
def test_pipelined_replay_matches_jax_pipelined_learner(tmp_path,
                                                        prio_exponent):
    """The same blocks through the port's K=4 stager and JAX's K=4
    stager: integer fields and the pointer exact, float fields exact, the
    sum tree's leaves within 2.4e-7 at 0.9 (pow's last ulp, ROADMAP C)
    and its sums at rtol 1e-6 (test_torch_replay's rule), exact at
    1.0."""
    import jax
    from r2d2_tpu.config import Config as JConfig
    from r2d2_tpu.models.network import NetworkApply as JNetworkApply
    from r2d2_tpu.replay.structs import Block as JBlock
    from r2d2_tpu.runtime.feeder import BlockQueue as JBlockQueue
    from r2d2_tpu.runtime.learner_loop import Learner as JLearner

    prio = f"--replay.prio_exponent={prio_exponent}"
    port = learner(4, prio)
    over = {
        "env.game_name": "Fake", "env.frame_height": 24,
        "env.frame_width": 24, "env.frame_stack": 2,
        "network.hidden_dim": 16, "network.cnn_out_dim": 32,
        "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
        "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
        "sequence.forward_steps": 3, "replay.capacity": 800,
        "replay.block_length": 20, "replay.batch_size": 8,
        "replay.learning_starts": 100, "replay.prio_exponent": prio_exponent,
        "replay.ingest_batch_blocks": 4, "runtime.save_interval": 0,
        "runtime.steps_per_dispatch": 1, "runtime.save_dir": str(tmp_path)}
    jcfg = JConfig().replace(**over)
    jnet = JNetworkApply(4, jcfg.network, 2, 24, 24)
    jl = JLearner(jcfg, jnet)
    try:
        assert jl._ingest_k == 4
        blocks = synthetic_blocks(port.spec, 45, seed=2)
        jq = JBlockQueue(use_mp=False)
        for blk in blocks:
            jq.put(JBlock(**dataclasses.asdict(blk)))
        q = filled_queue(blocks)
        assert drain_until(port, q, len(blocks)) == len(blocks)
        assert drain_until(jl, jq, len(blocks), timeout=120.0) == len(blocks)
        js = jax.tree_util.tree_map(np.asarray, jl.replay_state)
        ts = port.replay_state
        for name in INT_FIELDS + FLOAT_FIELDS:
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          getattr(js, name), err_msg=name)
        if prio_exponent == 1.0:
            np.testing.assert_array_equal(ts.tree.numpy(), js.tree)
        else:
            leaves = 2 ** (port.spec.tree_layers - 1) - 1
            np.testing.assert_allclose(ts.tree.numpy()[leaves:],
                                       js.tree[leaves:], rtol=0, atol=2.4e-7)
            np.testing.assert_allclose(ts.tree.numpy(), js.tree, rtol=1e-6)
        assert ts.block_ptr == int(js.block_ptr) == port.ring.ptr
        assert port.ring.slot_steps == jl.ring.slot_steps
        assert port.env_steps == jl.env_steps
    finally:
        port.stop_background()
        jl.stop_background()


def test_rate_limiter_backpressures_the_stager():
    """With the limiter on and no training, the stager stops popping once
    committed plus staged steps reach the budget (learning_starts + ratio
    = 120 steps, 6 blocks), within two staged batches of it; blocks stay
    in the queue (the actors' back-pressure); ingestion reads paused."""
    lr = learner(2, "--replay.max_env_steps_per_train_step=20")
    try:
        q = filled_queue(synthetic_blocks(lr.spec, 12, seed=5))
        drain_until(lr, q, 12, timeout=3.0)
        time.sleep(0.5)          # time to overrun, if the stager would
        lr.drain(q)
        steps = lr.spec.block_length
        committed = lr.env_steps // steps
        with lr._staged_lock:
            staged = lr._staged_env_steps // steps
        assert committed >= 6
        assert committed + staged <= 6 + 2 * 2
        assert q.qsize() >= 12 - (6 + 2 * 2)
        assert lr.ingestion_paused
    finally:
        lr.stop_background()


class _BrokenQueue:
    """A feeder whose stacked drain raises."""

    def qsize(self):
        return 3

    def drain_stacked(self, max_items, out=None):
        raise OSError("the ring went away")


def test_stager_exception_is_raised_on_the_main_thread():
    lr = learner(4)
    try:
        deadline = time.monotonic() + WAIT
        with pytest.raises(RuntimeError, match="stager thread died") as info:
            while time.monotonic() < deadline:
                lr.drain(_BrokenQueue())
                time.sleep(0.01)
        assert isinstance(info.value.__cause__, OSError)
    finally:
        lr.stop_background()


def test_stop_commits_what_was_staged():
    """stop_background joins the stager and commits every batch it had
    staged: each popped block is in the replay, the counters at zero."""
    lr = learner(4)
    try:
        q = filled_queue(synthetic_blocks(lr.spec, 9, seed=6))
        lr.drain(q)                  # starts the stager, commits little
    finally:
        lr.stop_background()
    assert lr._stager is None
    assert lr._staged_blocks == lr._staged_env_steps == 0
    assert lr.ring.total_adds == 9 - q.qsize()
    assert lr.replay_state.block_ptr == lr.ring.ptr


def test_ingest_knob_validation_and_resolution():
    """JAX's rules: -1 (auto) or >= 1, at most num_blocks; "auto" is 1 on
    the CPU and CUDA_AUTO's value on CUDA; host placement keeps K=1."""
    from r2d2_tpu_torch.config import CUDA_AUTO
    cfg = Config()
    assert cfg.replay.ingest_batch_blocks == -1
    assert cfg.replay.resolved_ingest_batch_blocks("cpu") == 1
    assert cfg.replay.resolved_ingest_batch_blocks(torch.device("cuda")) \
        == CUDA_AUTO["replay.ingest_batch_blocks"]
    for bad in (0, -2):
        with pytest.raises(ValueError, match="ingest_batch_blocks"):
            cfg.replace(**{"replay.ingest_batch_blocks": bad})
    with pytest.raises(ValueError, match="must be <= num_blocks"):
        cfg.replace(**{"replay.ingest_batch_blocks": cfg.num_blocks + 1})
    k = parse_overrides(cfg, ["--replay.ingest_batch_blocks=8"])
    assert Config.from_json(k.to_json()).replay.ingest_batch_blocks == 8
    assert k.replay.resolved_ingest_batch_blocks("cuda") == 8
    host = learner(4, "--replay.placement=host",
                   "--replay.learning_starts=40")
    try:
        assert host._ingest_k == 1
    finally:
        host.stop_background()


def test_record_ingest_block_only_when_pipelined(tmp_path):
    """K > 1: the record's ``ingest`` block (K, queue depth, staged and
    committed batches and their host ms), reset each interval; K = 1: the
    record's keys as before."""
    lr = learner(4)
    try:
        q = filled_queue(synthetic_blocks(lr.spec, 8, seed=7))
        assert drain_until(lr, q, 8) == 8
        rec = lr.metrics.log(1.0)
        block = rec["ingest"]
        assert block["batch_blocks"] == 4 and block["queue_depth"] == 0
        assert block["staged_batches"] == block["committed_batches"] >= 2
        assert block["stage_ms"] > 0 and block["commit_ms"] > 0
        again = lr.metrics.log(1.0)["ingest"]
        assert again["staged_batches"] == 0 and again["stage_ms"] is None
    finally:
        lr.stop_background()
    plain = TrainMetrics(0, str(tmp_path))
    keys = set(plain.log(1.0))
    assert "ingest" not in keys and "ingest_queue_depth" not in keys
    assert "recovery" not in keys
