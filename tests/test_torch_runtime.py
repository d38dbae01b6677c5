"""The port's runtime pieces on the CPU, against the JAX package's where a
counterpart exists: the weight service (shm seqlock round trip, bit-equal,
and its checksum path; the in-process store's per-reader versions; the
learner's snapshot publisher), TrainMetrics' log lines (the same as
JAX's for the same calls, speeds excepted), checkpoints (round trip,
pretrain, list, prune, resume wiring), the rate limiter's pause and
resume points (the same as JAX's Learner's for the same blocks and
steps), the patient put, the losses' flush, and the exact resume."""

import dataclasses
import re
import threading
import time

import numpy as np
import pytest
import torch

from r2d2_tpu.config import Config as JConfig
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.runtime.feeder import BlockQueue as JBlockQueue
from r2d2_tpu.runtime.learner_loop import Learner as JLearner
from r2d2_tpu.runtime.metrics import TrainMetrics as JTrainMetrics
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.learner.train_step import create_train_state
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.replay.structs import Block
from r2d2_tpu_torch.runtime import weights as W
from r2d2_tpu_torch.runtime.checkpoint import (apply_restore,
                                               latest_checkpoint,
                                               list_checkpoints,
                                               load_checkpoint_config,
                                               load_pretrain,
                                               prune_checkpoints,
                                               restore_checkpoint,
                                               save_checkpoint)
from r2d2_tpu_torch.runtime.feeder import BlockQueue, put_patient
from r2d2_tpu_torch.runtime.learner_loop import Learner
from r2d2_tpu_torch.runtime.metrics import TrainMetrics
from r2d2_tpu_torch.runtime.weights import (InProcWeightStore,
                                            SnapshotPublisher,
                                            WeightPublisher, WeightSubscriber,
                                            flat_parameters)
from tests.test_replay import _fill_blocks

pytestmark = pytest.mark.torch_port

TINY = {
    "env.game_name": "Fake", "env.frame_height": 12, "env.frame_width": 12,
    "env.frame_stack": 2, "network.hidden_dim": 8, "network.cnn_out_dim": 32,
    "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
    "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
    "sequence.forward_steps": 3, "replay.capacity": 800,
    "replay.block_length": 20, "replay.batch_size": 8,
    "replay.learning_starts": 100, "optim.lr": 1e-3,
    "runtime.save_interval": 50, "runtime.steps_per_dispatch": 1}
A = 4


def configs(tmp_path, **extra):
    over = {**TINY, "runtime.save_dir": str(tmp_path), **extra}
    return JConfig().replace(**over), Config().replace(**over)


def port_net(cfg) -> NetworkApply:
    return NetworkApply(A, cfg.network, cfg.env.frame_stack,
                        cfg.env.frame_height, cfg.env.frame_width, "cpu")


def port_block(jblock) -> Block:
    return Block(**{f.name: np.array(getattr(jblock, f.name))
                    for f in dataclasses.fields(Block)})


@pytest.fixture
def module():
    return port_net(Config().replace(**TINY)).init(0)


def test_weight_shm_roundtrip(module):
    """Publisher -> segment -> subscriber gives the parameters bit-equal;
    a repeated poll without a publish gives None."""
    pub = WeightPublisher(module)
    try:
        sub = WeightSubscriber(pub.name, module)
        flat = flat_parameters(module)
        np.testing.assert_array_equal(sub.poll(), flat)
        assert sub.poll() is None and sub.publish_count == 1
        pub.publish(flat + 1.0)
        np.testing.assert_array_equal(sub.poll(), flat + 1.0)
        assert sub.publish_count == pub.publish_count == 2
        sub.close()
    finally:
        pub.close()


def test_weight_shm_checksum_path(module, monkeypatch):
    """With the weakly-ordered hosts' check forced on, the round trip
    works and a payload changed after the version settled is refused."""
    monkeypatch.setattr(W, "_NEEDS_CHECKSUM", True)
    pub = WeightPublisher(module)
    try:
        sub = WeightSubscriber(pub.name, int(pub.num_weights))
        flat = flat_parameters(module)
        np.testing.assert_array_equal(sub.poll(), flat)
        pub.publish(flat + 1.0)
        pub._payload[0] += 123.0
        assert sub.poll() is None
        pub.publish(flat + 1.0)
        np.testing.assert_array_equal(sub.poll(), flat + 1.0)
        sub.close()
    finally:
        pub.close()


def test_inproc_store_per_reader_versions(module):
    store = InProcWeightStore(module)
    assert store.poll(0) is not None
    assert store.poll(0) is None
    assert store.poll(1) is not None
    assert store.reader_version(2) == 1 and store.publish_count == 1
    store.publish(module)
    assert store.poll(0) is not None and store.reader_version(0) == 2
    np.testing.assert_array_equal(store.current(reader_id=3),
                                  flat_parameters(module))
    assert store.poll(3) is None


def test_snapshot_publisher_writes_host_snapshots(module):
    """The learner's publish hook on the CPU: every call reaches the
    store, in order, as the parameters at the call; flush and close are
    bounded."""
    store = InProcWeightStore(module)
    snaps = SnapshotPublisher(store.publish, module)
    try:
        want = []
        for i in range(5):
            with torch.no_grad():
                next(module.parameters()).add_(1.0)
            want.append(flat_parameters(module))
            snaps(module)
        snaps.flush()
        assert snaps.requested == snaps.publishes == 5
        assert store.publish_count == 6
        np.testing.assert_array_equal(store.current(), want[-1])
    finally:
        snaps.close()
    assert not snaps._thread.is_alive()


def _calls(m):
    m.set_buffer_size(1234)
    m.on_block(20, episode_return=7.5)
    m.on_block(20, episode_return=None)
    m.on_train_step(0.25)
    m.on_train_step(0.35)
    m.on_ingest_drain(2, 0.004)
    first = m.log(20.0)
    m.on_block(20, episode_return=float("nan"))
    m.on_dropped_priority_update()
    second = m.log(5.0)
    return first, second


def test_metrics_write_the_jax_log_lines(tmp_path):
    """The same calls give train_player0.log the same lines as the JAX
    package's TrainMetrics (speeds excepted) and the records' core keys
    the same values."""
    ours = _calls(TrainMetrics(0, str(tmp_path / "t")))
    theirs = _calls(JTrainMetrics(0, str(tmp_path / "j")))
    got = (tmp_path / "t" / "train_player0.log").read_text().splitlines()
    want = (tmp_path / "j" / "train_player0.log").read_text().splitlines()
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        if "speed" in a:
            assert re.sub(r": .*/s$", "", a) == re.sub(r": .*/s$", "", b)
        else:
            assert a == b
    assert re.search(r"^average episode return: 7\.5000$", "\n".join(got),
                     re.M)
    for a, b in zip(ours, theirs):
        for key in set(a) - {"t"}:
            assert key in b, key
            assert a[key] == b[key], key
    assert (tmp_path / "t" / "metrics_player0.jsonl").read_text().count(
        "\n") == 2
    memory = TrainMetrics(0, log_dir=None)
    memory.log(1.0)
    assert memory.logger.handlers == []


def _train_state(cfg, seed=0):
    return create_train_state(port_net(cfg), cfg.optim, seed,
                              cfg.network.use_double)


def test_checkpoint_roundtrip_pretrain_list_prune(tmp_path):
    cfg = Config().replace(**{**TINY, "network.use_double": True})
    ts = _train_state(cfg)
    ts.step = 300
    paths = [save_checkpoint(str(tmp_path), "Fake", k, 0, ts, 9000,
                             config_json=cfg.to_json()) for k in (3, 1, 12)]
    restored = restore_checkpoint(paths[0])
    assert restored["step"] == 300 and restored["env_steps"] == 9000
    for name, t in ts.params.state_dict().items():
        assert torch.equal(restored["params"][name], t)
    assert load_checkpoint_config(paths[0]) == cfg
    other = _train_state(cfg, seed=5)
    load_pretrain(paths[0], other.params)
    for a, b in zip(other.params.parameters(), ts.params.parameters()):
        assert torch.equal(a, b)
    assert list_checkpoints(str(tmp_path), "Fake", 0) == [
        (1, paths[1]), (3, paths[0]), (12, paths[2])]
    assert latest_checkpoint(str(tmp_path), "Fake", 0) == paths[2]
    assert prune_checkpoints(str(tmp_path), "Fake", 0, 2) == [paths[1]]
    assert [i for i, _ in list_checkpoints(str(tmp_path), "Fake", 0)] \
        == [3, 12]
    assert not (tmp_path / "Fake1_player0.config.json").exists()
    assert prune_checkpoints(str(tmp_path), "Fake", 0, 0) == []
    bad = Config().replace(**{**TINY, "network.hidden_dim": 16})
    with pytest.raises(ValueError, match="shape"):
        load_pretrain(paths[0], _train_state(bad).params)


def test_learner_resume_wiring(tmp_path):
    """runtime.resume restores the step, env_steps, optimizer state and
    the sampling generator inside Learner construction; pretrain loads
    the weights into params and target; the two are exclusive."""
    _, cfg = configs(tmp_path, **{"network.use_double": True})
    first = Learner(cfg, port_net(cfg))
    first.train_state.step = 7
    first.env_steps = 321
    first.train_state.generator.manual_seed(99)
    with torch.no_grad():
        for p in first.train_state.params.parameters():
            p.add_(0.5)
    path = first.save(2)
    resumed = Learner(cfg.replace(**{"runtime.resume": path}),
                      port_net(cfg), seed=4)
    assert resumed.training_steps == 7 and resumed.env_steps == 321
    assert int(resumed.train_state.step_count) == 7
    assert torch.equal(resumed.train_state.generator.get_state(),
                       first.train_state.generator.get_state())
    for a, b in zip(resumed.train_state.params.parameters(),
                    first.train_state.params.parameters()):
        assert torch.equal(a, b)
    warm = Learner(cfg.replace(**{"runtime.pretrain": path}), port_net(cfg),
                   seed=4)
    assert warm.training_steps == 0 and warm.env_steps == 0
    for a, b in zip(warm.train_state.target_params.parameters(),
                    first.train_state.params.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Learner(cfg.replace(**{"runtime.resume": path,
                               "runtime.pretrain": path}), port_net(cfg))
    assert apply_restore(cfg.runtime, _train_state(cfg)) == 0


def _jax_learner(jcfg):
    return JLearner(jcfg, JNetworkApply(A, jcfg.network, 2, 12, 12))


@pytest.mark.parametrize("ratio", [2.0, 0.5])
def test_rate_limiter_matches_jax(tmp_path, ratio):
    """replay.max_env_steps_per_train_step: the same blocks and the same
    step counts pause and resume ingestion at the same points in both
    learners (one block a drain), including a resumed run's budget."""
    jcfg, cfg = configs(tmp_path, **{
        "replay.max_env_steps_per_train_step": ratio})
    blocks = _fill_blocks(_jax_learner(jcfg).spec, 30,
                          np.random.default_rng(0))
    runs = []
    for make, queue, set_step in (
            (lambda: _jax_learner(jcfg), JBlockQueue(use_mp=False),
             lambda lr, s: setattr(lr, "_host_step", s)),
            (lambda: Learner(cfg, port_net(cfg)), BlockQueue(use_mp=False),
             lambda lr, s: setattr(lr.train_state, "step", s))):
        learner = make()
        for blk in blocks:
            queue.put(blk if isinstance(queue, JBlockQueue)
                      else port_block(blk))
        trace = []
        for step in (0, 0, 10, 30, 31, 100, 200):
            set_step(learner, step)
            ingested = 0
            while learner.drain(queue, max_items=1):
                ingested += 1
            trace.append((step, ingested, learner.env_steps,
                          learner.ingestion_paused, learner.ready))
        runs.append(trace)
    assert runs[0] == runs[1]
    assert any(paused for *_, paused, _ in runs[1])


def test_rate_limiter_survives_resume(tmp_path):
    """The limiter's budget counts from the resumed process's start: an
    empty ring after a resume with large counters accepts blocks."""
    _, cfg = configs(tmp_path, **{"replay.max_env_steps_per_train_step": 2.0})
    first = Learner(cfg, port_net(cfg))
    first.env_steps = 9_999
    ckpt = first.save(7)
    resumed = Learner(cfg.replace(**{"runtime.resume": ckpt}), port_net(cfg))
    assert resumed.env_steps == 9_999 and not resumed.ingestion_paused
    q = BlockQueue(use_mp=False)
    for blk in _fill_blocks(resumed.spec, 8, np.random.default_rng(0)):
        q.put(port_block(blk))
    ingested = 0
    while resumed.drain(q, max_items=1):
        ingested += 1
    assert ingested == 6 and resumed.ready and resumed.ingestion_paused


def test_put_patient_blocks_until_space_and_honors_stop():
    q = BlockQueue(maxsize=1, use_mp=False)
    assert q.put_patient("a", should_stop=lambda: False, poll=0.05)
    done, beats = [], []
    t = threading.Thread(target=lambda: done.append(q.put_patient(
        "b", should_stop=lambda: False, poll=0.05,
        beat=lambda: beats.append(1))))
    t.start()
    time.sleep(0.2)
    assert t.is_alive() and not done and len(beats) >= 2
    assert q.drain(max_items=1) == ["a"]
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert done == [True] and q.drain() == ["b"]
    q.put_patient("c", should_stop=lambda: False, poll=0.05)
    t0 = time.time()
    assert put_patient(q._q, "d", should_stop=lambda: True, poll=0.05) \
        is False
    assert time.time() - t0 < 1.0


def test_losses_flush_into_metrics_once(tmp_path):
    """Dispatch losses stay on the device until flush_metrics, which
    moves them to the metrics' counters once and clears them; ``losses``
    reads the flushed values."""
    _, cfg = configs(tmp_path)
    learner = Learner(cfg, port_net(cfg))
    for blk in _fill_blocks(learner.spec, 6, np.random.default_rng(1)):
        blk = port_block(blk)
        blk.action = blk.action % A
        blk.last_action_row = blk.last_action_row % A
        learner.ingest(blk)
    outs = [learner.step()["loss"] for _ in range(3)]
    assert len(learner._pending_losses) == 3
    assert learner.metrics.training_steps == 0
    learner.flush_metrics()
    assert learner._pending_losses == []
    assert learner.metrics.training_steps == 3
    assert learner.losses == [float(x) for x in outs]
    assert learner.metrics.training_steps == 3


def test_learner_run_trains_from_a_queue(tmp_path):
    """Learner.run writes the step-0 checkpoint, then drains and trains
    to max_steps and flushes; a stop request ends it before any step."""
    _, cfg = configs(tmp_path)
    learner = Learner(cfg, port_net(cfg))
    q = BlockQueue(use_mp=False)
    for blk in _fill_blocks(learner.spec, 6, np.random.default_rng(2)):
        q.put(port_block(blk))
    assert learner.run(q, lambda: False, max_steps=3) == 3
    assert [i for i, _ in list_checkpoints(str(tmp_path), "Fake", 0)] == [0]
    assert learner.metrics.training_steps == 3 and learner.env_steps == 120
    assert Learner(cfg, port_net(cfg)).run(q, lambda: True, max_steps=3) == 0


@pytest.mark.slow
def test_full_resume_continues_exactly(tmp_path):
    """Train 2N steps against N, checkpoint, resume into a differently
    seeded fresh state, N more: params, optimizer state and losses equal
    bit for bit (the external-batch step on one batch, as in the JAX
    package's test)."""
    from r2d2_tpu_torch.learner.train_step import make_external_batch_step
    from r2d2_tpu_torch.replay.device_replay import (replay_add,
                                                     replay_init,
                                                     replay_sample)
    from r2d2_tpu_torch.runtime.checkpoint import resume_training_state
    cfg = Config().replace(**TINY)
    net = port_net(cfg)
    learner = Learner(cfg, net)
    spec = learner.spec
    rs = replay_init(spec, "cpu")
    for blk in _fill_blocks(spec, 3, np.random.default_rng(0)):
        blk = port_block(blk)
        blk.action = blk.action % A
        blk.last_action_row = blk.last_action_row % A
        replay_add(spec, rs, blk)
    batch = replay_sample(spec, rs, uniform=torch.rand(
        spec.batch_size, generator=torch.Generator().manual_seed(7)))
    step = make_external_batch_step(net, spec, cfg.optim, False)
    n = 3
    ts = _train_state(cfg, seed=1)
    losses = []
    for _ in range(n):
        ts, m = step(ts, batch)
        losses.append(float(m["loss"]))
    path = save_checkpoint(str(tmp_path), "Fake", 1, 0, ts, env_steps=123)
    for _ in range(n):
        ts, m = step(ts, batch)
        losses.append(float(m["loss"]))
    ts2 = _train_state(cfg, seed=99)
    assert resume_training_state(path, ts2) == 123 and ts2.step == n
    resumed = []
    for _ in range(n):
        ts2, m = step(ts2, batch)
        resumed.append(float(m["loss"]))
    assert resumed == losses[n:] and ts.step == ts2.step == 2 * n
    for a, b in zip(ts.params.parameters(), ts2.params.parameters()):
        assert torch.equal(a, b)
    for sa, sb in zip(ts.opt.state.values(), ts2.opt.state.values()):
        for key in sa:
            assert torch.equal(torch.as_tensor(sa[key]),
                               torch.as_tensor(sb[key])), key


def _save_params(save_dir: str, game: str, module) -> str:
    from r2d2_tpu_torch.config import OptimConfig
    from r2d2_tpu_torch.learner.train_step import TrainState, make_optimizer
    ts = TrainState(params=module, target_params=module,
                    opt=make_optimizer(OptimConfig(), module), step=0,
                    generator=torch.Generator())
    return save_checkpoint(save_dir, game, 1, 0, ts, 0)


def test_pretrain_migrates_standard_checkpoint_to_space_to_depth(tmp_path):
    """The twin of the JAX package's tests/test_runtime.py
    test_pretrain_auto_migrates_space_to_depth: a standard-layout
    checkpoint (JAX's weights, converted) warm-starts a
    network.space_to_depth="on" network through an exact rewrite, whose
    Q equals JAX's standard network's (atol/rtol 1e-5, f32, 84x84x4); an
    s2d checkpoint into a standard network is refused naming
    space_to_depth=off; an unrelated shape is an architecture mismatch."""
    import jax
    import jax.numpy as jnp
    from r2d2_tpu.config import NetworkConfig as JNetworkConfig
    from r2d2_tpu.models import initial_hidden as j_initial_hidden
    from r2d2_tpu_torch.config import NetworkConfig
    from r2d2_tpu_torch.models.convert import params_from_flax

    jnet = JNetworkApply(4, JNetworkConfig(hidden_dim=16, cnn_out_dim=32),
                         4, 84, 84)
    jparams = jnet.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    obs = rng.uniform(0, 1, (2, 3, 84, 84, 4)).astype(np.float32)
    la = np.zeros((2, 3, 4), np.float32)
    q_jax, _ = jnet.apply(jparams, jnp.asarray(obs), jnp.asarray(la),
                          j_initial_hidden(2, 16))

    def net(s2d: str, hidden: int = 16) -> NetworkApply:
        return NetworkApply(4, NetworkConfig(hidden_dim=hidden,
                                             cnn_out_dim=32,
                                             space_to_depth=s2d),
                            4, 84, 84, "cpu")

    standard = net("off").build()
    standard.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    path = _save_params(str(tmp_path), "Fake", standard)
    s2d = net("on").init(3)
    assert s2d.torso.convs[0].weight.shape[1] == 16
    load_pretrain(path, s2d)
    with torch.no_grad():
        q, _ = s2d(torch.from_numpy(obs), torch.from_numpy(la),
                   torch.zeros(2, 2, 16))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_jax), rtol=1e-5,
                               atol=1e-5)

    path_s2d = _save_params(str(tmp_path), "FakeS2d", net("on").init(4))
    with pytest.raises(ValueError, match="space_to_depth=off"):
        load_pretrain(path_s2d, net("off").init(5))
    with pytest.raises(ValueError, match="architecture mismatch"):
        load_pretrain(path, net("off", hidden=32).init(6))
