"""The port's cross-plane tracing (r2d2_tpu_torch/telemetry/tracing.py and
its wiring) against the JAX package's on the CPU: ``ServeTrace`` and
``ExperienceTrace`` give JAX's blocks from the same stamps, the hop
arithmetic across the 2^31 wrap; a served request's trace crosses the
in-process and shm rungs into the ``serving`` block's ``trace`` sub-block;
tracing off leaves request pickles and the shm layouts what they were; a
traced actor stamps every block (every N-th with its emission time), the
stamp crosses the shm block ring, lands in the ring accountant's mirrors
at ingest (per block and through the stager) and rides the replay
snapshot as JAX's does. Inputs come from numpy seeds."""

import pickle
import threading

import numpy as np
import pytest

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.structs import (Block, ReplaySpec, RingAccountant,
                                           block_trace)
from r2d2_tpu_torch.telemetry import tracing

pytestmark = pytest.mark.torch_port

A = 6
SMALL = {"env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
         "network.hidden_dim": 16, "network.cnn_out_dim": 32,
         "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
         "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
         "sequence.forward_steps": 3, "replay.capacity": 800,
         "replay.block_length": 20, "replay.batch_size": 8,
         "replay.learning_starts": 100, "serve.max_batch": 4,
         "serve.deadline_ms": 2.0, "runtime.save_interval": 0}


@pytest.mark.parametrize("seed", [0, 1])
def test_serve_trace_block_matches_jax(seed):
    from r2d2_tpu.telemetry.tracing import ServeTrace as JTrace
    rng = np.random.default_rng(seed)
    ours, theirs = tracing.ServeTrace(), JTrace()
    for _ in range(3):
        for _ in range(int(rng.integers(5, 40))):
            t = 1e9 + float(rng.uniform(0, 100))
            trace = {"id": 1, "t_submit_wall": t}
            if rng.random() < 0.8:
                trace["t_send_wall"] = t + float(rng.uniform(0, 0.01))
            if rng.random() < 0.9:
                trace["t_recv_wall"] = t + float(rng.uniform(-0.001, 0.05))
            wait = float(rng.uniform(-0.001, 0.02))
            ours.on_request(dict(trace), wait)
            theirs.on_request(dict(trace), wait)
            if rng.random() < 0.3:
                f, r = rng.uniform(0, 0.01, 2)
                ours.on_batch(float(f), float(r))
                theirs.on_batch(float(f), float(r))
        assert ours.interval_block() == theirs.interval_block()
    assert ours.interval_block() is theirs.interval_block() is None


@pytest.mark.parametrize("seed", [0, 1])
def test_experience_trace_block_matches_jax(monkeypatch, seed):
    import r2d2_tpu.telemetry.tracing as jt
    rng = np.random.default_rng(seed)
    clock = iter(int(x) for x in rng.integers(0, 2 ** 31, 1000))
    stamps = []

    def fake_now():
        stamps.append(next(clock))
        return stamps[-1]

    ours, theirs = tracing.ExperienceTrace(4), jt.ExperienceTrace(4)
    for _ in range(4):
        for _ in range(int(rng.integers(1, 6))):
            pairs = [(int(e) if rng.random() < 0.8 else -1,
                      int(i) if rng.random() < 0.9 else -1)
                     for e, i in rng.integers(0, 2 ** 31, (6, 2))]
            now = fake_now()
            monkeypatch.setattr(tracing, "now_ms", lambda: now)
            monkeypatch.setattr(jt, "now_ms", lambda: now)
            a, b = ours.on_sample(pairs), theirs.on_sample(pairs)
            assert a == b
            now = fake_now()
            ours.on_train(a)
            theirs.on_train(b)
        assert ours.interval_block() == theirs.interval_block()
    assert ours.on_sample([]) is None and ours.interval_block() is None


def test_hops_now_and_headers_match_jax():
    import r2d2_tpu.telemetry.tracing as jt
    rng = np.random.default_rng(3)
    for a, b in rng.integers(-5, 2 ** 31, (200, 2)):
        assert tracing.hop_ms(int(a), int(b)) == jt.hop_ms(int(a), int(b))
    assert tracing.hop_ms(2 ** 31 - 10, 5) == 15.0     # across the wrap
    assert (tracing.UNTRACED, tracing.SERVE_HOPS, tracing.EXPERIENCE_HOPS) \
        == (jt.UNTRACED, jt.SERVE_HOPS, jt.EXPERIENCE_HOPS)
    assert 0 <= tracing.now_ms() < 2 ** 31
    assert set(tracing.new_request_trace(7)) == set(jt.new_request_trace(7))
    assert (tracing.proc_header("serve", lease=3).keys()
            == jt.proc_header("serve", lease=3).keys())
    assert tracing.tracing_on(Config()) is False
    assert tracing.tracing_on(Config().replace(**{
        "telemetry.tracing_enabled": True}))
    assert not tracing.tracing_on(Config().replace(**{
        "telemetry.tracing_enabled": True, "telemetry.enabled": False}))


# -- served requests ---------------------------------------------------------------


@pytest.mark.parametrize("rung", ["inproc", "shm"])
def test_served_request_trace_crosses_the_rung(rung):
    """A RemotePolicy tracing every exchange over the rung: the server's
    ServeTrace sees every hop, and the serving block carries them."""
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.serve import (InprocEndpoint, PolicyServer,
                                      RemotePolicy, ServingStats,
                                      ShmServeChannel, ShmServeTransport)
    cfg = Config().replace(**SMALL)
    net = NetworkApply(A, cfg.network, 2, 24, 24, "cpu")
    stats = ServingStats()
    stats.trace = tracing.ServeTrace()
    ep = InprocEndpoint()
    srv = PolicyServer(cfg, net, net.init(0), endpoint=ep,
                       stats=stats).start()
    transport = None
    try:
        if rung == "inproc":
            channel = ep.connect()
        else:
            transport = ShmServeTransport(ep.submit, (24, 24), A, 16,
                                          request_slots=16, tracing=True)
            channel = ShmServeChannel(transport.request_ring, A, 16)
        remote = RemotePolicy(channel, A, 0.0, seed=0, client_id=1,
                              trace_every=1)
        remote.observe_reset(np.zeros((24, 24), np.uint8))
        for _ in range(5):
            remote.step()
        remote.close()
    finally:
        srv.stop()
        if transport is not None:
            transport.close()
    block = stats.interval_block()
    trace = block["trace"]
    assert trace["requests"] >= 5
    assert set(trace["hops"]) == set(tracing.SERVE_HOPS)
    assert all(h["count"] >= 5 for h in trace["hops"].values())


def test_untraced_requests_and_layouts_are_unchanged():
    """Tracing off: a request pickles without a trace, the shm request
    layout has no stamp fields, an untraced client's request has none,
    and the serving block has no trace sub-block."""
    from r2d2_tpu_torch.runtime.shm_feeder import block_layout
    from r2d2_tpu_torch.serve import ServingStats
    from r2d2_tpu_torch.serve.client import RemotePolicy
    from r2d2_tpu_torch.serve.transport import Request, request_layout
    req = Request(client_id=1, req_id=2)
    assert "trace" not in pickle.loads(pickle.dumps(req)).__dict__
    assert request_layout(24, 24, tracing=True)[:-2] \
        == request_layout(24, 24)
    assert [n for n, _, _ in request_layout(24, 24, tracing=True)[-2:]] \
        == ["t_submit_wall", "t_send_wall"]
    spec = ReplaySpec.from_config(Config().replace(**SMALL), "cpu")
    assert block_layout(spec, tracing=True)[:-1] == block_layout(spec)
    stats = ServingStats()
    stats.on_requests(1)
    assert "trace" not in stats.interval_block()
    sent = []

    class Channel:
        def request_many(self, reqs, timeout):
            sent.extend(reqs)
            from r2d2_tpu_torch.serve.transport import Reply
            return {r.req_id: Reply(r.req_id, 0, 0, np.zeros(A, np.float32),
                                    np.zeros((2, 16), np.float32))
                    for r in reqs}

    RemotePolicy(Channel(), A, 0.0).step()
    assert sent and not hasattr(sent[0], "trace")


# -- block lineage --------------------------------------------------------------


def _blocks(n: int, seed: int = 0):
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    spec = ReplaySpec.from_config(Config().replace(**SMALL), "cpu")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        blk = make_synthetic_block(spec, rng)
        out.append(Block(**{**blk.__dict__,
                            "action": blk.action % A,
                            "last_action_row": blk.last_action_row % A}))
    return spec, out


def test_traced_actor_stamps_every_block_and_every_nth_emission():
    from r2d2_tpu_torch.runtime.actor_loop import instrument_block_sink
    _, blocks = _blocks(7)
    got = []
    sink = instrument_block_sink(got.append, 0, trace_every=3,
                                 weight_version=lambda: 5, lane_base=2)
    for b in blocks:
        sink(b)
    stamps = [int(block_trace(b)) for b in got]
    assert [s >= 0 for s in stamps] == [i % 3 == 2 for i in range(7)]
    assert all(s == tracing.UNTRACED for i, s in enumerate(stamps)
               if i % 3 != 2)
    assert all(int(b.weight_version) == 5 for b in got)
    plain = []
    instrument_block_sink(plain.append, 0)(blocks[0])
    assert block_trace(plain[0]) is None


def test_stamp_crosses_the_shm_block_ring():
    from r2d2_tpu_torch.replay.structs import with_trace
    from r2d2_tpu_torch.runtime.shm_feeder import ShmBlockRing
    spec, blocks = _blocks(4)
    ring = ShmBlockRing(spec, maxsize=8, tracing=True)
    try:
        ring.put(with_trace(blocks[0], np.int32(123)), timeout=1.0)
        ring.put(blocks[1], timeout=1.0)      # unstamped: -1
        assert int(block_trace(ring.get_nowait())) == 123
        assert int(block_trace(ring.get_nowait())) == -1
        for i, b in enumerate(blocks):
            ring.put(with_trace(b, np.int32(i)), timeout=1.0)
        stacked, k = ring.drain_stacked(4)
        assert k == 4 and list(block_trace(stacked)) == [0, 1, 2, 3]
        clone = pickle.loads(pickle.dumps(ring))
        assert clone.tracing and clone.slot_bytes == ring.slot_bytes
    finally:
        ring.close()


@pytest.mark.parametrize("k", [1, 4], ids=["per_block", "stager"])
def test_learner_mirrors_the_stamps_like_jax(k):
    """Traced blocks into a Learner: the ring accountant's slot_trace holds
    each block's stamp and slot_ingest_ms a commit time (-1 untraced);
    JAX's RingAccountant given the same stamps holds the same slot_trace,
    and the snapshot's ring part equals JAX's."""
    from r2d2_tpu.replay.snapshot import _capture_ring as j_capture
    from r2d2_tpu.replay.structs import RingAccountant as JRing
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.snapshot import _capture_ring, _restore_ring
    from r2d2_tpu_torch.replay.structs import with_trace
    from r2d2_tpu_torch.runtime.feeder import BlockQueue
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    cfg = Config().replace(**{**SMALL, "telemetry.tracing_enabled": True,
                              "replay.ingest_batch_blocks": k,
                              "replay.max_env_steps_per_train_step": 0})
    spec, blocks = _blocks(10, seed=2)
    net = NetworkApply(A, cfg.network, 2, 24, 24, "cpu")
    learner = Learner(cfg, net)
    queue = BlockQueue(use_mp=False)
    stamps = [1000 + i if i % 2 else -1 for i in range(len(blocks))]
    for b, s in zip(blocks, stamps):
        queue.put(with_trace(b, np.int32(s)))
    try:
        deadline = threading.Event()
        for _ in range(200):
            learner.drain(queue)
            if learner.ring.total_adds == len(blocks):
                break
            deadline.wait(0.02)
    finally:
        learner.stop_background()
    ring = learner.ring
    assert ring.total_adds == len(blocks)
    assert ring.slot_trace[:len(blocks)] == stamps
    assert all((i >= 0) == (s >= 0)
               for i, s in zip(ring.slot_ingest_ms, stamps))
    jring = JRing(ring.num_blocks)
    for b, s, ing in zip(blocks, stamps, ring.slot_ingest_ms):
        jring.advance(int(b.learning_steps.sum()), int(b.weight_version),
                      trace_ms=s, ingest_ms=ing)
    assert _capture_ring(ring) == j_capture(jring)
    fresh = RingAccountant(ring.num_blocks)
    _restore_ring(fresh, _capture_ring(ring))
    assert (fresh.slot_trace, fresh.slot_ingest_ms) == (ring.slot_trace,
                                                        ring.slot_ingest_ms)
    untraced = RingAccountant(4)
    assert "slot_trace" not in _capture_ring(untraced)
