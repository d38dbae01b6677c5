"""The port's serving plane against the JAX package's on the CPU: the
micro-batcher's fill and deadline rules, the dispatch buckets, the
serving record block and the state cache against JAX's for the same
events, the port's PolicyServer against JAX's PolicyServer on one request
stream (f32, warm-up on at max_batch=4; actions equal, Q and h' within
atol 1e-5), served == local bit for bit (the one forward), idempotent
replays, expiry, weight sync, admission control, the in-proc, socket and
shm rungs, ``cli.serve --device=cpu`` as a process, served training
(thread and process/shm actors), ``cli.evaluate --serve`` and the
periodic record without serving."""

import json
import os
import queue
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import Config as JConfig
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.serve import InprocEndpoint as JInprocEndpoint
from r2d2_tpu.serve import PolicyServer as JPolicyServer
from r2d2_tpu.serve import RemoteBatchedPolicy as JRemoteBatchedPolicy
from r2d2_tpu.serve import Request as JRequest
from r2d2_tpu.serve import ServingStats as JServingStats
from r2d2_tpu.serve import StateCache as JStateCache
from r2d2_tpu.serve import collect_batch as j_collect_batch
from r2d2_tpu.serve import serve_buckets as j_serve_buckets
from r2d2_tpu_torch.actor.policy import ActorPolicy, BatchedActorPolicy
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.envs.factory import create_env
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.runtime.actor_loop import make_actor_policy
from r2d2_tpu_torch.runtime.metrics import TrainMetrics
from r2d2_tpu_torch.runtime.weights import InProcWeightStore
from r2d2_tpu_torch.serve import (KIND_STEP, STATUS_EXPIRED, InprocEndpoint,
                                  PolicyServer, RemoteBatchedPolicy,
                                  RemotePolicy, Request,
                                  ServingStats, ShmServeChannel,
                                  ShmServeTransport, SocketChannel,
                                  SocketServerTransport, StateCache,
                                  collect_batch, serve_buckets)

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
A = 4
SMALL = {"env.game_name": "Fake", "env.frame_height": 24,
         "env.frame_width": 24, "env.frame_stack": 2,
         "network.hidden_dim": 16, "network.cnn_out_dim": 32,
         "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
         "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
         "sequence.forward_steps": 3, "replay.capacity": 800,
         "replay.block_length": 20, "replay.batch_size": 8,
         "replay.learning_starts": 100, "serve.max_batch": 4,
         "serve.deadline_ms": 2.0, "runtime.save_interval": 0}
TINY_ARGS = ["--env.frame_height=24", "--env.frame_width=24",
             "--env.frame_stack=2", "--network.hidden_dim=16",
             "--network.cnn_out_dim=32",
             "--network.conv_layers=8,4,2;16,3,1"]


def cfgs(**over):
    return (JConfig().replace(**SMALL, **over),
            Config().replace(**SMALL, **over))


def port_server(cfg=None, seed: int = 0, **kw):
    cfg = cfg or Config().replace(**SMALL)
    net = NetworkApply(A, cfg.network, 2, 24, 24, "cpu")
    module = net.init(seed)
    ep = InprocEndpoint()
    srv = PolicyServer(cfg, net, module, endpoint=ep, **kw).start()
    return cfg, net, module, ep, srv


def frame(rng):
    return rng.integers(0, 255, (24, 24), np.uint8)


def ask(ep, req):
    got, event = [], threading.Event()
    ep.submit(req, lambda r: (got.append(r), event.set()))
    assert event.wait(10.0)
    return got[0]


# ---------------------------------------------------------------------------
# the micro-batcher, the buckets, the record block, the cache vs JAX


def _pending(cls, age: float = 0.0):
    req = cls(client_id=0, req_id=0)
    req.t_recv = time.monotonic() - age
    return (req, lambda reply: None)


@pytest.mark.parametrize("case", [
    dict(queued=5, max_batch=4, deadline=10.0, expected=None, age=0.0),
    dict(queued=0, max_batch=8, deadline=0.03, expected=None, age=0.0),
    dict(queued=3, max_batch=8, deadline=10.0, expected=2, age=0.0),
    dict(queued=4, max_batch=8, deadline=0.01, expected=None, age=5.0)])
def test_collect_batch_matches_jax(case):
    """Fill, deadline, early dispatch at the expected clients, and a
    backlog drained past the deadline: the same batch and left-over as
    JAX's collect_batch for the same queue."""
    sizes = []
    for fn, cls in ((collect_batch, Request), (j_collect_batch, JRequest)):
        inbox = queue.Queue()
        for _ in range(case["queued"]):
            inbox.put(_pending(cls))
        batch = fn(inbox, _pending(cls, case["age"]), case["max_batch"],
                   case["deadline"], expected=case["expected"])
        sizes.append((len(batch), inbox.qsize()))
    assert sizes[0] == sizes[1]


def test_serve_buckets_match_jax():
    for max_batch in (1, 2, 3, 4, 5, 32, 48, 64):
        assert serve_buckets(max_batch) == j_serve_buckets(max_batch)


@pytest.mark.parametrize("admission", [False, True])
def test_serving_stats_block_matches_jax(admission):
    """The same events give JAX's serving block (and admission
    sub-block); the interval is consumed, cumulative counters stay."""
    ours, theirs = ServingStats(), JServingStats()
    for st in (ours, theirs):
        st.admission_enabled = admission
        assert st.interval_block() is None
        for s in (1e-4, 2e-3, 2e-3, 0.05):
            st.on_request_latency(s)
        st.on_timeout(5.0)
        st.on_batch(3, False, True, False)
        st.on_batch(4, True, False, False)
        st.on_batch(1, False, False, True)
        st.on_requests(9)
        st.on_replies(8)
        st.on_expired(1)
        st.on_shed(2)
        st.on_admitted_latency(3e-3)
        st.on_clients(connects=3, reconnects=1, disconnects=1, evictions=2)
        st.active_clients = 3
    assert ours.interval_block(5.0, 4) == theirs.interval_block(5.0, 4)
    ours.on_requests(1)
    theirs.on_requests(1)
    assert ours.interval_block() == theirs.interval_block()


def test_state_cache_matches_jax(rng):
    """Leases, reconnects, evictions (a full shard, the sweep), observe,
    reset, recorded and replayed ops: the same arrays and counters as
    JAX's StateCache after the same operations."""
    caches = [cls(slots=4, shards=2, frame_hw=(24, 24), frame_stack=2,
                  hidden_dim=16, lease_timeout_s=5.0, action_dim=A)
              for cls in (StateCache, JStateCache)]
    frames = [frame(rng) for _ in range(8)]
    hid = rng.normal(size=(2, 16)).astype(np.float32)
    q = rng.normal(size=A).astype(np.float32)
    results = []
    for c in caches:
        got = [c.lease(cid, now=float(t)) for t, cid in
               enumerate((0, 1, 2, 3))]
        slot0 = got[0][0]
        c.reset_slot(slot0, frames[0])
        c.observe(slot0, frames[1], 2)
        c.observe(got[2][0], frames[2], 1)
        c.write_hidden(slot0, hid)
        c.record_op(slot0, 4, 3, q)
        got.append(c.release(1, now=5.0))
        got.append(c.lease(5, now=6.0))             # a full shard evicts
        got.append(c.release(0, now=7.0))
        got.append(c.lease(0, now=8.0))             # reconnects
        got.append(c.release(2, now=8.0))
        got.append(c.sweep(now=200.0))
        got.append(c.lease(7, now=201.0))
        results.append(got)
    assert results[0] == results[1]
    assert results[0][5] == (results[0][1][0], True)
    ours, theirs = caches
    for name in ("hidden", "stacked", "last_action", "op_seq",
                 "reply_action", "reply_q", "_slot_client", "_last_seen",
                 "_connected"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name), err_msg=name)
    assert (ours.connects, ours.reconnects, ours.evictions) == \
        (theirs.connects, theirs.reconnects, theirs.evictions)
    assert ours.evictions > 0 and ours.reconnects == 1
    assert ours.cached_reply(0)[0] == theirs.cached_reply(0)[0]


# ---------------------------------------------------------------------------
# the server


def test_policy_server_matches_jax_server(rng):
    """The port's PolicyServer (CPU, f32, warm-up on, max_batch=4) and
    JAX's on the same weights and one stream of 4-lane requests: actions
    equal where the greedy choice is clear, Q and h' within 1e-5; both
    dispatch full buckets."""
    jcfg, cfg = cfgs()
    jnet = JNetworkApply(A, jcfg.network, 2, 24, 24)
    jparams = jnet.init(jax.random.PRNGKey(0))
    net = NetworkApply(A, cfg.network, 2, 24, 24, "cpu")
    module = net.build()
    module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    jep, ep = JInprocEndpoint(), InprocEndpoint()
    jsrv = JPolicyServer(jcfg, jnet, jparams, endpoint=jep,
                         warmup=True).start()
    srv = PolicyServer(cfg, net, module, endpoint=ep, warmup=True).start()
    try:
        eps, seeds = [0.0] * 4, [1, 2, 3, 4]
        jpol = JRemoteBatchedPolicy(jep.connect(), A, eps, seeds)
        pol = RemoteBatchedPolicy(ep.connect(), A, eps, seeds)
        for i in range(4):
            f = frame(rng)
            jpol.observe_reset_lane(i, f)
            pol.observe_reset_lane(i, f)
        for _ in range(12):
            ja, jq, jh = jpol.act()
            ta, tq, th = pol.act()
            np.testing.assert_allclose(tq, jq, atol=1e-5)
            np.testing.assert_allclose(th, jh, atol=1e-5)
            top2 = np.sort(jq, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 1e-5
            np.testing.assert_array_equal(ta[clear], ja[clear])
            nxt = np.stack([frame(rng) for _ in range(4)])
            jpol.observe(nxt, ja)
            pol.observe(nxt, ja)
        ours = srv.stats.interval_block()
        theirs = jsrv.stats.interval_block()
        assert ours["batch"]["fill_mean"] == theirs["batch"]["fill_mean"] \
            == 4.0
        assert ours["replies"] == theirs["replies"] == 48
    finally:
        jsrv.stop()
        srv.stop()


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("lanes", [1, 4])
def test_served_equals_local_bit_for_bit(rng, mode, lanes):
    """At equal seeds and epsilons the served actions, Q and hidden are the
    local policy's bit for bit (the one forward on the same state math),
    bootstrap too; at int8 the server probes on its own ticks."""
    cfg = Config().replace(**SMALL, **{
        "network.inference_dtype": mode,
        "telemetry.quant_probe_interval": 3})
    from r2d2_tpu_torch.telemetry import QuantStats
    stats = QuantStats(mode, 3)
    _, net, module, ep, srv = port_server(cfg, quant_stats=stats)
    try:
        if lanes == 1:
            local = ActorPolicy(net, module, 0.4, seed=7)
            remote = RemotePolicy(ep.connect(), A, 0.4, seed=7)
            f = frame(rng)
            local.observe_reset(f)
            remote.observe_reset(f)
        else:
            eps, seeds = [0.4, 0.2, 0.1, 0.05], [3, 4, 5, 6]
            local = BatchedActorPolicy(net, module, eps, seeds)
            remote = RemoteBatchedPolicy(ep.connect(), A, eps, seeds)
            for i in range(lanes):
                f = frame(rng)
                local.observe_reset_lane(i, f)
                remote.observe_reset_lane(i, f)
        for t in range(12):
            a1, q1, h1 = local.act()
            a2, q2, h2 = remote.act()
            np.testing.assert_array_equal(a1, a2)
            np.testing.assert_array_equal(q1, q2)
            np.testing.assert_array_equal(h1, h2)
            if t == 5:
                np.testing.assert_array_equal(local.bootstrap_q(),
                                              remote.bootstrap_q())
            nxt = (frame(rng) if lanes == 1 else
                   np.stack([frame(rng) for _ in range(lanes)]))
            local.observe(nxt, a1)
            remote.observe(nxt, a2)
        assert remote.weight_version == 0           # no weight service
    finally:
        srv.stop()
    if mode == "int8":
        assert stats.interval_block()["probes"] >= 4


def test_run_actor_block_stream_served_equals_local():
    """run_actor with a local policy and with a served one on identically
    seeded envs emits identical blocks."""
    cfg = Config().replace(**SMALL)
    cfg_srv = cfg.replace(**{"actor.inference": "server"})
    _, net, module, ep, srv = port_server(cfg_srv)
    blocks = {"local": [], "server": []}
    try:
        for mode, c in (("local", cfg), ("server", cfg_srv)):
            env = create_env(c.env, seed=11)
            policy, run_loop = make_actor_policy(
                c, net, module, 0, seed=5, epsilon=0.3,
                serve_channel=ep.connect() if mode == "server" else None)
            run_loop(c, env, policy, blocks[mode].append, lambda: None,
                     lambda: False, max_env_steps=50)
    finally:
        srv.stop()
    assert len(blocks["local"]) == len(blocks["server"]) > 0
    for lb, sb in zip(blocks["local"], blocks["server"]):
        for field in ("obs_row", "last_action_row", "hidden", "action",
                      "reward", "gamma", "priority", "learning_steps"):
            np.testing.assert_array_equal(np.asarray(getattr(lb, field)),
                                          np.asarray(getattr(sb, field)),
                                          err_msg=field)
    with pytest.raises(ValueError, match="serve_channel"):
        make_actor_policy(cfg_srv, net, module, 0, seed=5)


def test_duplicate_op_replays_and_expiry(rng):
    """A retried copy of an applied op replays the cached reply without
    advancing the state; the next op advances; an older copy and a
    request older than the TTL are expired unapplied."""
    cfg = Config().replace(**SMALL, **{"serve.request_ttl_s": 0.5})
    _, _, _, ep, srv = port_server(cfg)
    try:
        obs = frame(rng)
        r1 = ask(ep, Request(client_id=5, req_id=100, kind=KIND_STEP,
                             op_seq=1, reset_obs=obs))
        r2 = ask(ep, Request(client_id=5, req_id=101, kind=KIND_STEP,
                             op_seq=1, reset_obs=obs))
        assert r2.action == r1.action
        np.testing.assert_array_equal(r2.q, r1.q)
        np.testing.assert_array_equal(r2.hidden, r1.hidden)
        r3 = ask(ep, Request(client_id=5, req_id=102, kind=KIND_STEP,
                             op_seq=2, obs=frame(rng), action=r1.action))
        assert not np.array_equal(r3.hidden, r1.hidden)
        r4 = ask(ep, Request(client_id=5, req_id=103, kind=KIND_STEP,
                             op_seq=1, reset_obs=obs))
        assert r4.status == STATUS_EXPIRED
        old = Request(client_id=9, req_id=1)
        got, event = [], threading.Event()
        old.t_recv = time.monotonic() - 10.0
        ep.inbox.put((old, lambda r: (got.append(r), event.set())))
        assert event.wait(5.0) and got[0].status == STATUS_EXPIRED
        assert srv.cache.leased_slots == 1          # client 9 untouched
    finally:
        srv.stop()


def test_weight_sync_and_version_stamp(rng):
    """The server polls the store, adopts a publication (in place) and
    stamps replies with it; int8 adopts the bundle payload and its
    stamp."""
    for mode in ("f32", "int8"):
        cfg = Config().replace(**SMALL, **{
            "serve.weight_poll_interval_s": 0.01,
            "network.inference_dtype": mode})
        net = NetworkApply(A, cfg.network, 2, 24, 24, "cpu")
        module = net.init(0)
        from r2d2_tpu_torch.runtime.weights import (make_publish_preparer,
                                                    wrap_publish)
        prepare = make_publish_preparer(net)
        store = InProcWeightStore(module if prepare is None
                                  else prepare(module, 1))
        from r2d2_tpu_torch.telemetry import QuantStats
        qs = QuantStats(mode)
        ep = InprocEndpoint()
        srv = PolicyServer(cfg, net, module, endpoint=ep,
                           weight_poll=lambda: store.poll("serve"),
                           weight_version=lambda: store.reader_version(
                               "serve"), quant_stats=qs).start()
        try:
            remote = RemotePolicy(ep.connect(), A, 0.0, seed=0)
            remote.observe_reset(frame(rng))
            q_before = remote.bootstrap_q()
            with torch.no_grad():
                for p in module.parameters():
                    p.mul_(2.0)
            wrap_publish(store.publish, prepare,
                         lambda: store.publish_count)(module)
            deadline = time.monotonic() + 10.0
            while remote.weight_version < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
                remote.bootstrap_q()
            assert remote.weight_version == 2
            assert not np.array_equal(q_before, remote.bootstrap_q())
            if mode == "int8":
                assert qs.publish_stamp == 2
        finally:
            srv.stop()


def test_admission_sheds_and_clients_retry(rng):
    """8 lanes against a batch of 2 and a queue bound of 1: the overflow is
    shed with STATUS_RETRY, the client absorbs it, and the serving block
    accounts for it."""
    cfg = Config().replace(**{
        **SMALL, "serve.max_batch": 2, "serve.queue_depth_bound": 1,
        "serve.deadline_ms": 1.0, "serve.state_shards": 8})
    _, _, _, ep, srv = port_server(cfg)
    try:
        pol = RemoteBatchedPolicy(ep.connect(), A, [0.0] * 8,
                                  list(range(8)), backoff_base_s=0.01,
                                  backoff_max_s=0.05)
        for i in range(8):
            pol.observe_reset_lane(i, frame(rng))
        for _ in range(4):
            a, _, _ = pol.act()
            pol.observe(np.stack([frame(rng) for _ in range(8)]), a)
        assert pol.shed_retries > 0
        adm = srv.stats.interval_block()["admission"]
        assert adm["shed"] > 0 and adm["shed_frac"] > 0
    finally:
        srv.stop()


@pytest.mark.parametrize("rung", ["inproc", "socket", "shm"])
def test_transport_round_trips(rng, rung):
    """Each rung carries requests and replies: two steps advance the
    hidden, a bootstrap does not, a disconnect releases the lease."""
    cfg, net, _, ep, srv = port_server()
    transport = channel = None
    try:
        if rung == "inproc":
            channel = ep.connect()
        elif rung == "socket":
            transport = SocketServerTransport(ep.submit, "127.0.0.1", 0)
            channel = SocketChannel(transport.host, transport.port,
                                    connect_retries=3, eager_connect=True)
        else:
            transport = ShmServeTransport(ep.submit, (24, 24), A, 16,
                                          request_slots=16)
            channel = ShmServeChannel(transport.request_ring, A, 16)
        remote = RemotePolicy(channel, A, 0.0, seed=0, client_id=3)
        remote.observe_reset(frame(rng))
        q0 = remote.bootstrap_q()
        _, q1, h1 = remote.step()
        _, q2, h2 = remote.step()
        np.testing.assert_array_equal(q0, q1)
        assert q1.shape == (A,) and h1.shape == (2, 16)
        assert not np.array_equal(h1, h2)
        remote.close()
        deadline = time.monotonic() + 5.0
        while srv.cache.active_clients and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.cache.active_clients == 0
        assert srv.cache.leased_slots == 1          # state kept
    finally:
        srv.stop()
        if transport is not None:
            transport.close()


# ---------------------------------------------------------------------------
# the entry points


def test_cli_serve_cpu_subprocess(tmp_path, rng):
    """``python -m r2d2_tpu_torch.cli.serve --device=cpu``: prints its
    address, answers a RemotePolicy over TCP, writes records with the
    serving block (and quant at int8), exits 0 at --seconds."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "r2d2_tpu_torch.cli.serve", "--device=cpu",
         "--seconds=8", "--save-dir", str(tmp_path),
         "--runtime.log_interval=1", "--network.inference_dtype=int8",
         *TINY_ARGS],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.match(r"serving on ([\d.]+):(\d+) \(action_dim=(\d+)\)", line)
        assert m, line + proc.stderr.read()
        policy = RemoteBatchedPolicy(
            SocketChannel(m.group(1), int(m.group(2)), connect_retries=5),
            int(m.group(3)), [0.1, 0.1], [1, 2])
        for i in range(2):
            policy.observe_reset_lane(i, frame(rng))
        for _ in range(10):
            actions, q, h = policy.act()
            policy.observe(np.stack([frame(rng), frame(rng)]), actions)
        assert q.shape == (2, int(m.group(3))) and h.shape == (2, 2, 16)
        policy.close()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "served" in out
    records = [json.loads(x) for x in
               (tmp_path / "serve_metrics.jsonl").read_text().splitlines()]
    assert any(r.get("serving", {}).get("replies", 0) > 0 for r in records)
    assert all(r["quant"]["dtype"] == "int8" for r in records)
    final = records[-1]
    assert final["final"] and final["device"] == "cpu"
    assert final["forward_ms_by_bucket"]["2"] is not None


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_served_training(tmp_path, mode):
    """cli.train --device=cpu --actor.inference=server at the tiny shape:
    trains, every action served (thread: in-proc channels; process: the
    shm rings, children exit 0), the record has the serving block (and
    quant at int8), the server adopted publications."""
    from r2d2_tpu_torch.cli import train as train_cli
    args = ["--device=cpu", f"--actor-mode={mode}", "--max-steps=12",
            "--env.game_name=Fake", "--actor.inference=server",
            "--serve.weight_poll_interval_s=0.1",
            "--runtime.log_interval=0.5", "--runtime.save_interval=0",
            f"--runtime.save_dir={tmp_path}", "--sequence.burn_in_steps=4",
            "--sequence.learning_steps=5", "--sequence.forward_steps=3",
            "--replay.capacity=800", "--replay.block_length=20",
            "--replay.batch_size=8", "--replay.learning_starts=100",
            "--runtime.steps_per_dispatch=1", *TINY_ARGS]
    if mode == "process":
        args.append("--network.inference_dtype=int8")
    summary = train_cli.main(args)
    assert summary["steps"] == 12
    assert np.isfinite(summary["final_loss"])
    served = summary["served"]
    assert served["rows"] >= summary["env_steps"] > 0
    if mode == "process":
        assert summary["actor_exitcodes"] == [0, 0]
        assert not [n for n in summary["shm_segments"]
                    if os.path.exists(os.path.join("/dev/shm", n))]
    records = [json.loads(x) for x in
               (tmp_path / "metrics_player0.jsonl").read_text().splitlines()]
    assert any("serving" in r for r in records)
    if mode == "process":
        assert all(r["quant"]["dtype"] == "int8" for r in records)


def test_evaluate_serve(tmp_path):
    """cli.evaluate --serve --serve-clients 2 (server on the CPU) gives the
    local evaluation's returns at epsilon 0 on the same envs."""
    from r2d2_tpu_torch.cli.evaluate import evaluate_checkpoint
    from r2d2_tpu_torch.learner.train_step import create_train_state
    from r2d2_tpu_torch.runtime.checkpoint import save_checkpoint
    cfg = Config().replace(**SMALL, **{"runtime.test_epsilon": 0.0,
                                       "runtime.save_dir": str(tmp_path),
                                       "env.episode_len": 40})
    net = NetworkApply(6, cfg.network, 2, 24, 24, "cpu")
    ts = create_train_state(net, cfg.optim, 3, False)
    path = save_checkpoint(str(tmp_path), "Fake", 0, 0, ts, 0,
                           config_json=cfg.to_json())
    local = evaluate_checkpoint(cfg, path, 2, seed=0)
    served = evaluate_checkpoint(cfg, path, 2, seed=0, serve_clients=1,
                                 device="cpu")
    assert served == local
    from r2d2_tpu_torch.cli import evaluate as eval_cli
    result = eval_cli.main(["--play", path, "--rounds", "3", "--serve",
                            "--serve-clients", "2", "--device=cpu",
                            *TINY_ARGS])
    assert result["evaluations"][0]["rounds"] == 3


def test_record_unchanged_without_serving(tmp_path):
    """With no serving or quant provider the periodic record's keys are
    what they were; a provider with no traffic leaves its block out."""
    plain = TrainMetrics(0, str(tmp_path / "a")).log(1.0)
    m = TrainMetrics(0, str(tmp_path / "b"))
    m.set_serving(lambda: None)
    assert m.log(1.0).keys() == plain.keys()
    m.set_serving(lambda: {"requests": 1})
    m.set_quant(lambda: {"dtype": "int8"})
    rec = m.log(1.0)
    assert rec.keys() - plain.keys() == {"serving", "quant"}
