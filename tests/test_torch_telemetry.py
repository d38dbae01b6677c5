"""The port's runtime telemetry (r2d2_tpu_torch/telemetry/core.py,
spans.py, board.py, profiler.py; tools/profile_step.py, cli/profile.py)
against the JAX package's on the CPU: the stage timers' summaries and
intervals, the span ring's drop and prune, the Chrome-trace events, the
shared-memory board through a spawned process, the drain thread, the null
telemetry, the config fields and their refusals, the env knobs
(``env.frame_skip``, ``env.clip_rewards``), the records of a thread-actor
``cli.train`` run (``stages`` keys and fields, the first record's
``costs``, neither with telemetry off), and the profiler's triggers
(``runtime.profile_at_step``, SIGUSR2, a refused start) and
``cli.profile``. Inputs come from numpy seeds; the JAX package is imported
inside the tests, so the port's child processes never load it."""

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.telemetry.board import TelemetryBoard
from r2d2_tpu_torch.telemetry.core import (NULL_TELEMETRY, STAGE_INDEX,
                                           STAGES, StageTimers, Telemetry,
                                           summarize_matrix)
from r2d2_tpu_torch.telemetry.spans import SpanTracer, chrome_trace_events

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent
TINY = {
    "env.game_name": "Fake",
    "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
    "network.hidden_dim": 16, "network.cnn_out_dim": 32,
    "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
    "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
    "sequence.forward_steps": 3,
    "replay.capacity": 800, "replay.block_length": 20,
    "replay.batch_size": 8, "replay.learning_starts": 100,
    "actor.num_actors": 2, "actor.actor_update_interval": 50,
    "optim.lr": 1e-3, "runtime.save_interval": 0,
    "runtime.log_interval": 0.2, "runtime.weight_publish_interval": 5,
    "runtime.steps_per_dispatch": 1}


def _observations(seed: int, n: int = 400):
    """(stage, seconds) pairs: stages uniform, durations log-uniform over
    0.1 us .. 200 s (past both ends of the buckets)."""
    rng = np.random.default_rng(seed)
    names = rng.integers(0, len(STAGES), n)
    seconds = 10.0 ** rng.uniform(-7, 2.3, n)
    return [(STAGES[int(i)], float(s)) for i, s in zip(names, seconds)]


# -- the stage timers ----------------------------------------------------------


def test_stages_and_their_order_are_jaxs():
    from r2d2_tpu.telemetry import core as jcore
    assert STAGES == jcore.STAGES and STAGE_INDEX == jcore.STAGE_INDEX
    assert len(STAGES) == 21


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_timers_summaries_and_take_match_jax(seed):
    """The same observations into both packages' timers: equal cumulative
    matrices, equal interval takes (the second take only the second
    batch), equal summaries."""
    from r2d2_tpu.telemetry import core as jcore
    ours, theirs = StageTimers(), jcore.StageTimers()
    obs = _observations(seed)
    for timers in (ours, theirs):
        for stage, s in obs[:250]:
            timers.observe(stage, s)
    first = ours.take()
    np.testing.assert_array_equal(first, theirs.take())
    assert first.sum() == 250
    for timers in (ours, theirs):
        for stage, s in obs[250:]:
            timers.observe(stage, s)
    second = ours.take()
    np.testing.assert_array_equal(second, theirs.take())
    assert second.sum() == len(obs) - 250
    np.testing.assert_array_equal(ours.cumulative(), theirs.cumulative())
    assert ours.take().sum() == 0
    assert summarize_matrix(first) == jcore.summarize_matrix(first)
    summary = summarize_matrix(ours.cumulative())
    assert summary == jcore.summarize_matrix(theirs.cumulative())
    for row in summary.values():
        assert set(row) == {"count", "p50_ms", "p95_ms", "p99_ms"}
        assert row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]


def test_stage_timers_refuse_unknown_and_share_one_lock():
    with pytest.raises(KeyError):
        StageTimers().observe("actor/not_a_stage", 1.0)
    timers = StageTimers()
    stages = ("ingest/stage", "learner/priority_writeback", "actor/forward",
              "learner/train_dispatch")

    def worker(stage):
        for _ in range(500):
            timers.observe(stage, 1e-4)

    threads = [threading.Thread(target=worker, args=(s,)) for s in stages]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    m = timers.cumulative()
    assert m.sum() == 2000
    assert all(m[STAGE_INDEX[s]].sum() == 500 for s in stages)


# -- spans ----------------------------------------------------------------------


@pytest.mark.parametrize("ring_size,events", [(16, 40), (64, 10)])
def test_span_ring_drops_oldest_like_jax(ring_size, events):
    """Past the ring's size the oldest spans fall off, counted; both
    packages keep and drop the same events."""
    from r2d2_tpu.telemetry import spans as jspans
    rng = np.random.default_rng(ring_size)
    starts = np.cumsum(rng.uniform(0.0, 1.0, events))
    ours, theirs = SpanTracer(ring_size), jspans.SpanTracer(ring_size)
    for i, t0 in enumerate(starts):
        tags = {"i": i} if i % 2 else None
        ours.record(f"s{i}", float(t0), float(t0) + 0.25, tags)
        theirs.record(f"s{i}", float(t0), float(t0) + 0.25, tags)
    got, want = ours.drain(), theirs.drain()
    assert got == want
    assert len(got) == min(ring_size, events)
    assert got[-1]["name"] == f"s{events - 1}"
    assert ours.dropped == theirs.dropped == max(0, events - ring_size)
    assert ours.drain() == []


def test_span_rings_of_dead_threads_are_pruned():
    from r2d2_tpu.telemetry import spans as jspans
    for tracer in (SpanTracer(16), jspans.SpanTracer(16)):
        for i in range(3):
            t = threading.Thread(target=lambda i=i, tr=tracer: tr.record(
                f"w{i}", float(i), float(i) + 0.1))
            t.start()
            t.join()
        tracer.record("main", 5.0, 5.1)
        assert len(tracer._rings) == 4
        events = tracer.drain()
        assert {e["name"] for e in events} == {"w0", "w1", "w2", "main"}
        assert len({e["tid"] for e in events}) == 4
        # the dead threads' drained rings go; the live main thread's stays
        assert len(tracer._rings) == 1


def test_span_context_manager_and_disabled_tracer():
    tracer = SpanTracer(16)
    with pytest.raises(RuntimeError):
        with tracer.span("boom", slot=3):
            raise RuntimeError("x")
    (ev,) = tracer.drain()
    assert ev["name"] == "boom" and ev["tags"] == {"slot": 3}
    off = SpanTracer(16, enabled=False)
    off.record("a", 0.0, 1.0)
    with off.span("b"):
        pass
    assert off.drain() == [] and off.dropped == 0


@pytest.mark.parametrize("seed", [0, 3])
def test_chrome_trace_events_equal_jaxs(seed):
    from r2d2_tpu.telemetry import spans as jspans
    rng = np.random.default_rng(seed)
    events = [{"name": STAGES[int(rng.integers(len(STAGES)))],
               "ts": float(1.7e9 + rng.uniform(0, 100)),
               "dur": float(rng.uniform(0, 0.5)),
               "tid": f"thread-{int(rng.integers(3))}",
               **({"tags": {"blocks": int(rng.integers(9))}}
                  if rng.uniform() < 0.5 else {})} for _ in range(30)]
    got = chrome_trace_events(events, pid="learner-p0", pid_index=2)
    assert got == jspans.chrome_trace_events(events, pid="learner-p0",
                                             pid_index=2)
    assert sum(e["ph"] == "X" for e in got) == 30


# -- the board ------------------------------------------------------------------

_CHILD = """
import pickle, sys
import numpy as np
from r2d2_tpu_torch.telemetry.core import STAGES, Telemetry
board = pickle.loads(bytes.fromhex(sys.argv[1]))
rng = np.random.default_rng(int(sys.argv[2]))
tele = Telemetry(name="child", board=board, slot=1)
for i, s in zip(rng.integers(0, len(STAGES), 300),
                10.0 ** rng.uniform(-6, 1, 300)):
    tele.observe(STAGES[int(i)], float(s))
tele.close()
"""


def _child_counts(seed: int) -> np.ndarray:
    timers = StageTimers()
    rng = np.random.default_rng(seed)
    for i, s in zip(rng.integers(0, len(STAGES), 300),
                    10.0 ** rng.uniform(-6, 1, 300)):
        timers.observe(STAGES[int(i)], float(s))
    return timers.cumulative()


def test_board_round_trip_through_a_spawned_process():
    """A spawned process attaches the pickled board by name and publishes
    its timers into slot 1 at its close; the owner's interval deltas are
    that process's counts, and a reset slot's fresh row counts whole, as
    JAX's board reads the same publications."""
    from r2d2_tpu.telemetry.board import TelemetryBoard as JBoard
    board, jboard = TelemetryBoard(2), JBoard(2)
    try:
        env = dict(os.environ, PYTHONPATH=str(REPO))
        subprocess.run([sys.executable, "-c", _CHILD,
                        pickle.dumps(board).hex(), "7"], check=True,
                       env=env, cwd=str(REPO), timeout=120)
        want = _child_counts(7)
        np.testing.assert_array_equal(board.read()[1], want)
        assert board.read()[0].sum() == 0
        jboard.publish(1, want)
        np.testing.assert_array_equal(board.take_deltas(),
                                      jboard.take_deltas())
        assert board.take_deltas().sum() == 0
        # a respawn: the slot restarts from zero, then publishes less
        fresh = _child_counts(8) // 3
        for b in (board, jboard):
            b.reset_slot(1)
            b.publish(1, fresh)
        got = board.take_deltas()
        np.testing.assert_array_equal(got, jboard.take_deltas())
        np.testing.assert_array_equal(got, fresh)
        name = board.name
    finally:
        board.close()
        jboard.close()
    assert not os.path.exists(os.path.join("/dev/shm", name))
    assert board.name == name


def test_telemetry_merges_local_and_board_like_jax():
    from r2d2_tpu.telemetry import core as jcore
    from r2d2_tpu.telemetry.board import TelemetryBoard as JBoard
    board, jboard = TelemetryBoard(1), JBoard(1)
    try:
        summaries = []
        for pkg, b in ((None, board), (jcore, jboard)):
            cls = Telemetry if pkg is None else pkg.Telemetry
            # the owner's handle itself: the spawn path (a pickled handle
            # in another process) is the test above's
            worker = cls(name="w", board=b, slot=0)
            agg = cls(name="agg")
            agg.attach_board(b)
            for stage, s in _observations(5, 60):
                (worker if stage.startswith("actor/") else agg).observe(
                    stage, s)
            worker.flush()
            summaries.append((agg.interval_summary(),
                              agg.interval_summary()))
        assert summaries[0] == summaries[1]
        assert summaries[0][0] and summaries[0][1] == {}
    finally:
        board.close()
        jboard.close()


def test_drain_thread_writes_spans_and_publishes(tmp_path):
    """The drain thread appends the spans as JSONL lines in JAX's schema
    and publishes the counts to the board; close() flushes the rest."""
    from r2d2_tpu.telemetry import core as jcore
    board = TelemetryBoard(1)
    try:
        paths = {}
        for name, cls in (("port", Telemetry), ("jax", jcore.Telemetry)):
            tele = cls(name=name, board=board if name == "port" else None,
                       slot=0 if name == "port" else None,
                       flush_interval_s=0.05)
            paths[name] = str(tmp_path / f"spans_{name}.jsonl")
            tele.start_drain(paths[name])
            tele.observe("actor/block_emit", 0.01)
            tele.record_span("actor/block_emit", 1.0, 1.01, {"slot": 0})
            time.sleep(0.3)
            tele.record_span("ingest/commit", 2.0, 2.5)
            tele.close()
        lines = {k: [json.loads(x) for x in open(p)]
                 for k, p in paths.items()}
        for ours, theirs in zip(lines["port"], lines["jax"]):
            assert set(ours) == set(theirs)
            assert (ours["name"], ours["ts"], ours["dur"]) == (
                theirs["name"], theirs["ts"], theirs["dur"])
        assert [e["name"] for e in lines["port"]] == ["actor/block_emit",
                                                      "ingest/commit"]
        assert lines["port"][0]["pid"] == "port"
        assert board.read().sum() == 1
    finally:
        board.close()


def test_null_telemetry_is_inert(tmp_path):
    NULL_TELEMETRY.observe("actor/env_step", 1.0)
    NULL_TELEMETRY.record_span("x", 0.0, 1.0)
    with NULL_TELEMETRY.span("y"):
        pass
    NULL_TELEMETRY.start_drain(str(tmp_path / "spans.jsonl"))
    NULL_TELEMETRY.close()
    assert NULL_TELEMETRY.interval_summary() == {}
    assert NULL_TELEMETRY.timers.cumulative().sum() == 0
    assert not NULL_TELEMETRY.enabled and not NULL_TELEMETRY.spans.enabled
    assert not (tmp_path / "spans.jsonl").exists()


def test_put_patient_and_block_sink_observe():
    import queue
    from r2d2_tpu_torch.runtime.actor_loop import instrument_block_sink
    from r2d2_tpu_torch.runtime.feeder import put_patient
    tele = Telemetry(name="t")
    q = queue.Queue(maxsize=4)
    sink = instrument_block_sink(
        lambda b: put_patient(q, b, should_stop=lambda: False,
                              telemetry=tele), 0, telemetry=tele)
    assert sink("block")
    summary = tele.interval_summary()
    assert summary["actor/queue_put"]["count"] == 1
    assert summary["actor/block_emit"]["count"] == 1
    (ev,) = tele.spans.drain()
    assert ev["name"] == "actor/block_emit" and ev["tags"] == {"slot": 0}


def test_train_metrics_stages_block_matches_jax(tmp_path):
    """The same observations through both packages' TrainMetrics: equal
    ``stages`` blocks and dropped-span counts; a ``costs`` block rides one
    record; NULL telemetry (a bare TrainMetrics) emits neither."""
    from r2d2_tpu.runtime.metrics import TrainMetrics as JMetrics
    from r2d2_tpu.telemetry import core as jcore
    from r2d2_tpu_torch.runtime.metrics import TrainMetrics
    ours, theirs = TrainMetrics(0, log_dir=None), JMetrics(
        0, str(tmp_path))
    tele, jtele = Telemetry(name="t"), jcore.Telemetry(name="t")
    ours.set_telemetry(tele)
    theirs.set_telemetry(jtele)
    for stage, s in _observations(11, 120):
        tele.observe(stage, s)
        jtele.observe(stage, s)
    ours.set_costs({"model_flops_per_step": 1.0})
    a, b = ours.log(5.0), theirs.log(5.0)
    assert a["stages"] == b["stages"] and a["stages"]
    assert a["telemetry_dropped_spans"] == b["telemetry_dropped_spans"] == 0
    assert a["costs"] == {"model_flops_per_step": 1.0}
    again = ours.log(5.0)
    assert "costs" not in again and again["stages"] == {}
    bare = TrainMetrics(0, log_dir=None).log(1.0)
    assert "stages" not in bare and "telemetry_dropped_spans" not in bare


# -- the config and the env knobs ----------------------------------------------


def test_config_fields_defaults_and_refusals_match_jax():
    from r2d2_tpu.config import Config as JConfig
    ours, theirs = Config(), JConfig()
    for section, name in (("telemetry", "ring_size"),
                          ("telemetry", "flush_interval_s"),
                          ("telemetry", "spans"),
                          ("telemetry", "costmodel_enabled"),
                          ("runtime", "profile_dir"),
                          ("runtime", "profile_at_step"),
                          ("env", "frame_skip"), ("env", "clip_rewards")):
        assert (getattr(getattr(ours, section), name)
                == getattr(getattr(theirs, section), name)), name
    for key, value, word in (("telemetry.ring_size", 15, "ring_size"),
                             ("telemetry.flush_interval_s", 0.0,
                              "flush_interval_s"),
                             ("runtime.profile_at_step", -1,
                              "profile_at_step")):
        with pytest.raises(ValueError, match=word) as ours_err:
            ours.replace(**{key: value})
        with pytest.raises(ValueError, match=word) as theirs_err:
            theirs.replace(**{key: value})
        assert str(ours_err.value) == str(theirs_err.value)
    cfg = parse_overrides(Config(), [
        "--telemetry.ring_size=16", "--telemetry.flush_interval_s=0.5",
        "--telemetry.spans=false", "--telemetry.costmodel_enabled=false",
        "--runtime.profile_dir=/x", "--runtime.profile_at_step=7",
        "--env.frame_skip=4", "--env.clip_rewards=true"])
    again = Config.from_json(cfg.to_json())
    assert again == cfg
    assert (again.telemetry.ring_size, again.telemetry.spans,
            again.runtime.profile_at_step, again.env.frame_skip,
            again.env.clip_rewards) == (16, False, 7, 4, True)


@pytest.mark.parametrize("clip", [False, True])
def test_fake_env_rewards_match_jaxs_create_env(clip):
    from r2d2_tpu.config import EnvConfig as JEnvConfig
    from r2d2_tpu.envs.factory import create_env as j_create_env
    from r2d2_tpu_torch.config import EnvConfig
    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.envs.wrappers import ClipReward
    kw = dict(frame_height=24, frame_width=24, clip_rewards=clip)
    env, jenv = create_env(EnvConfig(**kw), seed=4), j_create_env(
        JEnvConfig(**kw), seed=4)
    assert isinstance(env, ClipReward) == clip
    actions = np.random.default_rng(4).integers(0, 6, 150)
    env.reset(), jenv.reset()
    for a in actions:
        _, r, done, _ = env.step(int(a))
        _, jr, jdone, _ = jenv.step(int(a))
        assert (r, done) == (jr, jdone)
        if done:
            env.reset(), jenv.reset()


class _StubGym:
    """A gymnasium env whose rewards overshoot [-1, 1]: numpy-seeded."""

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self.action_space = type("Space", (), {"n": 4})()
        self.observation_space = None

    def reset(self, seed=None):
        return np.zeros((32, 32, 3), np.uint8), {}

    def step(self, action):
        reward = float(self._rng.normal(0.0, 3.0))
        return (np.full((32, 32, 3), 7, np.uint8), reward, False, False, {})

    def close(self):
        pass


@pytest.mark.parametrize("frame_skip,clip", [(1, True), (4, True),
                                             (4, False)])
def test_gymnasium_env_gets_frameskip_and_clip_like_jax(
        monkeypatch, frame_skip, clip):
    """A stub gymnasium env: ``frameskip`` reaches gymnasium.make as in
    the JAX package (only when > 1), and the rewards equal JAX's
    create_env's, clipped to [-1, 1] under env.clip_rewards."""
    import gymnasium
    from r2d2_tpu.config import EnvConfig as JEnvConfig
    from r2d2_tpu.envs.factory import create_env as j_create_env
    from r2d2_tpu_torch.config import EnvConfig
    from r2d2_tpu_torch.envs.factory import create_env
    calls = []

    def make(env_id, **kwargs):
        calls.append((env_id, kwargs))
        return _StubGym(seed=9)

    monkeypatch.setattr(gymnasium, "make", make)
    kw = dict(game_name="ALE/Stub", env_type="-v5", frame_height=24,
              frame_width=24, frame_skip=frame_skip, clip_rewards=clip)
    env, jenv = create_env(EnvConfig(**kw)), j_create_env(JEnvConfig(**kw))
    assert calls[0] == calls[1]
    assert calls[0] == ("ALE/Stub-v5", {"frameskip": frame_skip}
                        if frame_skip > 1 else {})
    env.reset(), jenv.reset()
    rewards = []
    for _ in range(40):
        _, r, _, _ = env.step(0)
        _, jr, _, _ = jenv.step(0)
        assert r == jr
        rewards.append(r)
    if clip:
        assert max(map(abs, rewards)) <= 1.0
    else:
        assert max(map(abs, rewards)) > 1.0


# -- the records of cli.train ---------------------------------------------------


def _port_records(tmp_path, **overrides):
    from r2d2_tpu_torch.runtime.orchestrator import train
    cfg = Config().replace(**{**TINY, "runtime.save_dir": str(tmp_path),
                              **overrides})
    records = []
    train(cfg, max_training_steps=12, max_seconds=180, actor_mode="thread",
          device="cpu", log_fn=records.append)
    return records


def _stage_fields(records):
    out = {}
    for r in records:
        for name, row in (r.get("stages") or {}).items():
            out.setdefault(name, set()).update(row)
    return out


def test_cli_train_records_match_jax(tmp_path):
    """A thread-actor run of each package under the same config: the same
    ``stages`` keys, each with the same summary fields, over the run's
    records, and a first record whose ``costs`` block equals JAX's; the
    port's spans file parses."""
    from r2d2_tpu.config import Config as JConfig
    from r2d2_tpu.runtime.orchestrator import train as j_train
    # a record every loop turn: which stages a record holds then follows
    # the steps, not either package's speed
    ours = _port_records(tmp_path / "port", **{"runtime.log_interval": 0.0})
    jcfg = JConfig().replace(**{**TINY, "runtime.log_interval": 0.0,
                                "runtime.save_dir": str(tmp_path / "jax")})
    theirs = []
    j_train(jcfg, max_training_steps=12, max_seconds=180,
            actor_mode="thread", log_fn=theirs.append)
    got, want = _stage_fields(ours), _stage_fields(theirs)
    assert got == want
    assert {"actor/env_step", "actor/forward", "actor/block_emit",
            "actor/queue_put", "actor/weight_sync", "ingest/ring_get",
            "ingest/commit", "learner/train_dispatch", "learner/device_sync",
            "weights/publish"} <= set(got)
    assert ours[0]["costs"] == theirs[0]["costs"]
    assert not any("costs" in r for r in ours[1:])
    spans = [json.loads(x) for x in open(
        tmp_path / "port" / "spans_player0.jsonl")]
    assert spans and {e["name"] for e in spans} >= {
        "actor/block_emit", "ingest/commit", "learner/train_dispatch"}


def test_cli_train_records_omit_the_blocks_when_disabled(tmp_path):
    """telemetry.enabled=false: no stages, no costs, no spans file."""
    from r2d2_tpu_torch.cli import train
    args = [f"--{k}={';'.join(','.join(map(str, t)) for t in v)}"
            if k == "network.conv_layers" else f"--{k}={v}"
            for k, v in TINY.items()]
    train.main(args + ["--device=cpu", "--actor-mode=thread",
                       "--max-steps=6", f"--runtime.save_dir={tmp_path}",
                       "--telemetry.enabled=false"])
    records = [json.loads(x) for x in open(tmp_path /
                                           "metrics_player0.jsonl")]
    assert records
    assert not any(k in r for r in records
                   for k in ("stages", "telemetry_dropped_spans", "costs"))
    assert not list(tmp_path.glob("spans_*.jsonl"))


# -- the profiler ---------------------------------------------------------------


def test_profile_at_step_and_sigusr2_write_traces(tmp_path):
    """runtime.profile_at_step=3 on the CPU starts a capture once the
    learner reaches step 3 and writes its trace when the window ends; a
    SIGUSR2 later starts another (its flag handler only flags; the loop
    starts it); the previous handler is back after the run."""
    from r2d2_tpu_torch.runtime.orchestrator import train
    from r2d2_tpu_torch.tools.profile_step import summarize_trace
    cfg = Config().replace(**{**TINY, "runtime.save_dir": str(tmp_path),
                              "runtime.profile_at_step": 3})
    sent = []

    def hook(stack):
        if stack.learner.training_steps >= 8 and not sent:
            sent.append(stack.learner.training_steps)
            os.kill(os.getpid(), signal.SIGUSR2)

    before = signal.getsignal(signal.SIGUSR2)
    train(cfg, max_training_steps=16, max_seconds=180, actor_mode="thread",
          device="cpu", dispatch_hook=hook)
    assert signal.getsignal(signal.SIGUSR2) == before
    traces = sorted((tmp_path / "profile").glob("*.pt.trace.json"))
    assert sent and len(traces) == 2
    planes = summarize_trace(str(tmp_path / "profile"))
    assert planes["host operators"]


def test_capture_is_refused_while_another_profiler_runs(tmp_path):
    """A start while another torch.profiler is active is refused (and
    warned), leaving that profiler running; ``trace`` raises."""
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.telemetry.profiler import (ProfilerCapture,
                                                   profiler_active, trace)
    cap = ProfilerCapture()
    with profile(activities=[ProfilerActivity.CPU]):
        assert not cap.start(str(tmp_path))
        assert cap.refused == 1 and not cap.active
        assert profiler_active()
        with pytest.raises(RuntimeError, match="refused"):
            with trace(str(tmp_path)):
                pass
    assert not profiler_active()
    assert cap.start(str(tmp_path), duration_s=0.0)
    assert cap.poll() and cap.captures == 1
    assert os.path.exists(cap.last_trace)
    cap.stop()          # idempotent
    assert cap.captures == 1


def test_cli_profile_captures_and_summarizes_on_the_cpu(tmp_path, capsys):
    """cli.profile on the CPU at the tiny shape writes a trace and its
    meta (whole dispatches), and --summarize reads it back; the per-step
    figures divide by the traced steps."""
    from r2d2_tpu_torch.cli import profile
    from r2d2_tpu_torch.tools.profile_step import (read_meta,
                                                   traced_step_count)
    out = str(tmp_path / "prof")
    overrides = [f"--{k}={v}" for k, v in TINY.items()
                 if k.startswith(("env.frame", "network.h", "network.cnn",
                                  "sequence.", "replay.capacity",
                                  "replay.block", "replay.batch"))]
    overrides.append("--network.conv_layers=8,4,2;16,3,1")
    result = profile.main(["--device=cpu", "--steps", "3", "--out", out,
                           "--runtime.steps_per_dispatch=2", *overrides])
    assert traced_step_count(out) == 4 == result["steps"]
    meta = read_meta(out)
    assert meta["steps_per_dispatch"] == 2 and meta["device"] == "cpu"
    again = profile.main(["--summarize", out, "--top", "5"])
    assert again["steps"] == 4
    text = capsys.readouterr().out
    assert "== host operators" in text and "hand kernels" in text
    # no device plane on the CPU: nothing attributed to a kernel
    assert again["device_ms_per_step"] == 0.0
    assert all(row["launches_per_step"] == 0
               for row in again["hand_kernels"].values())
    with pytest.raises(SystemExit):
        profile.main(["--summarize", out, "--replay.capacity=800"])
