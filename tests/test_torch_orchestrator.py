"""The port's orchestrated trainer on the CPU, the twins of the JAX
package's end-to-end runtime tests: the thread-mode slice (steps, the
step-0 checkpoint, the reference's log lines), process mode over the shm
ring (no orphan process, every segment unlinked, the children exit clean
and never initialized CUDA; host placement too), SIGTERM as a clean stop
with a final checkpoint, the K-step dispatch's publish and save cadence,
and dead actors respawned by the supervisor. Every run is bounded by
``max_seconds`` and every join by a timeout."""

import os
import re
import signal
import threading
import time

import pytest

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.envs.factory import create_env
from r2d2_tpu_torch.runtime.checkpoint import list_checkpoints
from r2d2_tpu_torch.runtime.orchestrator import PlayerStack, train

pytestmark = pytest.mark.torch_port

LOG_LINES = (r"^buffer size: \d+$", r"^buffer update speed: .*/s$",
             r"^number of environment steps: \d+$",
             r"^number of training steps: \d+$", r"^training speed: .*/s$",
             r"^loss: \d+\.\d{4}$")


def tiny_config(tmp_path, **overrides) -> Config:
    """The JAX package's tests/test_runtime.py tiny_config."""
    cfg = Config().replace(**{
        "env.game_name": "Fake",
        "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
        "network.hidden_dim": 16, "network.cnn_out_dim": 32,
        "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
        "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
        "sequence.forward_steps": 3,
        "replay.capacity": 800, "replay.block_length": 20,
        "replay.batch_size": 8, "replay.learning_starts": 100,
        "actor.num_actors": 2, "actor.actor_update_interval": 50,
        "optim.lr": 1e-3,
        "runtime.save_dir": str(tmp_path), "runtime.save_interval": 50,
        "runtime.log_interval": 0.2, "runtime.weight_publish_interval": 5,
        "runtime.steps_per_dispatch": 1,
    })
    return cfg.replace(**overrides) if overrides else cfg


def _gone(names):
    return [n for n in names if os.path.exists(os.path.join("/dev/shm", n))]


def test_end_to_end_training_slice(tmp_path):
    """Thread actors on the Fake env feed the device replay; the learner
    trains; the step-0 checkpoint, the log and the publications happen;
    every thread is joined."""
    cfg = tiny_config(tmp_path)
    st = train(cfg, max_training_steps=15, max_seconds=120,
               actor_mode="thread", device="cpu")
    assert st.learner.training_steps >= 15
    assert st.learner.env_steps >= cfg.replay.learning_starts
    assert any(idx == 0 for idx, _ in list_checkpoints(str(tmp_path),
                                                       "Fake", 0))
    text = (tmp_path / "train_player0.log").read_text()
    for line in LOG_LINES:
        assert re.search(line, text, re.M), line
    assert st.snapshots.publishes == st.snapshots.requested >= 2
    assert st.store.publish_count == 1 + st.snapshots.publishes
    assert not any(t.is_alive() for t in st.threads)
    assert st.metrics.ingest_blocks_total > 0
    assert not _gone(st.segment_names)


@pytest.mark.parametrize("placement", ["device", "host"])
def test_end_to_end_process_mode(tmp_path, placement):
    """Spawned actor processes over the native shm ring and the weight
    segment: the learner trains on their blocks; close leaves no live
    child and no segment; every child exited 0, which it does only if it
    never initialized CUDA (actor_main.py)."""
    cfg = tiny_config(tmp_path, **{"runtime.save_interval": 0,
                                   "replay.placement": placement})
    st = train(cfg, max_training_steps=10, max_seconds=240,
               actor_mode="process", device="cpu")
    assert st.learner.training_steps >= 10
    assert st.learner.env_steps >= cfg.replay.learning_starts
    from r2d2_tpu_torch.runtime.shm_feeder import ShmBlockRing
    assert isinstance(st.queue._q, ShmBlockRing)
    assert len(st.processes) == cfg.actor.num_actors
    assert not any(p.is_alive() for p in st.processes), "orphan actors"
    assert [p.exitcode for p in st.processes] == [0, 0]
    assert len(st.segment_names) == 3 and not _gone(st.segment_names)
    if placement == "host":
        assert st.learner.host_replay is not None
        assert not st.learner._bg_threads


def test_sigterm_maps_to_clean_stop(tmp_path):
    """SIGTERM lands on the stop event: the run ends well before its
    bound, writes its final checkpoint, and the previous handler is
    restored."""
    cfg = tiny_config(tmp_path, **{"runtime.save_interval": 1000})
    prev = signal.getsignal(signal.SIGTERM)
    seen = []

    def hook(st):
        if not seen:
            seen.append(st.learner.training_steps)
            threading.Timer(0.5, lambda: os.kill(os.getpid(),
                                                 signal.SIGTERM)).start()

    t0 = time.time()
    st = train(cfg, max_training_steps=10**9, max_seconds=100,
               actor_mode="thread", device="cpu", dispatch_hook=hook)
    assert time.time() - t0 < 90, "the signal did not stop the run"
    assert signal.getsignal(signal.SIGTERM) is prev
    steps = st.learner.training_steps
    assert seen and steps >= 1
    # the step-0 checkpoint and the final one, one index past the slot
    assert [i for i, _ in list_checkpoints(str(tmp_path), "Fake", 0)] \
        == [0, steps // 1000 + 1]


def test_k_step_dispatch_publish_and_save_cadence(tmp_path):
    """steps_per_dispatch=4 trains in 4-step dispatches; a publish and a
    checkpoint fire after every dispatch that crosses their interval
    boundary (publish 5, save 6), as in the JAX learner's step."""
    cfg = tiny_config(tmp_path, **{"runtime.steps_per_dispatch": 4,
                                   "runtime.weight_publish_interval": 5,
                                   "runtime.save_interval": 6,
                                   "runtime.keep_checkpoints": 100})
    trace = []
    st = train(cfg, max_training_steps=24, max_seconds=120,
               actor_mode="thread", device="cpu",
               dispatch_hook=lambda s: trace.append(
                   (s.learner.training_steps, s.snapshots.requested)))
    assert [s for s, _ in trace] == [4, 8, 12, 16, 20, 24]
    want, prev = 0, 0
    for step, requested in trace:
        want += step // 5 > prev // 5
        prev = step
        assert requested == want, trace
    assert st.snapshots.publishes == want
    saved = [i for i, _ in list_checkpoints(str(tmp_path), "Fake", 0)]
    assert saved == [0] + sorted({s // 6 for s, _ in trace
                                  if s // 6 > (s - 4) // 6})
    assert len(st.learner.save_ms) == len(saved)


def test_supervisor_respawns_dead_actors(tmp_path):
    """A dead thread actor and a killed process actor are respawned by
    supervise(); with restarts off a dead thread stays dead; a stop
    request respawns nothing."""
    cfg = tiny_config(tmp_path)
    action_dim = create_env(cfg.env).action_space.n
    stack = PlayerStack(cfg, 0, action_dim, "cpu")
    stop = threading.Event()
    stack.start_actors_threads(stop)
    try:
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join(timeout=5)
        stack.threads[0] = dead
        assert stack.supervise() == 1 and stack.threads[0].is_alive()
        stack.threads[0] = dead
        stop.set()
        assert stack.supervise() == 0
    finally:
        stop.set()
        stack.close()

    cfg = tiny_config(tmp_path, **{"runtime.restart_dead_actors": False})
    stack = PlayerStack(cfg, 0, action_dim, "cpu")
    stop = threading.Event()
    stack.start_actors_threads(stop)
    try:
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join(timeout=5)
        stack.threads[1] = dead
        assert stack.supervise() == 0 and not stack.threads[1].is_alive()
    finally:
        stop.set()
        stack.close()

    import multiprocessing as mp
    cfg = tiny_config(tmp_path, **{"actor.num_actors": 1})
    stack = PlayerStack(cfg, 0, action_dim, "cpu")
    stop = mp.get_context("spawn").Event()
    stack.start_actors_processes(stop)
    try:
        first = stack.processes[0]
        first.kill()
        first.join(timeout=10)
        assert not first.is_alive()
        assert stack.supervise() == 1
        assert stack.processes[0] is not first
        assert stack.processes[0].is_alive()
        assert stack.health.restarts == 1
    finally:
        stop.set()
        stack.close()
    assert not any(p.is_alive() for p in stack.processes)
