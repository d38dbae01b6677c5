"""The port's Learner under host placement on the CPU: it trains through
the prefetch and write-back threads and the write-back reaches the host
tree; a stalled write-back counts its drops; a dead prefetch thread raises
instead of hanging; stop_background joins; steps_per_dispatch > 1 is
ignored with a warning; the synchronous trainer refuses the placement
and the orchestrated one trains under it; both placements stamp the
ring's slots alike. Every wait on a thread is
bounded."""

import dataclasses
import logging
import queue
import threading
import time

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.cli import train
from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.tools import sync_train as sync_cli
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.runtime.learner_loop import Learner
from r2d2_tpu_torch.tools.sync_train import sync_train
from tests.test_torch_replay import synthetic_blocks
from tests.test_torch_train import TINY_ARGS

pytestmark = pytest.mark.torch_port

ACTIONS = 18        # synthetic blocks draw actions in [0, 18)
WAIT = 60.0         # seconds any wait on a thread may take here


def bounded(fn, timeout: float = WAIT):
    """``fn()`` in a helper thread, failing the test if it has not
    returned within ``timeout`` seconds; its result or its exception."""
    result = {}

    def run():
        try:
            result["value"] = fn()
        except BaseException as e:          # handed to the test
            result["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still running after {timeout} s"
    if "error" in result:
        raise result["error"]
    return result.get("value")


def wait_until(cond, timeout: float = WAIT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"not within {timeout} s"
        time.sleep(0.01)


def host_learner(*extra, blocks=6) -> Learner:
    cfg = parse_overrides(Config(), TINY_ARGS + [
        "--replay.placement=host", "--replay.learning_starts=40", *extra])
    net = NetworkApply(ACTIONS, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    learner = Learner(cfg, net)
    for block in synthetic_blocks(learner.spec, blocks, seed=1):
        learner.ingest(block)
    return learner


def test_host_learner_trains_and_writes_priorities_back():
    """Four steps through the pipeline threads: finite losses, one step a
    dispatch, the shared ring accountant, no device replay; the
    write-back reaches the native tree, whose mass changes."""
    learner = host_learner()
    try:
        assert learner.ready and learner.replay_state is None
        assert learner.ring is learner.host_replay.ring
        assert learner.host_replay._native is not None
        total = learner.host_replay._native.total
        for _ in range(4):
            m = bounded(learner.step)
            assert np.isfinite(float(m["loss"])) and "priorities" not in m
        assert learner.training_steps == 4 and learner.steps_per_dispatch == 1
        wait_until(lambda: learner._writeback_q.unfinished_tasks == 0)
        assert learner.host_replay._native.total != total
        assert learner.dropped_priority_updates == 0
        assert len(learner.timings["sample_ms"]) >= 4
        assert len(learner.losses) == 4
        with pytest.raises(ValueError, match="no jitter"):
            learner.step(torch.rand(learner.spec.batch_size))
    finally:
        learner.stop_background(join_timeout=WAIT)
    assert not learner._bg_threads


def test_stalled_writeback_counts_dropped_updates():
    """A write-back stalled inside update_priorities behind a one-slot
    queue: a later step's put finds the queue full, drops the update and
    counts it."""
    learner = host_learner()
    release = threading.Event()
    original = learner.host_replay.update_priorities

    def stalled(*args, **kwargs):
        release.wait(timeout=WAIT)
        return original(*args, **kwargs)

    learner.host_replay.update_priorities = stalled
    learner._writeback_q = queue.Queue(maxsize=1)
    try:
        for _ in range(4):
            bounded(learner.step)
        assert learner.dropped_priority_updates >= 1
    finally:
        release.set()
        learner.stop_background(join_timeout=WAIT)
    assert not learner._bg_threads


def test_dead_prefetch_thread_raises_instead_of_hanging():
    learner = host_learner()

    def broken(*args, **kwargs):
        raise OSError("sampling failed")

    learner.host_replay.sample = broken
    try:
        with pytest.raises(RuntimeError, match="pipeline thread died") as e:
            bounded(learner.step)
        assert isinstance(e.value.__cause__, OSError)
    finally:
        learner.stop_background(join_timeout=WAIT)


def test_stop_background_joins_and_restarts():
    """stop_background joins both threads even with the prefetch queue
    full (the prefetch thread parked in its put); the next step starts
    them again; under device placement it is a no-op."""
    learner = host_learner()
    try:
        bounded(learner.step)
        wait_until(lambda: learner._prefetch_q.full())
        threads = list(learner._bg_threads)
        assert len(threads) == 2 and all(t.is_alive() for t in threads)
        bounded(lambda: learner.stop_background(join_timeout=WAIT))
        assert not any(t.is_alive() for t in threads)
        assert not learner._bg_threads
        bounded(learner.step)
        assert len(learner._bg_threads) == 2
    finally:
        learner.stop_background(join_timeout=WAIT)
    assert not learner._bg_threads
    cfg = parse_overrides(Config(), TINY_ARGS)
    device = Learner(cfg, NetworkApply(ACTIONS, cfg.network,
                                       cfg.env.frame_stack,
                                       cfg.env.frame_height,
                                       cfg.env.frame_width, "cpu"))
    device.stop_background()


def test_steps_per_dispatch_over_one_is_ignored_with_a_warning(caplog):
    with caplog.at_level(logging.WARNING):
        learner = host_learner("--runtime.steps_per_dispatch=4", blocks=0)
    assert learner.steps_per_dispatch == 1
    assert "ignoring runtime.steps_per_dispatch=4" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        host_learner(blocks=0)          # -1, auto: silent
    assert "ignoring" not in caplog.text


def test_sync_train_and_cli_refuse_host_placement(tmp_path):
    """The synchronous trainer's bit-reproducibility needs the device
    replay, as in the JAX package: it and its entry point refuse host
    placement. The orchestrated trainer (cli.train, thread actors) trains
    under it, and its close joins the learner's threads (the JAX
    package's test_end_to_end_host_placement). A placement other than the
    two is refused by the config."""
    cfg = parse_overrides(Config(), TINY_ARGS + ["--replay.placement=host"])
    with pytest.raises(ValueError, match="requires replay.placement='device'"):
        sync_train(cfg, 1, 0.4, device="cpu")
    with pytest.raises(ValueError, match="requires replay.placement='device'"):
        sync_cli.main(TINY_ARGS + ["--device=cpu", "--max-steps=1",
                                   "--replay.placement=host"])
    stacks = []
    summary = bounded(lambda: train.main(
        TINY_ARGS + ["--device=cpu", "--max-steps=4", "--max-seconds=90",
                     "--actor-mode=thread", "--replay.placement=host",
                     "--runtime.save_interval=0",
                     f"--runtime.save_dir={tmp_path}"],
        dispatch_hook=lambda st: stacks.append(st) if not stacks else None),
        timeout=WAIT * 2)
    assert summary["steps"] >= 4 and np.all(np.isfinite(summary["losses"]))
    learner = stacks[0].learner
    assert learner.host_replay is not None and len(learner.host_replay) > 0
    assert not learner._bg_threads
    assert not any(t.is_alive() for t in stacks[0].threads)
    with pytest.raises(ValueError, match="replay.placement must be one of"):
        parse_overrides(Config(), ["--replay.placement=disk"])


def test_both_placements_stamp_slot_weight_versions():
    """Ingest stamps each ring slot with its block's weight_version under
    either placement, and the stamps agree."""
    blocks = synthetic_blocks(host_learner(blocks=0).spec, 5, seed=2)
    for i, block in enumerate(blocks):
        block.weight_version = np.asarray(10 + i, np.int32)
    stamps = {}
    for placement in ("device", "host"):
        cfg = parse_overrides(Config(), TINY_ARGS + [
            f"--replay.placement={placement}"])
        learner = Learner(cfg, NetworkApply(
            ACTIONS, cfg.network, cfg.env.frame_stack, cfg.env.frame_height,
            cfg.env.frame_width, "cpu"))
        for block in blocks:
            learner.ingest(dataclasses.replace(block))
        stamps[placement] = (list(learner.ring.slot_versions),
                             learner.ring.live_versions(),
                             learner.ring.total_adds)
    assert stamps["device"] == stamps["host"]
    assert stamps["host"][1] == [10, 11, 12, 13, 14]
