"""The replay service's socket rung and its standalone process on the CPU:
a remote producer's blocks land as direct adds would, each ack naming
the routed shard; windowed frames with every other ack dropped still land
once each (cumulative acks) and flush reaps the window; a window stalled
behind a dropped last ack heals through the flush probe; a service
bounced mid-window is redialled and its unacked tail replayed into the
successor restored from its snapshot; a dead address raises at
construction and a late one is reached on the backoff ladder; the pump
ships a queue's stacked groups; ``service_main`` as a CPU subprocess
(``--device=cpu``) survives the kill drill with its snapshot restored bit
for bit, and refuses to start without a card unless asked for the CPU.
Frames carry numpy arrays only. Every test has a time limit of its own
and no wait is a fixed sleep."""

import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.fleet.replay_service import (RemoteReplayProducer,
                                                 ReplayProducerPump,
                                                 ReplayService,
                                                 ReplayServiceServer,
                                                 _block_fields)
from r2d2_tpu_torch.runtime.feeder import BlockQueue
from tests.test_torch_replay import FIELDS, specs, synthetic_blocks

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bounded(fn, timeout: float = 60.0):
    """``fn()`` on a helper thread, failing the test past ``timeout``."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:          # handed to the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still running after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def wait_until(cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"not within {timeout} s"
        time.sleep(0.01)


def spec_blocks(n, seed=0, num_blocks=4):
    _, spec = specs(num_blocks=num_blocks)
    return spec, synthetic_blocks(spec, n, seed=seed)


def assert_shards_equal(a: ReplayService, b: ReplayService) -> None:
    for x, y in zip(a.shards, b.shards):
        for name in FIELDS:
            assert torch.equal(getattr(x.state, name),
                               getattr(y.state, name)), name
        assert x.ring.slot_steps == y.ring.slot_steps


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_socket_rung_round_trip():
    """Lockstep frames: the ack names the routed shard and the service
    holds what direct adds build; the frame is numpy only."""
    def run():
        spec, blocks = spec_blocks(2)
        svc, ref = ReplayService(spec, 2, "cpu"), ReplayService(spec, 2, "cpu")
        server = ReplayServiceServer(svc)
        producer = RemoteReplayProducer(server.host, server.port)
        try:
            assert [producer.add_block(b) for b in blocks] == [0, 1]
            assert server.blocks_received == 2
            for blk in blocks:
                ref.add_block(blk)
            assert_shards_equal(svc, ref)
        finally:
            producer.close()
            server.close()
        fields = _block_fields(blocks[0])
        assert all(isinstance(v, np.ndarray) for v in fields.values())
        assert b"torch" not in pickle.dumps(("add", fields))
    bounded(run)


def test_windowed_frames_with_dropped_acks():
    """Every other data ack dropped, window 3: each block lands once,
    flush reaps the window, the interval stats count the drops, and the
    shards equal a direct grouped ingest."""
    def run():
        spec, blocks = spec_blocks(12, seed=1)
        svc = ReplayService(spec, 2, "cpu", ingest_batch_blocks=4)
        ref = ReplayService(spec, 2, "cpu", ingest_batch_blocks=4)
        server = ReplayServiceServer(svc, drop_ack_every=2)
        producer = RemoteReplayProducer(server.host, server.port, window=3)
        try:
            for i in range(0, 12, 4):
                producer.add_blocks(blocks[i:i + 4])
            assert producer.flush() == 12 and producer.inflight == 0
            assert producer.frames_sent == 3
            assert server.blocks_received == 12 and server.acks_dropped >= 1
            stats = server.interval_stats()
            assert stats["blocks"] == 12 and stats["frames"] == 3
            assert stats["window_max"] >= 1 and stats["acks_dropped"] >= 1
            assert stats["blocks_total"] == 12
            assert server.interval_stats()["blocks"] == 0
            for i in range(0, 12, 4):
                ref.add_blocks(blocks[i:i + 4])
            assert_shards_equal(svc, ref)
        finally:
            producer.close()
            server.close()
    bounded(run)


def test_window_stall_heals_through_the_flush_probe():
    """Every data ack dropped, window 1: the producer's receive times out,
    it sends a flush probe (always acked) and the cumulative ack covers
    the stalled frame; nothing is delivered twice."""
    def run():
        spec, blocks = spec_blocks(2, seed=2)
        svc = ReplayService(spec, 1, "cpu", ingest_batch_blocks=2)
        server = ReplayServiceServer(svc, drop_ack_every=1)
        producer = RemoteReplayProducer(server.host, server.port,
                                        dial_timeout=0.5, window=1)
        try:
            producer.add_blocks(blocks, timeout=0.5)
            assert producer.blocks_acked == 2 and producer.inflight == 0
            assert server.blocks_received == 2 and server.acks_dropped == 1
            assert svc.total_adds == 2
        finally:
            producer.close()
            server.close()
    bounded(run)


def test_flush_is_the_resync_point():
    """flush with nothing in flight returns the acked count; with frames
    in flight it reaps them all, and the stacked rung's frames land as
    the listed rung's."""
    def run():
        spec, blocks = spec_blocks(6, seed=3)
        svc = ReplayService(spec, 2, "cpu", ingest_batch_blocks=2)
        ref = ReplayService(spec, 2, "cpu", ingest_batch_blocks=2)
        server = ReplayServiceServer(svc)
        producer = RemoteReplayProducer(server.host, server.port, window=8)
        try:
            assert producer.flush() == 0
            q = BlockQueue(use_mp=False)
            for blk in blocks[:4]:
                q.put(blk)
            stacked, k = q.drain_stacked(4)
            producer.add_stacked(stacked, k)
            producer.add_blocks(blocks[4:])
            assert producer.inflight == 2
            assert producer.flush() == 6 and producer.inflight == 0
            ref.add_blocks(blocks[:4])
            ref.add_blocks(blocks[4:])
            assert_shards_equal(svc, ref)
        finally:
            producer.close()
            server.close()
    bounded(run)


def test_bounce_mid_window_replays_the_unacked_tail():
    """The service dies with a frame unacked (its ack dropped); a
    successor restored from the dead one's snapshot binds the same port;
    the producer redials on its ladder and replays the tail: every block
    acked, the replayed frame written again (6 adds for 4 blocks)."""
    def run():
        spec, blocks = spec_blocks(4, seed=4)
        svc1 = ReplayService(spec, 2, "cpu", ingest_batch_blocks=2)
        server1 = ReplayServiceServer(svc1, drop_ack_every=1)
        port = server1.port
        producer = RemoteReplayProducer(
            server1.host, port, window=4, connect_retries=60,
            backoff_base_s=0.05, backoff_max_s=0.25)
        server2 = svc2 = None
        try:
            producer.add_blocks(blocks[:2])
            wait_until(lambda: svc1.total_adds == 2)
            assert producer.inflight == 1
            snap = svc1.snapshot_state(2)
            server1.close()
            svc1.close()
            svc2 = ReplayService(spec, 2, "cpu", ingest_batch_blocks=2)
            svc2.restore_state(snap)
            server2 = ReplayServiceServer(svc2, "127.0.0.1", port)
            producer.add_blocks(blocks[2:])
            assert producer.flush() == 4 and producer.inflight == 0
            assert producer.reconnects >= 1 and producer.blocks_resent >= 2
            assert svc2.total_adds == 6
            assert server2.blocks_received == 4
        finally:
            producer.close()
            server1.close()
            if server2 is not None:
                server2.close()
    bounded(run)


def test_dead_address_raises_and_a_late_one_is_reached():
    def run():
        with pytest.raises(OSError):
            RemoteReplayProducer("127.0.0.1", _dead_port(),
                                 dial_timeout=0.5)
        port = _dead_port()
        accepted = threading.Event()

        def bind_late():
            srv = socket.create_server(("127.0.0.1", port))
            conn, _ = srv.accept()
            accepted.set()
            conn.close()
            srv.close()

        timer = threading.Timer(0.3, bind_late)
        timer.start()
        producer = RemoteReplayProducer(
            "127.0.0.1", port, dial_timeout=0.5, connect_retries=40,
            backoff_base_s=0.05, backoff_max_s=0.2)
        try:
            assert accepted.wait(10.0)
        finally:
            producer.close()
            timer.join(10.0)
    bounded(run)


def test_pump_ships_the_queue_as_stacked_groups():
    """A producer host's pump: queued blocks reach the service in
    windowed groups and land as sequential adds."""
    def run():
        spec, blocks = spec_blocks(6, seed=5)
        svc = ReplayService(spec, 2, "cpu", ingest_batch_blocks=4)
        ref = ReplayService(spec, 2, "cpu")
        server = ReplayServiceServer(svc)
        q = BlockQueue(use_mp=False)
        for blk in blocks:
            q.put(blk)
        producer = RemoteReplayProducer(server.host, server.port, window=2)
        stop = threading.Event()
        stop.set()                   # drain, then leave
        try:
            pump = ReplayProducerPump(q, producer, group=4)
            assert pump.run(stop=stop) == 6
            assert producer.blocks_acked == 6
            assert server.blocks_received == 6
            for blk in blocks:
                ref.add_block(blk)
            assert_shards_equal(svc, ref)
        finally:
            producer.close()
            server.close()
    bounded(run)


DRILL_OVERRIDES = {
    "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
    "network.hidden_dim": 16, "sequence.burn_in_steps": 4,
    "sequence.learning_steps": 5, "sequence.forward_steps": 3,
    "replay.capacity": 800, "replay.block_length": 20,
    "replay.batch_size": 8, "fleet.replay_shards": 2,
    "fleet.ingest_batch_blocks": 2, "fleet.spill_blocks": 4}


def test_service_main_kill_drill_on_the_cpu(tmp_path):
    """``python -m r2d2_tpu_torch.fleet.service_main --device=cpu`` as a
    child: SIGKILLed mid-ingest and restarted, it restores the snapshot's
    cut bit for bit; the producer reconnects, replays its tail and has
    every block acked; committed adds are monotone and the loss within a
    snapshot interval and a window of groups; both children gone."""
    from r2d2_tpu_torch.fleet.service_main import run_kill_drill
    report = bounded(lambda: run_kill_drill(
        DRILL_OVERRIDES, device="cpu", save_dir=str(tmp_path),
        timeout_s=60.0), timeout=180.0)
    assert all(report["verdict"].values()), report
    assert report["reconnects"] >= 1 and report["restored_blocks"] > 0
    assert report["child_exit_codes"][0] == -9
    assert report["child_exit_codes"][1] == 0
    rows = [line for line in open(tmp_path / "service_metrics_p0.jsonl")]
    assert rows and '"final": true' in rows[-1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_service_main_refuses_without_a_card():
    """Without a GPU and without --device=cpu the entry point raises; it
    does not carry on on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.fleet.service_main",
         "--fleet.replay_shards=1", "--max-seconds=1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "replay service:" not in proc.stdout
