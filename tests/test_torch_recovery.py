"""The port's crash-recovery plane (replay/snapshot.py, the Learner's
snapshot and restore hooks, runtime/supervisor.py) on the CPU, the cases
of the JAX package's tests/test_recovery.py that do not need the fleet:
the snapshot's leaves against JAX's ``capture_plain`` on the same blocks;
the disk round trip bit for bit; a spec mismatch refused; the manifest's
atomic commit and the torn-payload probe; the writer's latest-wins
contract; resume determinism (the resumed learner's next loss equals its
uninterrupted twin's exactly); a resume with no snapshot restoring the
checkpoint only; the snapshot cadence and the final snapshot; the
supervisor's clean exit, resume chain, crash-loop breaker and the CLI's
refusal of a multihost job, with the spawn context replaced by a fake
process; host placement refused; the record unchanged with the plane
off."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.replay import device_replay as tdr
from r2d2_tpu_torch.replay.snapshot import (SnapshotWriter, capture_plain,
                                            load_snapshot, read_manifest,
                                            restore_plain, snapshot_paths,
                                            wait_ready, write_snapshot)
from r2d2_tpu_torch.replay.structs import ReplaySpec, RingAccountant
from r2d2_tpu_torch.runtime.learner_loop import Learner
from tests.test_torch_replay import SPEC, specs, synthetic_blocks
from tests.test_torch_train import TINY_ARGS

pytestmark = pytest.mark.torch_port

LEAVES = ("tree", "obs", "last_action", "hidden", "action", "reward",
          "gamma", "burn_in_steps", "learning_steps", "forward_steps",
          "seq_start", "weight_version", "block_ptr", "lane")


def filled(spec, blocks):
    state = tdr.replay_init(spec, "cpu")
    ring = RingAccountant(spec.num_blocks)
    for blk in blocks:
        tdr.replay_add(spec, state, blk)
        ring.advance(int(np.asarray(blk.learning_steps).sum()),
                     int(blk.weight_version))
    return state, ring


def assert_states_equal(a, b):
    for name, value in vars(b).items():
        got = getattr(a, name)
        assert (torch.equal(got, value) if torch.is_tensor(value)
                else got == value), name


def recovery_learner(save_dir, *extra) -> Learner:
    cfg = parse_overrides(Config(), TINY_ARGS + [
        f"--runtime.save_dir={save_dir}", "--runtime.save_interval=0",
        "--runtime.snapshot_interval=100000",
        "--runtime.steps_per_dispatch=1", *extra])
    net = NetworkApply(18, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    return Learner(cfg, net)


@pytest.mark.parametrize("prio_exponent", [0.9, 1.0])
def test_snapshot_leaves_match_jax_capture_plain(prio_exponent):
    """The same 11 blocks (the 8-row ring wraps) into the port's replay
    and JAX's: the port's snapshot has JAX's leaves one for one, every
    leaf equal (the sum tree exact at prio_exponent 1, at 0.9 its leaves
    within 2.4e-7, pow's last ulp, and its sums at rtol 1e-6), and the
    same ring capture."""
    from r2d2_tpu.replay import device_replay as jdr
    from r2d2_tpu.replay.snapshot import capture_plain as j_capture
    from r2d2_tpu.replay.structs import Block as JBlock
    from r2d2_tpu.replay.structs import RingAccountant as JRing
    jspec, spec = specs(prio_exponent=prio_exponent)
    blocks = synthetic_blocks(spec, 11, seed=2)
    jstate, jring = jdr.replay_init(jspec), JRing(jspec.num_blocks)
    for blk in blocks:
        jstate = jdr.replay_add(jspec, jstate, JBlock(
            **dataclasses.asdict(blk)))
        jring.advance(int(blk.learning_steps.sum()), int(blk.weight_version))
    state, ring = filled(spec, blocks)
    want = j_capture(jspec, jstate, jring, 5, {"env_steps": 3})
    got = wait_ready(capture_plain(spec, state, ring, 5, {"env_steps": 3}))
    jleaves, leaves = want["shards"][0]["state"], got["shards"][0]["state"]
    assert set(leaves) == set(jleaves) == set(LEAVES)
    for name in LEAVES:
        assert leaves[name].dtype == jleaves[name].dtype, name
        if name == "tree" and prio_exponent != 1.0:
            first = 2 ** (spec.tree_layers - 1) - 1
            np.testing.assert_allclose(leaves[name][first:],
                                       jleaves[name][first:], rtol=0,
                                       atol=2.4e-7)
            np.testing.assert_allclose(leaves[name], jleaves[name],
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(leaves[name], jleaves[name],
                                          err_msg=name)
    assert got["shards"][0]["ring"] == {
        k: want["shards"][0]["ring"][k]
        for k in ("ptr", "total_adds", "buffer_steps", "slot_steps",
                  "slot_versions")}
    assert (got["kind"], got["step"], got["extra"]) == \
        (want["kind"], want["step"], want["extra"])


def test_plain_snapshot_roundtrip_bit_for_bit(tmp_path):
    """A wrapped replay and its accountant through the disk and back into
    a fresh replay: every tensor equal, in place (addresses kept), the
    pointer and the accountant equal."""
    spec = ReplaySpec(**SPEC)
    state, ring = filled(spec, synthetic_blocks(spec, 11, seed=3))
    write_snapshot(capture_plain(spec, state, ring, 42, {"env_steps": 99}),
                   str(tmp_path), 1)
    loaded = load_snapshot(str(tmp_path), 1)
    assert loaded["kind"] == "plain" and loaded["step"] == 42
    assert loaded["extra"]["env_steps"] == 99
    fresh, ring2 = tdr.replay_init(spec, "cpu"), RingAccountant(
        spec.num_blocks)
    addresses = {n: t.data_ptr() for n, t in vars(fresh).items()
                 if torch.is_tensor(t)}
    restore_plain(spec, fresh, ring2, loaded)
    assert_states_equal(fresh, state)
    assert addresses == {n: t.data_ptr() for n, t in vars(fresh).items()
                         if torch.is_tensor(t)}
    assert vars(ring2) == vars(ring)


def test_snapshot_spec_mismatch_refused():
    spec = ReplaySpec(**SPEC)
    state, ring = filled(spec, [])
    snap = wait_ready(capture_plain(spec, state, ring, 0))
    other = dataclasses.replace(spec, batch_size=4)
    with pytest.raises(ValueError, match="spec mismatch"):
        restore_plain(other, tdr.replay_init(other, "cpu"),
                      RingAccountant(other.num_blocks), snap)
    with pytest.raises(ValueError, match="not a plain"):
        restore_plain(spec, state, ring, {**snap, "kind": "service"})


def test_manifest_commit_is_atomic_and_a_torn_payload_is_absent(tmp_path):
    """No temporary file is left; read_manifest is the cheap probe; a
    payload whose size no longer matches its manifest reads as no
    snapshot."""
    spec = ReplaySpec(**SPEC)
    state, ring = filled(spec, synthetic_blocks(spec, 2, seed=4))
    write_snapshot(capture_plain(spec, state, ring, 7), str(tmp_path), 0)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    man = read_manifest(str(tmp_path), 0)
    assert man["kind"] == "plain" and man["step"] == 7
    assert man["total_adds"] == 2 and man["payload_bytes"] > 0
    assert read_manifest(str(tmp_path), 3) is None
    payload, _ = snapshot_paths(str(tmp_path), 0)
    data = open(payload, "rb").read()
    with open(payload, "wb") as f:
        f.write(data[:len(data) // 2])
    assert load_snapshot(str(tmp_path), 0) is None
    assert read_manifest(str(tmp_path), 0) is None


def test_snapshot_writer_latest_wins(tmp_path):
    """At most one cut waits (a newer one replaces it, counted dropped);
    every submitted cut is written or dropped after drain; write_now is
    synchronous; stop is idempotent; a failed write is raised at the next
    submit."""
    spec = ReplaySpec(**SPEC)
    state, ring = filled(spec, [])
    w = SnapshotWriter(str(tmp_path), 0)
    n = 6
    for step in range(n):
        w.submit(capture_plain(spec, state, ring, step))
    assert w.drain(10.0)
    assert w.count + w.dropped == n and w.count >= 1
    meta = w.write_now(capture_plain(spec, state, ring, 99))
    assert meta["step"] == 99 == read_manifest(str(tmp_path), 0)["step"]
    assert w.last_meta["step"] == 99
    w.stop()
    w.stop()
    blocked = tmp_path / "file"
    blocked.write_text("x")
    bad = SnapshotWriter(str(blocked / "sub"), 0)    # a file as directory
    bad.submit(capture_plain(spec, state, ring, 1))
    assert bad.drain(10.0)
    with pytest.raises(OSError):
        bad.submit(capture_plain(spec, state, ring, 2))
    bad.stop()


def test_learner_resume_determinism(tmp_path):
    """Checkpoint and snapshot, then the resumed learner is the
    uninterrupted twin: the replay, the ring accountant and the env steps
    equal, the generator's state carried by the snapshot (newer than the
    checkpoint's), and the next step's loss exactly the twin's."""
    lr = recovery_learner(tmp_path)
    try:
        for blk in synthetic_blocks(lr.spec, 6, seed=5):
            lr.ingest(blk)
        lr.step()
        ckpt = lr.save(1)
        # draws past the checkpoint: the snapshot's generator state is the
        # one the next step samples with, the checkpoint's is older
        torch.rand(5, generator=lr.train_state.generator)
        lr.snapshot_replay()
        assert lr._snap_writer.drain(10.0) and lr._snap_writer.count == 1
        man = read_manifest(str(tmp_path), 0)
        assert man["total_adds"] == lr.ring.total_adds == 6
        ref = {n: (t.clone() if torch.is_tensor(t) else t)
               for n, t in vars(lr.replay_state).items()}
        twin_loss = lr.step()["loss"].item()
        resumed = recovery_learner(tmp_path, f"--runtime.resume={ckpt}")
        try:
            assert resumed._restores == 1 and resumed._restored_blocks == 6
            assert vars(resumed.ring) == vars(lr.ring)
            for name, value in ref.items():
                got = getattr(resumed.replay_state, name)
                assert (torch.equal(got, value) if torch.is_tensor(value)
                        else got == value), name
            assert resumed.env_steps == lr.env_steps
            rec = resumed.recovery_block()
            assert rec["restores"] == 1 and rec["restored_blocks"] == 6
            assert resumed.step()["loss"].item() == twin_loss
        finally:
            resumed.stop_background()
    finally:
        lr.stop_background()


def test_resume_without_snapshot_restores_the_checkpoint_only(tmp_path):
    lr = recovery_learner(tmp_path)
    try:
        ckpt = lr.save(1)
    finally:
        lr.stop_background()
    resumed = recovery_learner(tmp_path, f"--runtime.resume={ckpt}")
    try:
        assert resumed._restores == 0
        assert resumed.ring.total_adds == 0 and resumed.ready is False
    finally:
        resumed.stop_background()
    off = recovery_learner(tmp_path, f"--runtime.resume={ckpt}",
                           "--runtime.restore_replay=false")
    try:
        assert off._restores == 0
    finally:
        off.stop_background()


def test_snapshot_cadence_and_the_final_snapshot(tmp_path):
    """step() snapshots at each runtime.snapshot_interval boundary;
    save_final writes one more beside the final checkpoint, at once."""
    lr = recovery_learner(tmp_path, "--runtime.snapshot_interval=2",
                          "--runtime.save_interval=100")
    try:
        for blk in synthetic_blocks(lr.spec, 6, seed=6):
            lr.ingest(blk)
        for _ in range(5):
            lr.step()
        assert lr._snap_writer.drain(10.0)
        w = lr._snap_writer
        assert w.count + w.dropped == 2 and len(lr.snapshot_capture_ms) == 2
        lr.save_final()
        assert read_manifest(str(tmp_path), 0)["step"] == 5
        assert lr.recovery_block()["lost_blocks_est"] == 0
    finally:
        lr.stop_background()


def test_record_unchanged_with_the_plane_off(tmp_path):
    """snapshot_interval 0: no writer, no recovery block, no file, the
    record's keys as before; on: the block is in the record."""
    lr = recovery_learner(tmp_path, "--runtime.snapshot_interval=0")
    try:
        assert lr._snap_writer is None and lr.recovery_block() is None
        for blk in synthetic_blocks(lr.spec, 6, seed=7):
            lr.ingest(blk)
        lr.step()
        lr.metrics.set_recovery(lr.recovery_block)
        rec = lr.metrics.log(1.0)
        assert "recovery" not in rec and json.dumps(rec)
        assert read_manifest(str(tmp_path), 0) is None
    finally:
        lr.stop_background()
    on = recovery_learner(tmp_path)
    try:
        on.metrics.set_recovery(on.recovery_block)
        block = on.metrics.log(1.0)["recovery"]
        assert block["restores"] == 0 and block["supervisor"]["restarts"] \
            == 0 and block["snapshot"]["count"] == 0
    finally:
        on.stop_background()


def test_snapshots_refuse_host_placement():
    with pytest.raises(ValueError, match="snapshot_interval"):
        Config().replace(**{"replay.placement": "host",
                            "runtime.snapshot_interval": 10})
    for bad in ("--runtime.snapshot_interval=-1",):
        with pytest.raises(ValueError, match="snapshot_interval"):
            parse_overrides(Config(), [bad])
    cfg = parse_overrides(Config(), ["--runtime.snapshot_interval=5",
                                     "--runtime.restore_replay=false",
                                     "--runtime.auto_resume=true"])
    assert (cfg.runtime.snapshot_interval, cfg.runtime.restore_replay,
            cfg.runtime.auto_resume) == (5, False, True)
    assert Config.from_json(cfg.to_json()) == cfg


# ---- the supervisor, with a fake child process ---------------------------


class _FakeProc:
    def __init__(self, exitcodes, calls, args):
        self.exitcode = exitcodes.pop(0) if exitcodes else 0
        self.pid = 4242
        calls.append(args)

    def start(self):
        pass

    def is_alive(self):
        return False

    def join(self, timeout=None):
        pass

    def terminate(self):
        pass

    def kill(self):
        pass


class _FakeCtx:
    def __init__(self, exitcodes, calls):
        self._exitcodes, self._calls = exitcodes, calls

    def Process(self, target=None, args=(), name=""):
        return _FakeProc(self._exitcodes, self._calls, args)


def _sup_cfg(tmp_path, **extra) -> Config:
    return Config().replace(**{
        "env.game_name": "Fake", "runtime.save_dir": str(tmp_path),
        "runtime.restart_backoff_base_s": 0.01,
        "runtime.restart_backoff_max_s": 0.02,
        "runtime.max_restarts_per_window": 2,
        "runtime.restart_window_s": 600.0, **extra})


def _patch_ctx(monkeypatch, exitcodes):
    import multiprocessing
    calls = []
    ctx = _FakeCtx(list(exitcodes), calls)
    monkeypatch.setattr(multiprocessing, "get_context",
                        lambda method=None: ctx)
    return calls


def test_supervisor_clean_exit_does_not_relaunch(tmp_path, monkeypatch):
    from r2d2_tpu_torch.runtime.supervisor import supervise_train
    calls = _patch_ctx(monkeypatch, [0])
    assert supervise_train(_sup_cfg(tmp_path), device="cpu") == 0
    assert len(calls) == 1
    assert calls[0][0]["runtime"]["resume"] == "" and calls[0][5] == "cpu"
    assert not os.path.exists(tmp_path / "learner.pid")
    assert not torch.cuda.is_initialized()


def test_supervisor_resume_chain(tmp_path, monkeypatch):
    """A crashed child is relaunched from the newest checkpoint (pretrain
    cleared), the restart count passed on."""
    from r2d2_tpu_torch.runtime.supervisor import supervise_train
    os.makedirs(tmp_path / "Fake3_player0")
    os.makedirs(tmp_path / "Fake7_player0")
    calls = _patch_ctx(monkeypatch, [-9, 0])
    cfg = _sup_cfg(tmp_path, **{"runtime.pretrain": "w"})
    assert supervise_train(cfg) == 1
    assert len(calls) == 2
    assert calls[0][0]["runtime"]["resume"] == ""
    assert calls[1][0]["runtime"]["resume"].endswith("Fake7_player0")
    assert calls[1][0]["runtime"]["pretrain"] == ""
    assert calls[1][4] == 1


def test_supervisor_crash_loop_breaker(tmp_path, monkeypatch):
    from r2d2_tpu_torch.runtime.supervisor import supervise_train
    calls = _patch_ctx(monkeypatch, [1, 1, 1, 1, 1])
    with pytest.raises(RuntimeError, match="crash-loop breaker"):
        supervise_train(_sup_cfg(tmp_path))
    assert len(calls) == 3


def test_cli_routes_auto_resume_and_refuses_multihost(tmp_path, monkeypatch):
    """cli.train hands --runtime.auto_resume to the supervisor (the child
    gets the device flag); the supervisor refuses a multi-process
    multihost job before any child starts (the cluster's scheduler
    supervises such jobs, as in the JAX package)."""
    from r2d2_tpu_torch.cli import train
    calls = _patch_ctx(monkeypatch, [0])
    out = train.main(["--runtime.auto_resume=true", "--device=cpu",
                      "--actor-mode=thread", "--max-steps=3",
                      f"--runtime.save_dir={tmp_path}"])
    assert out == {"supervised": True, "restarts": 0}
    assert calls[0][1:4] == ("thread", 3, None) and calls[0][5] == "cpu"
    with pytest.raises(NotImplementedError, match="multihost"):
        train.main(["--runtime.auto_resume=true", "--mesh.multihost=true",
                    "--mesh.num_processes=2", "--mesh.dp=2"])
    assert len(calls) == 1
