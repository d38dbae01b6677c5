"""The port's resource plane (r2d2_tpu_torch/telemetry/resources.py and its
wiring) against the JAX package's on the CPU: the summary keys, the buffer
registry, the monitor's block and its one-shot forensics dump from the
same injected device counters, the host usage, the buffers a Learner
registers (bytes equal to its tensors'), the default ``cli.train`` record
of each package with the same ``resources`` and ``alerts`` keys (apart
from the keys JAX documents as backend-optional, and the port's own
device additions), the kill switch, the health plane on a multi-host
rank's rows, and the device replay's capacity guard reading through the
one memory reader. Inputs come from numpy seeds."""

import json

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.telemetry import resources
from r2d2_tpu_torch.telemetry.resources import (BufferRegistry, HealthPlane,
                                                ResourceMonitor,
                                                device_memory_stats,
                                                pytree_nbytes)

pytestmark = pytest.mark.torch_port

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
    "runtime.log_interval": 0.0, "runtime.weight_publish_interval": 5,
    "runtime.steps_per_dispatch": 1}
# the device entries' keys the JAX package reports only where the backend
# does (its CPU reports none); the port's CUDA reader adds two of its own
BACKEND_OPTIONAL = set(resources.SUMMARY_KEYS) | {"peak_seen",
                                                  "headroom_frac"}
PORT_DEVICE_KEYS = {"kind"} | set(resources.EXTRA_KEYS)


def test_summary_keys_registry_and_host_usage_match_jax():
    from r2d2_tpu.telemetry import resources as j_res
    assert resources.SUMMARY_KEYS == j_res.SUMMARY_KEYS
    ours, theirs = BufferRegistry(), j_res.BufferRegistry()
    rng = np.random.default_rng(0)
    for i in range(20):
        name = f"p{int(rng.integers(0, 3))}/b{int(rng.integers(0, 4))}"
        n = int(rng.integers(0, 1 << 30))
        for reg in (ours, theirs):
            reg.register(name, n)
        if i % 5 == 4:
            for reg in (ours, theirs):
                reg.clear_prefix("p1/")
                reg.unregister("p0/b0")
    assert ours.snapshot() == theirs.snapshot()
    assert ours.total() == theirs.total()
    assert set(resources.host_usage()) == set(j_res.host_usage())
    assert device_memory_stats("cpu") == {}


def _stats_fn(seq):
    it = iter(seq)

    def stats(device):
        return dict(next(it))
    return stats


def test_monitor_block_and_dump_match_jax(tmp_path):
    """Injected counters through both monitors (the device list forced to
    one device): the same devices, headroom, host keys and buffers; the
    first sample under the floor dumps once, in JAX's fields."""
    from r2d2_tpu.telemetry import resources as j_res
    seq = [{"bytes_in_use": 10, "peak_bytes_in_use": 12,
            "bytes_limit": 100, "largest_alloc_size": 4},
           {"bytes_in_use": 97, "peak_bytes_in_use": 99,
            "bytes_limit": 100, "largest_alloc_size": 4},
           {"bytes_in_use": 50, "peak_bytes_in_use": 99,
            "bytes_limit": 100, "largest_alloc_size": 4}]
    reg, jreg = BufferRegistry(), j_res.BufferRegistry()
    for r in (reg, jreg):
        r.register("p0/train_state", 123)
    ours = ResourceMonitor(0, str(tmp_path / "a"), interval_s=0.0,
                           registry=reg, stats_fn=_stats_fn(seq),
                           devices=["cpu"])

    class Dev:
        id, platform = 0, "cpu"

    theirs = j_res.ResourceMonitor(0, str(tmp_path / "b"), interval_s=0.0,
                                   registry=jreg, stats_fn=_stats_fn(seq))
    import jax
    orig = jax.local_devices
    jax.local_devices = lambda: [Dev()]
    try:
        for _ in range(3):
            ours.sample()
            theirs.sample()
            a, b = ours.block(), theirs.block()
            for block in (a, b):
                block["host"] = set(block["host"])
            assert a == b
    finally:
        jax.local_devices = orig
    assert ours.dumped and theirs.dumped
    mine = json.loads(open(ours.dump_path).read())
    jaxs = json.loads(open(theirs.dump_path).read())
    assert set(mine) == set(jaxs) and mine["reason"] == jaxs["reason"]
    assert mine["buffers"] == jaxs["buffers"] == {"p0/train_state": 123}
    assert ours.dump() is None            # one-shot


def test_pytree_nbytes_counts_each_tensor_once():
    from r2d2_tpu_torch.learner.train_step import create_train_state
    from r2d2_tpu_torch.models.network import NetworkApply
    cfg = Config().replace(**TINY)
    net = NetworkApply(6, cfg.network, 2, 24, 24, "cpu")
    for double in (False, True):
        ts = create_train_state(net, cfg.optim, 0, double)
        ts.params.zero_grad(set_to_none=False)
        want = {t.data_ptr(): t.nbytes for t in
                list(ts.params.parameters()) + list(ts.params.buffers())
                + list(ts.target_params.parameters())
                + [v for s in ts.opt.state.values() for v in s.values()
                   if torch.is_tensor(v)] + [ts.step_count]}
        assert pytree_nbytes(ts) == sum(want.values())
    assert pytree_nbytes({"a": torch.zeros(3), "b": [torch.zeros(2, 2)],
                          "c": None, "d": 5}) == 28


def _port_records(tmp_path, mode="process", **overrides):
    from r2d2_tpu_torch.runtime.orchestrator import train
    cfg = Config().replace(**{**TINY, "runtime.save_dir": str(tmp_path),
                              **overrides})
    records = []
    stack = train(cfg, max_training_steps=8, max_seconds=180,
                  actor_mode=mode, device="cpu", log_fn=records.append)
    return records, stack


def _keys(records, block):
    return {k for r in records for k in r.get(block, {})}


def test_cli_train_records_carry_jaxs_resources_and_alerts(tmp_path):
    """A run of each package on the CPU with process actors (cli.train's
    default): every record has ``resources`` and ``alerts`` with JAX's
    keys (the actor slots' gauges from the board included); the port's
    buffers name the train state and the replay ring with their tensors'
    bytes; the compile sub-block no retrace (no capture on the CPU);
    alerts_player0.jsonl exists; with resources off neither block is
    written."""
    from r2d2_tpu.config import Config as JConfig
    from r2d2_tpu.runtime.orchestrator import train as j_train
    ours, stack = _port_records(tmp_path / "port")
    theirs = []
    j_train(JConfig().replace(**{**TINY,
                                 "runtime.save_dir": str(tmp_path / "jax")}),
            max_training_steps=8, max_seconds=180, actor_mode="process",
            log_fn=theirs.append)
    assert ours and all("resources" in r and "alerts" in r for r in ours)
    assert all("resources" in r and "alerts" in r for r in theirs)
    assert _keys(ours, "resources") == _keys(theirs, "resources")
    assert _keys(ours, "alerts") == _keys(theirs, "alerts")
    comp = {k for r in ours for k in r["resources"]["compile"]}
    assert comp == {k for r in theirs for k in r["resources"]["compile"]}
    dev_ours = {k for r in ours for d in r["resources"]["devices"]
                for k in d}
    dev_theirs = {k for r in theirs for d in r["resources"]["devices"]
                  for k in d}
    assert dev_ours - PORT_DEVICE_KEYS == dev_theirs - BACKEND_OPTIONAL
    assert set(ours[-1]["resources"]["host"]) == set(
        theirs[-1]["resources"]["host"])
    # one gauge a slot (an actor publishes at its telemetry flush, which
    # a run this short may not have reached)
    slots = ours[-1]["resources"]["actor_slots"]
    assert set(slots) == set(theirs[-1]["resources"]["actor_slots"])
    assert len(slots["rss_bytes"]) == TINY["actor.num_actors"]
    assert all(r >= 0 for r in slots["rss_bytes"])
    buffers = ours[-1]["resources"]["buffers"]
    learner = stack.learner
    assert buffers["p0/train_state"] == pytree_nbytes(learner.train_state)
    assert buffers["p0/replay_ring"] == sum(
        t.nbytes for t in vars(learner.replay_state).values()
        if torch.is_tensor(t))
    # no graph is captured on the CPU; a host library's first load is
    # the only compile event a run can hold
    comp = ours[-1]["resources"]["compile"]
    assert comp["retraces_total"] == 0 and comp["warm"] is True
    assert comp["compiles_total"] <= 2
    assert (tmp_path / "port" / "alerts_player0.jsonl").exists()
    off, _ = _port_records(tmp_path / "off", "thread",
                           **{"telemetry.resources_enabled": False})
    assert off and not any("resources" in r or "alerts" in r for r in off)


def test_health_plane_annotates_rank_rows(tmp_path):
    """A row with no TrainMetrics (a multi-host rank > 0): ``annotate``
    adds the resources block and the rank's alert pass, firings to its
    own file; the plane is absent with resources off."""
    cfg = Config().replace(**{"runtime.save_dir": str(tmp_path),
                              "telemetry.alerts_heartbeat_age_s": 1.0})
    plane = HealthPlane(cfg, None, 0, devices=["cpu"],
                        alerts_name="alerts_host1.jsonl")
    try:
        row = plane.annotate({"t": 1.0, "heartbeat_age_max_s": 5.0})
        assert set(row["resources"]) >= {"devices", "host", "buffers",
                                         "compile"}
        assert [a["rule"] for a in row["alerts"]["fired"]] == [
            "heartbeat_stale"]
        lines = (tmp_path / "alerts_host1.jsonl").read_text().splitlines()
        assert len(lines) == 1
    finally:
        plane.close()
    assert HealthPlane.from_config(cfg.replace(**{
        "telemetry.resources_enabled": False}), None) is None


def test_capacity_guard_reads_the_one_memory_reader(monkeypatch):
    """The ring's bytes against the card's free bytes as
    device_memory_stats reads them: refused with the numbers, and the
    exact-gather hint where the storage is padded; nothing read on the
    CPU."""
    from r2d2_tpu_torch.replay import device_replay
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    spec = ReplaySpec.from_config(Config().replace(**TINY), "cpu")
    seen = []

    def fake(device):
        seen.append(str(device))
        return ({} if torch.device(device).type == "cpu"
                else {"bytes_free": spec.device_ring_bytes})
    monkeypatch.setattr(resources, "device_memory_stats", fake)
    device_replay._guard_device_capacity(spec, torch.device("cpu"))
    with pytest.raises(ValueError, match="Reduce replay.capacity"):
        device_replay._guard_device_capacity(spec, torch.device("cuda"))
    import dataclasses
    padded = dataclasses.replace(spec, exact_gather=True)
    with pytest.raises(ValueError, match="pallas_exact_gather='off'"):
        device_replay._guard_device_capacity(padded, torch.device("cuda"))
    assert seen == ["cpu", "cuda", "cuda"]


def test_multihost_ranks_carry_their_own_resources_and_alerts(tmp_path):
    """Two loopback controllers on the CPU (parallel/multihost.py's demo):
    rank 0's records and rank 1's host rows each carry ``resources`` (the
    controller's train state and replay shard among the buffers) and an
    ``alerts`` block; rank 1's firings go to alerts_host1.jsonl."""
    from r2d2_tpu_torch.parallel.multihost import launch_demo
    save_dir = tmp_path / "mh"
    # a record every loop turn on rank 0, a host row each on rank 1
    records = launch_demo(2, str(save_dir), 6, 240.0, device="cpu",
                          collective_timeout=60.0,
                          overrides=["--runtime.log_interval=0"])
    assert [r["rank"] for r in records] == [0, 1]
    rank0 = [json.loads(x) for x in open(save_dir / "metrics_player0.jsonl")]
    rank1 = [json.loads(x) for x in open(save_dir / "telemetry_host1.jsonl")]
    for rows in (rank0, rank1):
        assert rows and all("resources" in r and "alerts" in r for r in rows)
        assert {"p0/train_state", "p0/replay_ring"} <= set(
            rows[-1]["resources"]["buffers"])
    assert (save_dir / "alerts_player0.jsonl").exists()
    assert (save_dir / "alerts_host1.jsonl").exists()
