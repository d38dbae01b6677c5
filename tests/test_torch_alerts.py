"""The port's alert engine (r2d2_tpu_torch/telemetry/alerts.py) against the
JAX package's on the CPU: the stock rule set under the same config, the
key-path reader, and one seeded sequence of periodic records through both
engines: the records' ``alerts`` blocks and the jsonl lines equal. The
config's ``alerts_*`` fields carry JAX's defaults and bounds, and
``cli.serve`` writes ``serve_alerts.jsonl``. Inputs come from numpy seeds."""

import json

import numpy as np
import torch
import pytest

from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.telemetry.alerts import (AlertEngine, AlertRule,
                                             default_rules, record_value)

pytestmark = pytest.mark.torch_port

ALERT_FIELDS = [f for f in Config().telemetry.__dataclass_fields__
                if f.startswith("alerts_")]


def _rule_tuple(rule):
    return (rule.name, rule.kind, tuple(rule.path), rule.bound,
            rule.severity, rule.below, rule.window)


@pytest.mark.parametrize("overrides", [
    {}, {"alerts_window": 3, "alerts_retrace_storm": 1,
         "alerts_hbm_headroom_frac": 0.5, "alerts_serve_p99_ms": 20.0}],
    ids=["defaults", "overridden"])
def test_default_rules_match_jax(overrides):
    from r2d2_tpu.config import Config as JConfig
    from r2d2_tpu.telemetry.alerts import default_rules as j_rules
    ours = Config().replace(**{f"telemetry.{k}": v
                               for k, v in overrides.items()})
    theirs = JConfig().replace(**{f"telemetry.{k}": v
                                  for k, v in overrides.items()})
    assert ([_rule_tuple(r) for r in default_rules(ours.telemetry)]
            == [_rule_tuple(r) for r in j_rules(theirs.telemetry)])


def test_alert_fields_defaults_and_bounds_match_jax():
    """Every ``alerts_*`` field the rules read, with JAX's default; each
    bound refused with JAX's message; the fleet telemetry's fields
    refused naming ROADMAP A.6 and A.7, the replay tiers' switch taken
    with JAX's default."""
    from r2d2_tpu.config import Config as JConfig
    ours, theirs = Config(), JConfig()
    assert set(ALERT_FIELDS) == {f for f in theirs.telemetry
                                 .__dataclass_fields__
                                 if f.startswith("alerts_")}
    for name in ALERT_FIELDS + ["resources_enabled", "resources_interval_s",
                                "resources_headroom_warn_frac",
                                "compile_enabled", "alerts_enabled",
                                "tracing_enabled", "trace_sample_every"]:
        assert (getattr(ours.telemetry, name)
                == getattr(theirs.telemetry, name)), name
    for name, bad in (("alerts_window", 1), ("alerts_retrace_storm", 0),
                      ("alerts_hbm_headroom_frac", 1.0),
                      ("alerts_throughput_drop_frac", 0.0),
                      ("alerts_staleness_growth_factor", 1.0),
                      ("resources_interval_s", 0.0),
                      ("trace_sample_every", 0)):
        with pytest.raises(ValueError, match=name):
            ours.replace(**{f"telemetry.{name}": bad})
        with pytest.raises(ValueError, match=name):
            theirs.replace(**{f"telemetry.{name}": bad})
    for name in ("fleet_enabled", "fleet_host_row_max_bytes"):
        with pytest.raises(SystemExit, match="A.6.*second part"):
            parse_overrides(ours, [f"--telemetry.{name}=true"])
    assert (ours.telemetry.replay_tiers_enabled
            == theirs.telemetry.replay_tiers_enabled)
    assert parse_overrides(ours, ["--telemetry.replay_tiers_enabled=true"]
                           ).telemetry.replay_tiers_enabled


@pytest.mark.parametrize("path, want", [
    (("a",), 1.0), (("b", "c"), 2.5), (("b", "d"), None), (("e",), None),
    (("f",), None), (("g",), None), (("b",), None), (("a", "x"), None)])
def test_record_value_matches_jax(path, want):
    from r2d2_tpu.telemetry.alerts import record_value as j_value
    record = {"a": 1, "b": {"c": 2.5, "d": None}, "f": "text", "g": [1]}
    assert record_value(record, path) == j_value(record, path) == want


def test_rule_validation_matches_jax():
    from r2d2_tpu.telemetry.alerts import AlertRule as JRule
    for cls in (AlertRule, JRule):
        with pytest.raises(ValueError, match="unknown kind"):
            cls("x", "level", ("a",), 1.0)
        with pytest.raises(ValueError, match="window"):
            cls("x", "drop", ("a",), 0.5, window=1)


def _records(seed: int, n: int = 40):
    """A run's records: throughput that collapses and recovers, counters
    that step, a headroom that dips below the floor twice, retrace bursts,
    non-finite steps, a serving block on some records, blocks missing on
    others."""
    rng = np.random.default_rng(seed)
    out = []
    hangs = restarts = disconnects = 0
    for i in range(n):
        speed = float(rng.uniform(80, 120))
        if 15 <= i < 19 or 30 <= i < 32:
            speed *= float(rng.uniform(0.05, 0.3))
        hangs += int(rng.random() < 0.1)
        restarts += int(rng.random() < 0.15)
        disconnects += int(rng.integers(0, 3))
        rec = {"t": float(i), "training_steps": 10 * i, "env_steps": 100 * i,
               "buffer_speed": float(rng.uniform(900, 1100)),
               "training_speed": speed if i > 2 else 0.0,
               "actor_hangs_detected": hangs, "actor_restarts": restarts,
               "heartbeat_age_max_s": float(rng.uniform(0, 200)),
               "resources": {
                   "hbm_headroom_frac_min": (0.01 if i in (7, 8, 25)
                                             else 0.4),
                   "compile": {"retraces_interval":
                               int(rng.integers(0, 5))}},
               "learning": {"sample_age": {"p50": float(rng.uniform(1, 3))
                                           * (10 if i == 35 else 1)},
                            "nonfinite_steps": int(rng.random() < 0.05)}}
        if i % 3 == 0:
            rec["serving"] = {"latency": {"p99_ms":
                                          float(rng.uniform(1, 1500))},
                              "batch": {"starved_frac":
                                        float(rng.uniform(0, 1))},
                              "clients": {"disconnects": disconnects}}
        if i % 7 == 0:
            del rec["resources"]
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_blocks_and_jsonl_match_jax(tmp_path, seed):
    from r2d2_tpu.config import Config as JConfig
    from r2d2_tpu.telemetry.alerts import AlertEngine as JEngine
    from r2d2_tpu.telemetry.alerts import default_rules as j_rules
    ours = AlertEngine(default_rules(Config().telemetry),
                       jsonl_path=str(tmp_path / "ours.jsonl"))
    theirs = JEngine(j_rules(JConfig().telemetry),
                     jsonl_path=str(tmp_path / "theirs.jsonl"))
    fired = 0
    for rec in _records(seed):
        a, b = ours.evaluate(dict(rec)), theirs.evaluate(dict(rec))
        assert a == b
        fired += len(a["fired"])
    assert fired > 0 and ours.fired_total == theirs.fired_total == fired
    lines = (tmp_path / "ours.jsonl").read_text().splitlines()
    assert lines == (tmp_path / "theirs.jsonl").read_text().splitlines()
    assert len(lines) == fired
    assert ours.active == theirs.active
    # a resumed engine appends; a fresh one truncates, as JAX's
    AlertEngine(default_rules(Config().telemetry),
                jsonl_path=str(tmp_path / "ours.jsonl"), resume=True)
    assert (tmp_path / "ours.jsonl").read_text().splitlines() == lines
    AlertEngine(default_rules(Config().telemetry),
                jsonl_path=str(tmp_path / "ours.jsonl"))
    assert (tmp_path / "ours.jsonl").read_text() == ""


def test_duplicate_rule_names_are_refused():
    rule = AlertRule("x", "threshold", ("a",), 1.0)
    with pytest.raises(ValueError, match="duplicate"):
        AlertEngine([rule, rule])


def test_cli_serve_writes_alerts_and_the_process_header(tmp_path):
    """``cli.serve`` on the CPU (tiny shape): every record carries the
    ``proc`` header and an ``alerts`` block, and ``serve_alerts.jsonl``
    exists; with alerts off, no block and no file."""
    from r2d2_tpu_torch.cli import serve
    tiny = ["--env.frame_height=24", "--env.frame_width=24",
            "--env.frame_stack=2", "--network.hidden_dim=16",
            "--network.cnn_out_dim=32", "--network.conv_layers=8,4,2;16,3,1",
            "--runtime.log_interval=0.2", "--serve.max_batch=4"]
    for alerts in (True, False):
        d = tmp_path / str(alerts)
        serve.main(["--device=cpu", "--seconds", "0.6", "--save-dir", str(d),
                    f"--telemetry.alerts_enabled={str(alerts).lower()}",
                    *tiny])
        records = [json.loads(x) for x in open(d / "serve_metrics.jsonl")]
        assert records and records[-1]["final"]
        assert all({"plane", "pid", "clock_anchor"} <= set(r["proc"])
                   for r in records)
        assert all(("alerts" in r) == alerts for r in records)
        assert (d / "serve_alerts.jsonl").exists() == alerts


def test_replay_plane_rules_are_live_on_the_services_blocks():
    """The replay plane's rules read blocks the port now emits: records
    carrying a port ReplayService's ``replay_service`` block (a one-page
    tier that thrashes, promotions with the tier stats on, grouped adds
    with a backlog noted at the drain) and an
    ExperienceTrace ``trace`` block (the service's lineage lookups, the
    emit stamps aging after ten records) fire spill_thrash,
    ingest_backlog, spill_promotion_latency and e2e_latency_growth, the
    two engines alike; fanout_lag and orphaned_slot find no block."""
    from r2d2_tpu.config import Config as JConfig
    from r2d2_tpu.telemetry.alerts import AlertEngine as JEngine
    from r2d2_tpu.telemetry.alerts import default_rules as j_rules
    from r2d2_tpu_torch.fleet.replay_service import ReplayService
    from r2d2_tpu_torch.replay.structs import with_trace
    from r2d2_tpu_torch.telemetry.tracing import ExperienceTrace, now_ms
    from tests.test_torch_replay import specs, synthetic_blocks
    bounds = {"alerts_spill_promotion_ms": 1e-6, "alerts_ingest_backlog": 4,
              "alerts_window": 4}
    ours = AlertEngine(default_rules(Config().replace(**{
        f"telemetry.{k}": v for k, v in bounds.items()}).telemetry))
    theirs = JEngine(j_rules(JConfig().replace(**{
        f"telemetry.{k}": v for k, v in bounds.items()}).telemetry))
    _, spec = specs(num_blocks=2, prio_exponent=1.0)
    svc = ReplayService(spec, 1, "cpu", spill_blocks=1, promote_per_sample=1,
                        ingest_batch_blocks=2, tier_stats=True)
    trace = ExperienceTrace()
    gen = torch.Generator().manual_seed(0)
    fired, rules = [], [r for r in default_rules(Config().telemetry)
                        if r.name in ("fanout_lag", "orphaned_slot")]
    blocks = synthetic_blocks(spec, 48, seed=3)
    for i in range(24):
        age = 50 if i < 10 else 5000
        svc.add_blocks([with_trace(blk, np.int32(now_ms() - age))
                        for blk in blocks[2 * i:2 * i + 2]])
        svc.note_backlog(8 if i % 5 == 4 else 0)
        batch, shard, _ = svc.sample(gen)
        trace.on_train(trace.on_sample(
            svc.trace_lookup(shard, batch.idxes.numpy())))
        rec = {"t": float(i), "replay_service": svc.interval_block(),
               "trace": trace.interval_block()}
        assert all(record_value(rec, r.path) is None for r in rules)
        a, b = ours.evaluate(dict(rec)), theirs.evaluate(dict(rec))
        assert a == b
        fired += [f["rule"] for f in a["fired"]]
    assert {"spill_thrash", "ingest_backlog", "spill_promotion_latency",
            "e2e_latency_growth"} <= set(fired), fired
