"""Declarative alerting over the periodic metrics records, the JAX
package's ``telemetry/alerts.py``: a small rule engine evaluated once a
record, at the log boundary, inside ``TrainMetrics.log`` on the assembled
record, so every record carries an ``alerts`` block and every firing
appends one line to ``alerts_player{p}.jsonl`` (``serve_alerts.jsonl``
for ``cli.serve``, ``alerts_host{r}.jsonl`` on a multi-host rank > 0).

Rules are data (:class:`AlertRule`): a kind, a key path into the record,
and a bound. Four kinds:

  * ``threshold`` — value crosses a bound (heartbeat age, device memory
    headroom with ``below=True``, the interval's retraces, non-finite
    steps);
  * ``drop``      — value falls below ``bound x`` the rolling median of
    the previous ``window`` records (throughput collapse; warm-up zeros
    never enter the median, so the rule arms only once the metric has
    been healthy for a full window);
  * ``growth``    — value exceeds ``bound x`` the rolling median
    (sample-age creep);
  * ``counter``   — a cumulative counter increased since the last record
    (hang detections, restarts): one increment fires exactly once; the
    baseline starts at zero.

Level-triggered kinds (threshold/drop/growth) fire on the
inactive->active edge and stay silently active until the condition
clears; recovery re-arms the rule. Rules whose block a record lacks
stay inactive on it: the replay service's ``replay_service`` block
(spill, promotion latency, ingest) and the ``trace`` block exist under
``fleet.replay_shards`` and ``telemetry.tracing_enabled``; the fan-out,
membership, promotion, quality and tower blocks are not emitted yet.
"""

import json
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

_KINDS = ("threshold", "drop", "growth", "counter")


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule. ``path`` walks nested dicts of the periodic
    record (``("learning", "sample_age", "p50")``); missing keys / None
    values leave the rule inactive (never a false fire on a record that
    simply lacks the block)."""

    name: str
    kind: str                    # threshold | drop | growth | counter
    path: Tuple[str, ...]
    bound: float
    severity: str = "warn"       # warn | crit
    below: bool = False          # threshold: fire when value <= bound
    window: int = 8              # drop/growth rolling-median window

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"alert rule {self.name!r}: unknown kind {self.kind!r} "
                f"(expected one of {_KINDS})")
        if self.kind in ("drop", "growth") and self.window < 2:
            raise ValueError(
                f"alert rule {self.name!r}: window must be >= 2")


def record_value(record: dict, path: Sequence[str]) -> Optional[float]:
    """Walk a key path into the record; None for missing/None/non-numeric
    leaves (absent blocks must read as 'no data', not as zero)."""
    node: Any = record
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    if node is None or isinstance(node, (dict, list, str)):
        return None
    try:
        return float(node)
    except (TypeError, ValueError):
        return None


def default_rules(tcfg) -> Tuple[AlertRule, ...]:
    """The stock rule set, parameterized by the TelemetryConfig
    ``alerts_*`` knobs — what the orchestrator, on-device, multi-host
    and serving loops install."""
    w = tcfg.alerts_window
    return (
        # throughput collapse vs the run's own recent history: the first
        # signal — a parked fleet or wedged stager shows here first
        AlertRule("env_throughput_drop", "drop", ("buffer_speed",),
                  tcfg.alerts_throughput_drop_frac, "crit", window=w),
        AlertRule("learner_throughput_drop", "drop", ("training_speed",),
                  tcfg.alerts_throughput_drop_frac, "crit", window=w),
        # an actor the watchdog had to declare hung (cumulative counter:
        # one hang -> exactly one alert)
        AlertRule("actor_stall", "counter", ("actor_hangs_detected",),
                  1.0, "crit"),
        AlertRule("actor_restart", "counter", ("actor_restarts",), 1.0,
                  "warn"),
        AlertRule("heartbeat_stale", "threshold", ("heartbeat_age_max_s",),
                  tcfg.alerts_heartbeat_age_s, "warn"),
        # replay staleness creep: sample ages growing past a multiple of
        # their own recent median (weight publication or ingestion lagging)
        AlertRule("staleness_growth", "growth",
                  ("learning", "sample_age", "p50"),
                  tcfg.alerts_staleness_growth_factor, "warn", window=w),
        # machine-side rules (the resources block)
        AlertRule("hbm_headroom", "threshold",
                  ("resources", "hbm_headroom_frac_min"),
                  tcfg.alerts_hbm_headroom_frac, "crit", below=True),
        AlertRule("retrace_storm", "threshold",
                  ("resources", "compile", "retraces_interval"),
                  float(tcfg.alerts_retrace_storm), "crit"),
        AlertRule("nan", "threshold", ("learning", "nonfinite_steps"),
                  1.0, "crit"),
        # sharded-anakin balance: max/min per-shard env-steps
        # over the interval, measured from the blocks each shard's ring
        # actually received. Today's lockstep program emits full blocks
        # on every shard every segment, so this reads exactly 1.0 and
        # the rule stays silent BY CONSTRUCTION — it is the standing
        # guard for the compositions that can skew it (ragged/partial
        # per-shard emission, elastic meshes with parked shards), where
        # the lockstep program would run at the slowest shard's pace.
        # Inactive on non-anakin runs (no block).
        AlertRule("shard_imbalance", "threshold",
                  ("anakin", "shard_imbalance"),
                  tcfg.alerts_shard_imbalance, "warn"),
        # replay & data-pathology rules:
        # priority collapse = the sampling distribution's effective
        # sample size shrank to a sliver of the live leaves (training is
        # grinding a handful of sequences)
        AlertRule("priority_collapse", "threshold",
                  ("replay_diag", "tree", "ess_frac"),
                  tcfg.alerts_replay_ess_frac, "warn", below=True),
        # a mass of leaves tied at the tree max: prioritization has
        # stopped discriminating (constant-stamp seeding never resampled,
        # or TD errors saturating)
        AlertRule("priority_saturation", "threshold",
                  ("replay_diag", "tree", "frac_at_max"),
                  tcfg.alerts_priority_saturation, "warn"),
        # replay sized/prioritized wrong: the share of experience evicted
        # without EVER being sampled is growing past its own history.
        # Watches the PER-INTERVAL fraction — the cumulative one's
        # per-window change decays as 1/t and would mask late-onset
        # pathology behind a long healthy prefix.
        AlertRule("never_sampled_growth", "growth",
                  ("replay_diag", "evictions", "interval",
                   "never_sampled_frac"),
                  tcfg.alerts_never_sampled_growth, "warn", window=w),
        # ε-ladder lanes contributing nothing to the learning signal —
        # Ape-X exploration measured at the point of learning
        AlertRule("lane_starvation", "threshold",
                  ("replay_diag", "lanes", "starved_frac"),
                  tcfg.alerts_lane_starved_frac, "warn"),
        # fleet rules:
        # one rank's mean step time running a multiple of the fastest
        # rank's — under lockstep the WHOLE pod runs at its pace
        AlertRule("rank_straggler", "threshold",
                  ("fleet", "step_time", "skew"),
                  tcfg.alerts_rank_straggler, "warn"),
        # this rank's loop time is mostly spent blocked in the per-
        # iteration psum — the DCN barrier (or a peer) owns the step
        AlertRule("lockstep_wait_frac", "threshold",
                  ("fleet", "lockstep", "wait_frac"),
                  tcfg.alerts_lockstep_wait_frac, "warn"),
        # per-rank ingested env-steps diverging: one host's actors are
        # starving its replay shards relative to the fleet
        AlertRule("fleet_desync", "threshold",
                  ("fleet", "env_steps", "divergence"),
                  tcfg.alerts_fleet_desync, "warn"),
        # a rank stopped writing its host row (rank-0 view): wedged or
        # dead past the heartbeat horizon
        AlertRule("missing_rank", "threshold",
                  ("fleet", "host_rows", "max_age_s"),
                  tcfg.alerts_missing_rank_age_s, "crit"),
        # serving-plane rules:
        # client-visible request latency P99 over the SLO ceiling —
        # includes queueing, retries, and timed-out attempts, so a dead
        # or wedged server fires this DURING the outage, and recovery
        # re-arms it (the chaos drill's acceptance)
        AlertRule("serve_latency_slo", "threshold",
                  ("serving", "latency", "p99_ms"),
                  tcfg.alerts_serve_p99_ms, "crit"),
        # the micro-batcher dispatching singletons despite >1 connected
        # clients: batching is not coalescing under load (deadline too
        # tight for the arrival cadence, or clients serialized)
        AlertRule("serve_batch_starvation", "threshold",
                  ("serving", "batch", "starved_frac"),
                  tcfg.alerts_serve_starved_frac, "warn"),
        # a burst of client disconnects within one interval (cumulative
        # counter: one burst, one alert) — flapping clients or a
        # lease-thrashing cache
        AlertRule("serve_client_churn", "counter",
                  ("serving", "clients", "disconnects"),
                  tcfg.alerts_serve_churn, "warn"),
        # brownout: the interval's shed fraction crossed the ceiling — the
        # fleet is rejecting a sustained share of offered load at the
        # queue-depth bound, i.e. under-provisioned, not just bursty
        AlertRule("serve_brownout", "threshold",
                  ("serving", "admission", "shed_frac"),
                  tcfg.alerts_serve_shed_frac, "warn"),
        # quantized-inference rule: the interval's lane-weighted
        # greedy-action agreement between the quantized forward and its
        # f32 twin fell to/below the floor — the quantized policy has
        # stopped acting like the policy the learner is training. A
        # probe-free interval carries agree_frac=None, which HOLDS the
        # rule (no data ≠ recovery).
        AlertRule("quant_divergence", "threshold",
                  ("quant", "agree_frac"),
                  tcfg.alerts_quant_agreement, "warn", below=True),
        # elastic-fleet rules:
        # spill thrash — the interval's demoted pages are falling off
        # the LRU end before re-promotion (eviction/demotion ratio): the
        # device ring turns over faster than the spill tier can cycle
        # experience back, so the tier is pure write-through loss
        AlertRule("spill_thrash", "threshold",
                  ("replay_service", "spill", "thrash_frac"),
                  tcfg.alerts_spill_thrash_frac, "warn"),
        # a weight-tree relay stopped propagating: its subtree's actors
        # act publications behind the learner (max root-to-relay lag)
        AlertRule("fanout_lag", "threshold",
                  ("replay_service", "fanout", "max_lag"),
                  tcfg.alerts_fanout_lag, "warn"),
        # a leased slot went silent without being parked or re-adopted —
        # a leaked lease the membership plane cannot fill (crit: the
        # fleet is silently narrower than the lease table claims)
        AlertRule("orphaned_slot", "threshold",
                  ("replay_service", "membership", "orphaned"),
                  tcfg.alerts_orphaned_slots, "crit"),
        # batched service ingest:
        # blocks left queued behind the service's grouped drain —
        # producers burst faster than the dispatch plane commits, so
        # experience ages in the feeder queue before ever becoming
        # samplable
        AlertRule("ingest_backlog", "threshold",
                  ("replay_service", "ingest", "backlog"),
                  tcfg.alerts_ingest_backlog, "warn"),
        # per-tier replay telemetry: pages promoted this interval
        # sat demoted longer than the ceiling before coming back — the
        # spill tier is a parking lot, not a cache (experience ages out
        # of relevance before it becomes samplable again)
        AlertRule("spill_promotion_latency", "threshold",
                  ("replay_service", "spill", "promotion_latency",
                   "p95_ms"),
                  tcfg.alerts_spill_promotion_ms, "warn"),
        # cross-plane tracing:
        # the end-to-end env-step -> gradient latency grew past a
        # multiple of its own recent median — experience is aging
        # somewhere between emission and consumption (ingest backlog,
        # spill churn, or a starved sampler; the per-hop breakdown in
        # the same block says which)
        AlertRule("e2e_latency_growth", "growth",
                  ("trace", "e2e_experience_latency", "p95_ms"),
                  tcfg.alerts_e2e_latency_growth, "warn", window=w),
        # crash-recovery rules:
        # the newest durable replay snapshot is older than the ceiling —
        # a crash now would lose more experience than the plane promises
        # (the writer thread wedged, or the interval is mis-sized)
        AlertRule("snapshot_stale", "threshold",
                  ("recovery", "snapshot", "age_s"),
                  tcfg.alerts_snapshot_stale_s, "warn"),
        # the supervisor has relaunched the learner repeatedly — a
        # crash LOOP, not a one-off preemption; the breaker is about to
        # (or did) give up, and every lap replays the snapshot window
        AlertRule("recovery_loop", "threshold",
                  ("recovery", "supervisor", "restarts"),
                  tcfg.alerts_recovery_loop, "crit"),
        # policy-quality rules:
        # the continuous-eval mean return fell below a fraction of its
        # own recent median — the policy the fleet is serving got WORSE
        # (regression past the publish boundary, not just a noisy
        # episode; eval snapshots persist across intervals so the
        # median is over real evals)
        AlertRule("quality_regression", "drop",
                  ("quality", "eval", "mean_return"),
                  tcfg.alerts_quality_regression, "warn", window=w),
        # shadow-scored candidate disagreeing with the live policy past
        # the bound — the canary under evaluation does not act like the
        # policy it would replace (crit: promotion must not proceed). A
        # shadow-free interval carries divergence=None, which HOLDS the
        # rule (no data ≠ recovery).
        AlertRule("canary_divergence", "threshold",
                  ("quality", "shadow", "divergence"),
                  tcfg.alerts_canary_divergence, "crit"),
        # a canary has been staged longer than the ceiling without a
        # promote/refuse/rollback decision — the deployment plane is
        # wedged mid-promotion and part of the fleet is serving an
        # unvetted candidate (age_s is None outside the canary state,
        # so the rule is inactive the rest of the time)
        AlertRule("promotion_stall", "threshold",
                  ("quality", "promotion", "age_s"),
                  tcfg.alerts_promotion_stall_s, "warn"),
    )


@dataclass
class _RuleState:
    active: bool = False
    history: deque = field(default_factory=deque)
    last_counter: Optional[float] = None


class AlertEngine:
    """Evaluates the rule set against each periodic record; returns the
    record's ``alerts`` block and appends fired alerts to the JSONL
    stream. One engine per metrics stream (player), attached via
    :meth:`TrainMetrics.set_sentinel`."""

    def __init__(self, rules: Sequence[AlertRule],
                 jsonl_path: Optional[str] = None, resume: bool = False):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names in {names}")
        self.rules = tuple(rules)
        self._state = {r.name: _RuleState(
            history=deque(maxlen=r.window)) for r in self.rules}
        self.fired_total = 0
        self._jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            if not resume:
                # fresh run truncates, resume appends — the TrainMetrics
                # JSONL contract
                open(jsonl_path, "w").close()

    @property
    def active(self) -> List[str]:
        return sorted(n for n, s in self._state.items() if s.active)

    def evaluate(self, record: dict) -> dict:
        """One pass over all rules → the record's ``alerts`` block:
        ``{"active": [names], "fired": [alert dicts]}``. Consumes the
        record in order (counter baselines, history windows advance)."""
        fired: List[dict] = []
        for rule in self.rules:
            value = record_value(record, rule.path)
            st = self._state[rule.name]
            was_active = st.active
            active, detail = self._eval(rule, st, value)
            st.active = active
            if active and not was_active:
                alert = {"rule": rule.name, "severity": rule.severity,
                         "value": value, "bound": rule.bound, **detail}
                fired.append(alert)
        if fired:
            self.fired_total += len(fired)
            self._append(record, fired)
        return {"active": self.active, "fired": fired}

    def _eval(self, rule: AlertRule, st: _RuleState,
              value: Optional[float]) -> Tuple[bool, dict]:
        if rule.kind == "counter":
            # cumulative counter: edge per increase of >= bound. The
            # baseline starts at ZERO, not at the first observation —
            # health counters are process-local and start at 0 in fresh
            # and resumed runs alike, and a hang detected during warm-up
            # (before the first log boundary) must still alert when the
            # first record arrives already carrying the count.
            if value is None:
                return False, {}
            prev, st.last_counter = st.last_counter, value
            prev = 0.0 if prev is None else prev
            if value - prev >= rule.bound:
                return True, {"delta": value - prev}
            return False, {}
        if value is None:
            # no data: level rules hold their state (a training pause must
            # not read as recovery + refire); history simply doesn't grow
            return st.active, {}
        if rule.kind == "threshold":
            hit = value <= rule.bound if rule.below else value >= rule.bound
            return hit, {}
        # drop / growth: compare against the rolling median of PREVIOUS
        # healthy observations, then admit the value to the window
        baseline = None
        if len(st.history) == st.history.maxlen:
            baseline = float(np.median(st.history))
        active = st.active
        detail: dict = {}
        if baseline is not None and baseline > 0:
            if rule.kind == "drop":
                active = value < rule.bound * baseline
            else:
                active = value > rule.bound * baseline
            detail = {"baseline": round(baseline, 3)}
        # zeros never enter the median: a warm-up/paused interval would
        # otherwise poison the 'healthy' baseline both kinds compare to
        if value > 0 and not active:
            st.history.append(value)
        return active, detail if active else {}

    def _append(self, record: dict, fired: List[dict]) -> None:
        if not self._jsonl_path:
            return
        with open(self._jsonl_path, "a") as f:
            for alert in fired:
                row = {"t": record.get("t"),
                       "training_steps": record.get("training_steps"),
                       "env_steps": record.get("env_steps"), **alert}
                f.write(json.dumps(row) + "\n")
