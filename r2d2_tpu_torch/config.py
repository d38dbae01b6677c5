"""Configuration of the PyTorch port: the env, network, sequence, replay,
optim, actor, runtime and mesh sections of the JAX package's config, with
the same field names and defaults, so a ``--section.field=value`` override
means the same thing in both packages. Only the fields the port reads are
here: a setting of a part the port does not have yet
(``--fleet.fanout_degree=2``, ``--multiplayer.player_id=0``, ...) is
refused as an unknown field instead of being ignored, and a value the port
cannot honour yet is refused naming the item that brings it: ``mesh.mp >
1`` under ``mesh.multihost`` (ROADMAP A.4) and ``serve.servers > 1``
(A.6). ``actor.on_device`` with ``mesh.mp > 1`` is refused in the JAX
package's words, as it refuses it. The telemetry section holds the master
switch ``enabled``, the learning diagnostics (``learning_enabled``,
``learning_interval``, ``learning_dq_batch``, ``nan_policy``), the replay
diagnostics (``replay_diag_enabled``, ``replay_diag_interval``) and
``quant_probe_interval``, the stage timers' and spans' fields
(``ring_size``, ``flush_interval_s``, ``spans``), the cost model's switch
(``costmodel_enabled``), the resource, compile and alert planes
(``resources_*``, ``compile_enabled``, ``alerts_enabled`` and every
``alerts_*`` bound) and tracing (``tracing_enabled``,
``trace_sample_every``) and the replay service's tiers
(``replay_tiers_enabled``); its fleet-plane fields (``fleet_enabled``,
``fleet_host_row_max_bytes``) and its quality and tower fields are
refused as unknown fields naming A.7. The fleet section holds the replay
plane's fields (``fleet.replay_shards`` and the service's spill tier,
routing, socket rung, grouped ingest and staging, ``FleetConfig``); its
membership, fan-out and promotion fields are refused naming ROADMAP
A.6's second part.

The tri-state knobs ("on"/"off"/"auto") resolve for the device the port
runs on, never for a TPU:

* kernel knobs (``replay.pallas_sample_gather``, ``optim.pallas_obs_decode``)
  name the hand-written CUDA kernels. A CUDA tensor always goes through its
  kernel and a CPU tensor through the plain PyTorch version, so "auto" is
  the only setting valid on both; "on" on the CPU and "off" on CUDA raise.
* ``network.bf16``: "auto" = bf16 on CUDA, f32 on the CPU.
* ``network.pallas_lstm`` picks a path, not a route: "on" runs the LSTM
  time scan (T > 1) as one fused scan (``ops/lstm_kernels.py``: the kernels
  on CUDA, their plain versions on the CPU), "off" (the default) the Python
  scan. "auto" = the faster path as ``tools/bench.py`` measured it on CUDA
  (``CUDA_AUTO``), off on the CPU. Its TPU grid and debug knobs
  (``pallas_lstm_block``, ``pallas_lstm_interpret``) have no meaning on the
  card and are refused.
* ``optim.fused_double_unroll`` (double DQN only) is parsed and checked as
  in the JAX package, where "on" interleaves the online and target unrolls
  in one time loop. Here both values run the same two unrolls
  (``models/network.py dual_sequence_q``); "auto" resolves as for
  pallas_lstm.
* ``runtime.steps_per_dispatch``: learner steps per dispatch, one CUDA graph
  of K steps on the card, K = 1 too (``learner/train_step.py
  make_dispatch_step``). -1 = ``CUDA_AUTO``'s 4 on CUDA, 1 on the CPU.
* ``network.space_to_depth``: "on"/"off" only, as in the JAX package: it
  picks the first conv's parameter layout. Which input the conv runs on is
  not a setting (models/network.py ``input_layout``).
* ``replay.placement``: "device" (the replay ring and its sum tree on the
  card; the fused learner step samples there) or "host" (a numpy ring and
  the native sum tree in host memory, ``replay/host_replay.py``; the
  learner trains on batches a prefetch thread copies to the card, one step
  a dispatch). Any other value is refused; the JAX package reads every
  value but "host" as "device".
* ``replay.pallas_exact_gather``: the 84x84 -> 96x128 storage pad that
  Mosaic's tile rule needed. A CUDA copy does not need it, so "auto" = off
  on every device; "on" still gives the padded layout.
* ``replay.ingest_batch_blocks``: blocks a stager thread pops, stages in
  pinned memory and copies to the card ahead of one ``replay_add_many``
  commit (runtime/learner_loop.py). -1 = ``CUDA_AUTO``'s value on CUDA,
  1 (the per-block drain) on the CPU.
* ``mesh.dp``: data-parallel ranks, one process and one GPU each
  (``parallel/``); -1 = every visible GPU (``torch.cuda.device_count()``)
  over ``mesh.mp``, so 1 on a one-card machine, which runs the unsharded
  path.
* ``mesh.mp``: tensor-parallel ranks a dp row (parallel/tensor_parallel.py),
  under both placements; dp x mp ranks in all, one GPU each. Its
  dispatches run eagerly on both backends (``learner/train_step.py
  eager_steps``): gloo's collectives cannot be captured in a CUDA graph,
  and an NCCL capture of the tensor-parallel step is ROADMAP item A.4
  (not built). mp = 1 keeps its CUDA graphs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

PLACEMENTS = ("device", "host")       # replay.placement
INFERENCE_DTYPES = ("f32", "bf16", "int8")   # network.inference_dtype

# What "auto" (and steps_per_dispatch=-1) resolves to on CUDA: the faster
# setting in pairs that tools/bench.py measured in one call on an H100 at
# the reference shape (PERF.md section 5): the fused scan against the loop
# (single DQN). K=4 was the fewest steps a dispatch within 1% of the
# fastest while K=1 ran eagerly; measured again with K=1 a one-step graph
# as the Learner runs it (PERF.md section 6), K=1, 4 and 16 tie
# within 0.13% (K=4 at 0.9990 of K=1), so bench's tie-break names K=1.
# K stays 4: K also sets the loops' cadence, which the bench does not
# time (the on-device loop acts one segment a dispatch, multihost
# all-reduces once a dispatch), and every loop figure and check was
# measured at 4; a change waits for an A/B through the loops
# (ROADMAP.md). fused_double_unroll stays off: an interleaved unroll measured
# no faster than the two unrolls, which both settings now run.
# ingest_batch_blocks: per-block (1) against the stager at 8, orchestrated
# seq-updates/s with two thread actors (chip_smoke.py phase 10(a)'s runs,
# H100 80GB HBM3 at 700 W, in turns 1, 8, 8, 1 in one call): 1 at
# 8,858.87 and 9,833.88, 8 at 9,322.99 and 9,255.80, so 8 is not faster
# beyond the spread and "auto" stays 1 (PERF.md section 5). The CPU
# resolves them to off, off, 1 and 1.
CUDA_AUTO = {"network.pallas_lstm": True,
             "optim.fused_double_unroll": False,
             "runtime.steps_per_dispatch": 4,
             "replay.ingest_batch_blocks": 1}


@dataclass(frozen=True)
class EnvConfig:
    game_name: str = "Fake"
    env_type: str = "R2D2-v0"
    frame_stack: int = 4
    frame_height: int = 84
    frame_width: int = 84
    # fixed episode length of the synthetic envs (Fake and the on-device
    # Fake/Grid twins, envs/device_env.py)
    episode_len: int = 120
    # grid side of the on-device gridworld (env kind "Grid")
    grid_size: int = 6
    # gymnasium's frameskip for engine envs (1 = none; the synthetic envs
    # ignore it)
    frame_skip: int = 1
    # clip rewards to [-1, 1] (envs/wrappers.py ClipReward); off, as every
    # call site of the reference passes
    clip_rewards: bool = False

    @property
    def env_id(self) -> str:
        return self.game_name + self.env_type


@dataclass(frozen=True)
class NetworkConfig:
    hidden_dim: int = 512
    cnn_out_dim: int = 1024
    use_dueling: bool = True
    use_double: bool = False
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (32, 8, 4), (64, 4, 2), (64, 3, 1))
    bf16: str = "auto"
    # "on": the first conv's parameters are held in the 2x2 space-to-depth
    # layout; "off": the standard layout. The conv runs on the
    # space-to-depth input either way where the shapes allow it
    # (models/network.py input_layout)
    space_to_depth: str = "off"
    # fused LSTM scan (ops/lstm_kernels.py) instead of the Python scan
    pallas_lstm: str = "off"
    # weight dtype of the acting and serving forward ("f32", "bf16",
    # "int8"): the publication carries the quantized twin beside the f32
    # weights (models/network.py make_inference_bundle); the learner
    # trains in the network.bf16 policy whatever this says
    inference_dtype: str = "f32"


@dataclass(frozen=True)
class SequenceConfig:
    burn_in_steps: int = 40
    learning_steps: int = 10
    forward_steps: int = 5

    @property
    def seq_len(self) -> int:
        return self.burn_in_steps + self.learning_steps + self.forward_steps


@dataclass(frozen=True)
class ReplayConfig:
    capacity: int = 500_000
    block_length: int = 400
    prio_exponent: float = 0.9
    importance_sampling_exponent: float = 0.6
    batch_size: int = 128
    learning_starts: int = 1_000
    pallas_sample_gather: str = "auto"
    pallas_exact_gather: str = "auto"
    # blocks a stager thread pops and stages for one replay_add_many
    # commit (K > 1), or the per-block drain (1); -1 = auto
    # (resolved_ingest_batch_blocks). Host placement always drains per
    # block: its ingest is a numpy copy, not a device write.
    ingest_batch_blocks: int = -1
    # blocks the learner pops from the feeder queue per drain (committed
    # per drain on the pipelined path), in the training loop and the
    # orchestrator's warm-up loop alike
    drain_max_blocks: int = 32
    # rate limiter: ingestion pauses once env_steps > learning_starts +
    # ratio * train_steps (0 = unthrottled); the synchronous trainer
    # collects exactly this many env steps per dispatch
    max_env_steps_per_train_step: float = 0.0
    placement: str = "device"       # or "host"

    def resolved_ingest_batch_blocks(self, device) -> int:
        """A value > 0 as given; -1: CUDA_AUTO's on CUDA, 1 on the CPU."""
        if self.ingest_batch_blocks > 0:
            return self.ingest_batch_blocks
        if _device_type(device) == "cuda":
            return CUDA_AUTO["replay.ingest_batch_blocks"]
        return 1


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    adam_eps: float = 1e-3
    grad_norm: float = 40.0
    gamma: float = 0.997
    target_net_update_interval: int = 2_000
    training_steps: int = 500_000
    value_rescale_eps: float = 1e-2
    priority_eta: float = 0.9
    pallas_obs_decode: str = "auto"
    # "planar" and "nhwc" give the same tensor here: the CUDA decode
    # writes the layout the network's first conv takes directly
    pallas_decode_layout: str = "planar"
    # the JAX package's interleaved double-DQN unroll; parsed and checked,
    # both values run models/network.py dual_sequence_q
    fused_double_unroll: str = "off"


@dataclass(frozen=True)
class ActorConfig:
    """Ape-X actor fan-out."""

    num_actors: int = 2
    base_eps: float = 0.4
    eps_alpha: float = 7.0
    actor_update_interval: int = 400   # env steps between weight pulls
    max_episode_steps: int = 27_000
    near_greedy_eps: float = 0.02      # episode returns come from actors below
    # env lanes per actor worker (envs/vector.py): N > 1 steps N envs
    # through one (N, 1) policy forward a tick; the epsilon ladder spreads
    # over num_actors * envs_per_actor lanes (vector_lane_epsilons)
    envs_per_actor: int = 1
    # on-device acting (runtime/anakin_loop.py): True trains through the
    # fused act+train loop, whose acting segment steps anakin_lanes
    # on-device envs (envs/device_env.py) through the learner's own
    # network for block_length steps and writes one block per lane into
    # the device replay, as one CUDA graph on the card; no actor, queue
    # or weight service is built
    on_device: bool = False
    anakin_lanes: int = 64
    # acting segments per learner dispatch once training has started
    # (before learning_starts the loop only acts): the collect:learn knob,
    # with the rate limiter on top
    anakin_scans_per_train: int = 1
    # initial priority of on-device blocks: a positive constant stamp, or
    # "td" (the n-step TD errors of the acting policy's own Q-values,
    # mixed per sequence with optim.priority_eta, as the host assembler
    # seeds them)
    anakin_priority: Any = 1.0
    # where the acting forward runs: "local" (each actor's own policy) or
    # "server" (thin clients of one micro-batched policy server in the
    # learner's process, which holds the weights and every lane's
    # recurrent state; serve/)
    inference: str = "local"


@dataclass(frozen=True)
class MeshConfig:
    """Data-parallel layout of the learner, the JAX package's ``MeshConfig``
    on one host: ``dp`` ranks, one process and one GPU each, in a
    ``torch.distributed`` process group (``parallel/mesh.py``). Each rank
    holds a replay shard and a replica of the train state; one all-reduce
    of the gradient a step keeps the replicas equal (``parallel/sharded.py``).

    ``dp``: 1 = the unsharded path; N > 1 = N ranks; -1 = every visible
    device over ``mp``. ``mp``: tensor parallelism, each dp row's ``mp``
    ranks holding feature shards of the train state
    (parallel/tensor_parallel.py); dp x mp ranks in all. Under
    ``replay.placement="host"`` no dp path is taken at mp = 1 whatever
    ``dp`` says, as in the JAX package, whose host placement builds its
    step before it looks at the mesh; at mp > 1 host placement runs the
    tensor-parallel external-batch step over the dp x mp mesh, rank 0
    holding the host replay.

    ``multihost``: the multi-controller trainer, where each controller
    owns one card, its actors and its replay shard and the controllers
    run in lockstep (parallel/multihost.py)."""

    dp: int = 1
    mp: int = 1

    def resolved_dp(self, n_devices: int) -> int:
        mp = max(self.mp, 1)
        return self.dp if self.dp > 0 else max(n_devices // mp, 1)
    # Multi-host (parallel/multihost.py): one controller process a card,
    # each with its own actors and replay shard, joined over
    # tcp://coordinator_address; num_processes controllers, this one
    # process_id. dp is then num_processes (or -1 for it).
    multihost: bool = False
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclass(frozen=True)
class TelemetryConfig:
    """The telemetry fields the port reads, with the JAX package's names
    and defaults: the master switch, the stage timers and spans
    (telemetry/core.py, telemetry/spans.py), the cost model's block, the
    learning diagnostics (telemetry/learning.py), the replay diagnostics
    (telemetry/replaydiag.py) and the quantized forward's probe.
    The resource sampler, the compile telemetry and the alert engine
    (telemetry/resources.py, compile.py, alerts.py) and the cross-plane
    tracing (telemetry/tracing.py) follow, with every ``alerts_*`` field
    the JAX package's ``default_rules`` reads. ``enabled`` gates all of
    them: off, no stage is observed, no span is recorded or written, no
    board is made, and the record carries no ``stages``, ``costs``,
    ``learning``, ``replay_diag``, ``resources`` or ``alerts`` block. The
    JAX package's fleet-plane, policy-quality and tower fields are
    refused as unknown fields naming ROADMAP A.7."""

    # master switch: false turns the stage timers, the spans, the costs
    # block and both diagnostic pillars off (the step, its graph and the
    # record are then what they are without them)
    enabled: bool = True
    # the span ring's capacity a thread; when a drain interval overflows
    # it the oldest spans drop, counted as telemetry_dropped_spans
    ring_size: int = 4096
    # the drain's cadence: spans to spans_*.jsonl, process actors' stage
    # counts to the shared-memory board
    flush_interval_s: float = 5.0
    # the span sub-switch: the stage timers stay on (they feed the
    # record's stages block); spans cost a JSONL file a process
    spans: bool = True
    # the first record's one-shot costs block: the analytic per-component
    # FLOPs and bytes of the configured step (telemetry/costmodel.py)
    costmodel_enabled: bool = True
    # the learning diagnostics fused into the learner step: |TD|,
    # priority and |Q| histograms, per-group gradient norms, the
    # non-finite guard, sample staleness, and every learning_interval
    # steps the target distance and the stored-state dQ check on
    # learning_dq_batch sequences
    learning_enabled: bool = True
    learning_interval: int = 200
    learning_dq_batch: int = 16
    # a non-finite loss or gradient norm seen at a metrics flush: both
    # policies write one nan_dump_player{p}.json; "warn" logs and goes
    # on, "halt" raises and stops the run at that flush
    nan_policy: str = "warn"
    # the replay diagnostics: the sum tree's health every
    # replay_diag_interval steps, the per-slot sample counts and the
    # eviction ledger, the sampled batches' lane composition
    replay_diag_enabled: bool = True
    replay_diag_interval: int = 50
    # every N-th quantized forward also runs the f32 twin on the same live
    # rows (max |dQ| and greedy agreement into the record's "quant"
    # block); 0 = no probe
    quant_probe_interval: int = 256
    # -- resources, compile telemetry, alerts --
    # the periodic record's resources block (device memory, host RSS/CPU,
    # buffer owners, the compile sub-block) and, with alerts_enabled, its
    # alerts block; off, neither block exists
    resources_enabled: bool = True
    # seconds between resource samples (riding the supervision cadence)
    resources_interval_s: float = 10.0
    # the first sample with a device's headroom (free / total) below this
    # writes resource_dump_player{p}.json once; 0 = no dump
    resources_headroom_warn_frac: float = 0.05
    # CUDA-graph captures and kernel builds counted with their wall time,
    # retraces after warm-up, the serving buckets' pre-capture coverage
    compile_enabled: bool = True
    # the rule engine over each record (alerts_player{p}.jsonl)
    alerts_enabled: bool = True
    # drop/growth rules: the rolling-median window, in records
    alerts_window: int = 8
    alerts_throughput_drop_frac: float = 0.5
    alerts_heartbeat_age_s: float = 120.0
    alerts_staleness_growth_factor: float = 4.0
    alerts_hbm_headroom_frac: float = 0.05
    alerts_retrace_storm: int = 3
    alerts_shard_imbalance: float = 1.5
    alerts_replay_ess_frac: float = 0.05
    alerts_priority_saturation: float = 0.5
    alerts_never_sampled_growth: float = 2.0
    alerts_lane_starved_frac: float = 0.5
    # the fleet block's rules (inactive: the port emits no fleet block)
    alerts_rank_straggler: float = 2.0
    alerts_lockstep_wait_frac: float = 0.75
    alerts_fleet_desync: float = 4.0
    alerts_missing_rank_age_s: float = 120.0
    # the serving block's rules
    alerts_serve_p99_ms: float = 1000.0
    alerts_serve_starved_frac: float = 0.95
    alerts_serve_churn: float = 3.0
    alerts_serve_shed_frac: float = 0.2
    alerts_quant_agreement: float = 0.95
    # the replay service's rules (fleet.replay_shards >= 1; fanout_lag and
    # orphaned_slot stay inactive: no fan-out or membership sub-block)
    alerts_spill_thrash_frac: float = 0.5
    alerts_fanout_lag: float = 8.0
    alerts_orphaned_slots: float = 1.0
    alerts_ingest_backlog: float = 64.0
    alerts_spill_promotion_ms: float = 60_000.0
    # the trace block's rule (the service-routed learner's trace block)
    alerts_e2e_latency_growth: float = 4.0
    # the recovery block's rules
    alerts_snapshot_stale_s: float = 600.0
    alerts_recovery_loop: float = 2.0
    # the quality block's rules (inactive: no quality block)
    alerts_quality_regression: float = 0.5
    alerts_canary_divergence: float = 0.25
    alerts_promotion_stall_s: float = 600.0
    # -- cross-plane tracing (telemetry/tracing.py) --
    # served requests carry a trace dict (the serving block's trace
    # sub-block), emitted blocks a trace_ms stamp (the ring accountant's
    # slot mirrors); off, records, requests, ring layouts and blocks are
    # what they are without it
    tracing_enabled: bool = False
    # every N-th block / serve exchange is traced (1 = all)
    trace_sample_every: int = 16
    # the replay service's per-tier sub-blocks in replay_service.spill:
    # the promoted pages' time in the tier and the bytes a tier holds;
    # off, the block is what it is without them
    replay_tiers_enabled: bool = False


@dataclass(frozen=True)
class FleetConfig:
    """The fleet's replay plane (fleet/replay_service.py), the JAX
    package's ``FleetConfig`` without its membership, fan-out and
    promotion fields (ROADMAP A.6, second part: refused as unknown
    fields naming it). Every default leaves the learner's replay what it
    is without the service."""

    # 0 = the learner's own replay (one ring, or dp-sharded); >= 1 = a
    # ReplayService of this many shards, each num_blocks / replay_shards
    # rows on the learner's device, trained through the external-batch
    # step on the service's sampled batches
    replay_shards: int = 0
    # a shard's host spill tier, in blocks: a ring write over a live
    # block demotes that block's host page into an LRU page store
    # instead of destroying it; 0 = no tier (overwrites as without it)
    spill_blocks: int = 0
    # spilled pages rotated back into the ring per sample (0: none)
    spill_promote_per_sample: int = 1
    # block -> shard: "round_robin" (the dp path's feeding order) or
    # "lane" (the block's lane stamp mod the shards; -1 round robin)
    replay_route: str = "round_robin"
    # "" = in-process producers only; "socket" = the service also listens
    # on service_host:service_port for remote producers
    service_transport: str = ""
    service_host: str = "127.0.0.1"
    service_port: int = 0           # 0 = ephemeral
    # blocks a grouped commit takes (replay_add_many in pow2 chunks);
    # 1 = one replay_add a block
    ingest_batch_blocks: int = 1
    # a remote producer's unacked frames in flight (1 = lockstep)
    socket_window: int = 1
    # promote by a page's stored priority on a background thread kicked
    # at write-back time, instead of LRU pages inside the sample
    spill_prefetch: bool = False
    # a prefetch thread samples the next batch while the step runs and a
    # write-back thread applies the priorities grouped by shard
    sample_staging: bool = False

    @property
    def active(self) -> bool:
        """A fleet plane is on: the record carries a replay_service
        block."""
        return self.replay_shards > 0


@dataclass(frozen=True)
class ServeConfig:
    """The central policy server (serve/): thin clients send raw frames,
    one server loop holds the weights and a per-client state cache and
    micro-batches requests into one forward. ``actor.inference="server"``
    routes the actors through it, ``cli/serve.py`` runs it alone,
    ``cli/evaluate.py --serve`` evaluates through it."""

    # a batch dispatches when it holds max_batch requests or its oldest is
    # deadline_ms old; widths pad to power-of-two buckets, each one CUDA
    # graph captured at start on the card
    max_batch: int = 32
    deadline_ms: float = 5.0
    # one server only: the router that spreads shards over several servers
    # is not ported, so any other value is refused
    servers: int = 1
    max_servers: int = 0
    # admission control: past this inbox backlog after a batch fill, the
    # oldest queued requests are shed with STATUS_RETRY (0 = off)
    queue_depth_bound: int = 0
    # state cache: slots (one lane each) in equal shard groups
    state_slots: int = 1024
    state_shards: int = 4
    # a disconnected client's state is kept this long (reconnect window)
    lease_timeout_s: float = 120.0
    # client timeout a request, and the retry budget before it gives up
    request_timeout_s: float = 5.0
    max_retry_s: float = 60.0
    # requests older than this at dispatch are dropped unapplied (0 = off)
    request_ttl_s: float = 10.0
    # process actors' rung: "shm" (native request/reply rings), "socket"
    # (TCP) or "auto" (shm where the native ring builds, else socket)
    transport: str = "auto"
    host: str = "127.0.0.1"
    port: int = 0                    # 0 = an ephemeral port
    request_ring_slots: int = 256
    reply_ring_slots: int = 16
    # seconds between the server's weight-service polls
    weight_poll_interval_s: float = 1.0
    # capture (CUDA) or run (CPU) every dispatch bucket at start
    warmup: bool = True


@dataclass(frozen=True)
class RuntimeConfig:
    save_dir: str = "models"
    pretrain: str = ""               # weights-only warm start ("" = none)
    # full resume: params, target params, optimizer state, step, env_steps
    # and the sampling generator
    resume: str = ""
    save_interval: int = 1_000       # learner steps between checkpoints
    log_interval: float = 20.0       # seconds between metric log lines
    weight_publish_interval: int = 2  # learner steps between publications
    # learner steps per dispatch: one CUDA graph of K steps on the card, K
    # eager steps on the CPU; -1 = auto (resolved_steps_per_dispatch).
    # Publish and checkpoint cadences coarsen to dispatch boundaries.
    steps_per_dispatch: int = -1
    # host placement: device batches the prefetch thread keeps queued
    prefetch_batches: int = 4
    # process actors: blocks cross through the native shared-memory ring
    # (a failed build raises); false: a multiprocessing.Queue
    shm_transport: bool = True
    test_epsilon: float = 0.01
    seed: int = 0
    # non-empty: a torch.profiler capture of the first training interval
    # is written here (telemetry/profiler.py)
    profile_dir: str = ""
    # > 0: one capture once the learner's step counter reaches it, for
    # min(log_interval, 30) s, into profile_dir or {save_dir}/profile;
    # SIGUSR2 starts the same capture on demand
    profile_at_step: int = 0
    restart_dead_actors: bool = True
    # worker health: supervision cadence, the hang watchdog (0 = off) and
    # its grace before a worker's first heartbeat
    supervise_interval_s: float = 5.0
    hang_timeout_s: float = 120.0
    hang_spawn_grace_s: float = 300.0
    # per-slot restart backoff (the k-th failure in the window waits
    # base * 2^(k-2), capped) and the crash-loop breaker (0 = off)
    restart_backoff_base_s: float = 1.0
    restart_backoff_max_s: float = 60.0
    max_restarts_per_window: int = 5
    restart_window_s: float = 300.0
    # one diagnostic dump when no block arrives for this long (0 = off)
    ingest_stall_timeout_s: float = 300.0
    keep_checkpoints: int = 0        # newest K kept per player; 0 = all
    # learner steps between durable replay snapshots
    # ({save_dir}/replay_player{p}.npz + .json, replay/snapshot.py), written
    # by a background thread from a cut taken between dispatches; 0 = off
    # (no files, no "recovery" record block)
    snapshot_interval: int = 0
    # on runtime.resume, reload the newest committed replay snapshot beside
    # the checkpoint (ring, tree, pointer, sampling generator) before the
    # first dispatch; off restores the checkpoint only
    restore_replay: bool = True
    # cli.train runs training as a child process of a supervisor
    # (runtime/supervisor.py) that relaunches a dead child from its newest
    # checkpoint on the restart_* / max_restarts_per_window ladder
    auto_resume: bool = False

    def resolved_steps_per_dispatch(self, device) -> int:
        """A value > 0 as given; otherwise ``CUDA_AUTO``'s on CUDA and 1
        on the CPU."""
        if self.steps_per_dispatch > 0:
            return self.steps_per_dispatch
        if _device_type(device) == "cuda":
            return CUDA_AUTO["runtime.steps_per_dispatch"]
        return 1


@dataclass(frozen=True)
class Config:
    env: EnvConfig = field(default_factory=EnvConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    sequence: SequenceConfig = field(default_factory=SequenceConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    actor: ActorConfig = field(default_factory=ActorConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)

    def __post_init__(self):
        if self.replay.block_length % self.sequence.learning_steps != 0:
            raise ValueError(
                f"replay.block_length ({self.replay.block_length}) must be a "
                f"multiple of sequence.learning_steps ({self.sequence.learning_steps})"
            )
        if self.replay.capacity % self.replay.block_length != 0:
            raise ValueError(
                f"replay.capacity ({self.replay.capacity}) must be a multiple "
                f"of replay.block_length ({self.replay.block_length})"
            )
        if self.sequence.forward_steps < 1:
            raise ValueError("sequence.forward_steps must be >= 1")
        if self.replay.placement not in PLACEMENTS:
            raise ValueError(f"replay.placement must be one of {PLACEMENTS}"
                             f"; got {self.replay.placement!r}")
        if self.replay.ingest_batch_blocks == 0 or \
                self.replay.ingest_batch_blocks < -1:
            raise ValueError(
                f"replay.ingest_batch_blocks ({self.replay.ingest_batch_blocks})"
                " must be -1 (auto) or >= 1")
        if self.replay.ingest_batch_blocks > self.num_blocks:
            raise ValueError(
                f"replay.ingest_batch_blocks ({self.replay.ingest_batch_blocks})"
                f" must be <= num_blocks ({self.num_blocks}): replay_add_many"
                " scatter rows would alias in the ring")
        if self.replay.drain_max_blocks < 1:
            raise ValueError(
                f"replay.drain_max_blocks ({self.replay.drain_max_blocks}) "
                "must be >= 1")
        if self.runtime.profile_at_step < 0:
            raise ValueError("runtime.profile_at_step must be >= 0")
        if self.runtime.snapshot_interval < 0:
            raise ValueError(
                f"runtime.snapshot_interval "
                f"({self.runtime.snapshot_interval}) must be >= 0 "
                "(learner steps between replay snapshots; 0 disables)")
        if (self.runtime.snapshot_interval
                and self.replay.placement == "host"):
            raise ValueError(
                "runtime.snapshot_interval requires the device replay "
                "(replay.placement='device'): the host-replay numpy twin "
                "has no snapshot plane yet — set snapshot_interval=0 or "
                "switch placement")
        if not 1 <= self.actor.envs_per_actor <= 100:
            raise ValueError(
                f"actor.envs_per_actor ({self.actor.envs_per_actor}) must be "
                "in [1, 100]: per-lane seeds fill the worker's 100-wide seed "
                "window (runtime.seed + 100*actor_idx + lane)")
        self._check_envs_and_acting()
        self._check_inference()
        self._check_mesh()
        self._check_fleet()

    def _check_fleet(self) -> None:
        """The replay plane's rules, in the JAX package's words."""
        fl = self.fleet
        if fl.replay_shards < 0:
            raise ValueError(
                f"fleet.replay_shards ({fl.replay_shards}) must be >= 0 "
                "(0 = legacy in-mesh replay)")
        if fl.replay_shards > 0:
            if self.replay.placement != "device":
                raise ValueError(
                    "fleet.replay_shards requires replay.placement="
                    "'device': the service's shards are the "
                    "device-resident rings (host placement already has its "
                    "own CPU tree — disaggregate the device plane)")
            if self.mesh.dp != 1 or self.mesh.mp != 1:
                raise ValueError(
                    "fleet.replay_shards composes with a 1x1 mesh only: "
                    "the service IS the replay sharding layer (it "
                    "generalizes the dp-sharded rings into addressable "
                    "shards) — set mesh.dp=1/mesh.mp=1 or use the "
                    "in-mesh dp sharding without the service")
            if self.actor.on_device:
                raise ValueError(
                    "fleet.replay_shards requires the host actor fleet: "
                    "the fused on-device loop ring-writes straight into "
                    "its colocated replay (actor.on_device) — the "
                    "service exists for producers that do NOT share the "
                    "learner's program")
            if self.mesh.multihost:
                raise ValueError(
                    "fleet.replay_shards is single-controller for now — "
                    "the lockstep multihost trainer keeps its per-rank "
                    "in-mesh shards (routing its ranks through the "
                    "service is the ROADMAP item-1 composition)")
            if self.num_blocks % fl.replay_shards != 0:
                raise ValueError(
                    f"fleet.replay_shards ({fl.replay_shards}) must "
                    f"divide num_blocks ({self.num_blocks}): shards are "
                    "equal device-ring slices — adjust replay.capacity "
                    "or the shard count")
            if fl.replay_route == "lane":
                lanes = self.actor.num_actors * self.actor.envs_per_actor
                if lanes < fl.replay_shards:
                    raise ValueError(
                        f"fleet.replay_route='lane' with "
                        f"{fl.replay_shards} shards needs at least that "
                        f"many ε-ladder lanes (fleet has {lanes}): shard "
                        "s only receives lanes with lane % shards == s, "
                        "so an uncovered shard would hold the training "
                        "gate closed forever — grow the fleet or use "
                        "replay_route='round_robin'")
        if fl.spill_blocks < 0:
            raise ValueError(
                f"fleet.spill_blocks ({fl.spill_blocks}) must be >= 0")
        if fl.spill_blocks > 0 and fl.replay_shards < 1:
            raise ValueError(
                "fleet.spill_blocks requires fleet.replay_shards >= 1: "
                "the spill tier is the replay service's demotion target "
                "(the in-mesh rings overwrite in place)")
        if fl.spill_promote_per_sample < 0:
            raise ValueError(
                f"fleet.spill_promote_per_sample "
                f"({fl.spill_promote_per_sample}) must be >= 0")
        if fl.replay_route not in ("round_robin", "lane"):
            raise ValueError(
                f"fleet.replay_route ({fl.replay_route!r}) must be "
                "'round_robin' or 'lane'")
        if fl.service_transport not in ("", "socket"):
            raise ValueError(
                f"fleet.service_transport ({fl.service_transport!r}) "
                "must be '' (in-proc producers only) or 'socket'")
        if fl.service_transport and fl.replay_shards < 1:
            raise ValueError(
                "fleet.service_transport requires fleet.replay_shards "
                ">= 1 (there is no service to listen for)")
        if fl.service_port < 0:
            raise ValueError(
                f"fleet.service_port ({fl.service_port}) must be >= 0 "
                "(0 = ephemeral)")
        if fl.ingest_batch_blocks < 1:
            raise ValueError(
                f"fleet.ingest_batch_blocks ({fl.ingest_batch_blocks}) "
                "must be >= 1 (1 = the per-block replay_add path)")
        if fl.ingest_batch_blocks > 1 and fl.replay_shards < 1:
            raise ValueError(
                "fleet.ingest_batch_blocks > 1 requires "
                "fleet.replay_shards >= 1: grouped ingest is the "
                "service's commit plane (the in-mesh path already has "
                "replay.ingest_batch_blocks) — a run without the "
                "service would silently ignore the knob")
        if fl.socket_window < 1:
            raise ValueError(
                f"fleet.socket_window ({fl.socket_window}) must be >= 1 "
                "(1 = one-frame-one-ack lockstep)")
        if fl.socket_window > 1 and fl.service_transport != "socket":
            raise ValueError(
                "fleet.socket_window > 1 requires "
                "fleet.service_transport='socket': the in-flight window "
                "is the socket rung's ack pipeline — in-proc producers "
                "have no frames to window")
        if fl.spill_prefetch and fl.spill_blocks < 1:
            raise ValueError(
                "fleet.spill_prefetch requires fleet.spill_blocks >= 1: "
                "priority-aware prefetch promotes from the spill tier — "
                "with no tier the knob would be silently ignored")
        if fl.sample_staging and fl.replay_shards < 1:
            raise ValueError(
                "fleet.sample_staging requires fleet.replay_shards >= 1:"
                " the stager pipelines the SERVICE sample path (the "
                "in-mesh learner already pipelines via the ingest "
                "stager)")

    def _check_mesh(self) -> None:
        """The mesh's rules: the multi-controller trainer's under
        ``mesh.multihost`` (on-device acting with mp > 1 is refused with
        the acting rules, as in the JAX package)."""
        if self.mesh.multihost:
            self._check_multihost()

    def _check_multihost(self) -> None:
        """The multi-controller trainer's rules (parallel/multihost.py):
        one controller a card, so dp is the controller count; the
        combinations the JAX package refuses, refused in its words."""
        mesh = self.mesh
        if mesh.num_processes < 1:
            raise ValueError(f"mesh.num_processes ({mesh.num_processes}) "
                             "must be >= 1")
        if not 0 <= mesh.process_id < mesh.num_processes:
            raise ValueError(
                f"mesh.process_id ({mesh.process_id}) must be in [0, "
                f"mesh.num_processes={mesh.num_processes})")
        if mesh.mp > 1:
            raise ValueError(
                f"mesh.mp={mesh.mp} with mesh.multihost: a controller drives "
                "one card, and tensor parallelism across controllers (the "
                "JAX package's GSPMD lockstep ingest) is ROADMAP item A.4 "
                "(not ported); run mesh.mp on one host (cli.train "
                "--mesh.mp) or set mesh.mp=1")
        if mesh.dp not in (-1, mesh.num_processes):
            raise ValueError(
                f"mesh.dp={mesh.dp} with mesh.multihost: each controller "
                "drives one card, so mesh.dp must equal mesh.num_processes "
                f"({mesh.num_processes}) or be -1")
        if self.actor.on_device:
            raise ValueError(
                "actor.on_device is single-controller only (the fused loop "
                "is not integrated with the lockstep multihost trainer "
                "yet) — unset mesh.multihost")
        if self.actor.inference == "server":
            raise ValueError(
                "actor.inference='server' is single-host for now: the "
                "multihost lockstep fleet wires its own weight distribution"
                " — routing its actors through a serve transport is the "
                "router/fleet item, ROADMAP A.6")

    def _check_telemetry(self) -> None:
        """The diagnostics' fields, checked in the JAX package's words."""
        t = self.telemetry
        if t.learning_interval < 1:
            raise ValueError(f"telemetry.learning_interval "
                             f"({t.learning_interval}) must be >= 1")
        if t.learning_dq_batch < 1:
            raise ValueError(f"telemetry.learning_dq_batch "
                             f"({t.learning_dq_batch}) must be >= 1")
        if t.nan_policy not in ("warn", "halt"):
            raise ValueError(f"telemetry.nan_policy ({t.nan_policy!r}) must "
                             "be 'warn' or 'halt'")
        if t.replay_diag_interval < 1:
            raise ValueError(f"telemetry.replay_diag_interval "
                             f"({t.replay_diag_interval}) must be >= 1")
        if t.ring_size < 16:
            raise ValueError(f"telemetry.ring_size ({t.ring_size}) must be "
                             ">= 16")
        if t.flush_interval_s <= 0:
            raise ValueError("telemetry.flush_interval_s must be > 0")
        # the JAX package's bounds on the ported fields, in its words
        for name, ok, bound in _TELEMETRY_BOUNDS:
            value = getattr(t, name)
            if not ok(value):
                raise ValueError(f"telemetry.{name} ({value}) must be "
                                 f"{bound}")

    def _check_inference(self) -> None:
        """The quantized plane's and the policy server's rules, the JAX
        package's wording; what the port does not have yet is refused
        naming the item that brings it."""
        net, actor, sv = self.network, self.actor, self.serve
        if net.inference_dtype not in INFERENCE_DTYPES:
            raise ValueError(
                f"network.inference_dtype ({net.inference_dtype!r}) must be "
                "'f32', 'bf16', or 'int8' — the acting/serving forward's "
                "weight dtype (the learner always trains in the network.bf16 "
                "policy regardless)")
        self._check_telemetry()
        if self.telemetry.quant_probe_interval < 0:
            raise ValueError(
                f"telemetry.quant_probe_interval "
                f"({self.telemetry.quant_probe_interval}) must be >= 0 (0 "
                "disables the accuracy probe)")
        if actor.inference not in ("local", "server"):
            raise ValueError(f"actor.inference ({actor.inference!r}) must be "
                             "'local' or 'server'")
        if actor.inference == "server":
            if actor.on_device:
                raise ValueError(
                    "actor.inference='server' requires the host actor "
                    "fleet: the fused on-device loop (actor.on_device) has "
                    "no per-step policy client — its acting forward is "
                    "already device-resident")
            lanes = actor.num_actors * actor.envs_per_actor
            if lanes > sv.state_slots:
                raise ValueError(
                    f"actor fleet has {lanes} lanes but serve.state_slots "
                    f"is {sv.state_slots}: every lane leases a server-side "
                    "state slot, so an undersized cache would thrash "
                    "(evict live episodes) — raise serve.state_slots")
        if sv.servers != 1 or sv.max_servers != 0:
            raise ValueError(
                f"serve.servers={sv.servers}, serve.max_servers="
                f"{sv.max_servers}: the port serves from one server; a "
                "serving fleet needs serve/router.py and fleet/membership.py"
                ", ROADMAP item A.6 (router/fleet)")
        if sv.max_batch < 1:
            raise ValueError(f"serve.max_batch ({sv.max_batch}) must be >= 1")
        if sv.deadline_ms < 0:
            raise ValueError(
                f"serve.deadline_ms ({sv.deadline_ms}) must be >= 0")
        if sv.queue_depth_bound < 0:
            raise ValueError(f"serve.queue_depth_bound "
                             f"({sv.queue_depth_bound}) must be >= 0")
        if sv.state_slots < 1 or sv.state_shards < 1:
            raise ValueError(
                "serve.state_slots and serve.state_shards must be >= 1")
        if sv.state_slots % sv.state_shards != 0:
            raise ValueError(
                f"serve.state_slots ({sv.state_slots}) must be divisible by "
                f"serve.state_shards ({sv.state_shards}): shards are equal "
                "slot groups")
        for fname in ("lease_timeout_s", "request_timeout_s",
                      "max_retry_s", "weight_poll_interval_s"):
            if getattr(sv, fname) <= 0:
                raise ValueError(f"serve.{fname} must be > 0")
        if sv.request_ttl_s < 0:
            raise ValueError(
                f"serve.request_ttl_s ({sv.request_ttl_s}) must be >= 0 (0 "
                "disables expiry)")
        if sv.transport not in ("auto", "shm", "socket"):
            raise ValueError(f"serve.transport ({sv.transport!r}) must be "
                             "'auto', 'shm', or 'socket'")
        if sv.request_ring_slots < 2 or sv.reply_ring_slots < 2:
            raise ValueError("serve.request_ring_slots and "
                             "serve.reply_ring_slots must be >= 2")

    def _check_envs_and_acting(self) -> None:
        """The synthetic envs' and on-device acting's rules, the JAX
        package's wording; the on-device preconditions fail here, at
        construction, not inside the acting segment."""
        env, actor = self.env, self.actor
        if env.episode_len < 1:
            raise ValueError(
                f"env.episode_len ({env.episode_len}) must be >= 1")
        if env.grid_size < 2:
            raise ValueError(f"env.grid_size ({env.grid_size}) must be >= 2")
        if env.grid_size > min(env.frame_height, env.frame_width):
            raise ValueError(
                f"env.grid_size ({env.grid_size}) must be <= the frame size "
                f"({env.frame_height}x{env.frame_width}): a grid cell needs "
                "at least one pixel, or the gridworld renders a uniform "
                "background (zero-information obs)")
        if actor.anakin_lanes < 1:
            raise ValueError(
                f"actor.anakin_lanes ({actor.anakin_lanes}) must be >= 1")
        if actor.anakin_scans_per_train < 1:
            raise ValueError(
                f"actor.anakin_scans_per_train "
                f"({actor.anakin_scans_per_train}) must be >= 1")
        if isinstance(actor.anakin_priority, str):
            if actor.anakin_priority != "td":
                raise ValueError(
                    f"actor.anakin_priority ({actor.anakin_priority!r}) must "
                    "be 'td' (n-step TD seeding from the acting policy's "
                    "Q-values) or a positive constant stamp")
        elif not actor.anakin_priority > 0:
            raise ValueError(
                f"actor.anakin_priority ({actor.anakin_priority}) must be > "
                "0: zero-priority sequences are unsamplable, so a freshly "
                "emitted block could never be trained on")
        if not actor.on_device:
            return
        if self.replay.placement != "device":
            raise ValueError(
                "actor.on_device requires replay.placement='device': the "
                "acting segment writes its blocks straight into the device "
                "replay (host placement would bring back the host round "
                "trip the path exists to remove)")
        if env.episode_len % self.replay.block_length != 0:
            raise ValueError(
                f"actor.on_device requires env.episode_len "
                f"({env.episode_len}) to be a multiple of replay.block_length "
                f"({self.replay.block_length}): the acting segment emits "
                "fixed block_length-step blocks, so episode ends must land "
                "on block boundaries (the host path's emit-on-done "
                "semantics)")
        if self.mesh.mp > 1:
            raise ValueError(
                "actor.on_device composes with data-parallel meshes "
                "only: the fused acting scan runs per-shard lane "
                "groups over mesh.dp, but model parallelism (mesh.mp "
                f"= {self.mesh.mp}) shards the network's feature dims "
                "through the GSPMD learner step, which the acting "
                "scan does not run under — set mesh.mp=1 (mesh.dp > 1 "
                "is fine) or actor.on_device=false")
        dp = self.mesh.dp
        if dp > 1 and actor.anakin_lanes % dp != 0:
            raise ValueError(
                f"actor.anakin_lanes ({actor.anakin_lanes}) must be "
                f"divisible by mesh.dp ({dp}): the acting segment partitions "
                "the lanes into equal per-shard groups (anakin_lanes % dp == "
                "0); adjust actor.anakin_lanes or mesh.dp")
        # mesh.dp=-1 (every device) resolves at run time; the loop checks
        # both rules again against the resolved dp there
        per_shard = actor.anakin_lanes // dp if dp > 1 else actor.anakin_lanes
        if per_shard > self.num_blocks:
            raise ValueError(
                f"actor.anakin_lanes ({actor.anakin_lanes}) must leave each "
                f"shard's lane group ({per_shard}) <= num_blocks "
                f"({self.num_blocks}): each segment writes one block per "
                "lane in one ring write, whose rows must not alias; grow "
                "replay.capacity or lower the lane count")

    @property
    def seqs_per_block(self) -> int:
        return self.replay.block_length // self.sequence.learning_steps

    @property
    def num_blocks(self) -> int:
        return self.replay.capacity // self.replay.block_length

    def replace(self, **dotted: Any) -> "Config":
        """New Config with ``section.field`` overrides applied."""
        updates: Dict[str, Dict[str, Any]] = {}
        for key, value in dotted.items():
            section, _, fname = key.partition(".")
            if not fname or "." in fname:
                raise KeyError(f"override key must be section.field: {key!r}")
            hint = not_ported_hint(section, fname)
            if hint:
                raise ValueError(f"{key}: the JAX package's field, not "
                                 f"ported yet (ROADMAP {hint})")
            updates.setdefault(section, {})[fname] = value
        return dataclasses.replace(self, **{
            section: dataclasses.replace(getattr(self, section), **fields)
            for section, fields in updates.items()})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        """Inverse of to_dict (tuples round-trip through JSON lists); a
        section absent from ``d`` takes its defaults."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            sub = dict(d.get(f.name) or {})
            for key, value in sub.items():
                if isinstance(value, list):
                    sub[key] = tuple(
                        tuple(x) if isinstance(x, list) else x for x in value)
            kwargs[f.name] = _SECTION_TYPES[f.name](**sub)
        return cls(**kwargs)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        return cls.from_dict(json.loads(text))


_SECTION_TYPES = {"env": EnvConfig, "network": NetworkConfig,
                  "sequence": SequenceConfig, "replay": ReplayConfig,
                  "optim": OptimConfig, "actor": ActorConfig,
                  "runtime": RuntimeConfig, "telemetry": TelemetryConfig,
                  "serve": ServeConfig, "mesh": MeshConfig,
                  "fleet": FleetConfig}

def _parse_setting(setting, field_name: str):
    """"on" -> True, "off" -> False, "auto" -> None (legacy bools and their
    CLI spellings accepted, as in the JAX package)."""
    if isinstance(setting, bool):
        return setting
    lowered = str(setting).lower()
    if lowered == "auto":
        return None
    if lowered in ("on", "true", "1", "yes"):
        return True
    if lowered in ("off", "false", "0", "no"):
        return False
    raise ValueError(
        f"{field_name} must be 'on', 'off', or 'auto'; got {setting!r}")


def resolve_bf16(setting, device) -> bool:
    value = _parse_setting(setting, "network.bf16")
    return device.type == "cuda" if value is None else value


def resolve_exact_gather(setting) -> bool:
    value = _parse_setting(setting, "replay.pallas_exact_gather")
    return bool(value)


def check_kernel_setting(setting, device, field_name: str) -> None:
    """A kernel knob must agree with the device: CUDA tensors always take
    the hand kernel, CPU tensors the plain version."""
    value = _parse_setting(setting, field_name)
    on_cuda = device.type == "cuda"
    if value is not None and value != on_cuda:
        raise ValueError(
            f"{field_name}={setting!r} cannot hold on {device}: on CUDA the "
            "hand kernel is the only route and on the CPU the plain PyTorch "
            "version is; use 'auto'")


def _device_type(device) -> str:
    return "cpu" if device is None else str(device).split(":")[0]


def _resolve_auto(setting, field_name: str, device) -> bool:
    value = _parse_setting(setting, field_name)
    if value is None:
        return _device_type(device) == "cuda" and CUDA_AUTO[field_name]
    return value


def resolve_pallas_lstm(setting, device=None) -> bool:
    """"on" = the fused scan, "off" = the Python scan, "auto" = CUDA_AUTO's
    choice on CUDA, the Python scan on the CPU (``device`` None)."""
    return _resolve_auto(setting, "network.pallas_lstm", device)


def resolve_fused_double_unroll(setting, device=None) -> bool:
    """The setting as a bool, "auto" as for resolve_pallas_lstm; raises on
    a value the JAX package refuses."""
    return _resolve_auto(setting, "optim.fused_double_unroll", device)


def resolve_space_to_depth(setting) -> bool:
    """"on"/"off" only: the setting changes the parameter layout, so it
    must resolve the same on every device (as in the JAX package)."""
    value = _parse_setting(setting, "network.space_to_depth")
    if value is None:
        raise ValueError(
            "network.space_to_depth must be 'on' or 'off' ('auto' is not "
            "allowed: the setting changes the parameter layout, so it must "
            "resolve identically on every host)")
    return value


def check_network(network: NetworkConfig) -> None:
    """Refuse network settings the port cannot resolve."""
    resolve_space_to_depth(network.space_to_depth)
    resolve_pallas_lstm(network.pallas_lstm)


def check_decode_layout(optim: OptimConfig) -> None:
    if str(optim.pallas_decode_layout).lower() not in ("planar", "nhwc"):
        raise ValueError("optim.pallas_decode_layout must be 'planar' or "
                         f"'nhwc'; got {optim.pallas_decode_layout!r}")


# the JAX package's telemetry and fleet fields the port refuses, with the
# ROADMAP item that brings them
_NOT_PORTED = {
    "telemetry": {
        **{name: ("A.7, the fleet telemetry (telemetry/fleet.py), with "
                 "A.6's second part")
           for name in ("fleet_enabled", "fleet_host_row_max_bytes")},
        **{name: "A.7, the telemetry remainder (quality, tower)"
           for name in ("quality_enabled", "quality_eval_interval_s",
                        "quality_eval_rounds", "quality_eval_clients",
                        "quality_calib_sample_every", "tower_enabled")},
    },
    "fleet": {
        name: "A.6, second part: membership, leases, fan-out, promotion"
        for name in ("fanout_degree", "fanout_pull_interval_s",
                     "max_slots", "elastic", "lease_transport",
                     "lease_host", "lease_port",
                     "promotion_return_tolerance",
                     "promotion_calibration_bound",
                     "promotion_divergence_bound", "promotion_min_shadow",
                     "promotion_canary_frac")},
}


def not_ported_hint(section: str, fname: str) -> str:
    """The ROADMAP item that brings a JAX field the port refuses ("" for
    any other name)."""
    return _NOT_PORTED.get(section, {}).get(fname, "")

# (field, check, the bound in the JAX package's words)
_TELEMETRY_BOUNDS = (
    ("resources_interval_s", lambda v: v > 0, "> 0"),
    ("resources_headroom_warn_frac", lambda v: 0 <= v < 1, "in [0, 1)"),
    ("alerts_window", lambda v: v >= 2, ">= 2"),
    ("alerts_throughput_drop_frac", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_heartbeat_age_s", lambda v: v >= 0, ">= 0"),
    ("alerts_staleness_growth_factor", lambda v: v > 1, "> 1"),
    ("alerts_hbm_headroom_frac", lambda v: 0 <= v < 1, "in [0, 1)"),
    ("alerts_retrace_storm", lambda v: v >= 1, ">= 1"),
    ("alerts_shard_imbalance", lambda v: v > 1, "> 1"),
    ("alerts_replay_ess_frac", lambda v: 0 < v < 1, "in (0, 1)"),
    ("alerts_priority_saturation", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_never_sampled_growth", lambda v: v > 1, "> 1"),
    ("alerts_lane_starved_frac", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_rank_straggler", lambda v: v > 1, "> 1"),
    ("alerts_lockstep_wait_frac", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_fleet_desync", lambda v: v > 1, "> 1"),
    ("alerts_missing_rank_age_s", lambda v: v > 0, "> 0"),
    ("alerts_serve_p99_ms", lambda v: v > 0, "> 0"),
    ("alerts_serve_starved_frac", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_serve_churn", lambda v: v >= 1, ">= 1"),
    ("alerts_serve_shed_frac", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_quant_agreement", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_spill_thrash_frac", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_fanout_lag", lambda v: v >= 1, ">= 1"),
    ("alerts_orphaned_slots", lambda v: v >= 1, ">= 1"),
    ("alerts_ingest_backlog", lambda v: v >= 1, ">= 1"),
    ("alerts_spill_promotion_ms", lambda v: v > 0, "> 0"),
    ("alerts_e2e_latency_growth", lambda v: v > 1, "> 1"),
    ("alerts_snapshot_stale_s", lambda v: v > 0, "> 0"),
    ("alerts_recovery_loop", lambda v: v >= 1, ">= 1"),
    ("alerts_quality_regression", lambda v: 0 < v < 1, "in (0, 1)"),
    ("alerts_canary_divergence", lambda v: 0 < v <= 1, "in (0, 1]"),
    ("alerts_promotion_stall_s", lambda v: v > 0, "> 0"),
    ("trace_sample_every", lambda v: v >= 1, ">= 1"),
)

_SCALARS = {"bool": bool, "int": int, "float": float, "str": str,
            "Optional[str]": str}


def _coerce(key: str, value: str, annotation: str) -> Any:
    if "Tuple[Tuple[int, int, int], ...]" in str(annotation):
        # --network.conv_layers=8,4,2;16,3,1
        try:
            layers = tuple(tuple(int(x) for x in triple.split(","))
                           for triple in value.split(";") if triple)
        except ValueError:
            layers = ()
        if not layers or any(len(t) != 3 for t in layers):
            raise SystemExit(
                f"invalid value {value!r} for {key!r}: expected "
                "';'-separated out_channels,kernel,stride triples")
        return layers
    if str(annotation) == "Any":
        # actor.anakin_priority: a number is a constant stamp, any other
        # string stays a string for Config's check ("td")
        try:
            return float(value)
        except ValueError:
            return value
    target = _SCALARS.get(str(annotation))
    if target is None:
        raise SystemExit(f"cannot set {key!r} from the command line")
    if target is bool:
        lowered = value.lower()
        if lowered in ("1", "true", "yes", "on"):
            return True
        if lowered in ("0", "false", "no", "off"):
            return False
        raise SystemExit(f"invalid value {value!r} for {key!r} (expected a "
                         "boolean)")
    try:
        return target(value)
    except ValueError:
        raise SystemExit(f"invalid value {value!r} for {key!r} (expected "
                         f"{target.__name__})") from None


def parse_overrides(cfg: Config, argv: List[str]) -> Config:
    """Apply ``--section.field=value`` overrides, coerced from the field
    annotations. Unknown keys raise."""
    dotted: Dict[str, Any] = {}
    for arg in argv:
        if not arg.startswith("--") or "=" not in arg:
            raise SystemExit(
                f"unrecognized argument {arg!r}; expected --section.field=value")
        key, _, raw = arg[2:].partition("=")
        section, _, fname = key.partition(".")
        if section not in {f.name for f in dataclasses.fields(cfg)}:
            raise SystemExit(f"unknown config section {section!r}")
        matching = {f.name: f for f in dataclasses.fields(getattr(cfg, section))}
        if fname not in matching:
            hint = not_ported_hint(section, fname)
            if hint:
                hint = (": the JAX package's field, not ported yet (ROADMAP "
                        f"{hint})")
            raise SystemExit(f"unknown field {fname!r} in section "
                             f"{section!r}{hint}")
        dotted[key] = _coerce(key, raw, matching[fname].type)
    return cfg.replace(**dotted) if dotted else cfg


def apex_epsilon(actor_id: int, num_actors: int, base_eps: float,
                 alpha: float) -> float:
    """Ape-X per-actor epsilon ladder: eps_i = base ** (1 + i*alpha/(N-1));
    a single actor gets base_eps."""
    if num_actors <= 1:
        return base_eps
    return base_eps ** (1 + actor_id / (num_actors - 1) * alpha)


def vector_lane_epsilons(actor_idx: int, actor_cfg: ActorConfig,
                         total_actors: Optional[int] = None) -> List[float]:
    """Per-lane epsilon of one vector actor worker: the Ape-X ladder spread
    over all ``total_actors * envs_per_actor`` lanes, worker ``actor_idx``
    owning a contiguous slice, so a fleet of vector actors explores like
    the equally sized fleet of scalar actors. ``total_actors`` defaults to
    ``actor_cfg.num_actors``."""
    if total_actors is None:
        total_actors = actor_cfg.num_actors
    if not 0 <= actor_idx < total_actors:
        raise ValueError(f"actor_idx {actor_idx} outside the fleet of "
                         f"{total_actors} workers")
    k = actor_cfg.envs_per_actor
    total = total_actors * k
    return [apex_epsilon(actor_idx * k + lane, total, actor_cfg.base_eps,
                         actor_cfg.eps_alpha)
            for lane in range(k)]
