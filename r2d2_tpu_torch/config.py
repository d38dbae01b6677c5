"""Configuration of the PyTorch port: the env, network, sequence, replay,
optim, actor and runtime sections of the JAX package's config, with the
same field names and defaults, so a ``--section.field=value`` override
means the same thing in both packages. Only the fields the port reads are
here: a setting of a part the port does not have yet
(``--network.inference_dtype=int8``, ``--replay.ingest_batch_blocks=8``,
``--runtime.snapshot_interval=N``, ``--mesh.dp=2``, ...) is refused as an
unknown field instead of being ignored.

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
  of K steps on the card (``learner/train_step.py
  make_multi_learner_step``). -1 = the bench's winner on CUDA, 1 on the
  CPU.
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
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

PLACEMENTS = ("device", "host")       # replay.placement

# What "auto" (and steps_per_dispatch=-1) resolves to on CUDA: the faster
# setting in pairs that tools/bench.py measured in one call on an H100 at
# the reference shape (PERF.md section 5): the fused scan against the loop
# (single DQN), and K=4, the fewest steps a dispatch within 1% of the
# fastest. fused_double_unroll stays off: an interleaved unroll measured
# no faster than the two unrolls, which both settings now run. The CPU
# resolves them to off, off and 1.
CUDA_AUTO = {"network.pallas_lstm": True,
             "optim.fused_double_unroll": False,
             "runtime.steps_per_dispatch": 4}


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
    # blocks the learner pops from the feeder queue per drain, in the
    # training loop and the orchestrator's warm-up loop alike
    drain_max_blocks: int = 32
    # rate limiter: ingestion pauses once env_steps > learning_starts +
    # ratio * train_steps (0 = unthrottled); the synchronous trainer
    # collects exactly this many env steps per dispatch
    max_env_steps_per_train_step: float = 0.0
    placement: str = "device"       # or "host"


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

    def resolved_steps_per_dispatch(self, device) -> int:
        """A value > 0 as given; otherwise the bench's winner on CUDA and 1
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
        if self.replay.drain_max_blocks < 1:
            raise ValueError(
                f"replay.drain_max_blocks ({self.replay.drain_max_blocks}) "
                "must be >= 1")
        if not 1 <= self.actor.envs_per_actor <= 100:
            raise ValueError(
                f"actor.envs_per_actor ({self.actor.envs_per_actor}) must be "
                "in [1, 100]: per-lane seeds fill the worker's 100-wide seed "
                "window (runtime.seed + 100*actor_idx + lane)")
        self._check_envs_and_acting()

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
        if actor.anakin_lanes > self.num_blocks:
            raise ValueError(
                f"actor.anakin_lanes ({actor.anakin_lanes}) must be <= "
                f"num_blocks ({self.num_blocks}): each segment writes one "
                "block per lane in one ring write, whose rows must not "
                "alias; grow replay.capacity or lower the lane count")

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
                  "runtime": RuntimeConfig}


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


_SCALARS = {"bool": bool, "int": int, "float": float, "str": str}


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
            raise SystemExit(f"unknown field {fname!r} in section {section!r}")
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
