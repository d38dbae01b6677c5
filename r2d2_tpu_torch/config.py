"""Configuration of the PyTorch port: the env, network, sequence, replay and
optim sections of the JAX package's config, with the same field names and
defaults, so a ``--section.field=value`` override means the same thing in
both packages. Only the fields the port reads are here: a JAX-only setting
(``--network.inference_dtype=int8``, ``--runtime.save_interval=N``, ...) is
refused as an unknown field instead of being ignored.

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
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

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
    episode_len: int = 120

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
    # env steps collected per learner step by the synchronous trainer
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
class RuntimeConfig:
    # learner steps per dispatch: one CUDA graph of K steps on the card, K
    # eager steps on the CPU; -1 = auto (resolved_steps_per_dispatch)
    steps_per_dispatch: int = -1
    # host placement: device batches the prefetch thread keeps queued
    prefetch_batches: int = 4

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
