"""The cost model, the JAX package's ``telemetry/costmodel.py``. Its
analytic half: per-component (torso / lstm / head / sum_tree / replay)
FLOPs and bytes of one learner step and the serial-chain model, from the
config alone (no device work). The periodic record's one-shot ``costs``
block is built from it (runtime/learner_loop.py), and ``chip_smoke.py``
and ``tools/profile_step.py`` divide ``model_flops_per_step`` by a
measured step time for the share of the card's peak. Its measured half,
in place of XLA's program costs: ``program_cost`` and
``collect_cost_table`` count the FLOPs one call of each program executes
(``torch.utils.flop_counter`` plus the hand kernels' formulas;
``tools/roofline.py`` joins them).

``peak_spec`` reads the card's peak rates from ``PEAK_SPECS``, a table of
NVIDIA cards keyed by a substring of ``torch.cuda.get_device_name``. Each
row is the vendor's datasheet figure for that card at the power limit it
names: dense (no sparsity) tensor-core bf16 FLOP/s, FP32 FLOP/s on the
CUDA cores, and the device memory rate. A card below its limit runs
slower under load, so a share of the peak is stated beside the card's
name and its limit as ``nvidia-smi`` reports it. An unknown card, or the
CPU, gets a nominal placeholder marked ``nominal=True``, never quoted.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

# (device-name marker, spec); the first marker found in the name wins, so
# the specific variants come before the plain "H100"
PEAK_SPECS: Tuple[Tuple[str, Dict[str, Any]], ...] = (
    # H100 NVL, 400 W
    ("h100 nvl", dict(flops_bf16=835.5e12, flops_f32=60e12,
                      hbm_gbps=3900.0, power_limit_w=400.0)),
    # H100 PCIe, 350 W
    ("h100 pcie", dict(flops_bf16=756e12, flops_f32=51e12,
                       hbm_gbps=2000.0, power_limit_w=350.0)),
    # H100 SXM5 (reported as "NVIDIA H100 80GB HBM3"), 700 W
    ("h100", dict(flops_bf16=989.4e12, flops_f32=67e12, hbm_gbps=3350.0,
                  power_limit_w=700.0)),
    # A100 SXM4 80GB, 400 W
    ("a100", dict(flops_bf16=312e12, flops_f32=19.5e12, hbm_gbps=2039.0,
                  power_limit_w=400.0)),
)

# a placeholder for the CPU and unknown cards: structure only
NOMINAL = dict(flops_bf16=5e10, flops_f32=5e10, hbm_gbps=10.0,
               power_limit_w=None, nominal=True)


def peak_spec(device_kind: Optional[str] = None) -> Dict[str, Any]:
    """Peak FLOP/s and memory rate of ``device_kind`` (default: CUDA
    device 0's name, or "cpu" without CUDA)."""
    if device_kind is None:
        import torch
        device_kind = (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu")
    kind = device_kind.lower()
    for marker, spec in PEAK_SPECS:
        if marker in kind:
            return dict(spec, device_kind=device_kind, nominal=False)
    return dict(NOMINAL, device_kind=device_kind)


COMPONENTS = ("torso", "lstm", "head", "sum_tree", "replay")


def _tree_num_layers(capacity: int) -> int:
    """Smallest L with 2**(L-1) >= capacity leaves."""
    num_layers = 1
    while capacity > 2 ** (num_layers - 1):
        num_layers += 1
    return num_layers


def _conv_pyramid(cfg, action_dim: int):
    """Per-layer conv MACs a token and activation element counts, and the
    FC, LSTM and head MACs a token: the one place of the shape math."""
    net, env = cfg.network, cfg.env
    h, w, c = env.frame_height, env.frame_width, env.frame_stack
    conv_macs, conv_elems = [], []
    for features, kernel, stride in net.conv_layers:
        h = (h - kernel) // stride + 1
        w = (w - kernel) // stride + 1
        conv_macs.append(h * w * features * kernel * kernel * c)
        conv_elems.append(h * w * features)
        c = features
    fc_macs = h * w * c * net.cnn_out_dim
    lstm_in = net.cnn_out_dim + action_dim
    lstm_macs = 4 * net.hidden_dim * (lstm_in + net.hidden_dim)
    head_macs = net.hidden_dim * net.hidden_dim + net.hidden_dim * action_dim
    if net.use_dueling:
        head_macs += net.hidden_dim * net.hidden_dim + net.hidden_dim
    return conv_macs, conv_elems, fc_macs, lstm_macs, head_macs


def model_flops_per_step(cfg, action_dim: int, use_double: bool) -> float:
    """Model FLOPs of one learner step: forward, backward (~2x the
    forward) and with double DQN the target forward, the conv, FC, LSTM
    and head MACs over the whole (batch x window) unroll at 2 FLOPs a
    MAC. Elementwise, decode and Adam FLOPs are not counted. The first
    conv's input gradient is never computed (the observation needs none),
    so the first conv counts one unroll fewer."""
    conv_macs, _, fc_macs, lstm_macs, head_macs = _conv_pyramid(
        cfg, action_dim)
    unrolls = 3.0 + (1.0 if use_double else 0.0)
    tokens = cfg.replay.batch_size * cfg.sequence.seq_len
    macs_all = sum(conv_macs) + fc_macs + lstm_macs + head_macs
    first_conv = conv_macs[0] if conv_macs else 0.0
    return 2.0 * tokens * (macs_all * unrolls - first_conv)


def analytic_component_costs(cfg, action_dim: int,
                             use_double: Optional[bool] = None,
                             act_bytes: Optional[int] = None,
                             device=None) -> Dict[str, Any]:
    """Per-component FLOPs and bytes of one learner step, from the config
    alone. Bytes are first-order estimates (activations read and written
    once an unroll in the compute dtype, parameters read once an unroll
    in f32, the uint8 gather and decode, the sum tree's node touches),
    enough to tell compute- from memory-bound components, not a transfer
    model. ``act_bytes``: the resolved activation dtype's size (the
    Learner passes 2 under bf16, 4 under f32); unresolved, "on" counts 2
    and anything else 4. ``device``: where the step runs, which resolves
    ``optim.fused_double_unroll``'s "auto" (the CPU's value without
    one)."""
    from r2d2_tpu_torch.config import resolve_fused_double_unroll
    net, env, seq = cfg.network, cfg.env, cfg.sequence
    if use_double is None:
        use_double = net.use_double
    conv_macs, conv_elems, fc_macs, lstm_macs, head_macs = _conv_pyramid(
        cfg, action_dim)
    B, T = cfg.replay.batch_size, seq.seq_len
    tokens = B * T
    unrolls = 3.0 + (1.0 if use_double else 0.0)
    if act_bytes is None:
        act_bytes = 2 if str(net.bf16).lower() in ("on", "true", "1") else 4
    H = net.hidden_dim

    obs_bytes = tokens * env.frame_height * env.frame_width * env.frame_stack
    conv_act_bytes = sum(conv_elems) * tokens * act_bytes
    c_in = env.frame_stack
    torso_params = 0.0
    for features, kernel, _ in net.conv_layers:
        torso_params += 4.0 * kernel * kernel * c_in * features
        c_in = features
    fc_in = conv_elems[-1] if conv_elems else 0
    torso_params += 4.0 * fc_in * net.cnn_out_dim
    lstm_params = 4.0 * 4 * H * ((net.cnn_out_dim + action_dim) + H)
    head_params = 4.0 * head_macs

    components = {
        "torso": {
            "flops": 2.0 * tokens * (
                (sum(conv_macs) + fc_macs) * unrolls
                - (conv_macs[0] if conv_macs else 0.0)),
            "bytes": (obs_bytes
                      + obs_bytes * act_bytes
                      + 2.0 * unrolls * conv_act_bytes
                      + unrolls * torso_params),
        },
        "lstm": {
            "flops": 2.0 * tokens * lstm_macs * unrolls,
            # the hoisted input projection and the per-step h/c chain;
            # the recurrent weights once (kept on chip across the scan)
            "bytes": (2.0 * unrolls * tokens * 4 * H * act_bytes
                      + 2.0 * unrolls * tokens * 2 * H * act_bytes
                      + unrolls * lstm_params),
        },
        "head": {
            "flops": 2.0 * tokens * head_macs * unrolls,
            "bytes": (2.0 * unrolls * tokens * (H + action_dim) * act_bytes
                      + unrolls * head_params),
        },
    }
    # the sum tree: the stratified descent, the leaf update and the
    # rebuild, a handful of f32 operations a (sample x layer)
    layers = _tree_num_layers(cfg.replay.capacity
                              // cfg.sequence.learning_steps)
    touches = B * layers
    components["sum_tree"] = {"flops": 8.0 * touches,
                              "bytes": 4.0 * 4 * touches}
    # the sample's data movement: the uint8 window gather, the hidden and
    # meta rows
    components["replay"] = {
        "flops": 0.0,
        "bytes": float(obs_bytes + B * 2 * H * 4
                       + B * seq.learning_steps * 4 * 4),
    }

    total_flops = sum(c["flops"] for c in components.values())
    # the serial recurrent chain: forward and backward walk it; the
    # target forward adds a walk under double DQN unless the fused dual
    # unroll interleaves it with the online one
    fused_dual = use_double and resolve_fused_double_unroll(
        cfg.optim.fused_double_unroll, device)
    serial_walks = 2 + (1 if (use_double and not fused_dual) else 0)
    serial_iters = T * serial_walks
    serial_flops = 2.0 * 4 * H * H * B * serial_iters
    return {
        "components": components,
        "total_flops": total_flops,
        "model_flops_per_step": model_flops_per_step(cfg, action_dim,
                                                     use_double),
        "tokens_per_step": tokens,
        "unrolls": unrolls,
        "serial_chain": {
            "iterations": serial_iters,
            "per_iter_flops": 2.0 * 4 * H * H * B,
            "flops": serial_flops,
            "share_of_total": (serial_flops / total_flops
                               if total_flops else 0.0),
        },
    }


def costs_block(cfg, action_dim: int, act_bytes: int,
                device=None) -> Dict[str, Any]:
    """The record's one-shot ``costs`` block, in the JAX package's keys."""
    costs = analytic_component_costs(cfg, action_dim, act_bytes=act_bytes,
                                      device=device)
    return {
        "model_flops_per_step": costs["model_flops_per_step"],
        "tokens_per_step": costs["tokens_per_step"],
        "components": {name: {"flops": c["flops"], "bytes": c["bytes"]}
                       for name, c in costs["components"].items()},
        "serial_chain": costs["serial_chain"],
    }



# ---------------------------------------------------------------------------
# The measured half: the FLOPs the port's programs execute, counted by
# ``torch.utils.flop_counter.FlopCounterMode`` (aten's matrix products and
# convolutions, backward included) plus the hand kernels' formulas
# (ops/launch_counts.py ``counted_flops``: a kernel launched through ctypes
# is invisible to the flop counter). On the CPU the plain versions run as
# aten operators and are counted directly; on the card the formulas stand
# in for them, so the two devices count the same program alike.

# the pinned small configuration the cost tables and the roofline's CPU
# preset build at (the JAX package's)
GATE_OVERRIDES = {
    "env.game_name": "Fake",
    "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
    "env.episode_len": 40,
    "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
    "network.hidden_dim": 32, "network.cnn_out_dim": 64,
    "network.use_double": True,
    "sequence.burn_in_steps": 6, "sequence.learning_steps": 5,
    "sequence.forward_steps": 3,
    "replay.capacity": 800, "replay.block_length": 20,
    "replay.batch_size": 8, "replay.learning_starts": 100,
    "actor.anakin_lanes": 4,
    "runtime.steps_per_dispatch": 3,
}


def gate_config():
    from r2d2_tpu_torch.config import Config
    return Config().replace(**GATE_OVERRIDES)


# the JAX package's GATE_VARIANTS the port has: the sharded and tensor-
# parallel steps need ranks of a mesh (``tools/dp_check.py``), not one
# process, and are left out
GATE_VARIANTS = ("learner_step", "learner_step_multi", "replay_add_many",
                 "replay_sample", "anakin_act", "serve_forward",
                 "quant_forward")


def program_cost(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under the flop counter: ``flops``
    (all of it), ``aten_flops`` (what the counter saw) and
    ``kernel_flops`` (the hand kernels' formulas, by kernel)."""
    from torch.utils.flop_counter import FlopCounterMode

    from r2d2_tpu_torch.ops.launch_counts import counted_flops
    with counted_flops() as kernels, FlopCounterMode(display=False) as mode:
        fn(*args, **kwargs)
    aten = float(mode.get_total_flops())
    return {"flops": aten + sum(kernels.values()), "aten_flops": aten,
            "kernel_flops": {k: v for k, v in kernels.items() if v}}


def collect_cost_table(cfg, variants=GATE_VARIANTS, device=None,
                       action_dim: Optional[int] = None) -> Dict[str, Any]:
    """Build each requested program at ``cfg``'s shapes on ``device``
    (CUDA by default; the CPU runs the plain versions) and count one call
    of it (telemetry off: the programs without the diagnostics, as the
    JAX package's table builds them). ``action_dim``: the env's (default:
    probed from ``cfg.env``)."""
    import numpy as np
    import torch

    from r2d2_tpu_torch.learner.train_step import (_make_step_body,
                                                   create_train_state,
                                                   eager_steps,
                                                   make_learner_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.device_replay import (replay_add_many,
                                                     replay_init,
                                                     replay_sample)
    from r2d2_tpu_torch.replay.structs import ReplaySpec, stack_blocks
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    from r2d2_tpu_torch.utils.device import resolve_device

    variants = tuple(variants)
    unknown = set(variants) - set(GATE_VARIANTS)
    if unknown:
        raise ValueError(f"unknown cost variants {sorted(unknown)}; the "
                         f"port has {GATE_VARIANTS}")
    device = resolve_device(device)
    cfg = cfg.replace(**{"telemetry.enabled": False})
    if action_dim is None:
        from r2d2_tpu_torch.envs.factory import create_env
        probe = create_env(cfg.env, seed=cfg.runtime.seed)
        action_dim = probe.action_space.n
        probe.close()
    net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    spec = ReplaySpec.from_config(cfg, device)
    use_double = cfg.network.use_double
    rng = np.random.default_rng(0)
    programs: Dict[str, Dict[str, Any]] = {}

    def block():
        # the synthetic block's actions, in this env's range
        blk = make_synthetic_block(spec, rng)
        return dataclasses.replace(
            blk, action=blk.action % action_dim,
            last_action_row=blk.last_action_row % action_dim)

    def filled():
        rs = replay_init(spec, device)
        k = min(8, spec.num_blocks)
        replay_add_many(spec, rs, stack_blocks([block() for _ in range(k)]))
        return rs, k

    if {"learner_step", "learner_step_multi", "replay_add_many",
            "replay_sample"} & set(variants):
        rs, k_add = filled()
        ts = create_train_state(net, cfg.optim, cfg.runtime.seed,
                                use_double)
    if "learner_step" in variants:
        step = make_learner_step(net, spec, cfg.optim, use_double)
        programs["learner_step"] = program_cost(step, ts, rs)
    if "learner_step_multi" in variants:
        k = max(cfg.runtime.resolved_steps_per_dispatch(device), 2)
        multi = eager_steps(_make_step_body(net, spec, cfg.optim,
                                            use_double), k)
        programs["learner_step_multi"] = dict(program_cost(multi, ts, rs),
                                              steps_per_dispatch=k)
    if "replay_add_many" in variants:
        blocks = stack_blocks([block() for _ in range(k_add)])
        programs["replay_add_many"] = dict(
            program_cost(replay_add_many, spec, rs, blocks), blocks=k_add)
    if "replay_sample" in variants:
        programs["replay_sample"] = program_cost(
            replay_sample, spec, rs, generator=ts.generator)
    if "anakin_act" in variants:
        from r2d2_tpu_torch.runtime.anakin_loop import _FusedParts
        parts = _FusedParts(cfg.replace(**{"actor.on_device": True}),
                            device, None, None)
        programs["anakin_act"] = dict(
            program_cost(parts.segment.run, 1, eager=True),
            lanes=cfg.actor.anakin_lanes)
    if "serve_forward" in variants or "quant_forward" in variants:
        from r2d2_tpu_torch.actor.policy import (InferenceTwin,
                                                 make_forward_fn)
        from r2d2_tpu_torch.models.network import make_inference_bundle
        b = cfg.serve.max_batch
        h, w, s = net.obs_hw
        obs = torch.zeros((b, h, w, s), device=device)
        last_action = torch.full((b,), -1, dtype=torch.int64, device=device)
        hidden = torch.zeros((b, 2, cfg.network.hidden_dim), device=device)
        module = net.init(cfg.runtime.seed)
        if "serve_forward" in variants:
            fwd = make_forward_fn(net, "f32")
            programs["serve_forward"] = dict(
                program_cost(fwd, module, obs, last_action, hidden),
                batch=b)
        if "quant_forward" in variants:
            dtype = (cfg.network.inference_dtype
                     if cfg.network.inference_dtype != "f32" else "int8")
            qnet = NetworkApply(
                action_dim, dataclasses.replace(cfg.network,
                                                inference_dtype=dtype),
                cfg.env.frame_stack, cfg.env.frame_height,
                cfg.env.frame_width, device)
            twin = InferenceTwin(qnet, make_inference_bundle(qnet, module, 1))
            fwd = make_forward_fn(qnet)
            programs["quant_forward"] = dict(
                program_cost(fwd, twin, obs, last_action, hidden, 1, b),
                batch=b, inference_dtype=dtype)
    return {"device": str(device),
            "shape": {"batch": spec.batch_size, "seq_len": spec.seq_window,
                      "frame": [cfg.env.frame_height, cfg.env.frame_width,
                                cfg.env.frame_stack],
                      "hidden": cfg.network.hidden_dim,
                      "cnn_out": cfg.network.cnn_out_dim},
            "action_dim": action_dim,
            "programs": programs}
