"""Host-side acting policies: the network's T=1 step in f32 on the CPU,
the rolling frame stack, and epsilon-greedy exploration from numpy's
``default_rng`` streams, the counterparts of the JAX package's
``ActorPolicy`` and ``BatchedActorPolicy``.

Actors act on host CPUs while the learner owns the card, as in the JAX
package: each policy holds its own f32 CPU module. Weights arrive either
as a module (copied over) or as a flat f32 host snapshot, the parameters
in ``module.parameters()`` order (runtime/weights.py), which is what the
weight service publishes. A policy never reads the learner's live CUDA
module while it trains.

At ``network.inference_dtype`` "bf16" or "int8" the policies act with the
quantized twin (models/network.py): the published payload is then the
bundle (f32 weights, twin, stamp), and a module or plain weights given
directly get a twin built here (stamp 0). The forward then also takes a
tick and the live row count and returns the accuracy probe
(``make_forward_fn``); the probe's results go to a ``QuantStats``.
"""

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.models.network import (NetworkApply, QuantInference,
                                           action_one_hot, bundle_from_flat,
                                           bundle_size, f32_reference_module,
                                           initial_hidden, is_quant_bundle,
                                           make_inference_bundle,
                                           named_params)
from r2d2_tpu_torch.runtime.weights import load_parameters


def host_network(net: NetworkApply) -> NetworkApply:
    """The acting twin of ``net``: f32 on the CPU whatever the learner's
    compute policy (parameters are f32 storage under either, so the
    weight exchange is unchanged)."""
    h, w, s = net.obs_hw
    return NetworkApply(net.action_dim,
                        dataclasses.replace(net.config, bf16="off"),
                        s, h, w, device="cpu")


def make_forward_fn(net: NetworkApply, inference_dtype: Optional[str] = None,
                    probe_interval: int = 0):
    """The one acting forward, shared by both policies and the policy
    server (serve/server.py), so served and local inference run one
    program.

    At "f32" (``inference_dtype`` defaults to ``net.config``'s): a (N, 1)
    single-step recurrent forward ``fn(module, stacked_obs, last_action,
    hidden)`` with ``stacked_obs`` (N, H, W, stack) f32 in [0, 1],
    ``last_action`` (N,) int (-1 = none, a zero one-hot row) and
    ``hidden`` (N, 2, hidden) packed, arrays or tensors on the module's
    device; returns (greedy actions (N,), Q (N, A), hidden' (N, 2,
    hidden)) as tensors.

    At "bf16"/"int8": ``fn(twin, stacked_obs, last_action, hidden, tick,
    live) -> (actions, q, hidden', probe)`` with ``twin`` an
    ``InferenceTwin``. On every ``probe_interval``-th tick the f32 twin
    also runs on the same inputs, and probe = (max |Q_f32 - Q| over the
    first ``live`` rows, the greedy agreement over them, 1.0); on other
    ticks (0, 0, 0), and the f32 twin does not run. JAX decides this with
    a ``lax.cond`` inside its program; the caller knows the tick on the
    host, so here it is a host-side branch. ``live`` keeps padding rows
    (the server's buckets) out of the probe."""
    mode = (inference_dtype if inference_dtype is not None
            else net.config.inference_dtype)

    def inputs(stacked_obs, last_action, hidden, device):
        obs = torch.as_tensor(stacked_obs, dtype=torch.float32,
                              device=device)[:, None]
        la = torch.as_tensor(last_action, dtype=torch.int64, device=device)
        one_hot = action_one_hot(la, net.action_dim)[:, None]  # (N, 1, A)
        return obs, one_hot, torch.as_tensor(hidden, device=device)

    if mode == "f32":
        @torch.no_grad()
        def step_fn(module, stacked_obs, last_action, hidden):
            device = next(module.parameters()).device
            q, h = module(*inputs(stacked_obs, last_action, hidden, device))
            q = q[:, 0]
            return q.argmax(dim=-1), q, h

        return step_fn

    interval = int(probe_interval)

    @torch.no_grad()
    def quant_step_fn(twin, stacked_obs, last_action, hidden, tick, live):
        obs, one_hot, hid = inputs(stacked_obs, last_action, hidden,
                                   twin.device)
        q, h = twin.quant(obs, one_hot, hid)
        q = q[:, 0]
        actions = q.argmax(dim=-1)
        if interval > 0 and int(tick) % interval == 0:
            q32, _ = twin.f32(obs, one_hot, hid)
            probe = quant_probe(q, actions, q32[:, 0], live)
        else:
            zero = torch.zeros((), device=q.device)
            probe = (zero, zero, zero)
        return actions, q, h, probe

    return quant_step_fn


def quant_probe(q: torch.Tensor, actions: torch.Tensor, q32: torch.Tensor,
                live) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max |q32 - q|, greedy agreement, 1.0) over the first ``live``
    rows, as 0-d tensors."""
    mask = torch.arange(q.shape[0], device=q.device) < int(live)
    n = mask.float().sum().clamp_min(1.0)
    dq = torch.where(mask[:, None], (q32 - q).abs(),
                     torch.zeros((), device=q.device)).max()
    agree = ((q32.argmax(dim=-1) == actions) & mask).float().sum() / n
    return dq, agree, torch.ones((), device=q.device)


class InferenceTwin:
    """A bundle adopted on a device for the quantized forward: ``quant``
    (the prepared twin, models/network.py ``QuantInference``), ``f32`` (the
    probe's true-f32 reference module) and ``stamp``. ``load_`` adopts a
    new bundle into the same storage."""

    def __init__(self, net: NetworkApply, bundle, device=None):
        self.device = torch.device(device if device is not None
                                   else net.device)
        self.quant = QuantInference(net, bundle["quant"], self.device)
        self.f32 = f32_reference_module(net, self.device)
        self.stamp = 0
        self.load_(bundle)

    def load_(self, bundle) -> None:
        self.quant.load_(bundle["quant"])
        with torch.no_grad():
            for p, v in zip(self.f32.parameters(),
                            named_params(self.quant.net,
                                         bundle["f32"]).values()):
                p.copy_(v)
        self.stamp = int(bundle["stamp"])

    def tensors(self):
        return self.quant.tensors() + list(self.f32.parameters())


def as_bundle(net: NetworkApply, params):
    """``params`` as the inference bundle of ``net``'s inference dtype:
    a bundle as it is, the flat payload of one decoded, anything else (a
    module, plain weights) quantized here with stamp 0."""
    if is_quant_bundle(params):
        return params
    if not isinstance(params, (torch.nn.Module, Mapping)):
        flat = torch.as_tensor(params)
        if flat.dim() == 1 and flat.numel() == bundle_size(net) \
                and flat.numel() != net.num_params:
            return bundle_from_flat(net, flat)
    return make_inference_bundle(net, params, 0)


def feed_quant_probe(stats, probe_interval: int, probe, lanes: int,
                     tick: Optional[int] = None) -> None:
    """One forward's probe (dq_max, agree_frac, probed) into a QuantStats,
    shared by the local policies and the server. No sink, no probe, or a
    tick off the interval (known on the host) reads nothing back."""
    if stats is None or probe_interval <= 0:
        return
    if tick is not None and tick % probe_interval != 0:
        return
    dq, agree, probed = (float(x) for x in probe)
    if probed > 0.5:
        stats.on_probe(dq, agree, lanes=lanes)


class _HostModule:
    """The f32 CPU module both policies act with, its weight intake, and
    the quantized plumbing (the twin, the tick, the probe's sink), which
    does nothing at inference_dtype "f32"."""

    def _init_module(self, net: NetworkApply, params, copy_updates: bool,
                     quant_stats=None, probe_interval: int = 0):
        self.net = host_network(net)
        self.action_dim = net.action_dim
        self._copy_updates = copy_updates
        self._quant = self.net.config.inference_dtype != "f32"
        self._quant_stats = quant_stats
        self._probe_interval = int(probe_interval) if self._quant else 0
        self._tick = 0
        if self._quant:
            self.twin = InferenceTwin(self.net, as_bundle(self.net, params),
                                      "cpu")
        else:
            self.module = self.net.build().eval().requires_grad_(False)
            load_parameters(self.module, params, copy=True)
        self._fwd = make_forward_fn(self.net,
                                    probe_interval=self._probe_interval)

    def update_params(self, params) -> None:
        """Adopt new weights: a module, or a flat f32 host snapshot (the
        bundle's payload at a quantized dtype). With ``copy_updates=False``
        a snapshot becomes the module's storage (the weight subscriber
        hands over a fresh copy per poll)."""
        if self._quant:
            bundle = as_bundle(self.net, params)
            self.twin.load_(bundle)
            if self._quant_stats is not None:
                self._quant_stats.on_stamp(bundle["stamp"])
            return
        load_parameters(self.module, params, copy=self._copy_updates)

    def _forward(self, stacked, last_action, hidden, lanes: int,
                 feed: bool = True):
        if not self._quant:
            return self._fwd(self.module, stacked, last_action, hidden)
        actions, q, h, probe = self._fwd(self.twin, stacked, last_action,
                                         hidden, self._tick, lanes)
        if feed:
            feed_quant_probe(self._quant_stats, self._probe_interval, probe,
                             lanes, tick=self._tick)
        return actions, q, h


class ActorPolicy(_HostModule):
    def __init__(self, net: NetworkApply, params, epsilon: float,
                 seed: int = 0, copy_updates: bool = True, quant_stats=None,
                 quant_probe_interval: int = 0):
        self._init_module(net, params, copy_updates, quant_stats,
                          quant_probe_interval)
        self.epsilon = float(epsilon)
        self.rng = np.random.default_rng(seed)
        self.reset_state()

    def reset_state(self) -> None:
        h, w, s = self.net.obs_hw
        self.hidden = initial_hidden(1, self.net.config.hidden_dim)
        self.stacked = np.zeros((h, w, s), np.float32)
        self.last_action = -1

    def observe_reset(self, obs: np.ndarray) -> None:
        """Fill the frame stack with the episode's first observation."""
        self.reset_state()
        self.stacked[:] = (np.asarray(obs, np.float32) / 255.0)[..., None]

    def observe(self, obs: np.ndarray, action: int) -> None:
        """Roll the frame stack and record the action taken."""
        self.stacked = np.roll(self.stacked, -1, axis=-1)
        self.stacked[..., -1] = np.asarray(obs, np.float32) / 255.0
        self.last_action = int(action)

    def _step(self, feed: bool = True):
        return self._forward(self.stacked[None], [self.last_action],
                             self.hidden, 1, feed)

    def step(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """Greedy action, Q-values and packed hidden after this step."""
        action, q, self.hidden = self._step()
        self._tick += 1
        return int(action[0]), q[0].numpy(), self.hidden[0].numpy()

    def act(self) -> Tuple[int, np.ndarray, np.ndarray]:
        action, q, hidden = self.step()
        if self.rng.random() < self.epsilon:
            action = int(self.rng.integers(self.action_dim))
        return action, q, hidden

    def bootstrap_q(self) -> np.ndarray:
        """Q at the current state without advancing the recurrent state
        (the tick does not advance either, so no probe is fed twice)."""
        return self._step(feed=False)[1][0].numpy()


class BatchedActorPolicy(_HostModule):
    """N env lanes through one (N, 1) forward a tick. Per-lane state
    (frame stack, packed hidden, last action) lives in host numpy so one
    lane resets without touching the others; each lane has its own
    epsilon and its own numpy stream, drawn in the scalar policy's order
    (one uniform a step, one integer only when exploring), so a lane acts
    like the ``ActorPolicy`` it replaces."""

    def __init__(self, net: NetworkApply, params,
                 epsilons: Sequence[float], seeds: Sequence[int],
                 copy_updates: bool = True, quant_stats=None,
                 quant_probe_interval: int = 0):
        if len(epsilons) != len(seeds):
            raise ValueError(
                f"epsilons ({len(epsilons)}) and seeds ({len(seeds)}) must "
                "have one entry per lane")
        self._init_module(net, params, copy_updates, quant_stats,
                          quant_probe_interval)
        self.num_lanes = len(epsilons)
        self.epsilons = np.asarray(epsilons, np.float64)
        self.rngs = [np.random.default_rng(s) for s in seeds]
        self.reset_state()

    def reset_state(self) -> None:
        h, w, s = self.net.obs_hw
        n = self.num_lanes
        self.hidden = np.zeros((n, 2, self.net.config.hidden_dim), np.float32)
        self.stacked = np.zeros((n, h, w, s), np.float32)
        self.last_action = np.full(n, -1, np.int32)

    def reset_lane(self, lane: int) -> None:
        self.hidden[lane] = 0.0
        self.stacked[lane] = 0.0
        self.last_action[lane] = -1

    def observe_reset_lane(self, lane: int, obs: np.ndarray) -> None:
        self.reset_lane(lane)
        self.stacked[lane] = (np.asarray(obs, np.float32) / 255.0)[..., None]

    def observe(self, obs: np.ndarray, actions: np.ndarray) -> None:
        """obs (N, H, W) uint8; actions (N,)."""
        self.stacked = np.roll(self.stacked, -1, axis=-1)
        self.stacked[..., -1] = np.asarray(obs, np.float32) / 255.0
        self.last_action = np.asarray(actions, np.int32)

    def _step(self, feed: bool = True):
        return self._forward(self.stacked, self.last_action, self.hidden,
                             self.num_lanes, feed)

    def step(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Greedy actions (N,), Q (N, A), packed hiddens (N, 2, hidden)
        after this step."""
        actions, q, hidden = self._step()
        self._tick += 1
        self.hidden = hidden.numpy().copy()   # reset_lane writes rows
        return actions.numpy(), q.numpy(), self.hidden

    def act(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        actions, q, hidden = self.step()
        actions = np.array(actions)
        for i, rng in enumerate(self.rngs):
            if rng.random() < self.epsilons[i]:
                actions[i] = int(rng.integers(self.action_dim))
        return actions, q, hidden

    def bootstrap_q(self) -> np.ndarray:
        """(N, A) Q at every lane's current state, no state advanced."""
        return self._step(feed=False)[1].numpy()
