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
"""

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.models.network import (NetworkApply, action_one_hot,
                                           initial_hidden)
from r2d2_tpu_torch.runtime.weights import load_parameters


def host_network(net: NetworkApply) -> NetworkApply:
    """The acting twin of ``net``: f32 on the CPU whatever the learner's
    compute policy (parameters are f32 storage under either, so the
    weight exchange is unchanged)."""
    h, w, s = net.obs_hw
    return NetworkApply(net.action_dim,
                        dataclasses.replace(net.config, bf16="off"),
                        s, h, w, device="cpu")


def make_forward_fn(net: NetworkApply):
    """The one acting forward, shared by both policies: a (N, 1)
    single-step recurrent forward ``fn(module, stacked_obs, last_action,
    hidden)`` with ``stacked_obs`` (N, H, W, stack) f32 in [0, 1],
    ``last_action`` (N,) int (-1 = none, a zero one-hot row) and
    ``hidden`` (N, 2, hidden) packed, arrays or tensors on the module's
    device; returns (greedy actions (N,), Q (N, A), hidden' (N, 2,
    hidden)) as tensors."""

    @torch.no_grad()
    def step_fn(module, stacked_obs, last_action, hidden):
        obs = torch.as_tensor(stacked_obs, dtype=torch.float32)[:, None]
        la = torch.as_tensor(last_action, dtype=torch.int64)
        one_hot = action_one_hot(la, net.action_dim)[:, None]  # (N, 1, A)
        q, h = module(obs, one_hot, torch.as_tensor(hidden))
        q = q[:, 0]
        return q.argmax(dim=-1), q, h

    return step_fn


class _HostModule:
    """The f32 CPU module both policies act with, and its weight intake."""

    def _init_module(self, net: NetworkApply, params, copy_updates: bool):
        self.net = host_network(net)
        self.module = self.net.build().eval().requires_grad_(False)
        self.action_dim = net.action_dim
        self._copy_updates = copy_updates
        load_parameters(self.module, params, copy=True)
        self._fwd = make_forward_fn(self.net)

    def update_params(self, params) -> None:
        """Adopt new weights: a module, or a flat f32 host snapshot. With
        ``copy_updates=False`` a snapshot becomes the module's storage
        (the weight subscriber hands over a fresh copy per poll)."""
        load_parameters(self.module, params, copy=self._copy_updates)


class ActorPolicy(_HostModule):
    def __init__(self, net: NetworkApply, params, epsilon: float,
                 seed: int = 0, copy_updates: bool = True):
        self._init_module(net, params, copy_updates)
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

    def _step(self):
        return self._fwd(self.module, self.stacked[None],
                         [self.last_action], self.hidden)

    def step(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """Greedy action, Q-values and packed hidden after this step."""
        action, q, self.hidden = self._step()
        return int(action[0]), q[0].numpy(), self.hidden[0].numpy()

    def act(self) -> Tuple[int, np.ndarray, np.ndarray]:
        action, q, hidden = self.step()
        if self.rng.random() < self.epsilon:
            action = int(self.rng.integers(self.action_dim))
        return action, q, hidden

    def bootstrap_q(self) -> np.ndarray:
        """Q at the current state without advancing the recurrent state."""
        return self._step()[1][0].numpy()


class BatchedActorPolicy(_HostModule):
    """N env lanes through one (N, 1) forward a tick. Per-lane state
    (frame stack, packed hidden, last action) lives in host numpy so one
    lane resets without touching the others; each lane has its own
    epsilon and its own numpy stream, drawn in the scalar policy's order
    (one uniform a step, one integer only when exploring), so a lane acts
    like the ``ActorPolicy`` it replaces."""

    def __init__(self, net: NetworkApply, params,
                 epsilons: Sequence[float], seeds: Sequence[int],
                 copy_updates: bool = True):
        if len(epsilons) != len(seeds):
            raise ValueError(
                f"epsilons ({len(epsilons)}) and seeds ({len(seeds)}) must "
                "have one entry per lane")
        self._init_module(net, params, copy_updates)
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

    def _step(self):
        return self._fwd(self.module, self.stacked, self.last_action,
                         self.hidden)

    def step(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Greedy actions (N,), Q (N, A), packed hiddens (N, 2, hidden)
        after this step."""
        actions, q, hidden = self._step()
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
        return self._step()[1].numpy()
