"""Host-side acting policy: the network's T=1 step in f32 on the CPU, the
rolling frame stack, and epsilon-greedy exploration from a
``torch.Generator`` — the counterpart of the JAX package's ``ActorPolicy``.

Actors act on host CPUs while the learner owns the card, as in the JAX
package; ``update_params`` copies the learner's weights over.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from r2d2_tpu_torch.models.network import NetworkApply, initial_hidden


class ActorPolicy:
    def __init__(self, net: NetworkApply, params: torch.nn.Module,
                 epsilon: float, seed: int = 0):
        h, w, s = net.obs_hw
        # f32 on the host whatever the learner's compute policy
        self.net = NetworkApply(net.action_dim,
                                dataclasses.replace(net.config, bf16="off"),
                                s, h, w, device="cpu")
        self.module = self.net.build().eval()
        self.epsilon = float(epsilon)
        self.action_dim = net.action_dim
        self.generator = torch.Generator().manual_seed(seed)
        self.update_params(params)
        self.reset_state()

    def update_params(self, params: torch.nn.Module) -> None:
        with torch.no_grad():
            for dst, src in zip(self.module.parameters(), params.parameters()):
                dst.copy_(src.detach().to("cpu", torch.float32))

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

    @torch.no_grad()
    def _forward(self):
        obs = torch.from_numpy(self.stacked)[None, None]       # (1,1,H,W,K)
        la = torch.zeros((1, 1, self.action_dim))
        if self.last_action >= 0:
            la = F.one_hot(torch.tensor([[self.last_action]]),
                           self.action_dim).float()
        q, hidden = self.module(obs, la, self.hidden)
        return q[0, 0], hidden

    def step(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """Greedy action, Q-values and packed hidden after this step."""
        q, self.hidden = self._forward()
        return int(q.argmax()), q.numpy(), self.hidden[0].numpy()

    def act(self) -> Tuple[int, np.ndarray, np.ndarray]:
        action, q, hidden = self.step()
        if torch.rand((), generator=self.generator) < self.epsilon:
            action = int(torch.randint(self.action_dim, (),
                                       generator=self.generator))
        return action, q, hidden

    def bootstrap_q(self) -> np.ndarray:
        """Q at the current state without advancing the recurrent state."""
        q, _ = self._forward()
        return q.numpy()
