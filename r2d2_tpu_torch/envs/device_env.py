"""Environments as batched tensor functions, the port's counterpart of the
JAX package's ``envs/jax_env.py``: ``DeviceFakeEnv`` (``JaxFakeEnv``),
``DeviceGridWorld`` (``JaxGridWorld``) and ``HostDeviceEnv``
(``HostJaxEnv``).

The host envs (envs/fake.py) step one lane a Python call. These step N
lanes with tensor ops on the device of their ``device`` field, so the
on-device acting segment (actor/anakin.py) runs env, policy and block
assembly without leaving the card, and one CUDA graph holds all of it.

Protocol (duck-typed; both envs are frozen dataclasses):

  * attributes ``action_dim``, ``episode_len``, ``height``, ``width``,
    ``device``;
  * ``reset_draws(n, generator)`` / ``step_draws(n, generator)``: the
    random numbers a reset or a step of n lanes consumes, drawn from
    ``generator`` (a tensor, or None for a step that draws nothing);
  * ``reset(draws) -> (state, obs)``: fresh episodes for the lanes the
    draws are for; ``state`` a small dataclass of (N, ...) tensors, ``obs``
    (N, height, width) uint8;
  * ``step(state, action, draws) -> (state, obs, reward, done)``: one
    transition of every lane; reward f32, done bool, True exactly at step
    ``episode_len`` (the acting segment relies on episode ends landing on
    block boundaries, ``episode_len % block_length == 0``).

Drawing is apart from the dynamics so that a caller can inject the
draws: the parity tests hand in the numbers ``jax.random`` gives the JAX
envs, and the comparison is exact. ``HostDeviceEnv`` puts one lane of
either env behind the host gym-style API, so the same dynamics run under
the host actor loops too (factory kinds "JaxFake" and "Grid").
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def is_grid_id(game_name: str) -> bool:
    """True when ``EnvConfig.game_name`` names the on-device gridworld:
    exactly "Grid" or the "JaxGrid" prefix, as in the JAX package. Not a
    bare "Grid" prefix, which would capture gymnasium games such as
    "GridWorld"."""
    return game_name == "Grid" or game_name.startswith("JaxGrid")


@dataclasses.dataclass
class FakeState:
    schedule: torch.Tensor      # (N, episode_len + 1) int64 target actions
    t: torch.Tensor             # (N,) int64 step within the episode


@dataclasses.dataclass
class GridState:
    pos: torch.Tensor           # (N, 2) int64 agent cell (row, col)
    goal: torch.Tensor          # (N, 2) int64 goal cell
    t: torch.Tensor             # (N,) int64


@dataclasses.dataclass(frozen=True)
class DeviceFakeEnv:
    """envs/fake.py's FakeR2D2Env as batched tensor ops, the twin of
    ``JaxFakeEnv``: a bright column band marks the target action, taking
    it pays +1. The host env draws its target schedule with numpy's
    ``default_rng(seed)``; ``reset`` draws it from a torch generator
    instead (the same distribution, other numbers). ``state_from_schedule``
    takes explicit schedules, which the parity tests use."""

    action_dim: int = 6
    episode_len: int = 120
    height: int = 84
    width: int = 84
    device: torch.device = torch.device("cpu")

    def obs(self, state: FakeState) -> torch.Tensor:
        target = state.schedule.gather(1, state.t[:, None])       # (N, 1)
        band = self.width // self.action_dim
        cols = torch.arange(self.width, device=state.t.device)[None, :]
        in_band = (cols >= target * band) & (cols < (target + 1) * band)
        rows = torch.arange(self.height, device=state.t.device)[None, :]
        texture = rows == (state.t % self.height)[:, None]        # (N, H)
        # the time texture row after the band (the host sets it last)
        frame = torch.where(in_band[:, None, :], 224, 32)
        return torch.where(texture[:, :, None], 128, frame).to(torch.uint8)

    def state_from_schedule(self, schedule) -> FakeState:
        """Lanes whose target schedules are exactly ``schedule`` ((N,
        episode_len + 1), e.g. host envs' ``_schedule``), at step 0."""
        schedule = torch.as_tensor(np.asarray(schedule), dtype=torch.int64,
                                   device=self.device)
        if schedule.ndim != 2 or schedule.shape[1] != self.episode_len + 1:
            raise ValueError(f"schedules must be (N, {self.episode_len + 1})"
                             f"; got {tuple(schedule.shape)}")
        return FakeState(schedule, torch.zeros(schedule.shape[0],
                                               dtype=torch.int64,
                                               device=self.device))

    def reset_draws(self, n: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.randint(0, self.action_dim, (n, self.episode_len + 1),
                             generator=generator, device=self.device)

    def step_draws(self, n: int, generator) -> None:
        return None                 # deterministic given the schedule

    def reset(self, draws: torch.Tensor) -> Tuple[FakeState, torch.Tensor]:
        state = FakeState(draws.long(), torch.zeros(
            draws.shape[0], dtype=torch.int64, device=draws.device))
        return state, self.obs(state)

    def step(self, state: FakeState, action: torch.Tensor, draws=None):
        target = state.schedule.gather(1, state.t[:, None])[:, 0]
        reward = (action.long() == target).float()
        new = FakeState(state.schedule, state.t + 1)
        return new, self.obs(new), reward, new.t >= self.episode_len


@dataclasses.dataclass(frozen=True)
class DeviceGridWorld:
    """The twin of ``JaxGridWorld``: a ``size`` x ``size`` grid rendered as
    a (height, width) frame, agent 255, goal 128, background 16. Actions
    up/down/left/right/stay; stepping onto the goal pays +1 and respawns
    the agent at a drawn cell (nudged off the goal); the goal stays for
    the episode."""

    size: int = 6
    episode_len: int = 120
    height: int = 84
    width: int = 84
    device: torch.device = torch.device("cpu")
    # up / down / left / right / stay
    action_dim: int = dataclasses.field(default=5, init=False)

    def obs(self, state: GridState) -> torch.Tensor:
        device = state.pos.device
        row_cell = torch.arange(self.height, device=device) \
            // (self.height // self.size)
        col_cell = torch.arange(self.width, device=device) \
            // (self.width // self.size)
        valid = ((row_cell < self.size)[:, None]
                 & (col_cell < self.size)[None, :])

        def cell_mask(cell):                                  # (N, H, W)
            return ((row_cell[None, :, None] == cell[:, 0, None, None])
                    & (col_cell[None, None, :] == cell[:, 1, None, None])
                    & valid)

        frame = torch.where(cell_mask(state.goal), 128, 16)
        return torch.where(cell_mask(state.pos), 255,
                           frame).to(torch.uint8)

    def _nudge_off(self, cell: torch.Tensor,
                   other: torch.Tensor) -> torch.Tensor:
        """Where ``cell`` is ``other``, one diagonal step on (mod size):
        a fix-up without rejection loops that keeps the two apart."""
        clash = (cell == other).all(dim=-1, keepdim=True)
        return torch.where(clash, (cell + 1) % self.size, cell)

    def reset_draws(self, n: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """(N, 2, 2): each lane's agent cell and goal cell, before the
        nudge."""
        return torch.randint(0, self.size, (n, 2, 2), generator=generator,
                             device=self.device)

    def step_draws(self, n: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """(N, 2): each lane's respawn cell, used where it reaches the
        goal."""
        return torch.randint(0, self.size, (n, 2), generator=generator,
                             device=self.device)

    def reset(self, draws: torch.Tensor) -> Tuple[GridState, torch.Tensor]:
        pos = draws[:, 0].long()
        goal = self._nudge_off(draws[:, 1].long(), pos)
        state = GridState(pos, goal, torch.zeros(
            draws.shape[0], dtype=torch.int64, device=draws.device))
        return state, self.obs(state)

    def step(self, state: GridState, action: torch.Tensor,
             draws: torch.Tensor):
        a = action.long()
        delta = torch.stack([torch.where(a == 0, -1, torch.where(a == 1, 1, 0)),
                             torch.where(a == 2, -1, torch.where(a == 3, 1, 0))],
                            dim=-1)
        pos = (state.pos + delta).clamp(0, self.size - 1)
        reached = (pos == state.goal).all(dim=-1)
        respawn = self._nudge_off(draws.long(), state.goal)
        pos = torch.where(reached[:, None], respawn, pos)
        new = GridState(pos, state.goal, state.t + 1)
        return (new, self.obs(new), reached.float(),
                new.t >= self.episode_len)


class HostDeviceEnv:
    """Gym-style host adapter over one lane of a device env (reset(),
    step(a), close()) on the CPU, drawing from its own seeded generator:
    the same dynamics as the on-device path, reachable from the host actor
    loops."""

    def __init__(self, env, seed: int = 0):
        from r2d2_tpu_torch.envs.fake import _DiscreteSpace
        self.env = env
        self.action_space = _DiscreteSpace(env.action_dim, seed)
        self.episode_len = env.episode_len
        self._gen = torch.Generator(device=env.device).manual_seed(seed)
        self._state = None

    @property
    def unwrapped(self):
        return self

    def reset(self) -> np.ndarray:
        self._state, obs = self.env.reset(self.env.reset_draws(1, self._gen))
        return obs[0].cpu().numpy()

    def step(self, action: int):
        a = torch.full((1,), int(action), dtype=torch.int64,
                       device=self.env.device)
        self._state, obs, reward, done = self.env.step(
            self._state, a, self.env.step_draws(1, self._gen))
        return (obs[0].cpu().numpy(), float(reward[0]), bool(done[0]), {})

    def close(self) -> None:
        pass
