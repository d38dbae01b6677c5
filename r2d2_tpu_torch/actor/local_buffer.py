"""Actor-side block assembler, the counterpart of the JAX package's
actor/local_buffer.py: it produces the port's fixed-shape ``Block``.

Accumulates up to ``block_length`` transitions, then ``finish()`` computes on
the CPU (cheap, once per 400 steps):

  * n-step discounted returns by convolution (ref worker.py:463-466);
  * per-step effective discount whose tail encodes termination (0) or
    bootstrap-window shortening (gamma^m) so no ``done`` flag is stored
    (ref worker.py:445-456);
  * LSTM hidden snapshots at each sequence's *window start*
    ``seq_start[s] - burn_in[s]`` (stored-state strategy, ref worker.py:459).
    Deliberate divergence: the reference snapshots at ``s*learning``
    unconditionally, which in the FIRST block of an episode (carried burn-in
    < max) hands the learner a state that has already consumed the burn-in
    steps it is about to replay — steps processed twice. Indexing by window
    start is identical in steady state and correct at episode starts;
  * initial priorities from the actor's own (slightly stale) Q-values
    (ref worker.py:475-480);
  * carry-over of the last burn_in(+stack) frames/actions/hiddens so the next
    block's sequences get cross-block burn-in (ref worker.py:482-489).

Output is a fixed-shape ``Block`` (see replay/structs.py): ragged tails are
zero-padded, with zero priority + zero learning_steps marking empty slots.
"""

import math
from typing import Optional

import numpy as np

from r2d2_tpu_torch.ops.priority import mixed_td_errors_ragged
from r2d2_tpu_torch.ops.returns import (initial_priorities, n_step_gamma,
                                        n_step_return)
from r2d2_tpu_torch.replay.structs import Block, ReplaySpec, empty_block_np


class LocalBuffer:
    def __init__(self, spec: ReplaySpec, action_dim: int, gamma: float,
                 priority_eta: float = 0.9):
        self.spec = spec
        self.action_dim = action_dim
        self.gamma = gamma
        self.eta = priority_eta
        self.size = 0

    def __len__(self) -> int:
        return self.size

    def reset(self, init_obs: np.ndarray) -> None:
        """Start a new episode (ref worker.py:414-424). init_obs: (H, W) uint8."""
        spec = self.spec
        # frame_stack duplicate frames so the first stacked obs is well-defined
        self.obs_frames = [np.asarray(init_obs, np.uint8)] * spec.frame_stack
        self.last_actions = [-1]                      # -1 == null action
        self.hiddens = [np.zeros((2, spec.hidden_dim), np.float32)]
        self.actions = []
        self.rewards = []
        self.qvals = []
        self.curr_burn_in = 0
        self.size = 0
        self.sum_reward = 0.0
        self.done = False

    def add(self, action: int, reward: float, next_obs: np.ndarray,
            q_value: np.ndarray, hidden: np.ndarray) -> None:
        """Record one transition (ref worker.py:426-436). ``hidden`` is the
        packed (2, hidden_dim) state *after* this step."""
        self.hiddens.append(np.asarray(hidden, np.float32))
        self.actions.append(int(action))
        self.rewards.append(float(reward))
        self.obs_frames.append(np.asarray(next_obs, np.uint8))
        self.last_actions.append(int(action))
        self.qvals.append(np.asarray(q_value, np.float32).reshape(-1))
        self.sum_reward += float(reward)
        self.size += 1

    def finish(self, last_qval: Optional[np.ndarray] = None) -> Block:
        """Close the block. ``last_qval`` is the bootstrap Q at the next state
        (None ⇒ episode terminated). Returns a fixed-shape Block and keeps the
        burn-in tail for the next block."""
        spec = self.spec
        size = self.size
        assert 0 < size <= spec.block_length
        assert len(self.obs_frames) == spec.frame_stack + self.curr_burn_in + size
        assert len(self.last_actions) == self.curr_burn_in + size + 1

        num_seq = math.ceil(size / spec.learning)

        gammas = n_step_gamma(size, self.gamma, spec.forward, last_qval is not None)
        qvals = list(self.qvals)
        if last_qval is not None:
            qvals.append(np.asarray(last_qval, np.float32).reshape(-1))
        else:
            self.done = True
            qvals.append(np.zeros(self.action_dim, np.float32))
        qval_arr = np.stack(qvals)                       # (size+1, A)
        rewards = np.asarray(self.rewards, np.float64)
        returns = n_step_return(rewards, self.gamma, spec.forward)
        actions = np.asarray(self.actions, np.int32)

        burn_in = np.array(
            [min(s * spec.learning + self.curr_burn_in, spec.burn_in)
             for s in range(num_seq)], np.int32)
        learning = np.array(
            [min(spec.learning, size - s * spec.learning) for s in range(num_seq)],
            np.int32)
        forward = np.array(
            [min(spec.forward, size + 1 - int(learning[: s + 1].sum()))
             for s in range(num_seq)], np.int32)
        assert forward[-1] == 1 and burn_in[0] == self.curr_burn_in

        td = initial_priorities(qval_arr, actions, returns, gammas, spec.forward)
        prios = mixed_td_errors_ragged(td, learning, self.eta)

        # ---- fixed-shape assembly ----
        blk = Block(**empty_block_np(spec))
        blk.num_sequences.fill(num_seq)
        blk.sum_reward.fill(self.sum_reward if self.done else np.nan)
        frames = np.stack(self.obs_frames)               # (stack+burn0+size, H, W)
        blk.obs_row[: frames.shape[0]] = frames
        la = np.asarray(self.last_actions, np.int32)     # (burn0+size+1,)
        blk.last_action_row[: la.shape[0]] = la
        # hidden at each sequence's window start (see module docstring)
        window_starts = [self.curr_burn_in + s * spec.learning - int(burn_in[s])
                         for s in range(num_seq)]
        blk.hidden[:num_seq] = np.stack(
            [self.hiddens[w] for w in window_starts])
        for s in range(num_seq):
            l = int(learning[s])
            lo = s * spec.learning
            blk.action[s, :l] = actions[lo : lo + l]
            blk.reward[s, :l] = returns[lo : lo + l]
            blk.gamma[s, :l] = gammas[lo : lo + l]
            blk.seq_start[s] = self.curr_burn_in + lo
        blk.priority[:num_seq] = prios
        blk.burn_in_steps[:num_seq] = burn_in
        blk.learning_steps[:num_seq] = learning
        blk.forward_steps[:num_seq] = forward

        # ---- burn-in carry to next block (ref worker.py:482-489) ----
        self.obs_frames = self.obs_frames[-spec.frame_stack - spec.burn_in :]
        self.last_actions = self.last_actions[-spec.burn_in - 1 :]
        self.hiddens = self.hiddens[-spec.burn_in - 1 :]
        self.actions.clear()
        self.rewards.clear()
        self.qvals.clear()
        self.curr_burn_in = len(self.last_actions) - 1
        self.size = 0
        return blk
