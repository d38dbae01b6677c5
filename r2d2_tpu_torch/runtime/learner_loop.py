"""A minimal learner: train state and device replay on one device, block
ingestion, the training gate, and one dispatch of
``runtime.steps_per_dispatch`` learner steps per call (one CUDA graph of K
steps on the card). The counterpart of the JAX package's ``Learner``
without its threads, telemetry, checkpoints or services."""

from typing import List, Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                               make_learner_step,
                                               make_multi_learner_step)
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.replay.device_replay import replay_add, replay_init
from r2d2_tpu_torch.replay.structs import Block, ReplaySpec, RingAccountant
from r2d2_tpu_torch.utils.device import configure_numerics


class Learner:
    def __init__(self, cfg: Config, net: NetworkApply, seed: int = 0):
        configure_numerics()
        self.cfg = cfg
        self.net = net
        self.device = net.device
        self.spec = ReplaySpec.from_config(cfg, self.device)
        use_double = cfg.network.use_double
        self.train_state = create_train_state(net, cfg.optim, seed,
                                              use_double)
        self.replay_state = replay_init(self.spec, self.device)
        self.ring = RingAccountant(self.spec.num_blocks)
        self.steps_per_dispatch = cfg.runtime.resolved_steps_per_dispatch(
            self.device)
        if self.steps_per_dispatch > 1:
            self._step_fn = make_multi_learner_step(
                net, self.spec, cfg.optim, use_double,
                self.steps_per_dispatch)
        else:
            self._step_fn = make_learner_step(net, self.spec, cfg.optim,
                                              use_double)
        self.env_steps = 0
        # per dispatch: a device scalar (K = 1) or a (K,) tensor; no sync
        self.losses: List[torch.Tensor] = []

    def ingest(self, block: Block) -> None:
        """Ring-write one actor block."""
        learning = int(np.asarray(block.learning_steps).sum())
        replay_add(self.spec, self.replay_state, block)
        self.ring.advance(learning)
        self.env_steps += learning

    @property
    def ready(self) -> bool:
        """Training gate: replay.learning_starts buffered learning steps."""
        return self.ring.buffer_steps >= self.cfg.replay.learning_starts

    @property
    def training_steps(self) -> int:
        return self.train_state.step

    def step(self, uniform: Optional[torch.Tensor] = None) -> dict:
        """One dispatch: ``steps_per_dispatch`` learner steps
        (``training_steps`` advances by that many). ``uniform``: the
        jitter, (B,) for one step a dispatch, else (K, B)."""
        self.train_state, self.replay_state, metrics = self._step_fn(
            self.train_state, self.replay_state, uniform)
        self.losses.append(metrics["loss"])
        return metrics
