"""Replay data layout: fixed-shape block records and the device-resident
buffer state, as dataclasses of tensors (numpy arrays for a host-side
``Block``).

A block is a fixed-shape record; ragged reality rides on per-sequence
metadata (burn_in / learning / forward / seq_start) and the unused tail of
a short block is zero padding whose tree leaves have priority 0. Sequence s
starts at timeline ``seq_start[s]`` and its sampled window at
``seq_start[s] - burn_in[s]``; ``obs_row[t + j]`` (j < frame_stack) is the
stacked observation at step t, ``last_action_row[t]`` the action taken at
step t-1 (-1 = none).
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import (Config, check_kernel_setting,
                                   resolve_exact_gather)
from r2d2_tpu_torch.ops.sum_tree import tree_num_layers


@dataclass(frozen=True)
class ReplaySpec:
    """Static shape contract shared by the replay, the block assembler and
    the learner."""

    num_blocks: int
    seqs_per_block: int
    block_length: int
    burn_in: int
    learning: int
    forward: int
    frame_stack: int
    frame_height: int
    frame_width: int
    hidden_dim: int
    batch_size: int
    prio_exponent: float
    is_exponent: float
    # replay.pallas_exact_gather: store frames padded to the TPU's uint8
    # tile (84x84 -> 96x128). Off by default in the port; the gather
    # kernel and the decode handle either layout.
    exact_gather: bool = False
    # the replay diagnostics' state on the ring (per-slot sample counts
    # and birth stamps, the add counter, the eviction ledger): from
    # telemetry.enabled and telemetry.replay_diag_enabled, as in the JAX
    # package; False allocates none of it and the ring writes are what
    # they are without it
    replay_diag: bool = False

    @classmethod
    def from_config(cls, cfg: Config, device) -> "ReplaySpec":
        check_kernel_setting(cfg.replay.pallas_sample_gather,
                             torch.device(device), "replay.pallas_sample_gather")
        return cls(
            num_blocks=cfg.num_blocks,
            seqs_per_block=cfg.seqs_per_block,
            block_length=cfg.replay.block_length,
            burn_in=cfg.sequence.burn_in_steps,
            learning=cfg.sequence.learning_steps,
            forward=cfg.sequence.forward_steps,
            frame_stack=cfg.env.frame_stack,
            frame_height=cfg.env.frame_height,
            frame_width=cfg.env.frame_width,
            hidden_dim=cfg.network.hidden_dim,
            batch_size=cfg.replay.batch_size,
            prio_exponent=cfg.replay.prio_exponent,
            is_exponent=cfg.replay.importance_sampling_exponent,
            exact_gather=resolve_exact_gather(cfg.replay.pallas_exact_gather),
            replay_diag=(cfg.telemetry.enabled
                         and cfg.telemetry.replay_diag_enabled),
        )

    @property
    def stored_frame_height(self) -> int:
        if not self.exact_gather:
            return self.frame_height
        return -(-self.frame_height // 32) * 32

    @property
    def stored_frame_width(self) -> int:
        if not self.exact_gather:
            return self.frame_width
        return -(-self.frame_width // 128) * 128

    @property
    def device_ring_bytes(self) -> int:
        """Bytes that replay_init allocates (the obs ring dominates)."""
        n, s, l = self.num_blocks, self.seqs_per_block, self.learning
        obs = (n * self.obs_row_len
               * self.stored_frame_height * self.stored_frame_width)
        last_action = n * self.la_row_len * 4
        hidden = n * s * 2 * self.hidden_dim * 4
        seq_meta = n * s * (3 * l + 4) * 4
        versions = 2 * n * 4
        tree = (2 ** self.tree_layers - 1) * 4
        # the replay diagnostics: sample counts and birth stamps (N,), the
        # add counter, the eviction ledger (5,) and its histogram (64,)
        diag = (2 * n + 1 + 5 + 64) * 4 if self.replay_diag else 0
        return obs + last_action + hidden + seq_meta + versions + tree + diag

    @property
    def seq_window(self) -> int:
        return self.burn_in + self.learning + self.forward

    @property
    def obs_row_len(self) -> int:
        return self.burn_in + self.block_length + self.forward + self.frame_stack - 1

    @property
    def la_row_len(self) -> int:
        return self.burn_in + self.block_length + self.forward

    @property
    def num_sequences(self) -> int:
        return self.num_blocks * self.seqs_per_block

    @property
    def tree_layers(self) -> int:
        return tree_num_layers(self.num_sequences)


@dataclass
class Block:
    """One actor-produced block (numpy or tensors). With a leading K axis on
    every field it is a stack of K blocks (replay_add_many)."""

    obs_row: Any           # (obs_row_len, H, W) uint8
    last_action_row: Any   # (la_row_len,) int32, -1 = null
    hidden: Any            # (S, 2, hidden_dim) f32
    action: Any            # (S, L) int32
    reward: Any            # (S, L) f32, n-step discounted returns
    gamma: Any             # (S, L) f32, discount on the bootstrap
    priority: Any          # (S,) f32, 0 for empty slots
    burn_in_steps: Any     # (S,) int32
    learning_steps: Any    # (S,) int32, 0 for empty slots
    forward_steps: Any     # (S,) int32
    seq_start: Any         # (S,) int32
    num_sequences: Any     # () int32
    sum_reward: Any        # () f32, NaN = no finished episode to report
    weight_version: Any = dataclasses.field(
        default_factory=lambda: np.full((), -1, np.int32))
    lane: Any = dataclasses.field(
        default_factory=lambda: np.full((), -1, np.int32))


def block_trace(block: Block):
    """A block's lineage stamp, or None: every block of a traced run
    carries ``trace_ms``, an int32 attribute (telemetry/tracing.py: wall
    ms mod 2**31, -1 untraced; (K,) on a stacked drain). It is not a field:
    it never reaches the device, and an untraced run's blocks are what
    they are without tracing."""
    return getattr(block, "trace_ms", None)


def with_trace(block: Block, trace_ms) -> Block:
    """``block`` carrying ``trace_ms`` (None: nothing attached)."""
    if trace_ms is not None:
        block.trace_ms = trace_ms
    return block


def stack_blocks(blocks) -> Block:
    """K blocks -> one Block with a leading K axis on every field."""
    return Block(**{f.name: np.stack([np.asarray(getattr(b, f.name))
                                      for b in blocks])
                    for f in dataclasses.fields(Block)})


# the replay diagnostics' leaves of ReplayState (None with them off)
DIAG_LEAVES = ("sample_count", "added_at", "add_count", "evict_stats",
               "evict_life_hist")


@dataclass
class ReplayState:
    """Device-resident buffer state. Updated in place: the obs ring is
    never copied."""

    tree: torch.Tensor            # (2**tree_layers - 1,) f32
    obs: torch.Tensor             # (N, obs_row_len, Hs, Ws) uint8
    last_action: torch.Tensor     # (N, la_row_len) int32
    hidden: torch.Tensor          # (N, S, 2, hidden_dim) f32
    action: torch.Tensor          # (N, S, L) int32
    reward: torch.Tensor          # (N, S, L) f32
    gamma: torch.Tensor           # (N, S, L) f32
    burn_in_steps: torch.Tensor   # (N, S) int32
    learning_steps: torch.Tensor  # (N, S) int32
    forward_steps: torch.Tensor   # (N, S) int32
    seq_start: torch.Tensor       # (N, S) int32
    weight_version: torch.Tensor  # (N,) int32
    block_ptr: int                # ring pointer, kept on the host
    lane: torch.Tensor            # (N,) int32
    # the replay diagnostics' leaves (spec.replay_diag; None when off):
    # times each slot was sampled since its write, the add count at its
    # write, the ring's adds so far (a device tensor, advanced in place,
    # so a captured ring write advances it too), and the eviction ledger
    # [evicted, never sampled, lifetime sum, age sum, final priority sum]
    # with its lifetime histogram, both read and reset by the step's
    # interval snapshot (telemetry/replaydiag.py)
    sample_count: Optional[torch.Tensor] = None    # (N,) int32
    added_at: Optional[torch.Tensor] = None        # (N,) int32
    add_count: Optional[torch.Tensor] = None       # () int32
    evict_stats: Optional[torch.Tensor] = None     # (5,) f32
    evict_life_hist: Optional[torch.Tensor] = None  # (64,) int32


@dataclass
class SampleBatch:
    """One training batch, still in storage dtypes (uint8 obs, index
    actions); the learner step decodes it."""

    obs: torch.Tensor             # (B, seq_window + stack - 1, Hs, Ws) uint8
    last_action: torch.Tensor     # (B, seq_window) int32
    hidden: torch.Tensor          # (B, 2, hidden_dim) f32
    action: torch.Tensor          # (B, L) int32
    reward: torch.Tensor          # (B, L) f32
    gamma: torch.Tensor           # (B, L) f32
    burn_in_steps: torch.Tensor   # (B,) int32
    learning_steps: torch.Tensor  # (B,) int32
    forward_steps: torch.Tensor   # (B,) int32
    is_weights: torch.Tensor      # (B,) f32
    idxes: torch.Tensor           # (B,) int64 tree leaf indices
    weight_version: Optional[torch.Tensor] = None
    lane: Optional[torch.Tensor] = None


def batch_fields(batch: SampleBatch) -> Dict[str, Any]:
    """The fields of a batch that hold arrays or tensors, by name."""
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if getattr(batch, f.name) is not None}


class RingAccountant:
    """Host-side ring accounting: pointer advance, per-slot learning-step
    counts and weight versions, the total buffered steps behind the
    training gate, and the monotonic add counter behind the host replay's
    staleness guard. ``HostReplay`` owns one and the host-placement
    ``Learner`` reads that same instance; under device placement the
    ``Learner``'s instance mirrors ``ReplayState.block_ptr``."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.ptr = 0
        self.total_adds = 0        # monotonic; never wraps
        self.slot_steps = [0] * num_blocks
        self.buffer_steps = 0
        # the landed block's weight_version; -1 = empty or unstamped
        self.slot_versions = [-1] * num_blocks
        # lineage mirrors (telemetry/tracing.py): the landed block's
        # emission stamp and the wall ms it was committed; -1 untraced
        self.slot_trace = [-1] * num_blocks
        self.slot_ingest_ms = [-1] * num_blocks

    def advance(self, learning_steps: int, weight_version: int = -1,
                trace_ms: int = -1, ingest_ms: int = -1) -> int:
        """Account one block write: returns the slot it lands in and rolls
        the pointer, replacing the overwritten slot's step count."""
        slot = self.ptr
        self.buffer_steps += learning_steps - self.slot_steps[slot]
        self.slot_steps[slot] = learning_steps
        self.slot_versions[slot] = int(weight_version)
        self.slot_trace[slot] = int(trace_ms)
        self.slot_ingest_ms[slot] = int(ingest_ms)
        self.ptr = (slot + 1) % self.num_blocks
        self.total_adds += 1
        return slot

    def live_versions(self):
        """Weight versions of the slots that hold data (-1: unstamped)."""
        return [v for v, steps in zip(self.slot_versions, self.slot_steps)
                if steps > 0]

    def stale_adds(self, adds_snapshot: int) -> int:
        """Blocks written since ``adds_snapshot`` (a ``total_adds``)."""
        return self.total_adds - adds_snapshot


TORCH_DTYPES = {np.uint8: torch.uint8, np.int32: torch.int32,
                np.float32: torch.float32}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a replay field's numpy dtype."""
    return TORCH_DTYPES[np.dtype(np_dtype).type]


def empty_block_np(spec: ReplaySpec) -> dict:
    """Zeroed numpy block record (host-side assembly scratch)."""
    s, l = spec.seqs_per_block, spec.learning
    return dict(
        obs_row=np.zeros((spec.obs_row_len, spec.frame_height,
                          spec.frame_width), np.uint8),
        last_action_row=np.full((spec.la_row_len,), -1, np.int32),
        hidden=np.zeros((s, 2, spec.hidden_dim), np.float32),
        action=np.zeros((s, l), np.int32),
        reward=np.zeros((s, l), np.float32),
        gamma=np.zeros((s, l), np.float32),
        priority=np.zeros((s,), np.float32),
        burn_in_steps=np.zeros((s,), np.int32),
        learning_steps=np.zeros((s,), np.int32),
        forward_steps=np.zeros((s,), np.int32),
        seq_start=np.zeros((s,), np.int32),
        num_sequences=np.zeros((), np.int32),
        sum_reward=np.full((), np.nan, np.float32),
        weight_version=np.full((), -1, np.int32),
        lane=np.full((), -1, np.int32),
    )
