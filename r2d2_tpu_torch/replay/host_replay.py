"""Host (CPU) replay: a numpy block ring with the device replay's
``Block``/``SampleBatch`` contract, behind ``replay.placement="host"``.

The ring lives in host memory, so it may be larger than the card's; the
learner trains on batches sampled here and copied to the card
(``runtime/learner_loop.py``). The sum tree is the native C++ one
(``native/sum_tree.cc``), or the numpy twin when asked for
(``use_native=False``).

Sampling here races the learner's asynchronous priority write-back: blocks
may land between a sample and the write-back of its priorities. A
staleness guard drops the updates of ring slots overwritten since the
sample. It counts adds with a monotonic counter, not by comparing ring
pointers, which would miss a ring that wrapped back to the sampled pointer
or lapped it.
"""

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.ops.sum_tree import (tree_init_np, tree_sample_np,
                                         tree_update_np)
from r2d2_tpu_torch.replay.structs import (Block, ReplaySpec, RingAccountant,
                                           SampleBatch)
from r2d2_tpu_torch.telemetry.histogram import (NBUCKETS, bucket_index,
                                                value_counts_np)


def batch_layout(spec: ReplaySpec, batch_size: Optional[int] = None
                 ) -> Dict[str, Tuple[Tuple[int, ...], type]]:
    """The shape and type of each array of a batch that
    ``HostReplay.sample`` returns, by field of ``SampleBatch``."""
    b = batch_size or spec.batch_size
    window, learning = spec.seq_window, spec.learning
    i32, f32 = np.int32, np.float32
    return {
        "obs": ((b, window + spec.frame_stack - 1, spec.frame_height,
                 spec.frame_width), np.uint8),
        "last_action": ((b, window), i32),
        "hidden": ((b, 2, spec.hidden_dim), f32),
        "action": ((b, learning), i32),
        "reward": ((b, learning), f32),
        "gamma": ((b, learning), f32),
        "burn_in_steps": ((b,), i32),
        "learning_steps": ((b,), i32),
        "forward_steps": ((b,), i32),
        "is_weights": ((b,), f32),
        "idxes": ((b,), i32),
        "weight_version": ((b,), i32),
        "lane": ((b,), i32),
    }


class HostReplay:
    def __init__(self, spec: ReplaySpec, seed: int = 0,
                 use_native: bool = True):
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self.lock = threading.Lock()
        self._native = None
        if use_native:
            from r2d2_tpu_torch.native import NativeSumTree
            self._native = NativeSumTree(spec.num_sequences)
        else:
            self.tree_layers, self.tree = tree_init_np(spec.num_sequences)

        n, s, l = spec.num_blocks, spec.seqs_per_block, spec.learning
        # frames unpadded whatever replay.pallas_exact_gather says: the pad
        # is a device storage layout, and the decode strips it anyway
        self.obs = np.zeros((n, spec.obs_row_len, spec.frame_height,
                             spec.frame_width), np.uint8)
        self.last_action = np.full((n, spec.la_row_len), -1, np.int32)
        self.hidden = np.zeros((n, s, 2, spec.hidden_dim), np.float32)
        self.action = np.zeros((n, s, l), np.int32)
        self.reward = np.zeros((n, s, l), np.float32)
        self.gamma = np.zeros((n, s, l), np.float32)
        self.burn_in_steps = np.zeros((n, s), np.int32)
        self.learning_steps = np.zeros((n, s), np.int32)
        self.forward_steps = np.zeros((n, s), np.int32)
        self.seq_start = np.zeros((n, s), np.int32)
        self.weight_version = np.full((n,), -1, np.int32)
        self.lane = np.full((n,), -1, np.int32)
        # the one pointer and step account; the host-placement Learner
        # reads this instance
        self.ring = RingAccountant(n)
        # the replay diagnostics' numpy twin of the device ring's state
        # (spec.replay_diag): per-slot sample counts and birth stamps, the
        # eviction ledger in ReplayState.evict_stats' layout with its
        # lifetime histogram, and a mirror of the leaf priorities (the
        # native tree does not expose its leaves) for the tree's health
        self._diag = spec.replay_diag
        if self._diag:
            self.sample_count = np.zeros((n,), np.int64)
            self.added_at = np.zeros((n,), np.int64)
            self.evict_stats = np.zeros((5,), np.float64)
            self.evict_life_hist = np.zeros((NBUCKETS,), np.int64)
            self.leaf_prio = np.zeros((spec.num_sequences,), np.float64)

    def _tree_update(self, td_errors: np.ndarray, idxes: np.ndarray) -> None:
        if self._diag:
            # the trees' rule: p = |td| ** alpha, 0 stays 0
            td = np.asarray(td_errors, np.float64)
            self.leaf_prio[np.asarray(idxes, np.int64)] = np.where(
                td != 0.0, np.abs(td) ** self.spec.prio_exponent, 0.0)
        if self._native is not None:
            self._native.update(self.spec.prio_exponent, td_errors, idxes)
        else:
            tree_update_np(self.tree_layers, self.tree,
                           self.spec.prio_exponent, td_errors, idxes)

    def _tree_sample(self, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._native is not None:
            return self._native.sample(self.spec.is_exponent, batch, self.rng)
        return tree_sample_np(self.tree_layers, self.tree,
                              self.spec.is_exponent, batch, self.rng)

    def add(self, block: Block, trace_ms: int = -1,
            ingest_ms: int = -1) -> None:
        """One block; ``trace_ms``/``ingest_ms``: its lineage stamps for
        the ring accountant's mirrors (-1 untraced)."""
        spec = self.spec
        with self.lock:
            wv = int(np.asarray(block.weight_version))
            if self._diag:
                self._account_eviction(self.ring.ptr)
            ptr = self.ring.advance(
                int(np.asarray(block.learning_steps).sum()), wv,
                trace_ms, ingest_ms)
            self.weight_version[ptr] = wv
            self.lane[ptr] = int(np.asarray(block.lane))
            idxes = ptr * spec.seqs_per_block + np.arange(
                spec.seqs_per_block, dtype=np.int64)
            self._tree_update(np.asarray(block.priority, np.float64), idxes)
            self.obs[ptr] = block.obs_row
            self.last_action[ptr] = block.last_action_row
            self.hidden[ptr] = block.hidden
            self.action[ptr] = block.action
            self.reward[ptr] = block.reward
            self.gamma[ptr] = block.gamma
            self.burn_in_steps[ptr] = block.burn_in_steps
            self.learning_steps[ptr] = block.learning_steps
            self.forward_steps[ptr] = block.forward_steps
            self.seq_start[ptr] = block.seq_start

    def _account_eviction(self, slot: int) -> None:
        """The eviction ledger of the slot the next add overwrites, read
        before the add changes it (the device ring's order), then the
        slot's count restarts and its birth stamp is the add count."""
        if self.ring.slot_steps[slot] > 0:
            life = int(self.sample_count[slot])
            age = float(self.ring.total_adds - self.added_at[slot])
            lo = slot * self.spec.seqs_per_block
            prio = float(self.leaf_prio[lo:lo + self.spec.seqs_per_block]
                         .max())
            self.evict_stats += [1.0, float(life == 0), float(life), age,
                                 prio]
            if life > 0:
                self.evict_life_hist[bucket_index(float(life))] += 1
        self.sample_count[slot] = 0
        self.added_at[slot] = self.ring.total_adds

    def sample(self, batch_size: Optional[int] = None,
               out: Optional[SampleBatch] = None
               ) -> Tuple[SampleBatch, int]:
        """Returns (batch of numpy arrays, total_adds snapshot); the
        snapshot goes back with the batch's priorities to
        ``update_priorities``. ``out``: arrays laid out as ``batch_layout``
        says (pinned host memory, say) to gather into; it is then the batch
        returned."""
        spec = self.spec
        batch = batch_size or spec.batch_size
        if out is None:
            out = SampleBatch(**{name: np.empty(shape, dtype) for name, (
                shape, dtype) in batch_layout(spec, batch).items()})
        obs_len = spec.seq_window + spec.frame_stack - 1
        frame = (spec.frame_height, spec.frame_width)
        with self.lock:
            idxes, is_weights = self._tree_sample(batch)
            b = idxes // spec.seqs_per_block
            s = idxes % spec.seqs_per_block
            if self._diag:
                np.add.at(self.sample_count, b, 1)
            burn_in = self.burn_in_steps[b, s]
            start = (self.seq_start[b, s] - burn_in).astype(np.int64)
            if (start < 0).any() or (start + obs_len > spec.obs_row_len).any():
                raise IndexError("a sampled window leaves its block's row")
            # one take of whole frames over the flattened ring: take, not
            # fancy indexing, writes into ``out``; mode="clip" keeps numpy
            # from buffering the output, and the check above keeps every
            # row in range
            rows = (b[:, None] * spec.obs_row_len + start[:, None]
                    + np.arange(obs_len)).reshape(-1)
            np.take(self.obs.reshape(-1, *frame), rows, axis=0,
                    out=out.obs.reshape(-1, *frame), mode="clip")
            t = start[:, None] + np.arange(spec.seq_window)
            out.last_action[...] = self.last_action[b[:, None], t]
            out.hidden[...] = self.hidden[b, s]
            out.action[...] = self.action[b, s]
            out.reward[...] = self.reward[b, s]
            out.gamma[...] = self.gamma[b, s]
            out.burn_in_steps[...] = burn_in
            out.learning_steps[...] = self.learning_steps[b, s]
            out.forward_steps[...] = self.forward_steps[b, s]
            out.is_weights[...] = is_weights
            out.idxes[...] = idxes
            out.weight_version[...] = self.weight_version[b]
            out.lane[...] = self.lane[b]
            return out, self.ring.total_adds

    def update_priorities(self, idxes: np.ndarray, td_errors: np.ndarray,
                          adds_snapshot: int) -> None:
        """Write back a sample's priorities, dropping those of ring slots
        overwritten since the sample (``adds_snapshot``: the total_adds
        that ``sample`` returned). Stale rows leave the buffer for good,
        so their updates are dropped outright."""
        spec = self.spec
        idxes = np.asarray(idxes, np.int64)
        td_errors = np.asarray(td_errors, np.float64)
        with self.lock:
            adds = self.ring.stale_adds(adds_snapshot)
            if adds >= spec.num_blocks:
                return          # the whole ring was rewritten
            if adds > 0:
                block_ptr = self.ring.ptr
                old_ptr = (block_ptr - adds) % spec.num_blocks
                if block_ptr > old_ptr:
                    keep = (idxes < old_ptr * spec.seqs_per_block) | (
                        idxes >= block_ptr * spec.seqs_per_block)
                else:   # wrapped: stale are [old_ptr, N) and [0, block_ptr)
                    keep = (idxes < old_ptr * spec.seqs_per_block) & (
                        idxes >= block_ptr * spec.seqs_per_block)
                idxes, td_errors = idxes[keep], td_errors[keep]
            if idxes.size:
                self._tree_update(td_errors, idxes)

    def diag_raw(self) -> Optional[dict]:
        """The replay diagnostics' readings of host placement, in the
        layout of the device step's interval snapshot: the tree moments
        [active, sum, sum of squares, max, at max] and the histogram of
        the live leaves, and the eviction ledger, read and reset (the
        aggregator integrates the totals). None with the diagnostics
        off."""
        if not self._diag:
            return None
        from r2d2_tpu_torch.telemetry.replaydiag import AT_MAX_RTOL
        with self.lock:
            leaves = self.leaf_prio
            active_mask = leaves > 0
            active = float(active_mask.sum())
            mx = float(leaves.max()) if active else 0.0
            at_max = (float(np.sum(active_mask
                                   & (leaves >= mx * (1.0 - AT_MAX_RTOL))))
                      if active else 0.0)
            hist = value_counts_np(leaves, mask=active_mask)
            ev, self.evict_stats = self.evict_stats, np.zeros(5, np.float64)
            lh, self.evict_life_hist = (self.evict_life_hist,
                                        np.zeros(NBUCKETS, np.int64))
            return {"tree_moments": np.asarray(
                        [active, float(leaves.sum()),
                         float(np.sum(leaves ** 2)), mx, at_max], np.float64),
                    "leaf_hist": hist, "evict_stats": ev,
                    "evict_life_hist": lh}

    def __len__(self) -> int:
        return int(self.learning_steps.sum())
