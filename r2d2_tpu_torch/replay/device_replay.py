"""Device-resident prioritized sequence replay: add, sample and priority
update on the card.

The whole buffer lives in device memory as fixed-shape rings updated in
place. The learner step runs sample -> train -> priority write-back in
order on one stream, so no add can land between a sample and its write-back
and the ring needs no staleness guard.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.ops.replay_kernels import gather_rows
from r2d2_tpu_torch.ops.sum_tree import tree_sample, tree_update
from r2d2_tpu_torch.replay.structs import (Block, ReplaySpec, ReplayState,
                                           SampleBatch, stack_blocks)
from r2d2_tpu_torch.telemetry.histogram import value_counts
from r2d2_tpu_torch.telemetry import scopes


def _gib(b: float) -> str:
    return f"{b / 2**30:.1f} GiB"


def _guard_device_capacity(spec: ReplaySpec, device: torch.device) -> None:
    """Refuse a ring that cannot fit in free device memory, with numbers,
    instead of failing mid-allocation. The card's free memory is read
    through the one device-memory reader (telemetry/resources.py)."""
    from r2d2_tpu_torch.telemetry.resources import device_memory_stats
    free = device_memory_stats(device).get("bytes_free")
    ring = spec.device_ring_bytes
    if free is not None and ring > 0.9 * free:
        hint = ""
        if spec.exact_gather:
            unpadded = dataclasses.replace(spec, exact_gather=False)
            hint = ("; replay.pallas_exact_gather='off' shrinks storage "
                    f"to ~{_gib(unpadded.device_ring_bytes)} (row-gather "
                    "reads instead of exact-window copies)")
        raise ValueError(
            f"device replay ring needs ~{_gib(ring)} but the device has "
            f"{_gib(free)} free. Reduce replay.capacity or "
            f"replay.block_length, use replay.placement='host'{hint}.")


def replay_init(spec: ReplaySpec, device) -> ReplayState:
    device = torch.device(device)
    _guard_device_capacity(spec, device)
    n, s, l = spec.num_blocks, spec.seqs_per_block, spec.learning

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=device)

    diag = {}
    if spec.replay_diag:
        diag = dict(sample_count=zeros((n,), torch.int32),
                    added_at=zeros((n,), torch.int32),
                    add_count=zeros((), torch.int32),
                    evict_stats=zeros((5,), torch.float32),
                    evict_life_hist=zeros((64,), torch.int32))
    return ReplayState(
        tree=zeros((2 ** spec.tree_layers - 1,), torch.float32),
        obs=zeros((n, spec.obs_row_len, spec.stored_frame_height,
                   spec.stored_frame_width), torch.uint8),
        last_action=full((n, spec.la_row_len), -1),
        hidden=zeros((n, s, 2, spec.hidden_dim), torch.float32),
        action=zeros((n, s, l), torch.int32),
        reward=zeros((n, s, l), torch.float32),
        gamma=zeros((n, s, l), torch.float32),
        burn_in_steps=zeros((n, s), torch.int32),
        learning_steps=zeros((n, s), torch.int32),
        forward_steps=zeros((n, s), torch.int32),
        seq_start=zeros((n, s), torch.int32),
        weight_version=full((n,), -1),
        block_ptr=0,
        lane=full((n,), -1),
        **diag,
    )


# the Block fields a ring write reads
WRITTEN = ("priority", "obs_row", "last_action_row", "hidden", "action",
           "reward", "gamma", "burn_in_steps", "learning_steps",
           "forward_steps", "seq_start", "weight_version", "lane")


def write_rows(spec: ReplaySpec, state: ReplayState, rows: torch.Tensor,
               blocks: Block) -> None:
    """Write K stacked blocks, tensors on the replay's device, into ring
    ``rows`` (K,) int64 on that device and seed their K*S tree leaves by
    one tree_update. Device ops only, no host value read: the on-device
    acting segment calls this inside its CUDA graph, with rows from a
    device-side pointer. ``state.block_ptr`` is the caller's to advance.
    With the replay diagnostics on, the overwritten rows' lifetimes go
    into the eviction ledger first (``_account_evictions``)."""
    with scopes.scope("replay_add"):
        idxes = (rows[:, None] * spec.seqs_per_block
                 + torch.arange(spec.seqs_per_block,
                                device=rows.device)[None, :]
                 ).reshape(-1)
        if state.sample_count is not None:
            _account_evictions(spec, state, rows, idxes)
        tree_update(spec.tree_layers, state.tree, spec.prio_exponent,
                    blocks.priority.reshape(-1), idxes)
        # the stored frame may be tile-padded (exact_gather): write the true
        # frame into its corner; the pad stays zero from replay_init
        state.obs[rows, :, :spec.frame_height, :spec.frame_width] = \
            blocks.obs_row.to(torch.uint8)
        for name in ("last_action", "hidden", "action", "reward", "gamma",
                     "burn_in_steps", "learning_steps", "forward_steps",
                     "seq_start", "weight_version", "lane"):
            src = getattr(blocks, "last_action_row" if name == "last_action"
                          else name)
            dst = getattr(state, name)
            dst[rows] = src.to(dst.dtype)


def _account_evictions(spec: ReplaySpec, state: ReplayState,
                       rows: torch.Tensor, idxes: torch.Tensor) -> None:
    """The eviction ledger of K rows about to be overwritten (the JAX
    package's ``replay_add_many`` accounting), in place on the device:
    each row that held data adds [1, sampled never, times sampled, age
    in ring adds, its highest leaf priority] to ``evict_stats`` and its
    times sampled (if any) to ``evict_life_hist``; then the rows' counts
    restart and their birth stamps are the add counter's values. Reads
    the old leaves before the write's ``tree_update`` replaces them. The
    rows are distinct (K <= num_blocks), so the batch sees what K
    sequential writes would, row by row; row j's age counts from add
    ``add_count + j``, and the rows' contributions are added one after
    another, so the f32 priority sum is bit-equal to K writes of one
    block each."""
    k = rows.shape[0]
    live = (state.learning_steps[rows].sum(dim=1) > 0).float()     # (K,)
    counts = state.sample_count[rows].float()
    births = state.add_count + torch.arange(k, dtype=torch.int32,
                                            device=rows.device)
    ages = (births - state.added_at[rows]).float()
    leaf0 = 2 ** (spec.tree_layers - 1) - 1
    prio_row = state.tree[leaf0 + idxes].reshape(
        k, spec.seqs_per_block).amax(dim=1)
    rows_stats = torch.stack([live, live * (counts == 0).float(),
                              live * counts, live * ages, live * prio_row],
                             dim=1)                               # (K, 5)
    for j in range(k):
        state.evict_stats += rows_stats[j]
    state.evict_life_hist += value_counts(
        counts, mask=(live > 0) & (counts > 0))
    state.sample_count.index_fill_(0, rows, 0)    # no host scalar copy
    state.added_at[rows] = births
    state.add_count += k


def replay_add_many(spec: ReplaySpec, state: ReplayState,
                    blocks: Block) -> ReplayState:
    """Ring-write K stacked blocks (leading K axis on every field) in place:
    block k lands in row (block_ptr + k) % num_blocks and all K*S tree
    leaves are seeded by one tree_update. K <= num_blocks, so no two
    blocks share a row. Blocks already on the replay's device go straight
    in, their rows computed there. Host arrays on CUDA go through pinned
    memory and copy without blocking the host: the writes queue on the
    current stream behind the dispatches already there (a pageable copy
    would wait for them, leaving the card idle while the host catches
    up)."""
    on_device = torch.is_tensor(blocks.priority)
    k = int(blocks.priority.shape[0] if on_device
            else np.shape(blocks.priority)[0])
    if k > spec.num_blocks:
        raise ValueError(
            f"replay_add_many got {k} blocks but the ring has only "
            f"{spec.num_blocks} rows")
    device = state.obs.device
    if on_device:
        if blocks.priority.device != device:
            raise ValueError(f"blocks on {blocks.priority.device}, the "
                             f"replay on {device}")
        rows = (torch.arange(k, device=device) + state.block_ptr) \
            % spec.num_blocks
    else:
        cuda = device.type == "cuda"

        def t(x):
            host = torch.as_tensor(np.asarray(x))
            if cuda:
                host = host.pin_memory()
            return host.to(device, non_blocking=cuda)

        rows = t(np.asarray([(state.block_ptr + j) % spec.num_blocks
                             for j in range(k)], np.int64))
        blocks = dataclasses.replace(blocks, **{
            name: t(getattr(blocks, name)) for name in WRITTEN})
    write_rows(spec, state, rows, blocks)
    state.block_ptr = (state.block_ptr + k) % spec.num_blocks
    return state


def replay_add(spec: ReplaySpec, state: ReplayState,
               block: Block) -> ReplayState:
    """One block: the K=1 case of replay_add_many."""
    return replay_add_many(spec, state, stack_blocks([block]))


def _gather_windows(spec: ReplaySpec, state: ReplayState,
                    block_idx: torch.Tensor, window_start: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(obs, last_action) windows of the sampled sequences. The obs window
    (52 MB of uint8 at the reference shape) goes through the gather
    kernel; the 28 KB last-action window is plain indexing."""
    obs_len = spec.seq_window + spec.frame_stack - 1
    obs = gather_rows(state.obs, block_idx, window_start, obs_len)
    t = window_start.long()[:, None] + torch.arange(
        spec.seq_window, device=window_start.device)[None, :]
    return obs, state.last_action[block_idx.long()[:, None], t]


def replay_sample(spec: ReplaySpec, state: ReplayState,
                  generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None) -> SampleBatch:
    """Stratified prioritized sample of ``spec.batch_size`` sequences.
    ``uniform``: the stratum jitter draws (tree_sample), else drawn from
    ``generator``."""
    idxes, is_weights = tree_sample(
        spec.tree_layers, state.tree, spec.is_exponent, spec.batch_size,
        generator=generator, uniform=uniform)
    block_idx = idxes // spec.seqs_per_block
    seq_idx = idxes % spec.seqs_per_block
    burn_in = state.burn_in_steps[block_idx, seq_idx]
    seq_start = state.seq_start[block_idx, seq_idx]
    obs, last_action = _gather_windows(spec, state, block_idx,
                                       seq_start - burn_in)
    return SampleBatch(
        obs=obs,
        last_action=last_action,
        hidden=state.hidden[block_idx, seq_idx],
        action=state.action[block_idx, seq_idx],
        reward=state.reward[block_idx, seq_idx],
        gamma=state.gamma[block_idx, seq_idx],
        burn_in_steps=burn_in,
        learning_steps=state.learning_steps[block_idx, seq_idx],
        forward_steps=state.forward_steps[block_idx, seq_idx],
        is_weights=is_weights,
        idxes=idxes,
        weight_version=state.weight_version[block_idx],
        lane=state.lane[block_idx],
    )


def replay_update_priorities(spec: ReplaySpec, state: ReplayState,
                             idxes: torch.Tensor, td_errors: torch.Tensor
                             ) -> ReplayState:
    """Standalone priority write-back; the learner step calls tree_update
    directly."""
    tree_update(spec.tree_layers, state.tree, spec.prio_exponent, td_errors,
                idxes)
    return state


def replay_size(state: ReplayState) -> torch.Tensor:
    """Total stored learning steps."""
    return state.learning_steps.sum()
