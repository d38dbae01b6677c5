"""Replay diagnostics, the JAX package's ``telemetry/replaydiag.py``: what
the prioritized replay feeds the learner, computed in the learner step and
the ring writes and read at the metrics flush.

  * The sum tree's health: the (5,) moments [active, sum p, sum p^2, max,
    count at max] of the live leaves and their priority histogram on the
    shared log layout; the host derives the effective sample size
    ((sum p)^2 / sum p^2), the max/mean ratio and the share at max.
  * The lifetime ledger: the ring holds a per-slot sample count,
    incremented here at every step's sample, and a birth stamp; a ring
    write (replay/device_replay.py ``write_rows``, inside the on-device
    acting graph too) adds each overwritten slot's lifetime to the
    eviction ledger, from which the host reports the share of blocks
    evicted never sampled.
  * Lane provenance: each sampled batch's producing lanes, bincounted.

The tree snapshot and the ledger's read-and-reset happen on interval steps
(``new_step % interval == 0``). The JAX package branches with
``lax.cond``; here the host says which steps are interval steps
(``rd_on``, from its step count), and learner/train_step.py captures one
CUDA graph a pattern of them in a dispatch, as for the learning
diagnostics' dQ: off interval the outputs are NaN moments and zero
histograms and the ledger keeps accumulating.

Under the dp step the per-shard views are gathered to ``rd/shard_*`` (a
leading dp axis) and the lane counts summed (``shard_replay_diag``).
``ReplayDiagAggregator`` builds the periodic record's ``replay_diag``
block.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from r2d2_tpu_torch.telemetry.histogram import (NBUCKETS, value_counts,
                                                value_summary)

# the count-at-max tolerance: f32 priorities that round to the max count
AT_MAX_RTOL = 1e-6

_SNAPSHOT_KEYS = ("rd/tree_moments", "rd/leaf_hist", "rd/evict_stats",
                  "rd/evict_life_hist")


@dataclass(frozen=True)
class ReplayDiag:
    """The diagnostics' settings, given to the step factories; None there
    means they are off."""

    interval: int = 50        # learner steps between tree snapshots
    lanes: int = 0            # the global lane ladder's width

    @classmethod
    def from_config(cls, cfg) -> Optional["ReplayDiag"]:
        """The one gating rule: telemetry.enabled and
        telemetry.replay_diag_enabled (as ReplaySpec.replay_diag). The
        lanes are the on-device loop's, or the global actor ladder's
        (every controller's under multihost)."""
        t = cfg.telemetry
        if not (t.enabled and t.replay_diag_enabled):
            return None
        if cfg.actor.on_device:
            lanes = cfg.actor.anakin_lanes
        else:
            procs = (max(cfg.mesh.num_processes, 1)
                     if cfg.mesh.multihost else 1)
            lanes = procs * cfg.actor.num_actors * cfg.actor.envs_per_actor
        return cls(interval=t.replay_diag_interval, lanes=lanes)


# -- device side --------------------------------------------------------------


def tree_health_moments(tree: torch.Tensor, num_layers: int):
    """(moments, hist) of the tree's live (positive) leaves: moments the
    (5,) f32 [active, sum, sum of squares, max, count at max], hist their
    (64,) int32 priority histogram."""
    leaves = tree[2 ** (num_layers - 1) - 1:]
    mask = leaves > 0
    maskf = mask.float()
    mx = leaves.amax()
    at_max = torch.sum(maskf * (leaves >= mx * (1.0 - AT_MAX_RTOL)).float())
    moments = torch.stack([maskf.sum(), leaves.sum(), (leaves ** 2).sum(),
                           mx, at_max]).float()
    return moments, value_counts(leaves, mask=mask)


def lane_counts(lane: torch.Tensor, num_lanes: int) -> torch.Tensor:
    """(num_lanes + 1,) int32 bincount of a batch's producing lanes; the
    last bucket counts unknown (-1 or out-of-range) stamps."""
    lane = lane.reshape(-1).long()
    idx = torch.where((lane >= 0) & (lane < num_lanes), lane,
                      torch.full_like(lane, num_lanes))
    return torch.zeros(num_lanes + 1, dtype=torch.int32,
                       device=lane.device).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def fused_replay_diag(spec, rdiag: ReplayDiag, rd_on: bool, replay_state,
                      batch) -> Dict[str, torch.Tensor]:
    """The ``rd/`` values of one step, after its priority write-back;
    updates the replay's diagnostic leaves in place. Every step: the
    sampled blocks' counts go up by one (a scatter-add) and the batch's
    lanes are counted. On an interval step (``rd_on``: the new step count
    a multiple of ``rdiag.interval``, the JAX step's ``lax.cond``) the
    outputs carry the tree snapshot and the eviction ledger, which is
    then reset (its values are deltas since the last snapshot, far below
    f32's 2^24); otherwise NaN moments and zero histograms."""
    rs = replay_state
    out: Dict[str, torch.Tensor] = {}
    if rs.sample_count is not None:
        block_idx = (batch.idxes // spec.seqs_per_block).long()
        rs.sample_count.index_add_(
            0, block_idx, torch.ones_like(block_idx, dtype=torch.int32))
    if batch.lane is not None and rdiag.lanes > 0:
        out["rd/lane_counts"] = lane_counts(batch.lane, rdiag.lanes)
    device = rs.tree.device
    nan5 = torch.full((5,), float("nan"), dtype=torch.float32, device=device)
    zeros = torch.zeros(NBUCKETS, dtype=torch.int32, device=device)
    if not rd_on:
        out.update({"rd/tree_moments": nan5, "rd/leaf_hist": zeros,
                    "rd/evict_stats": nan5, "rd/evict_life_hist": zeros})
        return out
    out["rd/tree_moments"], out["rd/leaf_hist"] = tree_health_moments(
        rs.tree, spec.tree_layers)
    if rs.evict_stats is not None:
        out["rd/evict_stats"] = rs.evict_stats.clone()
        out["rd/evict_life_hist"] = rs.evict_life_hist.clone()
        rs.evict_stats.zero_()
        rs.evict_life_hist.zero_()
    else:
        out["rd/evict_stats"] = nan5
        out["rd/evict_life_hist"] = zeros
    return out


def shard_replay_diag(rd: Dict[str, torch.Tensor], mesh
                      ) -> Dict[str, torch.Tensor]:
    """The per-shard outputs of ``fused_replay_diag`` across the dp ranks
    (``mesh.dp_group``): the snapshot keys gathered to ``rd/shard_*`` with
    a leading dp axis, the lane counts summed. One all-gather of one f32
    row a rank, every step (counts in f32 are exact below 2^24)."""
    from r2d2_tpu_torch.parallel.tensor_parallel import gather_dp_rows
    keys = [k for k in _SNAPSHOT_KEYS] + (
        ["rd/lane_counts"] if "rd/lane_counts" in rd else [])
    sizes = [rd[k].numel() for k in keys]
    row = torch.cat([rd[k].reshape(-1).float() for k in keys])
    rows = gather_dp_rows(row[None], mesh)                    # (dp, F)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for key, n in zip(keys, sizes):
        part = rows[:, off:off + n]
        if rd[key].dtype != torch.float32:
            part = part.round().to(rd[key].dtype)
        if key == "rd/lane_counts":
            out[key] = part.sum(dim=0).to(rd[key].dtype)
        else:
            out[key.replace("rd/", "rd/shard_")] = part
        off += n
    return out


# -- host side ----------------------------------------------------------------


def derive_tree_stats(moments, hist=None) -> Optional[dict]:
    """The record's ``tree`` sub-block from one (5,) moment vector (and
    its leaf histogram); None for an off-interval or empty snapshot."""
    m = np.asarray(moments, np.float64).reshape(-1)
    if m.size < 5 or not np.isfinite(m[0]) or m[0] <= 0:
        return None
    active, s1, s2, mx, at_max = m[:5]
    ess = (s1 * s1 / s2) if s2 > 0 else 0.0
    mean = s1 / active
    out = {
        "active_leaves": int(active),
        "ess": round(ess, 2),
        "ess_frac": round(ess / active, 4),
        "max_mean_ratio": round(mx / mean, 3) if mean > 0 else None,
        "frac_at_max": round(at_max / active, 4),
    }
    if hist is not None:
        counts = np.asarray(hist, np.int64).reshape(-1)
        out["priorities"] = value_summary(counts)
        out["leaf_hist_counts"] = [int(c) for c in counts]
    return out


def merge_shard_moments(shard_moments) -> np.ndarray:
    """One (5,) moment vector from (dp, 5) per-shard ones: sums, the max
    of the maxes, and the count at max against the global max."""
    sm = np.asarray(shard_moments, np.float64).reshape(-1, 5)
    gmx = sm[:, 3].max() if sm.size else 0.0
    at_max = float(np.sum(np.where(
        sm[:, 3] >= gmx * (1.0 - AT_MAX_RTOL), sm[:, 4], 0.0)))
    return np.asarray([sm[:, 0].sum(), sm[:, 1].sum(), sm[:, 2].sum(),
                       gmx, at_max], np.float64)


def derive_evictions(stats, life_hist=None,
                     interval=None) -> Optional[dict]:
    """The record's ``evictions`` sub-block from the cumulative (5,)
    ledger [evicted, never sampled, lifetime sum, age sum, final priority
    sum] (f64 on the host), its lifetime histogram and this flush's delta
    (``interval``)."""
    s = np.asarray(stats, np.float64).reshape(-1)
    if s.size < 5 or not np.isfinite(s[0]):
        return None
    evicted, never, life, age, prio = s[:5]
    out: Dict[str, Any] = {"evicted": int(evicted),
                           "never_sampled": int(never)}
    if evicted > 0:
        out.update({
            "never_sampled_frac": round(never / evicted, 4),
            "mean_lifetime": round(life / evicted, 3),
            "mean_age_blocks": round(age / evicted, 2),
            "mean_final_priority": round(prio / evicted, 6),
        })
    if life_hist is not None:
        out["lifetime"] = value_summary(
            np.asarray(life_hist, np.int64).reshape(-1))
    if interval is not None:
        d = np.asarray(interval, np.float64).reshape(-1)
        out["interval"] = {"evicted": int(d[0]),
                           "never_sampled": int(d[1])}
        if d[0] > 0:
            out["interval"]["never_sampled_frac"] = round(d[1] / d[0], 4)
    return out


def derive_lanes(counts, num_lanes: int) -> Optional[dict]:
    """The record's ``lanes`` sub-block from the interval's summed
    (lanes + 1,) bincount."""
    c = np.asarray(counts, np.int64).reshape(-1)
    total = int(c.sum())
    if total == 0 or num_lanes <= 0:
        return None
    known = c[:-1]
    active = int(np.sum(known > 0))
    out = {
        "total_lanes": num_lanes,
        "sampled_sequences": total,
        "unknown_frac": round(float(c[-1]) / total, 4),
        "active_lanes": active,
        "starved_frac": round(1.0 - active / num_lanes, 4),
        "max_share": round(float(known.max()) / max(int(known.sum()), 1),
                           4),
    }
    if num_lanes <= 64:
        out["counts"] = [int(x) for x in known]
    return out


class ReplayDiagAggregator:
    """The host side of the ``rd/`` values, the JAX package's: snapshot
    keys take the newest interval firing, the eviction deltas and lane
    counts sum over the flush's dispatches; ``host_stats``
    (``HostReplay.diag_raw``) stands in for the device snapshot under
    host placement."""

    def __init__(self, lanes: int):
        self.lanes = lanes
        self._pending: List[Dict[str, Any]] = []
        self._cum_evict = np.zeros(5, np.float64)
        self._cum_life = np.zeros(NBUCKETS, np.int64)
        self._evict_seen = False

    def on_dispatch(self, metrics: Dict[str, Any]) -> None:
        rd = {k: v for k, v in metrics.items() if k.startswith("rd/")}
        if rd:
            self._pending.append(rd)

    @staticmethod
    def _last_snapshot(host, mkey, extras=()):
        for d in reversed(host):
            if mkey not in d:
                continue
            rows = np.asarray(d[mkey], np.float64).reshape(-1, 5)
            ex = [np.asarray(d[k]).reshape(rows.shape[0], -1)
                  for k in extras]
            for i in range(rows.shape[0] - 1, -1, -1):
                if np.isfinite(rows[i, 0]):
                    return rows[i], [e[i] for e in ex]
        return None, []

    @staticmethod
    def _sum_evict_deltas(host, key, hist_key):
        delta = np.zeros(5, np.float64)
        hist = np.zeros(NBUCKETS, np.int64)
        found = False
        for d in host:
            if key not in d:
                continue
            rows = np.asarray(d[key], np.float64).reshape(-1, 5)
            hrows = np.asarray(d[hist_key], np.int64).reshape(
                rows.shape[0], -1)
            finite = np.isfinite(rows[:, 0])
            if finite.any():
                found = True
                delta += rows[finite].sum(axis=0)
                hist += hrows[finite].sum(axis=0)
        return delta, hist, found

    @staticmethod
    def _last_shard_snapshot(host, mkey, extras=()):
        for d in reversed(host):
            if mkey not in d:
                continue
            m = np.asarray(d[mkey], np.float64)
            dp = m.shape[-2]
            slabs = m.reshape(-1, dp, 5)
            ex = [np.asarray(d[k]).reshape(slabs.shape[0], dp, -1)
                  for k in extras]
            for i in range(slabs.shape[0] - 1, -1, -1):
                if np.isfinite(slabs[i, :, 0]).any():
                    return slabs[i], [e[i] for e in ex]
        return None, []

    def flush(self, host_stats: Optional[dict] = None) -> Optional[dict]:
        """The interval's ``replay_diag`` block (None when no dispatch
        ran)."""
        from r2d2_tpu_torch.telemetry.learning import to_host
        if not self._pending:
            return None
        pending, self._pending = self._pending, []
        host = to_host(pending)

        block: Dict[str, Any] = {}
        moments = hist = None
        sh_m, sh_ex = self._last_shard_snapshot(
            host, "rd/shard_tree_moments", ("rd/shard_leaf_hist",))
        if sh_m is not None:
            block["shards"] = [derive_tree_stats(sh_m[i])
                               for i in range(sh_m.shape[0])]
            moments = merge_shard_moments(sh_m)
            hist = sh_ex[0].reshape(sh_m.shape[0], -1).sum(axis=0)
            delta, dhist, found = self._sum_evict_deltas(
                host, "rd/shard_evict_stats", "rd/shard_evict_life_hist")
        else:
            m, ex = self._last_snapshot(
                host, "rd/tree_moments", ("rd/leaf_hist",))
            if m is not None:
                moments, hist = m, ex[0]
            delta, dhist, found = self._sum_evict_deltas(
                host, "rd/evict_stats", "rd/evict_life_hist")

        if host_stats:
            moments = host_stats["tree_moments"]
            hist = host_stats["leaf_hist"]
            delta = np.asarray(host_stats["evict_stats"], np.float64)
            dhist = np.asarray(host_stats["evict_life_hist"], np.int64)
            found = True

        tree = derive_tree_stats(moments, hist) if moments is not None \
            else None
        if tree is not None:
            block["tree"] = tree
        if found:
            self._evict_seen = True
            self._cum_evict += delta
            self._cum_life += dhist.reshape(-1)
        if self._evict_seen:
            evictions = derive_evictions(
                self._cum_evict, self._cum_life,
                interval=(delta if found else np.zeros(5)))
            if evictions is not None:
                block["evictions"] = evictions

        lc = [np.asarray(d["rd/lane_counts"], np.int64)
              for d in host if "rd/lane_counts" in d]
        if lc:
            counts = np.concatenate(
                [c.reshape(-1, self.lanes + 1) for c in lc]).sum(axis=0)
            lanes = derive_lanes(counts, self.lanes)
            if lanes is not None:
                block["lanes"] = lanes

        return block or None
