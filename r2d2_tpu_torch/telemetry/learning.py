"""Learning diagnostics, the JAX package's ``telemetry/learning.py``: what
the training does, computed inside the learner step and read at the
metrics flush.

Device side (the JAX package's ``fused_diagnostics`` in two parts, which
learner/train_step.py calls around its all-reduce when a ``LearningDiag``
is given: ``batch_diagnostics`` before it, ``grad_diagnostics`` after):

  * histograms of |TD error|, of the written-back priorities and of
    |Q(s, a)| on the shared 64-bucket log layout (telemetry/histogram.py
    ``value_counts``: one bucketize and one scatter-add a batch);
  * the global gradient norm and one a parameter group (torso / lstm /
    head), taken before the clip;
  * the non-finite guard on the loss and the gradient norm;
  * sample staleness from the sequences' weight-version stamps;
  * on interval steps (``new_step % interval == 0``) the distance between
    the online and the target parameters and the stored-state check dQ
    (Kapturowski et al., ICLR 2019): Q from the stored hidden state and
    from a zero state, each against a zero-state unroll over the
    sequence's whole stored row. The JAX package branches with
    ``lax.cond``; here the caller says whether a step is an interval step
    (``dq_on``, from the host's step count), so a CUDA graph of the step
    holds one branch: learner/train_step.py keeps one graph a pattern of
    interval steps in a dispatch. Off-interval steps report NaN.

Host side (``LearningAggregator``): holds each dispatch's device values
until the flush, then builds the periodic record's ``learning`` block in
one transfer, and owns the NaN forensics: the first non-finite step
writes one ``nan_dump_player{p}.json``; ``nan_policy="halt"`` then raises.
"""

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from r2d2_tpu_torch.ops.indexing import learning_step_mask, online_q_positions
from r2d2_tpu_torch.ops.replay_kernels import stack_frames
from r2d2_tpu_torch.telemetry.histogram import (NBUCKETS, value_counts,
                                                value_summary)

_EPS = 1e-3          # the dQ normalization's floor

# a function of (tensors, group of each, number of groups) -> (G,) f32
# squared norms: the default sums each group's squares on this rank;
# under tensor parallelism the sharded tensors' squares are summed over
# the row (parallel/tensor_parallel.py TPGradients.group_sq_norms)
GroupSqNorms = Callable[[Sequence[torch.Tensor], Sequence[int], int],
                        torch.Tensor]


@dataclass(frozen=True)
class LearningDiag:
    """The diagnostics' settings, given to the step factories; None there
    means the diagnostics are off and the step is what it is without
    them."""

    interval: int = 200       # learner steps between dQ / target distance
    dq_batch: int = 16        # sequences a dQ evaluation

    @classmethod
    def from_config(cls, cfg) -> Optional["LearningDiag"]:
        """The one gating rule: telemetry.enabled and
        telemetry.learning_enabled."""
        t = cfg.telemetry
        if not (t.enabled and t.learning_enabled):
            return None
        return cls(interval=t.learning_interval, dq_batch=t.learning_dq_batch)

    def is_interval(self, new_step: int) -> bool:
        """Whether the step that makes the count ``new_step`` evaluates
        dQ and the target distance."""
        return new_step % self.interval == 0


# -- device side --------------------------------------------------------------


def local_group_sq_norms(tensors: Sequence[torch.Tensor],
                         groups: Sequence[int], n: int) -> torch.Tensor:
    """(n,) f32: each group's sum of squares on this rank, from the
    tensors' norms in one multi-tensor kernel (``torch._foreach_norm``)
    and a few more a step: the diagnostics ride every learner step."""
    sq = torch.stack(torch._foreach_norm([t.float() for t in tensors])) ** 2
    runs: List[List[tuple]] = [[] for _ in range(n)]
    start = 0
    for i in range(1, len(groups) + 1):      # runs of one group, as slices
        if i == len(groups) or groups[i] != groups[start]:
            runs[groups[start]].append((start, i))
            start = i
    return torch.stack([sum(sq[lo:hi].sum() for lo, hi in r) if r
                        else sq.new_zeros(()) for r in runs])


def param_groups(module: torch.nn.Module) -> List[str]:
    """Each parameter's group, in ``parameters()`` order: the top-level
    module of its name (torso, lstm, head), the flax tree's top-level
    key (models/convert.py)."""
    return [name.split(".")[0] for name, _ in module.named_parameters()]


def group_grad_norms(module: torch.nn.Module, grads: Sequence[torch.Tensor],
                     sq_norms: Optional[GroupSqNorms] = None
                     ) -> Dict[str, torch.Tensor]:
    """The global norm of each parameter group's gradients, by group name
    in sorted order (JAX: ``optax.global_norm`` of each top-level
    subtree)."""
    names = sorted(set(param_groups(module)))
    index = {name: i for i, name in enumerate(names)}
    groups = [index[g] for g in param_groups(module)]
    sq = (sq_norms or local_group_sq_norms)(grads, groups, len(names))
    norms = torch.sqrt(sq)
    return {name: norms[i] for i, name in enumerate(names)}


def param_distance(params: Sequence[torch.Tensor],
                   target: Sequence[torch.Tensor],
                   sq_norms: Optional[GroupSqNorms] = None) -> torch.Tensor:
    """The global L2 distance between the online and the target
    parameters (the drift since initialization without double DQN, where
    the target is the initial parameters)."""
    diffs = [p.detach() - t.detach() for p, t in zip(params, target)]
    return torch.sqrt((sq_norms or local_group_sq_norms)(
        diffs, [0] * len(diffs), 1)[0])


def _decode(net, spec, obs: torch.Tensor, last_action: torch.Tensor,
            length: int):
    """Stored rows -> network inputs over ``length`` steps: the decode
    dispatcher (the decode kernel on the card, which takes any length
    whose frames the rows hold) and the one-hot of the last actions (-1:
    a zero row)."""
    from r2d2_tpu_torch.models.network import SPACE_TO_DEPTH
    stacked = stack_frames(obs, length, spec.frame_stack,
                           out_dtype=net.compute_dtype,
                           out_height=spec.frame_height,
                           out_width=spec.frame_width,
                           space_to_depth=net.input_layout == SPACE_TO_DEPTH)
    la = last_action.long()
    one_hot = F.one_hot(la.clamp(min=0), net.action_dim).float()
    return stacked, one_hot * (la >= 0).unsqueeze(-1).float()


def _window_q(net, spec, module, batch, hidden: torch.Tensor
              ) -> torch.Tensor:
    """(m, T, A) f32: the sampled windows unrolled from ``hidden``."""
    stacked, la = _decode(net, spec, batch.obs, batch.last_action,
                          spec.seq_window)
    q, _ = module(stacked, la, hidden, net.input_layout)
    return q.float()


def _take(q: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return torch.gather(q, 1, pos.long()[:, :, None].expand(
        -1, -1, q.shape[-1]))


def delta_q_diag(net, spec, module, batch, replay_state, dq_batch: int):
    """The stored-state check (the module docstring) on the first
    ``dq_batch`` sequences of ``batch``: (delta_q_stored, delta_q_zero,
    delta_q_recomputed), f32 scalars. The reference unroll decodes each
    sequence's whole stored row (``spec.la_row_len`` steps) from the
    replay. No gradient: on the card the unrolls take the lean forward
    scan."""
    m = min(dq_batch, spec.batch_size)
    with torch.no_grad():
        sub = type(batch)(**{
            name: (None if getattr(batch, name) is None
                   else getattr(batch, name)[:m])
            for name in batch.__dataclass_fields__})
        q_stored = _window_q(net, spec, module, sub, sub.hidden)
        q_zero = _window_q(net, spec, module, sub,
                           torch.zeros_like(sub.hidden))
        idx = sub.idxes.long()
        b = idx // spec.seqs_per_block
        s = idx % spec.seqs_per_block
        seq_start = replay_state.seq_start[b, s]
        stacked, la = _decode(net, spec, replay_state.obs[b],
                              replay_state.last_action[b], spec.la_row_len)
        zeros = torch.zeros((m, 2, spec.hidden_dim), dtype=torch.float32,
                            device=idx.device)
        q_full, _ = module(stacked, la, zeros, net.input_layout)
        q_full = q_full.float()
        L = spec.learning
        lpos = seq_start.long()[:, None] + torch.arange(
            L, device=idx.device)[None, :]
        q_rec = _take(q_full, lpos)
        opos = online_q_positions(sub.burn_in_steps, L)
        q_s, q_z = _take(q_stored, opos), _take(q_zero, opos)
        mask = learning_step_mask(sub.learning_steps, L)
        denom = mask.sum().clamp(min=1.0)

        def dq(q, ref):
            d = torch.sqrt(torch.sum((q - ref) ** 2, dim=-1))
            scale = ref.abs().amax(dim=-1) + _EPS
            return torch.sum(d / scale * mask) / denom

        return dq(q_s, q_rec), dq(q_z, q_rec), dq(q_rec, q_s)


def version_stats(weight_version: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Reduced staleness stats over a (B,) stamp vector, for the paths
    that cannot return the raw vector (the dp step reduces them with
    min / max / mean). -1 stamps are unknown and left out; min and max
    saturate at 2^30 / -1 when every stamp is."""
    v = weight_version.float()
    known = (v >= 0).float()
    n_known = known.sum().clamp(min=1.0)
    big = torch.full_like(v, float(2 ** 30))
    return {
        "ld/version_min": torch.where(known > 0, v, big).amin(),
        "ld/version_max": torch.where(known > 0, v,
                                      torch.full_like(v, -1.0)).amax(),
        "ld/version_mean": torch.sum(v * known) / n_known,
        "ld/unknown_frac": 1.0 - known.sum() / v.shape[0],
    }


def nan_scalar(device) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=torch.float32, device=device)


def batch_diagnostics(net, spec, diag: LearningDiag, dq_on: bool, module,
                      params: Sequence[torch.Tensor],
                      target: Sequence[torch.Tensor], batch, aux,
                      replay_state=None, raw_arrays: bool = True,
                      sq_norms: Optional[GroupSqNorms] = None
                      ) -> Dict[str, torch.Tensor]:
    """The ``ld/`` values that need no gradient: the three histograms, the
    staleness stats (and, with ``raw_arrays``, the batch's stamps and
    indices), and on a ``dq_on`` step the target distance and, with a
    ``replay_state`` (device placement), dQ through ``module``;
    otherwise those four are NaN. ``params``, ``target``: the online and
    target parameters before the step's update."""
    out: Dict[str, torch.Tensor] = {
        "ld/td_hist": value_counts(aux["abs_td"], aux["mask"]),
        "ld/prio_hist": value_counts(aux["priorities"]),
        "ld/q_hist": value_counts(aux["q_chosen"], aux["mask"]),
    }
    out.update(version_stats(batch.weight_version))
    if raw_arrays:
        out["ld/weight_versions"] = batch.weight_version
        out["ld/batch_idxes"] = batch.idxes
    nan = nan_scalar(aux["abs_td"].device)
    out.update({"ld/target_dist": nan, "ld/delta_q_stored": nan,
                "ld/delta_q_zero": nan, "ld/delta_q_recomputed": nan})
    if dq_on:
        out["ld/target_dist"] = param_distance(params, target, sq_norms)
        if replay_state is not None:
            (out["ld/delta_q_stored"], out["ld/delta_q_zero"],
             out["ld/delta_q_recomputed"]) = delta_q_diag(
                net, spec, module, batch, replay_state, diag.dq_batch)
    return out


def grad_diagnostics(module, grads: Sequence[torch.Tensor],
                     sq_norms: Optional[GroupSqNorms] = None
                     ) -> Dict[str, torch.Tensor]:
    """The per-group gradient norms, of the (reduced) gradients before the
    clip."""
    return {f"ld/grad_norm_{name}": g
            for name, g in group_grad_norms(module, grads, sq_norms).items()}


# -- host side ----------------------------------------------------------------


def to_host(pending: List[Dict[str, Any]]) -> List[Dict[str, np.ndarray]]:
    """Dispatches' dicts of device tensors -> numpy, one transfer a key
    where the dispatches' shapes agree."""
    keys = sorted({k for d in pending for k in d})
    host: List[Dict[str, np.ndarray]] = [{} for _ in pending]
    for key in keys:
        rows = [(i, d[key]) for i, d in enumerate(pending) if key in d]
        values = [v for _, v in rows]
        if all(torch.is_tensor(v) for v in values) and len(
                {tuple(v.shape) for v in values}) == 1:
            stacked = torch.stack([v.detach() for v in values]).cpu().numpy()
            for (i, _), arr in zip(rows, stacked):
                host[i][key] = arr
        else:
            for i, v in rows:
                host[i][key] = (v.detach().cpu().numpy() if torch.is_tensor(v)
                                else np.asarray(v))
    return host


def _flatten_rows(values: List[np.ndarray], width: int) -> np.ndarray:
    return np.concatenate(
        [np.asarray(v).reshape(-1, width) for v in values], axis=0)


def _last_finite(values: List[np.ndarray]) -> Optional[float]:
    if not values:
        return None
    flat = np.concatenate([np.atleast_1d(np.asarray(v, np.float64))
                           for v in values])
    finite = flat[np.isfinite(flat)]
    return float(finite[-1]) if finite.size else None


class LearningAggregator:
    """The host side of the ``ld/`` values: each dispatch's metrics are
    held (``on_dispatch``, no sync) until ``flush`` builds the record's
    ``learning`` block, the JAX package's schema; the NaN forensics run
    there."""

    def __init__(self, player_idx: int, save_dir: str, nan_policy: str,
                 lr: float):
        self.player_idx = player_idx
        self.save_dir = save_dir or "."
        self.nan_policy = nan_policy
        self.lr = lr
        self.nan_dumped = False
        self._pending: List[Dict[str, Any]] = []

    def on_dispatch(self, metrics: Dict[str, Any]) -> None:
        ld = {k: v for k, v in metrics.items() if k.startswith("ld/")}
        if ld:
            self._pending.append(ld)

    @property
    def dump_path(self) -> str:
        return os.path.join(self.save_dir,
                            f"nan_dump_player{self.player_idx}.json")

    def flush(self, host_step: int, publish_count: Optional[int] = None,
              occupancy_versions: Optional[List[int]] = None
              ) -> Optional[dict]:
        """The interval's ``learning`` block (None when no step ran).
        ``publish_count``: the weight service's publication count now,
        the clock the ages are measured on; ``occupancy_versions``: the
        stamps of the ring's live slots (``RingAccountant
        .live_versions``)."""
        if not self._pending:
            return None
        pending, self._pending = self._pending, []
        host = to_host(pending)

        def col(key):
            return [d[key] for d in host if key in d]

        block: Dict[str, Any] = {}
        for name, key in (("td_abs", "ld/td_hist"),
                          ("priority", "ld/prio_hist"),
                          ("q_abs", "ld/q_hist")):
            rows = col(key)
            if rows:
                counts = _flatten_rows(rows, NBUCKETS).sum(axis=0)
                block[name] = value_summary(counts)
                block[name + "_counts"] = [int(c) for c in counts]

        gn: Dict[str, tuple] = {}
        for key in sorted({k for d in host for k in d
                           if k.startswith("ld/grad_norm")}):
            flat = np.concatenate([np.atleast_1d(np.asarray(v, np.float64))
                                   for v in col(key)])
            name = key[len("ld/grad_norm"):].lstrip("_") or "global"
            gn[name] = (round(float(np.max(flat)), 6),
                        round(float(np.mean(flat)), 6))
        block["grad_norm"] = {k: {"max": mx, "mean": mean}
                              for k, (mx, mean) in gn.items()}

        block["target_param_dist"] = _last_finite(col("ld/target_dist"))
        dq = {name: _last_finite(col(f"ld/delta_q_{name}"))
              for name in ("stored", "zero", "recomputed")}
        block["delta_q"] = dq if any(v is not None for v in dq.values()) \
            else None

        block["sample_age"] = self._sample_ages(col, publish_count)
        block["replay_age"] = self._occupancy_ages(publish_count,
                                                   occupancy_versions)
        nonfinite = int(sum(int(np.asarray(v).sum())
                            for v in col("ld/nonfinite")))
        block["nonfinite_steps"] = nonfinite
        if nonfinite:
            self._on_nonfinite(host_step, block, host)
        return block

    def _sample_ages(self, col, publish_count) -> Optional[dict]:
        """Ages (publish count - stamp) of every sequence trained this
        interval: from the raw stamps where the step returned them, else
        from the dp step's reduced stats. -1 stamps count as unknown."""
        raw = col("ld/weight_versions")
        if raw and publish_count is not None:
            v = np.concatenate([np.asarray(x).reshape(-1) for x in raw])
            known = v[v >= 0]
            out = {"unknown_frac": round(1.0 - known.size / max(v.size, 1),
                                         4)}
            if known.size:
                ages = np.maximum(publish_count - known.astype(np.int64), 0)
                out.update({
                    "p50": float(np.percentile(ages, 50)),
                    "p95": float(np.percentile(ages, 95)),
                    "max": int(ages.max()),
                    "mean": round(float(ages.mean()), 3),
                })
            return out
        vmax = col("ld/version_max")
        if vmax and publish_count is not None:
            def flat(values):
                return np.concatenate([np.atleast_1d(np.asarray(
                    v, np.float64)) for v in values])
            mx, mn = flat(vmax), flat(col("ld/version_min"))
            uf = flat(col("ld/unknown_frac"))
            known_mx = mx[mx >= 0]
            if known_mx.size == 0:
                return {"unknown_frac": 1.0}
            return {
                # the oldest stamp is the largest age and vice versa
                "max": int(max(publish_count - float(np.min(
                    mn[mn < 2 ** 29])), 0)) if np.any(mn < 2 ** 29) else 0,
                "min": int(max(publish_count - float(np.max(known_mx)), 0)),
                "unknown_frac": round(float(np.mean(uf)), 4),
            }
        return None

    def _occupancy_ages(self, publish_count,
                        occupancy_versions) -> Optional[dict]:
        if publish_count is None or not occupancy_versions:
            return None
        v = np.asarray([x for x in occupancy_versions if x >= 0], np.int64)
        if v.size == 0:
            return {"unknown_slots": len(occupancy_versions)}
        ages = np.maximum(publish_count - v, 0)
        return {
            "p50": float(np.percentile(ages, 50)),
            "p95": float(np.percentile(ages, 95)),
            "max": int(ages.max()),
            "slots": int(v.size),
            "unknown_slots": len(occupancy_versions) - int(v.size),
        }

    def _on_nonfinite(self, host_step: int, block: dict, host) -> None:
        """The first non-finite loss or gradient norm of the run writes one
        dump; then ``nan_policy`` decides: "warn" goes on, "halt"
        raises."""
        log = logging.getLogger(__name__)
        if not self.nan_dumped:
            self.nan_dumped = True
            last = host[-1]
            dump = {
                "step": int(host_step),
                "time": time.time(),
                "lr": self.lr,
                "nan_policy": self.nan_policy,
                "learning": {k: v for k, v in block.items()
                             if not k.endswith("_counts")},
                "histograms": {k: block[k] for k in
                               ("td_abs_counts", "priority_counts",
                                "q_abs_counts") if k in block},
                "last_batch_idxes": [
                    int(x) for x in np.asarray(
                        last.get("ld/batch_idxes", [])).reshape(-1)],
                "last_batch_weight_versions": [
                    int(x) for x in np.asarray(
                        last.get("ld/weight_versions", [])).reshape(-1)],
            }
            try:
                os.makedirs(self.save_dir, exist_ok=True)
                with open(self.dump_path, "w") as f:
                    json.dump(dump, f, indent=2)
            except OSError:
                log.exception("failed writing NaN forensics dump")
            log.warning(
                "player %d: NON-FINITE loss/grad-norm at step ~%d — "
                "forensics dumped to %s (telemetry.nan_policy=%s)",
                self.player_idx, host_step, self.dump_path, self.nan_policy)
        if self.nan_policy == "halt":
            raise RuntimeError(
                f"non-finite loss/grad-norm at step ~{host_step} "
                f"(telemetry.nan_policy=halt); forensics at "
                f"{self.dump_path}")
