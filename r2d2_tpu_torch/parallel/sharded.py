"""The data-parallel learner, the JAX package's ``parallel/sharded.py``
(its manual-dp ``shard_map`` path) over ``torch.distributed``, one process
a rank (``parallel/mesh.py``):

  * Each rank holds one replay shard (``num_blocks`` blocks, its own sum
    tree and ring pointer) on its device. Rank 0 feeds blocks round-robin:
    block k of a batch goes to shard ``(start_shard + k) % dp``; the batch
    is broadcast and each rank writes its own blocks in feed order, so
    every shard's pointer advances as under per-block adds. Sampling and
    the priority write-back stay local to the shard.
  * Params and optimizer state are replicated: each rank computes the
    gradient of its own ``batch_size`` sequences and one all-reduce mean
    makes the clip and the Adam update identical everywhere (the global
    batch is ``dp * batch_size``). The clip acts on the reduced gradient,
    as optax's ``tx.update`` does after JAX's ``pmean``; ``loss``,
    ``mean_abs_td`` and ``mean_q`` ride the same all-reduce, ``grad_norm``
    is the reduced gradient's.
  * Each rank draws its own sampling jitter from its own generator
    (``shard_seed``), the counterpart of ``fold_in(key, shard)``.
  * On-device acting: rank s acts lanes ``[s*lps, (s+1)*lps)`` of the
    global epsilon ladder (``lps = num_lanes / dp``), stamps them with
    their global lane index and writes its blocks into its own shard, with
    no cross-shard traffic; its stats are gathered to rank 0.

The inner computation is the single-device step's
(``learner/train_step.py``): the all-reduce enters through the hook
between its backward and its clip, which the unsharded path leaves empty.

The diagnostics (``diag``/``rdiag``, telemetry/) reduce as the JAX
package's manual dp step reduces them: the three histograms summed and
the staleness mean, the unknown share, the three dQs and the target
distance averaged, all in ``GradMean``'s one flat all-reduce; the
version min and max in one more (a max); the group norms from the
averaged gradients; no per-sequence vectors. The replay views are gathered
to ``rd/shard_*`` with a leading dp axis and the lane counts summed
(``shard_replay_diag``, one all-gather). Every collective runs on every
step, in every graph variant: the ranks pick the same variant from the
same step count, so none waits in a collective another skips.

With ``mesh.mp`` > 1 the step is the counterpart of the JAX package's
``_make_gspmd_learner_step`` (its diagnostics too: the learning ones of
this rank's view, which is shard 0's on rank 0, with the global loss and
gradients; the replay views stacked): the dp x mp grid of
parallel/mesh.py, the
replay shard of dp row d replicated bit for bit on its mp ranks (each
writes the same blocks and draws the same jitter, from
``shard_seed(seed, d)``), the train state feature-sharded over the row
(parallel/tensor_parallel.py: the forward column-parallel, the clip's
norm over the row), the gradient averaged over the ranks of one mp index
(``mesh.dp_group``). Its dispatches run eagerly on either backend.
"""

import dataclasses
import hashlib
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from r2d2_tpu_torch.actor.anakin import AnakinAct, init_act_carry
from r2d2_tpu_torch.config import OptimConfig
from r2d2_tpu_torch.learner.train_step import (GraphedSteps, TrainState,
                                               _make_step_body,
                                               diag_intervals, eager_steps,
                                               make_external_batch_step)
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.replay.device_replay import (WRITTEN, replay_add_many,
                                                 replay_init, replay_size)
from r2d2_tpu_torch.replay.structs import (Block, ReplaySpec, ReplayState,
                                           SampleBatch, empty_block_np,
                                           stack_blocks, torch_dtype)

_METRIC_SLOTS = ("loss", "mean_abs_td", "mean_q")
# the learning diagnostics the dp step averages and sums (JAX's pmean and
# psum sets); the version min and max go through a max
DIAG_MEANS = ("ld/version_mean", "ld/unknown_frac", "ld/delta_q_stored",
              "ld/delta_q_zero", "ld/delta_q_recomputed", "ld/target_dist")
DIAG_SUMS = ("ld/td_hist", "ld/prio_hist", "ld/q_hist")
DIAG_EXTRA = len(DIAG_MEANS) + 64 * len(DIAG_SUMS)


def shard_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s generator seed from a run's ``seed``: rank 0 keeps
    it (a one-rank mesh draws what the unsharded path draws), the others
    get streams of their own."""
    return seed + rank * (1 << 32)


# -- replay ---------------------------------------------------------------


def sharded_replay_init(spec: ReplaySpec, mesh: Mesh) -> ReplayState:
    """This rank's replay shard, on its device."""
    return replay_init(spec, mesh.device)


def wire_layout(fields):
    """``fields`` (name -> (shape, numpy dtype) of one row's item) as
    (name, shape, numpy dtype, torch dtype, offset, bytes) in a byte row,
    and the row's length: the 4-byte fields first (ties in ``fields``'
    order), the uint8 ones last, the row padded to 4 bytes, so every
    field's offset is aligned."""
    order = list(fields)
    names = sorted(order, key=lambda n: (-np.dtype(fields[n][1]).itemsize,
                                         order.index(n)))
    layout, off = [], 0
    for name in names:
        shape, np_dtype = fields[name]
        np_dtype = np.dtype(np_dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
        layout.append((name, tuple(shape), np_dtype, torch_dtype(np_dtype),
                       off, nbytes))
        off += nbytes
    return layout, -(-off // 4) * 4


def block_layout(spec: ReplaySpec):
    """``wire_layout`` of one block's written fields."""
    proto = empty_block_np(spec)
    return wire_layout({name: (proto[name].shape, proto[name].dtype)
                         for name in WRITTEN})


def pack_rows(layout, row: int, items, k: int, device: torch.device
          ) -> torch.Tensor:
    """``items``' fields (numpy or tensors), each cut into ``k`` rows
    along its leading elements (K stacked blocks; a batch's dp row
    slices) -> one (k, row) uint8 tensor on ``device``: a collective's one
    buffer."""
    if torch.is_tensor(getattr(items, layout[0][0])):
        parts = [getattr(items, name).to(device, dtype).reshape(k, -1)
                 .contiguous().view(torch.uint8)
                 for name, _, _, dtype, _, _ in layout]
        pad = row - sum(p.shape[1] for p in parts)
        if pad:
            parts.append(torch.zeros((k, pad), dtype=torch.uint8,
                                     device=device))
        return torch.cat(parts, dim=1)
    host = np.zeros((k, row), np.uint8)
    for name, _, np_dtype, _, off, nbytes in layout:
        a = np.ascontiguousarray(getattr(items, name), dtype=np_dtype)
        host[:, off:off + nbytes] = a.reshape(k, -1).view(np.uint8)
    buf = torch.from_numpy(host)
    if device.type == "cuda":
        return buf.pin_memory().to(device, non_blocking=True)
    return buf.to(device)


def unpack_rows(layout, buf: torch.Tensor) -> dict:
    """(K, row) bytes -> each field's K items stacked, by name, as tensors
    on ``buf``'s device."""
    k = buf.shape[0]
    return {name: buf[:, off:off + nbytes].contiguous().view(dtype)
            .reshape((k,) + tuple(shape))
            for name, shape, _, dtype, off, nbytes in layout}


def own_blocks(k: int, start_shard: int, mesh: Mesh) -> List[int]:
    """Which of a batch's ``k`` blocks go to this rank's shard (its dp
    row's: the row's mp ranks hold replicas of one shard)."""
    return [i for i in range(k)
            if (start_shard + i) % mesh.dp == mesh.dp_rank]


def make_sharded_replay_add_many(spec: ReplaySpec, mesh: Mesh):
    """``add_many(state, blocks, start_shard, k=None) -> state``: ring-write
    K stacked blocks round-robin over the dp shards, equal to K sequential
    ``make_sharded_replay_add`` calls starting at ``start_shard``. Rank 0
    passes the blocks and broadcasts them (one buffer); the other ranks
    pass ``blocks=None`` and ``k``. Block i goes to shard
    ``(start_shard + i) % dp``; each rank writes its own blocks, in feed
    order, with one ``replay_add_many``, so its ring pointer advances as
    under per-block adds. Every rank must call it, in the same order."""
    layout, row = block_layout(spec)

    def add_many(state: ReplayState, blocks: Optional[Block],
                 start_shard: int, k: Optional[int] = None) -> ReplayState:
        if mesh.leader:
            buf = pack_rows(layout, row, blocks,
                        int(np.shape(blocks.priority)[0]), mesh.device)
        else:
            buf = torch.empty((k, row), dtype=torch.uint8,
                              device=mesh.device)
        dist.broadcast(buf, src=0, group=mesh.group)
        mine = own_blocks(buf.shape[0], start_shard, mesh)
        if mine:
            idx = torch.tensor(mine, device=buf.device)
            replay_add_many(spec, state, Block(
                num_sequences=None, sum_reward=None,
                **unpack_rows(layout, buf[idx])))
        return state

    return add_many


def make_sharded_replay_add(spec: ReplaySpec, mesh: Mesh):
    """``add(state, block, shard_idx) -> state``: ring-write one block (rank
    0's; None elsewhere) into shard ``shard_idx``; the K=1 case of
    ``make_sharded_replay_add_many``."""
    add_many = make_sharded_replay_add_many(spec, mesh)

    def add(state: ReplayState, block: Optional[Block], shard_idx: int
            ) -> ReplayState:
        stacked = None if block is None else stack_blocks([block])
        return add_many(state, stacked, shard_idx, 1)

    return add


def sharded_buffer_steps(state: ReplayState, mesh: Mesh) -> int:
    """Learning steps stored over every shard (a collective)."""
    total = replay_size(state).to(torch.float64).reshape(1)
    dist.all_reduce(total, group=mesh.dp_group)
    return int(total.item())


# -- the learner step -------------------------------------------------------


class GradMean:
    """The hook between the step's backward and its clip: the mean over the
    dp ranks (``mesh.dp_group``) of the gradient and of the three metric
    scalars, in one all-reduce. The parameters' ``.grad`` are views of one
    flat f32 buffer allocated once (``attach``), so the collective is one
    call and a CUDA graph's addresses hold. With ``diag`` the buffer also
    carries the learning diagnostics' sums and means (``DIAG_MEANS``,
    ``DIAG_SUMS``; a call then takes and returns them), and their version
    min and max take one more all-reduce."""

    def __init__(self, mesh: Mesh, diag: bool = False):
        self.mesh = mesh
        self.flat: Optional[torch.Tensor] = None
        self.numel = 0
        self.extra = DIAG_EXTRA if diag else 0

    SLOTS = len(_METRIC_SLOTS)      # the scalars behind the gradient

    def attach(self, module: torch.nn.Module) -> None:
        params = list(module.parameters())
        if any(p.dtype != torch.float32 for p in params):
            raise ValueError("the flat gradient buffer holds f32 parameters "
                             "only")
        self.numel = sum(p.numel() for p in params)
        self.flat = torch.zeros(self.numel + self.SLOTS + self.extra,
                                dtype=torch.float32, device=params[0].device)
        off = 0
        for p in params:
            p.grad = self.flat[off:off + p.numel()].view_as(p)
            off += p.numel()

    def _check(self, grads: Sequence[torch.Tensor]) -> None:
        if self.flat is None or grads[0].data_ptr() != self.flat.data_ptr():
            raise RuntimeError("the gradients are not the flat buffer's views"
                               " (attach() before the first step)")

    def __call__(self, grads: Sequence[torch.Tensor], loss: torch.Tensor,
                 mean_abs_td: torch.Tensor, mean_q: torch.Tensor,
                 valid_steps: Optional[torch.Tensor] = None,
                 diag: Optional[dict] = None):
        self._check(grads)
        flat, n = self.flat, self.numel
        m = n + self.SLOTS
        flat[n:m].copy_(torch.stack([loss, mean_abs_td, mean_q]).float())
        dp = self.mesh.dp
        if diag is not None:
            # the means enter divided by dp, so the sum is their mean
            flat[m:].copy_(torch.cat(
                [torch.stack([diag[k] for k in DIAG_MEANS]).float() / dp]
                + [diag[k].float() for k in DIAG_SUMS]))
        dist.all_reduce(flat, group=self.mesh.dp_group)
        if dp > 1:
            flat[:m].mul_(1.0 / dp)
        out = flat[n:m].clone()
        if diag is None:
            return out[0], out[1], out[2]
        return out[0], out[1], out[2], self._diag_out(diag, flat[m:])

    def _diag_out(self, diag: dict, reduced: torch.Tensor) -> dict:
        out = dict(diag)
        reduced = reduced.clone()
        for i, key in enumerate(DIAG_MEANS):
            out[key] = reduced[i]
        off = len(DIAG_MEANS)
        for key in DIAG_SUMS:
            out[key] = reduced[off:off + 64].round().to(diag[key].dtype)
            off += 64
        extrema = torch.stack([-diag["ld/version_min"],
                               diag["ld/version_max"]]).float()
        dist.all_reduce(extrema, op=dist.ReduceOp.MAX,
                        group=self.mesh.dp_group)
        out["ld/version_min"], out["ld/version_max"] = -extrema[0], extrema[1]
        return out


class BatchMean(GradMean):
    """The hook of one global batch split over the ranks (host placement:
    rank r trains on its ``B/dp`` rows): the loss and its means divide by
    the learning steps of the whole batch, as the JAX package's GSPMD
    external step computes them over the global batch. Each rank's
    gradient and scalars are weighted by its own valid steps, summed with
    the weights in one all-reduce, and divided by the weights' sum (at
    least one, the loss's clamp)."""

    SLOTS = len(_METRIC_SLOTS) + 1          # the three scalars, the weight

    def __call__(self, grads: Sequence[torch.Tensor], loss: torch.Tensor,
                 mean_abs_td: torch.Tensor, mean_q: torch.Tensor,
                 valid_steps: Optional[torch.Tensor] = None):
        self._check(grads)
        flat, n = self.flat, self.numel
        w = valid_steps.float()
        flat[n:].copy_(torch.stack([loss.float() * w, mean_abs_td.float() * w,
                                    mean_q.float() * w, w]))
        flat[:n].mul_(w)
        dist.all_reduce(flat, group=self.mesh.dp_group)
        flat[:-1].div_(flat[-1].clamp(min=1.0))
        out = flat[n:-1].clone()
        return out[0], out[1], out[2]


def _train_state_tensors(ts: TrainState) -> List[torch.Tensor]:
    """Every tensor of a train state that the replicas share, in one order
    on every rank."""
    out = [ts.step_count] + list(ts.params.parameters())
    if ts.target_params is not ts.params:
        out += list(ts.target_params.parameters())
    for p in ts.params.parameters():
        state = ts.opt.state.get(p, {})
        out += [state[key] for key in sorted(state)
                if torch.is_tensor(state[key])]
    return out


def state_digest(ts: TrainState) -> str:
    """sha256 of the replicated train state's bytes: equal on every rank
    while the replicas are bit-equal."""
    h = hashlib.sha256()
    for t in _train_state_tensors(ts):
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def broadcast_train_state(ts: TrainState, mesh: Mesh) -> None:
    """Dp row 0's params, target, optimizer state and step to every row
    (rank 0's at mp = 1; under tensor parallelism each mp index's shards
    from row 0), so the replicas start bit-equal (a resumed run's too)."""
    with torch.no_grad():
        for t in _train_state_tensors(ts):
            dist.broadcast(t, src=mesh.mp_rank, group=mesh.dp_group)
    ts.step = int(ts.step_count.item())


class ShardedLearnerStep:
    """``step(train_state, replay_shard, uniform=None) -> (train_state,
    replay_shard, metrics)``: K = ``steps`` data-parallel learner steps a
    dispatch on this rank's shard, every rank calling it in lockstep.
    ``uniform``: this rank's (K, B) jitter ((B,) at K = 1), else drawn
    from the train state's generator. Metrics are stacked to (K,), scalars
    at K = 1, as the JAX package's step gives them.

    The first call attaches the flat gradient buffer and broadcasts rank
    0's train state. The backend picks the dispatch, which the step
    states in ``graphed``: with NCCL on CUDA the K steps and their
    all-reduces are one CUDA graph (``GraphedSteps``: the first dispatch
    eager, which also brings up NCCL's communicator before the capture);
    with gloo, which a graph cannot capture (it stages through the host),
    the K steps run eagerly. Under ``mesh.mp`` > 1 the train state must be
    tensor-parallel (``tensor_parallel.place_train_state``), the hooks
    are ``TPGradients``' around the mean, and the K steps run eagerly on
    both backends."""

    def __init__(self, net: NetworkApply, spec: ReplaySpec,
                 optim: OptimConfig, use_double: bool, mesh: Mesh,
                 steps: int, diag=None, rdiag=None):
        if steps < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1; got {steps}")
        from r2d2_tpu_torch.telemetry.replaydiag import shard_replay_diag
        self.mesh, self.steps = mesh, steps
        sq_norm = group_sq = None
        if mesh.mp > 1:
            from r2d2_tpu_torch.parallel.tensor_parallel import TPGradients
            self.reduce = TPGradients(mesh, GradMean(mesh))
            sq_norm = self.reduce.sq_norm
            group_sq = self.reduce.group_sq_norms
        else:
            self.reduce = GradMean(mesh, diag=diag is not None)
        body = _make_step_body(
            net, spec, optim, use_double, reduce=self.reduce,
            sq_norm=sq_norm, diag=diag, rdiag=rdiag,
            diag_reduce=mesh.mp == 1, group_sq=group_sq,
            rd_reduce=lambda rd: shard_replay_diag(rd, mesh))
        intervals = diag_intervals(diag, rdiag)
        self.graphed = mesh.backend == "nccl" and mesh.mp == 1
        self._dispatch = (GraphedSteps(body, steps, spec.batch_size,
                                       intervals=intervals)
                          if self.graphed
                          else eager_steps(body, steps, intervals))
        self._started = False

    def __call__(self, ts: TrainState, rs: ReplayState,
                 uniform: Optional[torch.Tensor] = None):
        if not self._started:
            self.reduce.attach(ts.params)
            broadcast_train_state(ts, self.mesh)
            self._started = True
        if uniform is not None and uniform.dim() == 1:
            uniform = uniform[None]
        ts, rs, metrics = self._dispatch(ts, rs, uniform)
        if self.steps == 1:
            metrics = {name: v[0] for name, v in metrics.items()}
        return ts, rs, metrics


def make_sharded_learner_step(net: NetworkApply, spec: ReplaySpec,
                              optim: OptimConfig, use_double: bool,
                              mesh: Mesh, steps_per_dispatch: int = 1,
                              diag=None, rdiag=None) -> ShardedLearnerStep:
    """The data-parallel step (``ShardedLearnerStep``): the single-device
    step's sampling, loss and write-back per shard, one all-reduce mean of
    the gradient, then clip and Adam; the target sync is the single
    step's, on the replicated step counter. ``mesh.mp`` > 1: the dp x mp
    step (the module docstring), JAX's ``_make_gspmd_learner_step``.
    ``diag``, ``rdiag``: the diagnostics, reduced as the module docstring
    says."""
    return ShardedLearnerStep(net, spec, optim, use_double, mesh,
                              steps_per_dispatch, diag, rdiag)


class DpRowGather:
    """``gather(aux, batch) -> (aux, batch)``: the per-sequence values the
    learning diagnostics and the lane counts read, of the whole batch
    split over the dp rows (row d holds rows ``[d*B/dp, (d+1)*B/dp)``):
    |TD|, the mask, Q(s, a), the priorities, the stamps, the indices and
    the lanes, in one all-gather of one f32 row a sequence over
    ``mesh.dp_group`` (indices and stamps are exact in f32 below 2^24).
    The external steps across dp rows use it, so their diagnostics are
    those of the global batch, as the JAX package's GSPMD step computes
    them."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, aux: dict, batch: SampleBatch):
        from r2d2_tpu_torch.parallel.tensor_parallel import gather_dp_rows
        b = aux["abs_td"].shape[0]
        lane = (batch.lane if batch.lane is not None
                else torch.full((b,), -1, device=aux["abs_td"].device))
        cols = [aux["abs_td"], aux["mask"], aux["q_chosen"],
                aux["priorities"][:, None], batch.weight_version[:, None],
                batch.idxes[:, None], lane[:, None]]
        widths = [c.shape[1] for c in cols]
        full = gather_dp_rows(torch.cat([c.float() for c in cols], dim=1),
                              self.mesh)
        split = torch.split(full, widths, dim=1)
        out_aux = dict(aux, abs_td=split[0], mask=split[1],
                       q_chosen=split[2], priorities=split[3][:, 0])
        out = dataclasses.replace(
            batch, weight_version=split[4][:, 0].round().to(
                batch.weight_version.dtype),
            idxes=split[5][:, 0].round().to(batch.idxes.dtype),
            lane=(None if batch.lane is None
                  else split[6][:, 0].round().to(batch.lane.dtype)))
        return out_aux, out


class ShardedExternalBatchStep:
    """``step(train_state, batch) -> (train_state, metrics)``: the
    external-batch step of host placement across the ranks, each on its
    own ``B/dp`` rows of one global batch (``BatchMean``); the priorities
    in ``metrics["priorities"]`` are this rank's rows, for its own host
    replay. As ``ShardedLearnerStep``: the first call attaches the flat
    gradient buffer and broadcasts rank 0's train state; NCCL on CUDA runs
    one CUDA graph of the step, gloo runs it eagerly."""

    def __init__(self, net: NetworkApply, spec: ReplaySpec,
                 optim: OptimConfig, use_double: bool, mesh: Mesh,
                 diag=None, rdiag=None):
        if spec.batch_size % mesh.dp:
            raise ValueError(
                f"replay.batch_size={spec.batch_size} is not divisible by "
                f"mesh dp={mesh.dp} — the batch axis cannot shard evenly")
        self.mesh = mesh
        self.local_batch = spec.batch_size // mesh.dp
        self.reduce = BatchMean(mesh)
        local = dataclasses.replace(spec, batch_size=self.local_batch)
        self.graphed = mesh.backend == "nccl"
        self._step = make_external_batch_step(
            net, local, optim, use_double, reduce=self.reduce,
            graphed=self.graphed, diag=diag, rdiag=rdiag,
            diag_gather=DpRowGather(mesh) if mesh.dp > 1 else None)
        self._started = False

    def __call__(self, ts: TrainState, batch: SampleBatch):
        if not self._started:
            self.reduce.attach(ts.params)
            broadcast_train_state(ts, self.mesh)
            self._started = True
        return self._step(ts, batch)


def make_sharded_external_batch_step(net: NetworkApply, spec: ReplaySpec,
                                     optim: OptimConfig, use_double: bool,
                                     mesh: Mesh, diag=None, rdiag=None
                                     ) -> ShardedExternalBatchStep:
    """Host placement's data-parallel step (``ShardedExternalBatchStep``),
    the counterpart of the JAX package's GSPMD external-batch step over a
    dp-sharded global batch: ``batch`` is this rank's ``B/dp`` rows.
    ``diag``, ``rdiag``: the diagnostics of the global batch
    (``DpRowGather``)."""
    return ShardedExternalBatchStep(net, spec, optim, use_double, mesh,
                                    diag, rdiag)


# -- on-device acting --------------------------------------------------------


def _lane_group_size(num_lanes: int, dp: int) -> int:
    if num_lanes % dp != 0:
        raise ValueError(
            f"anakin lanes ({num_lanes}) must divide evenly across the "
            f"mesh's dp={dp} shards (lanes % dp == 0)")
    return num_lanes // dp


def init_sharded_act_carry(env, spec: ReplaySpec, num_lanes: int, mesh: Mesh,
                           *, generator: Optional[torch.Generator] = None,
                           reset_draws: Optional[torch.Tensor] = None):
    """This rank's carry: fresh episodes in its ``num_lanes / dp`` lanes,
    reset from ``generator`` (the rank's own) or injected draws."""
    lps = _lane_group_size(num_lanes, mesh.dp)
    return init_act_carry(env, spec, lps, generator=generator,
                          reset_draws=reset_draws)


def make_sharded_anakin_act(env, net: NetworkApply, spec: ReplaySpec, *,
                            mesh: Mesh, num_lanes: int, epsilons,
                            gamma: float, priority, near_greedy_eps: float,
                            priority_eta: float = 0.9,
                            quant_probe_on: bool = True) -> AnakinAct:
    """This rank's acting segment: lanes ``[s*lps, (s+1)*lps)`` of the
    ``num_lanes``-wide ladder ``epsilons`` (rank s = ``mesh.rank``), its
    blocks stamped with those global lane indices. Its blocks go into the
    rank's own shard (``ActSegment`` over ``sharded_replay_init``'s
    state), so dp changes where lanes run, never the exploration
    schedule."""
    eps = [float(e) for e in epsilons]
    if len(eps) != num_lanes:
        raise ValueError(
            f"need one epsilon per GLOBAL lane: got {len(eps)} for "
            f"{num_lanes} lanes (the ladder spans all shards)")
    lps = _lane_group_size(num_lanes, mesh.dp)
    if lps > spec.num_blocks:
        raise ValueError(
            f"per-shard lane group ({lps} = {num_lanes} lanes / "
            f"dp={mesh.dp}) must be <= num_blocks ({spec.num_blocks}): each "
            "segment writes one block per lane into the shard's ring, whose "
            "rows must not alias")
    s = mesh.rank
    return AnakinAct(env, net, spec, num_lanes=lps,
                     epsilons=eps[s * lps:(s + 1) * lps], gamma=gamma,
                     priority=priority, near_greedy_eps=near_greedy_eps,
                     priority_eta=priority_eta, quant_probe_on=quant_probe_on,
                     lane_base=s * lps)


def gather_objects(obj, mesh: Mesh) -> list:
    """Every rank's ``obj`` (picklable), by rank, on every rank: the shards'
    stats and reports, over the host group."""
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.ctrl_group)
    return out
