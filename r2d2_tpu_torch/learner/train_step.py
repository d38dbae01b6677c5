"""The R2D2 learner step: sample -> decode -> unroll -> loss -> clip + Adam ->
priority write-back -> hard target sync, the counterpart of the JAX
package's fused ``make_learner_step``; ``make_multi_learner_step``, K
steps per dispatch (the JAX package's ``lax.scan`` of the step), which
``make_dispatch_step`` gives the learner at every K; and
``make_external_batch_step``, the step on a batch sampled on the host
(``replay.placement="host"``), which returns the priorities instead of
writing them back.

The JAX step is one XLA program over donated buffers; here the same steps
run on one CUDA stream and update the replay tree, the parameters and the
optimizer state in place.

Every factory takes ``diag`` (telemetry/learning.py ``LearningDiag``) and
``rdiag`` (telemetry/replaydiag.py ``ReplayDiag``), as the JAX package's
do: the learning and the replay diagnostics computed inside the step,
their ``ld/`` and ``rd/`` values returned with the metrics. None leaves
the step as it is without them. The learning diagnostics read the
gradients before the clip and the parameters and target before the
update (the JAX step feeds them its pre-update state); the replay
diagnostics run after the priority write-back. Their interval work (dQ
and the target distance on the steps whose new count is a multiple of
``diag.interval``, the tree snapshot and the eviction ledger's read on
multiples of ``rdiag.interval``; the JAX step's ``lax.cond``) is decided
on the host, from its mirror of the step count: a step is told
``dq_on`` and ``rd_on``, and a CUDA graph of K steps is captured once
for each pattern of interval steps among its K (``GraphedSteps``), so a
dispatch without one replays a graph without that work.

Sampling and its write-back stay atomic with
respect to ingestion because nothing else writes the replay between them.
The step makes no host sync and reads no host value that changes from step
to step (the target sync rides a step counter on the device, Adam keeps
its step count there), so K of them capture into one CUDA graph.

Optimizer: ``optax.chain(clip_by_global_norm(max), adam(lr, eps))``.
optax clips as ``g / norm * max`` whenever ``norm >= max`` (``clip_grad_norm_``
divides by ``norm + 1e-6`` instead, so it is not used). optax's Adam adds
eps outside the square root, which is what ``torch.optim.Adam`` does.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from r2d2_tpu_torch.config import (OptimConfig, check_decode_layout,
                                   check_kernel_setting,
                                   resolve_fused_double_unroll)
from r2d2_tpu_torch.models.network import (SPACE_TO_DEPTH, NetworkApply,
                                           R2D2Network, dual_sequence_q)
from r2d2_tpu_torch.ops.indexing import (learning_step_mask,
                                         online_q_positions,
                                         target_q_positions)
from r2d2_tpu_torch.ops.launch_counts import (add_launch_counts,
                                              captured_launches,
                                              launch_counts)
from r2d2_tpu_torch.ops.priority import mixed_td_errors_masked
from r2d2_tpu_torch.ops.replay_kernels import stack_frames
from r2d2_tpu_torch.ops.sum_tree import tree_update
from r2d2_tpu_torch.ops.value import inverse_value_rescale, value_rescale
from r2d2_tpu_torch.replay.device_replay import replay_sample
from r2d2_tpu_torch.replay.structs import (ReplaySpec, ReplayState,
                                           SampleBatch, batch_fields)
from r2d2_tpu_torch.telemetry import scopes
from r2d2_tpu_torch.telemetry.compile import compile_event
from r2d2_tpu_torch.utils.device import gc_paused


METRICS = ("loss", "mean_abs_td", "mean_q", "grad_norm")


@dataclass
class TrainState:
    params: R2D2Network
    target_params: R2D2Network      # the online module itself without double DQN
    opt: torch.optim.Optimizer
    step: int                       # host mirror of step_count
    generator: torch.Generator      # replay sampling draws
    # () int64 on the parameters' device: the steps taken, which the
    # target sync reads (made from ``step`` when not given)
    step_count: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.step_count is None:
            device = next(self.params.parameters()).device
            self.step_count = torch.full((), self.step, dtype=torch.int64,
                                         device=device)


def make_optimizer(optim: OptimConfig, module: R2D2Network
                   ) -> torch.optim.Optimizer:
    """Adam; on CUDA with ``capturable=True``, which keeps its step count
    on the device so the update captures into a CUDA graph (its bias
    correction is then computed there, in f32)."""
    cuda = next(module.parameters()).is_cuda
    return torch.optim.Adam(module.parameters(), lr=optim.lr,
                            betas=(0.9, 0.999), eps=optim.adam_eps,
                            capturable=cuda)


def create_train_state(net: NetworkApply, optim: OptimConfig, seed: int,
                       use_double: bool) -> TrainState:
    params = net.init(seed)
    if use_double:
        target = net.build()
        target.load_state_dict(params.state_dict())
        target.requires_grad_(False)
    else:
        target = params
    generator = torch.Generator(device=net.device).manual_seed(seed + 1)
    return TrainState(params=params, target_params=target,
                      opt=make_optimizer(optim, params), step=0,
                      generator=generator)


def clip_by_global_norm_(grads, max_norm: float,
                         sq_norm: Optional[Callable] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place; returns the pre-clip norm.
    ``sq_norm(grads)``: the squared global norm where the gradients are
    shards of it (tensor parallelism); the sum of their squares by
    default."""
    if sq_norm is None:
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    else:
        norm = torch.sqrt(sq_norm(grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def _decode_inputs(net: NetworkApply, spec: ReplaySpec, batch: SampleBatch
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Storage -> network inputs: uint8 frame rows -> stacked obs in the
    compute dtype and the layout the network's first conv takes
    (``net.input_layout``: (B, T, H, W, K) or (B, T, H/2, W/2, 4K); the
    decode kernel on CUDA, which strips any storage pad), last-action
    indices -> one-hot, where -1 (no action) becomes a zero row as
    jax.nn.one_hot gives."""
    with scopes.scope("obs_decode"):
        stacked = stack_frames(batch.obs, spec.seq_window, spec.frame_stack,
                               out_dtype=net.compute_dtype,
                               out_height=spec.frame_height,
                               out_width=spec.frame_width,
                               space_to_depth=(net.input_layout
                                               == SPACE_TO_DEPTH))
        la = batch.last_action.long()
        one_hot = F.one_hot(la.clamp(min=0), net.action_dim).float()
        return stacked, one_hot * (la >= 0).unsqueeze(-1).float()


def make_loss_fn(net: NetworkApply, spec: ReplaySpec, optim: OptimConfig,
                 use_double: bool):
    """Returns loss(online, target, batch) -> (loss, aux). One decode feeds
    both unrolls (``dual_sequence_q`` with double DQN)."""
    check_decode_layout(optim)
    check_kernel_setting(optim.pallas_obs_decode, net.device,
                         "optim.pallas_obs_decode")
    # refuses a value the JAX package refuses; "on" and "off" run the same
    # unrolls here (models/network.py dual_sequence_q)
    resolve_fused_double_unroll(optim.fused_double_unroll, net.device)

    def loss_fn(online: R2D2Network, target: R2D2Network,
                batch: SampleBatch):
        with scopes.scope("loss"):
            return _loss(online, target, batch)

    def _loss(online: R2D2Network, target: R2D2Network, batch: SampleBatch):
        stacked, last_action = _decode_inputs(net, spec, batch)
        if use_double:
            q_online, q_target_all = dual_sequence_q(
                net, online, target, stacked, last_action, batch.hidden,
                batch.hidden)
        else:
            q_online, _ = online(stacked, last_action, batch.hidden,
                                 net.input_layout)
        tpos = target_q_positions(batch.burn_in_steps, batch.learning_steps,
                                  batch.forward_steps, spec.learning,
                                  spec.forward)
        opos = online_q_positions(batch.burn_in_steps, spec.learning)
        mask = learning_step_mask(batch.learning_steps, spec.learning)
        num_actions = q_online.shape[-1]

        def at(q, pos):                                   # (B,T,A) -> (B,L,A)
            return torch.gather(q, 1, pos[:, :, None].expand(-1, -1,
                                                             num_actions))

        with torch.no_grad():
            q_online_tn = at(q_online.detach(), tpos)
            if use_double:
                a_star = q_online_tn.argmax(dim=-1, keepdim=True)
                q_next = torch.gather(at(q_target_all, tpos), 2,
                                      a_star)[:, :, 0]
            else:
                q_next = q_online_tn.amax(dim=-1)
            target_v = value_rescale(
                batch.reward + batch.gamma * inverse_value_rescale(
                    q_next, optim.value_rescale_eps),
                optim.value_rescale_eps)

        q_chosen = torch.gather(at(q_online, opos), 2,
                                batch.action.long()[:, :, None])[:, :, 0]
        td = (target_v - q_chosen) * mask
        num_valid = mask.sum().clamp(min=1.0)
        loss = 0.5 * torch.sum(batch.is_weights[:, None] * td ** 2) / num_valid
        abs_td = td.detach().abs()
        aux = {
            "priorities": mixed_td_errors_masked(abs_td, mask,
                                                 optim.priority_eta),
            "mean_abs_td": abs_td.sum() / num_valid,
            "mean_q": (q_chosen.detach() * mask).sum() / num_valid,
            # the learning steps the means divide by (unclamped): the
            # weight of this batch in a mean over several
            "valid_steps": mask.sum().detach(),
            # the per-element views the learning diagnostics' histograms
            # read (nothing is computed for them)
            "abs_td": abs_td,
            "mask": mask,
            "q_chosen": q_chosen.detach(),
        }
        return loss, aux

    return loss_fn


def _is_interval(interval: Optional[int], new_step: int) -> bool:
    return bool(interval) and new_step % interval == 0


def diag_intervals(diag, rdiag) -> Optional[Tuple[Optional[int],
                                                  Optional[int]]]:
    """(dQ interval, tree snapshot interval) of a step's diagnostics, None
    without either."""
    if diag is None and rdiag is None:
        return None
    return (diag.interval if diag is not None else None,
            rdiag.interval if rdiag is not None else None)


def step_flags(intervals, new_step: int) -> Tuple[bool, bool]:
    """A step's (dq_on, rd_on) from ``diag_intervals``."""
    if intervals is None:
        return False, False
    return (_is_interval(intervals[0], new_step),
            _is_interval(intervals[1], new_step))


def _make_train_body(net: NetworkApply, spec: ReplaySpec, optim: OptimConfig,
                     use_double: bool, reduce: Optional[Callable] = None,
                     sq_norm: Optional[Callable] = None, diag=None,
                     rdiag=None, diag_reduce: bool = False,
                     diag_gather: Optional[Callable] = None,
                     group_sq: Optional[Callable] = None):
    """``train(train_state, batch, rs=None, dq_on=False, rd_on=False) ->
    metrics``: one step's device work on a sampled batch, all of it in
    place (loss, clip + Adam, the step counter and the hard target sync);
    ``metrics["priorities"]`` holds the batch's (B,) new priorities. The
    host mirror ``step`` is the caller's to advance. ``reduce(grads,
    loss, mean_abs_td, mean_q, valid_steps) -> (loss, mean_abs_td,
    mean_q)``, between the backward and the clip: the data-parallel mean
    over ranks (parallel/sharded.py ``GradMean``, or ``BatchMean`` for
    one batch split over the ranks; under tensor parallelism
    ``TPGradients`` around it), in place on the gradients; None on a
    single device. ``sq_norm``: ``clip_by_global_norm_``'s
    (parallel/tensor_parallel.py ``TPGradients.sq_norm``).

    ``diag``: the learning diagnostics (telemetry/learning.py), of the
    batch, of the gradients after ``reduce`` and before the clip, and on
    ``dq_on`` steps the target distance and, given the replay ``rs``, dQ,
    all before the update. How they meet the ranks: ``diag_reduce`` (the
    dp step) reduces the batch's values in ``reduce``'s all-reduce
    (``reduce(..., diag=values)`` returns them reduced, the per-sequence
    vectors left out); ``diag_gather(aux, batch) -> (aux, batch)`` (the
    external steps over dp rows) gives the whole batch's per-sequence
    values first; otherwise they are this rank's. ``group_sq``: the
    group norms' squares (telemetry/learning.py ``GroupSqNorms``; tensor
    parallelism's). ``rdiag``: the lane counts of the batch (the external
    step's half of the replay diagnostics)."""
    from r2d2_tpu_torch.telemetry.learning import (batch_diagnostics,
                                                   grad_diagnostics)
    from r2d2_tpu_torch.telemetry.replaydiag import lane_counts
    loss_fn = make_loss_fn(net, spec, optim, use_double)
    interval = optim.target_net_update_interval
    frozen: List[torch.Tensor] = []      # the initial params (no double)

    def reference(ts: TrainState) -> List[torch.Tensor]:
        """The target the distance is taken to: without double DQN the
        initial parameters, the JAX package's frozen target."""
        if ts.target_params is not ts.params:
            return list(ts.target_params.parameters())
        if not frozen:
            frozen.extend(p.detach().clone() for p in ts.params.parameters())
        return frozen

    def train(ts: TrainState, batch: SampleBatch,
              rs: Optional[ReplayState] = None, dq_on: bool = False,
              rd_on: bool = False) -> Dict[str, torch.Tensor]:
        loss, aux = loss_fn(ts.params, ts.target_params, batch)
        ts.opt.zero_grad(set_to_none=False)
        loss.backward()
        grads = [p.grad for p in ts.params.parameters()]
        loss = loss.detach()
        with_ld = diag is not None and batch.weight_version is not None
        lanes = (rdiag is not None and batch.lane is not None
                 and rdiag.lanes > 0)
        ld: Dict[str, torch.Tensor] = {}
        view_aux, view = aux, batch
        if diag_gather is not None and (with_ld or lanes):
            view_aux, view = diag_gather(aux, batch)
        if with_ld:
            ld = batch_diagnostics(
                net, spec, diag, dq_on, ts.params,
                list(ts.params.parameters()), reference(ts), view,
                view_aux, replay_state=rs, raw_arrays=not diag_reduce,
                sq_norms=group_sq)
        if reduce is not None:
            if with_ld and diag_reduce:
                loss, aux["mean_abs_td"], aux["mean_q"], ld = reduce(
                    grads, loss, aux["mean_abs_td"], aux["mean_q"],
                    aux["valid_steps"], diag=ld)
            else:
                loss, aux["mean_abs_td"], aux["mean_q"] = reduce(
                    grads, loss, aux["mean_abs_td"], aux["mean_q"],
                    aux["valid_steps"])
        if with_ld:
            ld.update(grad_diagnostics(ts.params, grads, group_sq))
        with scopes.scope("optimizer"):
            grad_norm = clip_by_global_norm_(grads, optim.grad_norm, sq_norm)
        if with_ld:
            ld["ld/grad_norm"] = grad_norm
            ld["ld/nonfinite"] = torch.logical_not(
                torch.isfinite(loss) & torch.isfinite(grad_norm)).to(
                    torch.int32)
        with scopes.scope("optimizer"):
            ts.opt.step()
            # hard target sync on the 1-based step counter, on the device
            ts.step_count += 1
            if use_double:
                sync = ts.step_count % interval == 0
                with torch.no_grad():
                    for t, p in zip(ts.target_params.parameters(),
                                    ts.params.parameters()):
                        torch.where(sync, p, t, out=t)
        metrics = {"loss": loss, "mean_abs_td": aux["mean_abs_td"],
                   "mean_q": aux["mean_q"], "grad_norm": grad_norm,
                   "priorities": aux["priorities"]}
        metrics.update(ld)
        if lanes:
            metrics["rd/lane_counts"] = lane_counts(view.lane, rdiag.lanes)
        return metrics

    return train


def _make_step_body(net: NetworkApply, spec: ReplaySpec, optim: OptimConfig,
                    use_double: bool, reduce: Optional[Callable] = None,
                    sq_norm: Optional[Callable] = None, diag=None,
                    rdiag=None, diag_reduce: bool = False,
                    group_sq: Optional[Callable] = None,
                    rd_reduce: Optional[Callable] = None):
    """``body(train_state, replay_state, uniform, dq_on=False,
    rd_on=False) -> metrics``: sample, train, and write the priorities
    back, right after
    the sample they belong to. ``uniform``: the (B,) sampling jitter, or
    None to draw it from the train state's generator. ``reduce``,
    ``sq_norm``, ``diag``, ``diag_reduce``, ``group_sq``:
    ``_make_train_body``'s. ``rdiag``: the replay diagnostics
    (telemetry/replaydiag.py ``fused_replay_diag``, the tree snapshot on
    ``rd_on`` steps) after the write-back; ``rd_reduce(rd) -> rd``: their
    meeting over the dp ranks (``shard_replay_diag``), on every step."""
    from r2d2_tpu_torch.telemetry.replaydiag import fused_replay_diag
    train = _make_train_body(net, spec, optim, use_double, reduce, sq_norm,
                             diag=diag, diag_reduce=diag_reduce,
                             group_sq=group_sq)

    def body(ts: TrainState, rs: ReplayState,
             uniform: Optional[torch.Tensor], dq_on: bool = False,
             rd_on: bool = False) -> Dict[str, torch.Tensor]:
        with scopes.scope("replay_sample"):
            batch = replay_sample(spec, rs, generator=ts.generator,
                                  uniform=uniform)
        metrics = train(ts, batch, rs, dq_on)
        tree_update(spec.tree_layers, rs.tree, spec.prio_exponent,
                    metrics.pop("priorities"), batch.idxes)
        if rdiag is not None:
            rd = fused_replay_diag(spec, rdiag, rd_on, rs, batch)
            metrics.update(rd if rd_reduce is None else rd_reduce(rd))
        return metrics

    return body


def make_learner_step(net: NetworkApply, spec: ReplaySpec,
                      optim: OptimConfig, use_double: bool, diag=None,
                      rdiag=None):
    """Build ``step(train_state, replay_state, uniform=None) ->
    (train_state, replay_state, metrics)``. Both states update in place;
    metrics stay device tensors (no host sync). ``uniform`` injects the
    sampling jitter (tests); otherwise it is drawn from the train state's
    generator. ``diag``, ``rdiag``: the learning and replay diagnostics
    (the module docstring)."""
    body = _make_step_body(net, spec, optim, use_double, diag=diag,
                           rdiag=rdiag)
    intervals = diag_intervals(diag, rdiag)

    def step(ts: TrainState, rs: ReplayState,
             uniform: Optional[torch.Tensor] = None):
        metrics = body(ts, rs, uniform, *step_flags(intervals, ts.step + 1))
        ts.step += 1
        return ts, rs, metrics

    return step


def make_external_batch_step(net: NetworkApply, spec: ReplaySpec,
                             optim: OptimConfig, use_double: bool,
                             reduce: Optional[Callable] = None,
                             graphed: Optional[bool] = None,
                             sq_norm: Optional[Callable] = None, diag=None,
                             rdiag=None,
                             diag_gather: Optional[Callable] = None,
                             group_sq: Optional[Callable] = None):
    """The step of host-placement replay (``replay.placement="host"``): the
    batch is sampled on the host (``replay/host_replay.py``) and copied to
    the device by the caller. ``step(train_state, batch) -> (train_state,
    metrics)``; ``metrics["priorities"]`` (B,) goes back to the host tree
    with the sample's host indices, after the step. The batch is not
    consumed.

    On the CPU the step runs eagerly. On CUDA it is one CUDA graph of one
    step over a static batch (``GraphedSteps`` with a batch input): each
    call copies the given device batch into the static one on the current
    stream, which must be able to read it, and replays the graph; the
    first call runs eagerly as the capture's warm-up and counts as a step,
    the second captures. ``reduce``, ``sq_norm``: ``_make_train_body``'s
    (the sharded and the tensor-parallel external steps, parallel/);
    ``graphed``: False runs it eagerly on CUDA too (a collective a graph
    cannot capture), None = on CUDA. ``diag``: the learning diagnostics
    of a batch that carries its weight-version stamps; dQ is NaN here
    (the stored rows are in host memory), the target distance is taken on
    interval steps. ``rdiag``: the batch's lane counts; the tree's health
    and the evictions come from the host replay at the flush.
    ``diag_gather``, ``group_sq``: ``_make_train_body``'s."""
    train = _make_train_body(net, spec, optim, use_double, reduce, sq_norm,
                             diag=diag, rdiag=rdiag, diag_gather=diag_gather,
                             group_sq=group_sq)
    intervals = diag_intervals(diag, None)
    if graphed is None:
        graphed = net.device.type == "cuda"
    if graphed:
        return GraphedSteps(train, 1, spec.batch_size, batch_input=True,
                            intervals=intervals)

    def step(ts: TrainState, batch: SampleBatch):
        metrics = train(ts, batch, None, *step_flags(intervals, ts.step + 1))
        ts.step += 1
        return ts, metrics

    return step


def make_multi_learner_step(net: NetworkApply, spec: ReplaySpec,
                            optim: OptimConfig, use_double: bool,
                            steps_per_dispatch: int, diag=None, rdiag=None):
    """K = ``steps_per_dispatch`` learner steps per dispatch:
    ``multi(train_state, replay_state, uniform=None) -> (train_state,
    replay_state, metrics)`` with every metric stacked to (K,) and
    ``uniform`` the (K, B) jitter. The semantics are those of K calls of
    the single step: the same jitter chain (step k's draws are the k-th
    draw of B from the generator) and the same target-sync schedule,
    carried by the step counter; the diagnostics' values stack to (K,
    ...), with NaN dQ on the steps that are not interval steps.

    On the CPU it runs K eager steps. On CUDA it is one CUDA graph of K
    steps (``GraphedSteps``): the first dispatch runs its K steps eagerly
    (the warm-up; they are real steps), the second captures the graph and
    replays it, every later one replays it (with ``diag``, the graph of
    its pattern of interval steps)."""
    if steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1; got "
                         f"{steps_per_dispatch}")
    body = _make_step_body(net, spec, optim, use_double, diag=diag,
                           rdiag=rdiag)
    intervals = diag_intervals(diag, rdiag)
    if net.device.type == "cuda":
        return GraphedSteps(body, steps_per_dispatch, spec.batch_size,
                            intervals=intervals)
    return eager_steps(body, steps_per_dispatch, intervals)


def make_dispatch_step(net: NetworkApply, spec: ReplaySpec,
                       optim: OptimConfig, use_double: bool,
                       steps_per_dispatch: int, diag=None, rdiag=None):
    """The learner's dispatch on a device replay, for every device and K:
    ``make_multi_learner_step`` (one CUDA graph of K steps on the card, K
    eager steps on the CPU). At K = 1 it keeps the single step's contract
    (``make_learner_step``'s: (B,) jitter in, unstacked metrics out) and
    holds the K = 1 dispatch as ``multi``; at K > 1 it is that dispatch."""
    multi = make_multi_learner_step(net, spec, optim, use_double,
                                    steps_per_dispatch, diag=diag,
                                    rdiag=rdiag)
    if steps_per_dispatch > 1:
        return multi

    def step(ts: TrainState, rs: ReplayState,
             uniform: Optional[torch.Tensor] = None):
        ts, rs, metrics = multi(ts, rs,
                                None if uniform is None else uniform[None])
        return ts, rs, {name: t[0] for name, t in metrics.items()}

    step.multi = multi
    return step


def eager_steps(body: Callable, steps: int, intervals=None):
    """``multi(train_state, replay_state, uniform=None)``: ``steps`` eager
    calls of a step body, the metrics stacked to (K,). ``intervals``: the
    diagnostics' (``diag_intervals``; each step is told its flags)."""

    def multi(ts: TrainState, rs: ReplayState,
              uniform: Optional[torch.Tensor] = None):
        per_step = []
        for k in range(steps):
            per_step.append(body(ts, rs, None if uniform is None
                                 else uniform[k],
                                 *step_flags(intervals, ts.step + 1)))
            ts.step += 1
        return ts, rs, {name: torch.stack([m[name] for m in per_step])
                        for name in per_step[0]}

    return multi


def _state_tensors(ts: TrainState, rs: Optional[ReplayState]
                   ) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of the two states that a step reads or writes."""
    out = [("step_count", ts.step_count)]
    for prefix, module in (("params", ts.params),
                           ("target_params", ts.target_params)):
        for name, p in module.named_parameters():
            out.append((f"{prefix}.{name}", p))
            if p.grad is not None:
                out.append((f"{prefix}.{name}.grad", p.grad))
    for i, state in enumerate(ts.opt.state.values()):
        for key, value in state.items():
            if torch.is_tensor(value):
                out.append((f"opt.state[{i}].{key}", value))
    for name, value in (vars(rs).items() if rs is not None else ()):
        if torch.is_tensor(value):
            out.append((f"replay.{name}", value))
    return out


class GraphedSteps:
    """K learner steps as one CUDA graph, the counterpart of the JAX
    package's ``lax.scan`` of the step in one dispatch; with
    ``batch_input``, the external-batch step (K = 1) as one CUDA graph
    over a static batch, the counterpart of its single jitted program.

    * Dispatch 1 runs the K steps eagerly on a side stream: torch's
      warm-up before a capture, counted as real steps (no extra step is
      taken). Dispatch 2 captures the K steps into one graph and replays
      it; every later dispatch replays it.
    * With the diagnostics' ``intervals`` (``diag_intervals``), the K
      steps of a dispatch are told which of them are interval steps of
      either pillar (from the host's step count, ``flags``), and a graph
      is captured for each pattern at its first dispatch (``variants``),
      all in one memory pool: the JAX step's ``lax.cond``, without a
      branch in a graph. A run meets every pattern within one period of
      the intervals (their least common multiple with K: 200 steps at the
      defaults). Without them there is one graph, as before.
    * The inputs go into static buffers before each replay, on the current
      stream. Over the replay: the (K, B) jitter, step k's draws from the
      train state's generator, one per step as the single step draws them,
      or the injected ``uniform``; the graph holds no RNG state. With a
      batch input: the given device batch, field by field.
    * A replay reads and writes the tensors the captures saw, at their
      addresses: those of the states and the static inputs are recorded
      at the first capture, and a replay or a later capture raises if one
      of them has moved.
    * The kernel wrappers count launches when they are called, which a
      replay does not do: the counts of the capture are taken back and
      added once per replay.
    * A capture or launch that fails raises; nothing falls back to eager.
    """

    def __init__(self, body: Callable, steps: int, batch_size: int,
                 batch_input: bool = False, intervals=None):
        if batch_input and steps != 1:
            raise ValueError("a batch input feeds one step a dispatch")
        self.body = body
        self.steps = steps
        self.batch_size = batch_size
        self.batch_input = batch_input
        self.intervals = intervals
        self.dispatches = 0
        # per pattern of interval steps: (graph, static outputs, launches
        # a replay); the newest replayed one's in graph, out, launches
        self.variants: Dict[Tuple[bool, ...], tuple] = {}
        self.pool = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.uniform: Optional[torch.Tensor] = None    # (K, B) static
        self.batch: Optional[SampleBatch] = None       # static batch input
        self.out: Optional[Dict[str, torch.Tensor]] = None   # (K, ...) static
        self.addresses: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}              # per replay
        # what the allocator's reserve grew by across the captures (the
        # graphs' memory, as the resources block attributes it)
        self.pool_bytes = 0

    def flags(self, step: int) -> Tuple[Tuple[bool, bool], ...]:
        """(dq_on, rd_on) of each of the K steps from host step
        ``step``."""
        return tuple(step_flags(self.intervals, step + k + 1)
                     for k in range(self.steps))

    def _run(self, ts: TrainState, rs: Optional[ReplayState],
             flags) -> Dict[str, torch.Tensor]:
        if self.batch_input:
            per_step = [self.body(ts, self.batch, None, *flags[0])]
        else:
            per_step = [self.body(ts, rs, self.uniform[k], *flags[k])
                        for k in range(self.steps)]
        return {name: torch.stack([m[name] for m in per_step])
                for name in per_step[0]}

    def _fill_uniform(self, ts: TrainState, device: torch.device,
                      uniform: Optional[torch.Tensor]) -> None:
        if self.uniform is None:
            self.uniform = torch.empty((self.steps, self.batch_size),
                                       dtype=torch.float32, device=device)
        if uniform is not None:
            if tuple(uniform.shape) != tuple(self.uniform.shape):
                raise ValueError(f"uniform must be {tuple(self.uniform.shape)}"
                                 f"; got {tuple(uniform.shape)}")
            self.uniform.copy_(uniform)
            return
        for row in self.uniform:
            row.uniform_(generator=ts.generator)

    def _fill_batch(self, batch: SampleBatch) -> None:
        if self.batch is None:
            self.batch = dataclasses.replace(batch, **{
                name: torch.empty_like(t)
                for name, t in batch_fields(batch).items()})
        static = batch_fields(self.batch)
        given = batch_fields(batch)
        if static.keys() != given.keys() or any(
                (t.shape, t.dtype, t.device)
                != (static[n].shape, static[n].dtype, static[n].device)
                for n, t in given.items()):
            raise ValueError("the batch differs in fields, shapes, types or "
                             "device from the one the step was built on")
        for name, t in given.items():
            static[name].copy_(t)

    def _inputs(self) -> List[Tuple[str, torch.Tensor]]:
        """The static inputs, once the first call has made them."""
        if self.batch_input:
            return ([] if self.batch is None else
                    [(f"batch.{n}", t)
                     for n, t in batch_fields(self.batch).items()])
        return [] if self.uniform is None else [("uniform", self.uniform)]

    def _check_addresses(self, ts: TrainState,
                         rs: Optional[ReplayState]) -> None:
        now = {name: t.data_ptr()
               for name, t in _state_tensors(ts, rs) + self._inputs()}
        moved = sorted(name for name in now.keys() | self.addresses.keys()
                       if now.get(name) != self.addresses.get(name))
        if moved:
            raise RuntimeError(
                "the CUDA graph of the learner steps reads tensors that have "
                f"moved since it was captured: {moved[:8]}")

    def __call__(self, ts: TrainState, rs_or_batch,
                 uniform: Optional[torch.Tensor] = None):
        """``(ts, rs, uniform=None) -> (ts, rs, metrics)`` with (K,)
        metrics; with a batch input ``(ts, batch) -> (ts, metrics)``, the
        metrics of the one step."""
        device = ts.step_count.device
        if self.batch_input:
            rs = None
            self._fill_batch(rs_or_batch)
        else:
            rs = rs_or_batch
            self._fill_uniform(ts, device, uniform)
        flags = self.flags(ts.step)
        current = torch.cuda.current_stream(device)
        if self.dispatches == 0:
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = self._run(ts, rs, flags)
            current.wait_stream(side)
            for t in out.values():
                t.record_stream(current)
        else:
            if self.variants:
                self._check_addresses(ts, rs)
            if flags not in self.variants:
                self._capture(ts, rs, flags)
            self.graph, self.out, self.launches = self.variants[flags]
            self.graph.replay()
            add_launch_counts(self.launches)
            out = self.out
        self.dispatches += 1
        ts.step += self.steps
        if self.batch_input:
            return ts, {name: t[0].clone() for name, t in out.items()}
        return ts, rs, {name: t.clone() for name, t in out.items()}

    def _event_name(self, flags) -> str:
        """The capture's name for the compile telemetry: one name a
        pattern of interval steps."""
        pattern = "".join(f"{int(dq)}{int(rd)}" for dq, rd in flags)
        kind = "batch_step" if self.batch_input else "learner_step"
        return f"{kind}/K{self.steps}/{pattern}"

    def _signature(self, ts: TrainState, rs: Optional[ReplayState]) -> str:
        """The shapes a capture is made at."""
        shapes = [(n, tuple(t.shape)) for n, t in self._inputs()]
        if rs is not None:
            shapes.append(("obs", tuple(rs.obs.shape)))
        return repr(shapes)

    def _capture(self, ts: TrainState, rs: Optional[ReplayState],
                 flags) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.intervals is not None and self.pool is None:
            # the variants share one pool: they replay one at a time on
            # one stream, and each one's static outputs stay referenced
            self.pool = torch.cuda.graph_pool_handle()
        # thread-local: other threads (the host placement's prefetch and
        # write-back, the policy server) may allocate, copy, synchronize
        # and launch on their own streams while this thread captures; the
        # capture counts only the launches on its own stream
        stream = torch.cuda.Stream()
        reserved = torch.cuda.memory_reserved()
        with compile_event(self._event_name(flags), self._signature(ts, rs)), \
                gc_paused(), captured_launches(stream) as counted, \
                torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                 capture_error_mode="thread_local"):
            out = self._run(ts, rs, flags)
        self.pool_bytes += max(torch.cuda.memory_reserved() - reserved, 0)
        launches = {name: counted.get(name, 0) for name in launch_counts()}
        add_launch_counts({name: -n for name, n in launches.items()})
        self.variants[flags] = (graph, out, launches)
        if not self.addresses:
            self.addresses = {name: t.data_ptr()
                              for name, t in _state_tensors(ts, rs)
                              + self._inputs()}
        else:
            self._check_addresses(ts, rs)
