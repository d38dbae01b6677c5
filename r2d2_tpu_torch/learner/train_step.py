"""The R2D2 learner step: sample -> decode -> unroll -> loss -> clip + Adam ->
priority write-back -> hard target sync, the counterpart of the JAX
package's fused ``make_learner_step``, and ``make_multi_learner_step``, K
steps per dispatch (the JAX package's ``lax.scan`` of the step).

The JAX step is one XLA program over donated buffers; here the same steps
run on one CUDA stream and update the replay tree, the parameters and the
optimizer state in place. Sampling and its write-back stay atomic with
respect to ingestion because nothing else writes the replay between them.
The step makes no host sync and reads no host value that changes from step
to step (the target sync rides a step counter on the device, Adam keeps
its step count there), so K of them capture into one CUDA graph.

Optimizer: ``optax.chain(clip_by_global_norm(max), adam(lr, eps))``.
optax clips as ``g / norm * max`` whenever ``norm >= max`` (``clip_grad_norm_``
divides by ``norm + 1e-6`` instead, so it is not used). optax's Adam adds
eps outside the square root, which is what ``torch.optim.Adam`` does.
"""

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
                                              launch_counts)
from r2d2_tpu_torch.ops.priority import mixed_td_errors_masked
from r2d2_tpu_torch.ops.replay_kernels import stack_frames
from r2d2_tpu_torch.ops.sum_tree import tree_update
from r2d2_tpu_torch.ops.value import inverse_value_rescale, value_rescale
from r2d2_tpu_torch.replay.device_replay import replay_sample
from r2d2_tpu_torch.replay.structs import ReplaySpec, ReplayState, SampleBatch


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


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place; returns the pre-clip norm."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
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
    stacked = stack_frames(batch.obs, spec.seq_window, spec.frame_stack,
                           out_dtype=net.compute_dtype,
                           out_height=spec.frame_height,
                           out_width=spec.frame_width,
                           space_to_depth=net.input_layout == SPACE_TO_DEPTH)
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
        }
        return loss, aux

    return loss_fn


def _make_step_body(net: NetworkApply, spec: ReplaySpec, optim: OptimConfig,
                    use_double: bool):
    """``body(train_state, replay_state, uniform) -> metrics``: one step's
    device work, all of it in place; the host mirror ``step`` is the
    caller's to advance. ``uniform``: the (B,) sampling jitter, or None to
    draw it from the train state's generator."""
    loss_fn = make_loss_fn(net, spec, optim, use_double)
    interval = optim.target_net_update_interval

    def body(ts: TrainState, rs: ReplayState,
             uniform: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = replay_sample(spec, rs, generator=ts.generator,
                              uniform=uniform)
        loss, aux = loss_fn(ts.params, ts.target_params, batch)
        ts.opt.zero_grad(set_to_none=False)
        loss.backward()
        grads = [p.grad for p in ts.params.parameters()]
        grad_norm = clip_by_global_norm_(grads, optim.grad_norm)
        ts.opt.step()

        # priority write-back, right after the sample it belongs to
        tree_update(spec.tree_layers, rs.tree, spec.prio_exponent,
                    aux["priorities"], batch.idxes)

        # hard target sync on the 1-based step counter, on the device
        ts.step_count += 1
        if use_double:
            sync = ts.step_count % interval == 0
            with torch.no_grad():
                for t, p in zip(ts.target_params.parameters(),
                                ts.params.parameters()):
                    torch.where(sync, p, t, out=t)
        return {"loss": loss.detach(), "mean_abs_td": aux["mean_abs_td"],
                "mean_q": aux["mean_q"], "grad_norm": grad_norm}

    return body


def make_learner_step(net: NetworkApply, spec: ReplaySpec,
                      optim: OptimConfig, use_double: bool):
    """Build ``step(train_state, replay_state, uniform=None) ->
    (train_state, replay_state, metrics)``. Both states update in place;
    metrics stay device tensors (no host sync). ``uniform`` injects the
    sampling jitter (tests); otherwise it is drawn from the train state's
    generator."""
    body = _make_step_body(net, spec, optim, use_double)

    def step(ts: TrainState, rs: ReplayState,
             uniform: Optional[torch.Tensor] = None):
        metrics = body(ts, rs, uniform)
        ts.step += 1
        return ts, rs, metrics

    return step


def make_multi_learner_step(net: NetworkApply, spec: ReplaySpec,
                            optim: OptimConfig, use_double: bool,
                            steps_per_dispatch: int):
    """K = ``steps_per_dispatch`` learner steps per dispatch:
    ``multi(train_state, replay_state, uniform=None) -> (train_state,
    replay_state, metrics)`` with every metric stacked to (K,) and
    ``uniform`` the (K, B) jitter. The semantics are those of K calls of
    the single step: the same jitter chain (step k's draws are the k-th
    draw of B from the generator) and the same target-sync schedule,
    carried by the step counter.

    On the CPU it runs K eager steps. On CUDA it is one CUDA graph of K
    steps (``GraphedSteps``): the first dispatch runs its K steps eagerly
    (the warm-up; they are real steps), the second captures the graph and
    replays it, every later one replays it."""
    if steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1; got "
                         f"{steps_per_dispatch}")
    body = _make_step_body(net, spec, optim, use_double)
    if net.device.type == "cuda":
        return GraphedSteps(body, steps_per_dispatch, spec.batch_size)

    def multi(ts: TrainState, rs: ReplayState,
              uniform: Optional[torch.Tensor] = None):
        per_step = []
        for k in range(steps_per_dispatch):
            per_step.append(body(ts, rs, None if uniform is None
                                 else uniform[k]))
            ts.step += 1
        return ts, rs, {name: torch.stack([m[name] for m in per_step])
                        for name in METRICS}

    return multi


def _state_tensors(ts: TrainState, rs: ReplayState
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
    for name, value in vars(rs).items():
        if torch.is_tensor(value):
            out.append((f"replay.{name}", value))
    return out


class GraphedSteps:
    """K learner steps as one CUDA graph, the counterpart of the JAX
    package's ``lax.scan`` of the step in one dispatch.

    * Dispatch 1 runs the K steps eagerly on a side stream: torch's
      warm-up before a capture, counted as real steps (no extra step is
      taken). Dispatch 2 captures the K steps into one graph and replays
      it; every later dispatch replays it.
    * The jitter goes into a static (K, B) buffer before each replay:
      step k's draws from the train state's generator, one per step as
      the single step draws them, or the injected ``uniform``. The graph
      holds no RNG state.
    * A replay reads and writes the tensors the capture saw, at their
      addresses: those of both states are recorded at capture, and a
      replay raises if one of them has moved.
    * The kernel wrappers count launches when they are called, which a
      replay does not do: the counts of the capture are taken back and
      added once per replay.
    * A capture or launch that fails raises; nothing falls back to eager.
    """

    def __init__(self, body: Callable, steps: int, batch_size: int):
        self.body = body
        self.steps = steps
        self.batch_size = batch_size
        self.dispatches = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.uniform: Optional[torch.Tensor] = None    # (K, B) static
        self.out: Optional[torch.Tensor] = None        # (metrics, K) static
        self.addresses: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}              # per replay

    def _run(self, ts: TrainState, rs: ReplayState) -> torch.Tensor:
        per_step = [self.body(ts, rs, self.uniform[k])
                    for k in range(self.steps)]
        return torch.stack([torch.stack([m[name] for m in per_step])
                            for name in METRICS])

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

    def _check_addresses(self, ts: TrainState, rs: ReplayState) -> None:
        now = {name: t.data_ptr() for name, t in _state_tensors(ts, rs)}
        moved = sorted(name for name in now.keys() | self.addresses.keys()
                       if now.get(name) != self.addresses.get(name))
        if moved:
            raise RuntimeError(
                "the CUDA graph of the learner steps reads tensors that have "
                f"moved since it was captured: {moved[:8]}")

    def __call__(self, ts: TrainState, rs: ReplayState,
                 uniform: Optional[torch.Tensor] = None):
        device = ts.step_count.device
        self._fill_uniform(ts, device, uniform)
        current = torch.cuda.current_stream(device)
        if self.dispatches == 0:
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = self._run(ts, rs)
            current.wait_stream(side)
            out.record_stream(current)
        else:
            if self.graph is None:
                self._capture(ts, rs)
            else:
                self._check_addresses(ts, rs)
            self.graph.replay()
            add_launch_counts(self.launches)
            out = self.out
        self.dispatches += 1
        ts.step += self.steps
        out = out.clone()
        return ts, rs, dict(zip(METRICS, out.unbind(0)))

    def _capture(self, ts: TrainState, rs: ReplayState) -> None:
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._run(ts, rs)
        after = launch_counts()
        self.launches = {name: after[name] - before[name] for name in after}
        add_launch_counts({name: -n for name, n in self.launches.items()})
        self.graph, self.out = graph, out
        self.addresses = {name: t.data_ptr()
                          for name, t in _state_tensors(ts, rs)}
