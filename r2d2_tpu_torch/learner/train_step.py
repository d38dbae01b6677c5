"""The R2D2 learner step: sample -> decode -> unroll -> loss -> clip + Adam ->
priority write-back -> hard target sync, the counterpart of the JAX
package's fused ``make_learner_step``.

The JAX step is one XLA program over donated buffers; here the same steps
run eagerly on one CUDA stream and update the replay tree, the parameters
and the optimizer state in place. Sampling and its write-back stay atomic
with respect to ingestion because nothing else writes the replay between
them.

Optimizer: ``optax.chain(clip_by_global_norm(max), adam(lr, eps))``.
optax clips as ``g / norm * max`` whenever ``norm >= max`` (``clip_grad_norm_``
divides by ``norm + 1e-6`` instead, so it is not used). optax's Adam adds
eps outside the square root, which is what ``torch.optim.Adam`` does.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from r2d2_tpu_torch.config import (OptimConfig, check_decode_layout,
                                   check_kernel_setting)
from r2d2_tpu_torch.models.network import (SPACE_TO_DEPTH, NetworkApply,
                                           R2D2Network)
from r2d2_tpu_torch.ops.indexing import (learning_step_mask,
                                         online_q_positions,
                                         target_q_positions)
from r2d2_tpu_torch.ops.priority import mixed_td_errors_masked
from r2d2_tpu_torch.ops.replay_kernels import stack_frames
from r2d2_tpu_torch.ops.sum_tree import tree_update
from r2d2_tpu_torch.ops.value import inverse_value_rescale, value_rescale
from r2d2_tpu_torch.replay.device_replay import replay_sample
from r2d2_tpu_torch.replay.structs import ReplaySpec, ReplayState, SampleBatch


@dataclass
class TrainState:
    params: R2D2Network
    target_params: R2D2Network      # the online module itself without double DQN
    opt: torch.optim.Optimizer
    step: int
    generator: torch.Generator      # replay sampling draws


def make_optimizer(optim: OptimConfig, module: R2D2Network
                   ) -> torch.optim.Optimizer:
    return torch.optim.Adam(module.parameters(), lr=optim.lr,
                            betas=(0.9, 0.999), eps=optim.adam_eps)


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
    both unrolls."""
    check_decode_layout(optim)
    check_kernel_setting(optim.pallas_obs_decode, net.device,
                         "optim.pallas_obs_decode")

    def loss_fn(online: R2D2Network, target: R2D2Network,
                batch: SampleBatch):
        stacked, last_action = _decode_inputs(net, spec, batch)
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
                q_target_all, _ = target(stacked, last_action,
                                         batch.hidden, net.input_layout)
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


def make_learner_step(net: NetworkApply, spec: ReplaySpec,
                      optim: OptimConfig, use_double: bool):
    """Build ``step(train_state, replay_state, uniform=None) ->
    (train_state, replay_state, metrics)``. Both states update in place;
    metrics stay device tensors (no host sync). ``uniform`` injects the
    sampling jitter (tests); otherwise it is drawn from the train state's
    generator."""
    loss_fn = make_loss_fn(net, spec, optim, use_double)

    def step(ts: TrainState, rs: ReplayState,
             uniform: Optional[torch.Tensor] = None):
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

        ts.step += 1
        if use_double and ts.step % optim.target_net_update_interval == 0:
            with torch.no_grad():
                for t, p in zip(ts.target_params.parameters(),
                                ts.params.parameters()):
                    t.copy_(p)
        metrics = {"loss": loss.detach(), "mean_abs_td": aux["mean_abs_td"],
                   "mean_q": aux["mean_q"], "grad_norm": grad_norm}
        return ts, rs, metrics

    return step
