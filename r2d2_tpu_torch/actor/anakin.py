"""On-device acting: batched device envs, the policy forward and block
assembly as one acting segment on the card, the counterpart of the JAX
package's ``actor/anakin.py`` (Podracer "Anakin", arxiv 2104.06272).

The host actors pay, per env step and per lane, a Python round trip, a CPU
forward, numpy frame rolls and LocalBuffer appends. Here one acting
*segment* steps N lanes ``block_length`` times (the T=1 forward of the
learner's own network, epsilon-greedy, the env step, the frame roll),
then assembles one replay Block per lane with tensor ops, with a leading N
axis, which ``replay/device_replay.py write_rows`` ring-writes. On the
card ``ActSegment`` runs the whole of it, ring write included, as one CUDA
graph, the counterpart of JAX's one jitted ``lax.scan``; on the CPU the
same code runs eagerly. The forward reads the learner's live parameters by
reference, in the learner's compute dtype.

Semantics match the host pipeline where they can be compared (the port's
tests hold ``emit_blocks`` to JAX's and to the port's LocalBuffer):

  * timeline layout, burn-in carry across segments, stored hidden states
    at each sequence's window start, n-step returns and the gamma tail are
    the LocalBuffer's rules (actor/local_buffer.py) as gathers;
  * auto-reset follows envs/vector.py: the done step records the true
    terminal observation; the next step starts the new episode with a
    duplicated initial frame stack, zero hidden and no last action;
  * episodes end on block boundaries (Config checks ``episode_len %
    block_length == 0``), so there is one speculative reset a segment,
    selected after the last step;
  * initial priorities: a constant stamp (``actor.anakin_priority``), or
    "td": the n-step TD errors of the acting policy's own Q-values (one
    extra bootstrap forward a segment), mixed per sequence by the
    learner's eta rule, as LocalBuffer seeds them.

Random numbers are drawn per segment (``draw_segment``) from an explicit
``torch.Generator``, which the CUDA graph registers, so every replay draws
anew. A caller may inject the draws instead: the parity tests hand in the
numbers JAX's key splits give, and the comparison is exact.

Quantized acting (``network.inference_dtype`` "bf16" or "int8"): every
policy forward of the segment, the bootstrap one included, runs the
publish-time twin (an ``actor/policy.py InferenceTwin``: the dense layers
through ``int8_linear`` on the card) in place of the learner's module.
The accuracy probe (max |Q_f32 - Q_quant| and the greedy agreement over
the lanes, on the end-of-segment state before the reset) is
``quant_probe``; the graphed segment leaves that state in static tensors
and runs the probe after a replay, outside the graph, every
``telemetry.quant_probe_interval``-th segment.
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from r2d2_tpu_torch.models.network import NetworkApply, action_one_hot
from r2d2_tpu_torch.ops.launch_counts import (add_launch_counts,
                                              captured_launches,
                                              launch_counts)
from r2d2_tpu_torch.replay.device_replay import write_rows
from r2d2_tpu_torch.replay.structs import Block, ReplaySpec, ReplayState
from r2d2_tpu_torch.telemetry import scopes
from r2d2_tpu_torch.telemetry.compile import compile_event
from r2d2_tpu_torch.utils.device import gc_paused

STATS = ("episodes", "reported_episodes", "reported_return_sum",
         "env_steps")


@dataclass
class ActCarry:
    """Per-lane acting state carried across segments (leading N axis).

    ``cur_stack``/``hidden``/``last_action`` are the policy's per-step
    state; ``tail_*``/``burn0`` the LocalBuffer's burn-in carry: the last
    ``stack + burn_in`` frames, ``burn_in + 1`` actions and hidden
    snapshots of the timeline, right-aligned, with ``burn0`` (the host's
    ``curr_burn_in``) saying how much of each is live."""

    env_state: Any              # the env's state dataclass of tensors
    cur_stack: torch.Tensor     # (N, stack, H, W) uint8, oldest first
    hidden: torch.Tensor        # (N, 2, hidden) f32 packed
    last_action: torch.Tensor   # (N,) int64, -1 = none
    tail_frames: torch.Tensor   # (N, stack + B, H, W) uint8
    tail_la: torch.Tensor       # (N, B + 1) int32
    tail_hidden: torch.Tensor   # (N, B + 1, 2, hidden) f32
    burn0: torch.Tensor         # (N,) int32, live burn-in length
    ep_return: torch.Tensor     # (N,) f32, return of the episode in flight


@dataclass
class SegmentDraws:
    """The random numbers of one segment of N lanes and L steps."""

    explore: torch.Tensor           # (L, N) f32 uniforms, explore if < eps
    random_action: torch.Tensor     # (L, N) int, the exploring action
    env_step: Optional[torch.Tensor]  # (L, N, ...) the env's step draws
    env_reset: torch.Tensor         # the segment's speculative reset


def draw_segment(env, num_lanes: int, length: int, action_dim: int,
                 generator: Optional[torch.Generator]) -> SegmentDraws:
    """One segment's draws from ``generator``, on the env's device."""
    explore = torch.rand((length, num_lanes), generator=generator,
                         device=env.device)
    random_action = torch.randint(0, action_dim, (length, num_lanes),
                                  generator=generator, device=env.device)
    step = env.step_draws(length * num_lanes, generator)
    return SegmentDraws(
        explore, random_action,
        None if step is None else step.reshape(length, num_lanes,
                                               *step.shape[1:]),
        env.reset_draws(num_lanes, generator))


def _where(cond: torch.Tensor, a, b):
    """torch.where over tensors or state dataclasses, ``cond`` (N,)
    broadcast over each field's trailing dims."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _where(cond, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


def assign_(dst, src) -> None:
    """Copy ``src`` into ``dst`` field by field, in place (tensors or
    dataclasses of them): the static carry of a CUDA graph."""
    if dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            assign_(getattr(dst, f.name), getattr(src, f.name))
    else:
        dst.copy_(src)


def init_act_carry(env, spec: ReplaySpec, num_lanes: int, *,
                   generator: Optional[torch.Generator] = None,
                   reset_draws: Optional[torch.Tensor] = None) -> ActCarry:
    """Fresh episodes in every lane: the initial frame duplicated over the
    stack (the host policy's observe_reset), zero hidden, no last action,
    no burn-in: the LocalBuffer.reset state, batched. ``reset_draws``
    (injected) or drawn from ``generator``."""
    if reset_draws is None:
        reset_draws = env.reset_draws(num_lanes, generator)
    env_state, obs = env.reset(reset_draws)
    n, b, stack = num_lanes, spec.burn_in, spec.frame_stack
    device = obs.device
    cur_stack = obs[:, None].repeat(1, stack, 1, 1)
    tail_frames = torch.zeros((n, stack + b, spec.frame_height,
                               spec.frame_width), dtype=torch.uint8,
                              device=device)
    tail_frames[:, b:] = cur_stack
    return ActCarry(
        env_state=env_state,
        cur_stack=cur_stack,
        hidden=torch.zeros((n, 2, spec.hidden_dim), device=device),
        last_action=torch.full((n,), -1, dtype=torch.int64, device=device),
        tail_frames=tail_frames,
        tail_la=torch.full((n, b + 1), -1, dtype=torch.int32, device=device),
        tail_hidden=torch.zeros((n, b + 1, 2, spec.hidden_dim),
                                device=device),
        burn0=torch.zeros((n,), dtype=torch.int32, device=device),
        ep_return=torch.zeros((n,), device=device),
    )


def _take_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather along the time axis: buf (N, T, ...), idx (N, R)."""
    lanes = torch.arange(buf.shape[0], device=buf.device)[:, None]
    return buf[lanes, idx]


def _f32(x: float) -> float:
    """``x`` rounded to f32, as the JAX package's np.float32 constants."""
    return float(np.float32(x))


def emit_blocks(spec: ReplaySpec, gamma: float, priority,
                tail_frames, tail_la, tail_hidden, burn0, obs, actions,
                rewards, hiddens, terminal, final_return, report_mask,
                reset_obs, weight_version, *, q_seg=None, q_boot=None,
                priority_eta: float = 0.9, lanes=None
                ) -> Tuple[Block, tuple]:
    """LocalBuffer.finish as tensor ops over one segment, the JAX
    package's ``emit_blocks``.

    Inputs are lane-major: ``obs``/``actions``/``rewards``/``hiddens`` are
    (N, L, ...) per-step records (obs = the true next observation, the
    terminal frame included; hiddens = the packed state after each step),
    ``tail_*``/``burn0`` the previous segment's burn-in carry, and
    ``terminal`` (N,) whether the segment's last step ended the episode.
    Returns N fixed-shape Blocks (a leading N axis, ``write_rows``'s
    layout) and the next segment's tails (frames, actions, hiddens,
    burn0).

    ``priority``: a positive float (a constant stamp on every sequence)
    or "td": the host assembler's rule (ops/returns.py
    initial_priorities and the eta max/mean mix) from ``q_seg`` (N, L, A),
    the acting policy's Q at each step's state, and ``q_boot`` (N, A), the
    bootstrap Q after the last step (zeros where the episode ended).
    ``weight_version``: an int or a device scalar. ``lanes`` (N,) int32:
    each lane's index on the epsilon ladder, the blocks' provenance stamp
    (None stamps -1).

    Row ``i`` of a block's timeline is ``frames_all[i]`` of ``frames_all
    = tail ++ segment``: the right-aligned tails make the offset one
    per-lane constant ``B - burn0``."""
    with scopes.scope("emit_blocks"):
        n, l_seg = actions.shape
        b, f, lrn = spec.burn_in, spec.forward, spec.learning
        s, stack = spec.seqs_per_block, spec.frame_stack
        if l_seg != spec.block_length:
            raise ValueError(f"a segment of {l_seg} steps; blocks are "
                             f"{spec.block_length}")
        device = actions.device
        burn0 = burn0.long()
        actions = actions.to(torch.int32)

        buf_frames = torch.cat([tail_frames, obs], dim=1)
        buf_la = torch.cat([tail_la, actions], dim=1)
        buf_hid = torch.cat([tail_hidden, hiddens], dim=1)

        # obs / last-action rows, zero (-1) past the live timeline
        r_idx = torch.arange(spec.obs_row_len, device=device)
        idx = b - burn0[:, None] + r_idx[None, :]
        valid = r_idx[None, :] < stack + burn0[:, None] + l_seg
        obs_row = torch.where(
            valid[:, :, None, None],
            _take_rows(buf_frames, idx.clamp(0, buf_frames.shape[1] - 1)), 0)
        la_idx = torch.arange(spec.la_row_len, device=device)
        lidx = b - burn0[:, None] + la_idx[None, :]
        lvalid = la_idx[None, :] < burn0[:, None] + l_seg + 1
        la_row = torch.where(
            lvalid, _take_rows(buf_la, lidx.clamp(0, buf_la.shape[1] - 1)), -1)

        # per-sequence metadata (every slot full: L % learning == 0)
        s_arr = torch.arange(s, device=device)
        burn_in_s = torch.clamp(s_arr[None, :] * lrn + burn0[:, None], max=b)
        # the hidden at each sequence's window start (seq_start - burn_in):
        # in buffer coordinates the episode offset burn0 cancels out
        hidden_sel = _take_rows(buf_hid, b + s_arr[None, :] * lrn - burn_in_s)

        # n-step returns and the gamma tail (ops/returns.py, vectorized)
        padded = F.pad(rewards.float(), (0, f - 1))
        returns = _f32(gamma ** 0) * padded[:, :l_seg]
        for i in range(1, f):
            returns = returns + _f32(gamma ** i) * padded[:, i:i + l_seg]
        rem = l_seg - torch.arange(l_seg, device=device)      # steps to end
        g_tail = torch.full((), gamma, dtype=torch.float32,
                            device=device) ** rem.float()
        gammas = torch.where(
            rem[None, :] > f, _f32(gamma ** f),
            torch.where(terminal[:, None], 0.0, g_tail[None, :]))

        if isinstance(priority, str):
            # "td" (make_act_core checks the spelling): |n-step TD| a
            # step: the bootstrap for step t is max_a Q at row min(t + mf,
            # L) of the (L+1)-row Q timeline (the segment's states and the
            # bootstrap row), the host's [mf : size+1] slice edge-padded
            mf = min(f, l_seg)
            max_rows = torch.cat([q_seg, q_boot[:, None]], dim=1).amax(dim=-1)
            boot_idx = torch.clamp(torch.arange(l_seg, device=device) + mf,
                                   max=l_seg)
            chosen = q_seg.gather(2, actions.long()[:, :, None])[..., 0]
            td = (returns + gammas * max_rows[:, boot_idx] - chosen).abs()
            td_s = td.reshape(n, s, lrn)
            prio = (_f32(priority_eta) * td_s.amax(dim=-1)
                    + _f32(1.0 - priority_eta) * td_s.mean(dim=-1))
        else:
            prio = torch.full((n, s), float(priority), device=device)

        forward_s = torch.clamp(l_seg + 1 - (s_arr + 1) * lrn, max=f)
        sum_reward = torch.where(terminal & report_mask, final_return,
                                 float("nan"))
        if torch.is_tensor(weight_version):
            wv = weight_version.to(torch.int32).expand(n)
        else:
            wv = torch.full((n,), int(weight_version), dtype=torch.int32,
                            device=device)
        blocks = Block(
            obs_row=obs_row.to(torch.uint8),
            last_action_row=la_row.to(torch.int32),
            hidden=hidden_sel.float(),
            action=actions.reshape(n, s, lrn),
            reward=returns.reshape(n, s, lrn),
            gamma=gammas.reshape(n, s, lrn).float(),
            priority=prio.float(),
            burn_in_steps=burn_in_s.to(torch.int32),
            learning_steps=torch.full((n, s), lrn, dtype=torch.int32,
                                      device=device),
            forward_steps=forward_s.to(torch.int32).expand(n, s),
            seq_start=(burn0[:, None] + s_arr[None, :] * lrn).to(torch.int32),
            num_sequences=torch.full((n,), s, dtype=torch.int32,
                                     device=device),
            sum_reward=sum_reward.float(),
            weight_version=wv,
            lane=(torch.full((n,), -1, dtype=torch.int32, device=device)
                  if lanes is None else lanes.to(torch.int32)),
        )

        # the burn-in carry to the next segment (LocalBuffer's tail trim; a
        # lane whose episode ended restarts from LocalBuffer.reset instead)
        reset_tail = torch.cat([torch.zeros_like(tail_frames[:, :b]),
                                reset_obs[:, None].expand(-1, stack, -1, -1)],
                               dim=1)
        new_tails = (
            _where(terminal, reset_tail, buf_frames[:, -(stack + b):]),
            _where(terminal, torch.full_like(tail_la, -1),
                   buf_la[:, -(b + 1):]),
            _where(terminal, torch.zeros_like(tail_hidden),
                   buf_hid[:, -(b + 1):]),
            torch.where(terminal, 0, torch.clamp(burn0 + l_seg, max=b)
                        ).to(torch.int32),
        )
        return blocks, new_tails


def _forward_inputs(carry_stack, last_action, action_dim: int):
    """The T=1 window over the normalized frame stack and the one-hot last
    action, as the host policy feeds its forward."""
    stacked = (carry_stack.float() / 255.0).permute(0, 2, 3, 1)
    return stacked[:, None], action_one_hot(last_action, action_dim)[:, None]


@torch.no_grad()
def quant_probe(twin, end_state, action_dim: int) -> Dict[str, torch.Tensor]:
    """The quantized forward's accuracy probe on one segment's
    end-of-segment state ``(cur_stack, last_action, hidden)`` before the
    reset: the twin's Q against its true-f32 reference module's, as device
    scalars {"quant_dq": max |dQ|, "quant_agree": greedy agreement}."""
    cur_stack, last_action, hidden = end_state
    obs, one_hot = _forward_inputs(cur_stack, last_action, action_dim)
    qq = twin.quant(obs, one_hot, hidden)[0][:, 0]
    qf = twin.f32(obs, one_hot, hidden)[0][:, 0].float()
    return {"quant_dq": (qf - qq).abs().max(),
            "quant_agree": (qf.argmax(dim=-1) == qq.argmax(dim=-1)
                            ).float().mean()}


def make_act_core(env, net: NetworkApply, spec: ReplaySpec, *,
                  gamma: float, priority, priority_eta: float = 0.9,
                  quant_probe_on: bool = True):
    """The acting segment, the JAX package's ``make_act_core``:

        core(module, carry, weight_version, eps, report, lanes, draws)
            -> (carry, blocks, stats)

    ``module``: the network the forward runs (the learner's, by
    reference), or at a quantized ``network.inference_dtype`` the
    ``InferenceTwin`` whose twin every forward runs; ``eps`` (N,) f32 and
    ``report`` (N,) bool per lane; ``lanes`` (N,) int32 or None; ``draws``
    a SegmentDraws. Nothing is read back to the host, so the call captures
    into a CUDA graph. The returned carry holds new tensors; ``stats`` are
    device scalars (episodes ended, episodes reported, their return sum).
    Quantized, ``stats`` also holds ``end_state``, the pre-reset state the
    probe reads, and with ``quant_probe_on`` the probe's two scalars (JAX
    runs the probe inside its program; a graphed segment passes False and
    probes outside the graph)."""
    td_priority = isinstance(priority, str)
    if td_priority and priority != "td":
        raise ValueError(f"priority must be a positive float or 'td'; got "
                         f"{priority!r}")
    action_dim = net.action_dim
    if env.action_dim != action_dim:
        raise ValueError(f"env action_dim {env.action_dim} != network "
                         f"action_dim {action_dim}")
    if env.episode_len % spec.block_length != 0:
        # the segment resets lanes only at its end: a done in its middle
        # would step a finished episode instead of restarting it
        raise ValueError(
            f"env.episode_len {env.episode_len} must be a multiple of "
            f"block_length {spec.block_length}")

    quant = net.config.inference_dtype != "f32"

    def forward(module, carry_stack, last_action, hidden):
        with scopes.scope("act_forward"):
            obs, one_hot = _forward_inputs(carry_stack, last_action,
                                           action_dim)
            if quant:
                return module.quant(obs, one_hot, hidden)
            return module(obs, one_hot, hidden)

    @torch.no_grad()
    def core(module, carry: ActCarry, weight_version, eps: torch.Tensor,
             report: torch.Tensor, lanes: Optional[torch.Tensor],
             draws: SegmentDraws):
        # one speculative reset a segment, selected after the last step:
        # episodes end only on segment boundaries
        with scopes.scope("env_reset"):
            reset_state, reset_obs = env.reset(draws.env_reset)
        env_state, cur_stack = carry.env_state, carry.cur_stack
        hidden, last_action = carry.hidden, carry.last_action
        ep_return = carry.ep_return
        rec: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("obs", "action", "reward", "done", "hidden",
                            "ep_ret", "q")}
        for t in range(spec.block_length):
            q, hidden = forward(module, cur_stack, last_action, hidden)
            q = q[:, 0]
            greedy = q.argmax(dim=-1)
            explore = draws.explore[t] < eps
            action = torch.where(explore, draws.random_action[t].long(),
                                 greedy)
            with scopes.scope("env_step"):
                env_state, obs, reward, done = env.step(
                    env_state, action,
                    None if draws.env_step is None else draws.env_step[t])
            cur_stack = torch.cat([cur_stack[:, 1:], obs[:, None]], dim=1)
            last_action = action
            ep_return = ep_return + reward
            for k, v in (("obs", obs), ("action", action),
                         ("reward", reward), ("done", done),
                         ("hidden", hidden), ("ep_ret", ep_return),
                         ("q", q)):
                rec[k].append(v)
        terminal = rec["done"][-1]

        q_boot = None
        if td_priority:
            # the bootstrap Q at the end-of-segment state before the reset
            # (what the host passes to LocalBuffer.finish), zero where the
            # episode ended (finish(None)): one extra T=1 forward
            qb, _ = forward(module, cur_stack, last_action, hidden)
            q_boot = torch.where(terminal[:, None], 0.0, qb[:, 0])

        dones = torch.stack(rec["done"])                           # (L, N)
        ep_rets = torch.stack(rec["ep_ret"])
        blocks, tails = emit_blocks(
            spec, gamma, priority, carry.tail_frames, carry.tail_la,
            carry.tail_hidden, carry.burn0,
            torch.stack(rec["obs"], dim=1), torch.stack(rec["action"], dim=1),
            torch.stack(rec["reward"], dim=1),
            torch.stack(rec["hidden"], dim=1), terminal, ep_rets[-1],
            report, reset_obs, weight_version,
            q_seg=torch.stack(rec["q"], dim=1) if td_priority else None,
            q_boot=q_boot, priority_eta=priority_eta, lanes=lanes)
        # auto-reset where the episode ended: the records hold the true
        # terminal frame; the carry restarts from envs/vector.py's reset
        new = ActCarry(
            env_state=_where(terminal, reset_state, env_state),
            cur_stack=_where(terminal, reset_obs[:, None].expand_as(
                cur_stack), cur_stack),
            hidden=_where(terminal, torch.zeros_like(hidden), hidden),
            last_action=torch.where(terminal, -1, last_action),
            tail_frames=tails[0], tail_la=tails[1], tail_hidden=tails[2],
            burn0=tails[3], ep_return=torch.where(terminal, 0.0, ep_return))
        done_rep = dones & report[None, :]
        stats = {
            "episodes": dones.sum(),
            "reported_episodes": done_rep.sum(),
            "reported_return_sum": torch.where(done_rep, ep_rets, 0.0).sum(),
        }
        if quant:
            stats["end_state"] = (cur_stack, last_action, hidden)
            if quant_probe_on:
                stats.update(quant_probe(module, stats["end_state"],
                                         action_dim))
        return new, blocks, stats

    return core


class AnakinAct:
    """The acting segment with its per-lane constants, the JAX package's
    ``make_anakin_act``: ``act(module, carry, weight_version, draws=None,
    generator=None) -> (carry, blocks, stats)``, drawing from
    ``generator`` unless ``draws`` are injected. ``eps`` is the Ape-X
    ladder over the lanes; ``report`` marks the lanes at eps <=
    near_greedy_eps, whose episode returns are reported (the host loop's
    filter); ``lanes`` stamps each block with its lane's ladder index,
    ``lane_base + i`` (a data-parallel rank's slice of the global ladder
    starts at its ``lane_base``)."""

    def __init__(self, env, net: NetworkApply, spec: ReplaySpec, *,
                 num_lanes: int, epsilons: Sequence[float], gamma: float,
                 priority, near_greedy_eps: float,
                 priority_eta: float = 0.9, quant_probe_on: bool = True,
                 lane_base: int = 0):
        eps_list = [float(e) for e in epsilons]
        if len(eps_list) != num_lanes:
            raise ValueError(f"need one epsilon per lane: got "
                             f"{len(eps_list)} for {num_lanes} lanes")
        self.env, self.spec, self.num_lanes = env, spec, num_lanes
        self.action_dim = net.action_dim
        device = env.device
        self.eps = torch.tensor(eps_list, dtype=torch.float32,
                                device=device)
        self.report = torch.tensor([e <= near_greedy_eps for e in eps_list],
                                   device=device)
        self.lanes = torch.arange(lane_base, lane_base + num_lanes,
                                  dtype=torch.int32, device=device)
        self.quant = net.config.inference_dtype != "f32"
        self.core = make_act_core(env, net, spec, gamma=gamma,
                                  priority=priority,
                                  priority_eta=priority_eta,
                                  quant_probe_on=quant_probe_on)

    def draw(self, generator: Optional[torch.Generator]) -> SegmentDraws:
        return draw_segment(self.env, self.num_lanes, self.spec.block_length,
                            self.action_dim, generator)

    def __call__(self, module, carry: ActCarry, weight_version, *,
                 draws: Optional[SegmentDraws] = None,
                 generator: Optional[torch.Generator] = None):
        if draws is None:
            draws = self.draw(generator)
        return self.core(module, carry, weight_version, self.eps,
                         self.report, self.lanes, draws)


class ActSegment:
    """One acting segment and its ring write into the learner's device
    replay, the fused loop's acting dispatch.

    ``run(weight_version)`` acts N lanes for one segment from the static
    ``carry`` (updated in place), writes the N blocks into ring rows
    ``block_ptr .. block_ptr + N - 1`` (mod the ring) from a device-side
    pointer, adds the segment's stats to device accumulators
    (``take_stats`` reads them, one sync) and advances the host's
    ``replay_state.block_ptr``. ``weight_version`` and the pointer are
    static device scalars filled before each call.

    On the card: the first call runs eagerly on a side stream (the
    warm-up, a real segment); the second captures one CUDA graph of the
    draws, the segment, the ring write and the accumulation, with the
    generator registered so that each replay draws anew, and replays it;
    every later call replays it and raises if a tensor it reads (the
    network's parameters or the quantized twin's, the replay) has moved.
    A replay adds the kernel launches its capture counted (the int8
    segment's ``int8_linear``). On the CPU every call is eager.
    ``blocks`` and ``draws`` hold the newest segment's, ``end_state`` its
    pre-reset state when the forward is quantized (``probe``)."""

    def __init__(self, act: AnakinAct, module, carry: ActCarry,
                 spec: ReplaySpec, replay_state: ReplayState,
                 generator: torch.Generator):
        device = act.env.device
        self.act, self.module, self.carry = act, module, carry
        self.spec, self.replay_state = spec, replay_state
        self.generator = generator
        self.cuda = device.type == "cuda"
        self.weight_version = torch.zeros((), dtype=torch.int32,
                                          device=device)
        self.block_ptr = torch.zeros((), dtype=torch.int64, device=device)
        self.offsets = torch.arange(act.num_lanes, device=device)
        self.totals = {"episodes": torch.zeros((), dtype=torch.int64,
                                               device=device),
                       "reported_episodes": torch.zeros(
                           (), dtype=torch.int64, device=device),
                       "reported_return_sum": torch.zeros((), device=device),
                       "env_steps": torch.zeros((), dtype=torch.int64,
                                                device=device)}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = self.replays = 0
        self.blocks: Optional[Block] = None
        self.draws: Optional[SegmentDraws] = None
        self.end_state: Optional[tuple] = None
        self.addresses: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}      # a replay's, by kernel
        self._outputs: Optional[tuple] = None

    def _run(self) -> tuple:
        draws = self.act.draw(self.generator)
        carry, blocks, stats = self.act(self.module, self.carry,
                                        self.weight_version, draws=draws)
        rows = (self.block_ptr + self.offsets) % self.spec.num_blocks
        write_rows(self.spec, self.replay_state, rows, blocks)
        assign_(self.carry, carry)
        stats["env_steps"] = blocks.learning_steps.sum()
        for name in STATS:
            self.totals[name] += stats[name]
        return blocks, draws, stats.get("end_state")

    def _read(self) -> Dict[str, int]:
        """Addresses of what the graph reads and writes beyond its own
        tensors: the weights (the parameters, or the twin's tensors) and
        the replay."""
        if self.act.quant:
            out = {f"twin.{i}": t.data_ptr()
                   for i, t in enumerate(self.module.tensors())}
        else:
            out = {f"params.{n}": p.data_ptr()
                   for n, p in self.module.named_parameters()}
        out.update({f"replay.{n}": v.data_ptr()
                    for n, v in vars(self.replay_state).items()
                    if torch.is_tensor(v)})
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        stream = torch.cuda.Stream()
        signature = (f"lanes={self.act.num_lanes} "
                     f"quant={bool(self.act.quant)}")
        with compile_event("anakin_act", signature), gc_paused(), \
                captured_launches(stream) as counted, \
                torch.cuda.graph(graph, stream=stream,
                                 capture_error_mode="thread_local"):
            self._outputs = self._run()
        # the capture launched nothing: a replay adds these
        self.launches = {name: counted.get(name, 0)
                         for name in launch_counts()}
        add_launch_counts({name: -n for name, n in self.launches.items()})
        self.graph = graph
        self.addresses = self._read()

    def run(self, weight_version: int, eager: bool = False) -> None:
        """One segment. ``eager``: run it without the graph on the
        current stream (a check's twin of a replay)."""
        self.weight_version.fill_(int(weight_version))
        self.block_ptr.fill_(self.replay_state.block_ptr)
        if not self.cuda or eager:
            self.blocks, self.draws, self.end_state = self._run()
        elif self.calls == 0:
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.blocks, self.draws, self.end_state = self._run()
            current.wait_stream(side)
        else:
            if self.graph is None:
                self._capture()
            elif self._read() != self.addresses:
                moved = sorted(k for k, v in self._read().items()
                               if self.addresses.get(k) != v)
                raise RuntimeError("the acting graph reads tensors that "
                                   f"have moved since its capture: "
                                   f"{moved[:8]}")
            self.graph.replay()
            add_launch_counts(self.launches)
            self.replays += 1
            self.blocks, self.draws, self.end_state = self._outputs
        self.replay_state.block_ptr = ((self.replay_state.block_ptr
                                        + self.act.num_lanes)
                                       % self.spec.num_blocks)
        self.calls += 1

    def probe(self) -> Dict[str, float]:
        """The accuracy probe on the newest segment's pre-reset state,
        eagerly on the current stream (a quantized forward only)."""
        stats = quant_probe(self.module, self.end_state, self.act.action_dim)
        return {name: float(v) for name, v in stats.items()}

    def take_stats(self) -> Dict[str, float]:
        """The accumulated stats since the last take (one sync), zeroed."""
        values = torch.stack([self.totals[n].double()
                              for n in STATS]).tolist()
        for t in self.totals.values():
            t.zero_()
        return dict(zip(STATS, values))
