"""Actor rollout loops, the JAX package's ``runtime/actor_loop.py``: run
in a thread or a spawned process, with a policy on the host CPU.

Per step: policy step, epsilon-greedy, env.step, frame-stack roll,
LocalBuffer.add; at an episode's end the block is finished without a
bootstrap (its return reported only by near-greedy actors); at a block
boundary with the bootstrap Q; fresh weights are polled every
``actor.actor_update_interval`` env steps. A served policy
(``actor.inference="server"``) is driven by the same loops.

With a ``telemetry`` (telemetry/core.py) the loops observe
``actor/forward`` and ``actor/env_step`` each tick and
``actor/weight_sync`` each poll; ``instrument_block_sink`` adds
``actor/block_emit`` (with a span) around the sink.
"""

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from r2d2_tpu_torch.actor.local_buffer import LocalBuffer
from r2d2_tpu_torch.actor.policy import ActorPolicy, BatchedActorPolicy
from r2d2_tpu_torch.config import (Config, apex_epsilon,
                                   vector_lane_epsilons)
from r2d2_tpu_torch.replay.structs import ReplaySpec, with_trace
from r2d2_tpu_torch.telemetry.core import NULL_TELEMETRY
from r2d2_tpu_torch.telemetry.tracing import tracing_on


def _with(block, **fields):
    return dataclasses.replace(block, **{
        name: np.asarray(value, np.float32 if name == "sum_reward"
                         else np.int32) for name, value in fields.items()})


def actor_spec(cfg: Config) -> ReplaySpec:
    """The replay's shape contract as an actor needs it: on the host CPU,
    whatever kernel setting the learner's device takes."""
    return ReplaySpec.from_config(
        cfg.replace(**{"replay.pallas_sample_gather": "auto"}), "cpu")


def make_actor_env(cfg: Config, player_idx: int, actor_idx: int, seed: int,
                   env_factory: Optional[Callable] = None):
    """The one place of the scalar-or-vector env choice and the per-lane
    seeds (seed + lane, inside the worker's 100-wide seed window); shared
    by the thread spawner and the actor process."""
    if env_factory is None:
        from r2d2_tpu_torch.envs.factory import create_env
        env_factory = create_env
    name = f"p{player_idx}a{actor_idx}"
    if cfg.actor.envs_per_actor > 1:
        from r2d2_tpu_torch.envs.vector import make_vector_env
        return make_vector_env(cfg.env, cfg.actor.envs_per_actor, seed=seed,
                               name=name, env_factory=env_factory)
    return env_factory(cfg.env, seed=seed, name=name)


def make_actor_policy(cfg: Config, net, params, actor_idx: int, seed: int,
                      epsilon: Optional[float] = None,
                      copy_updates: bool = True,
                      total_actors: Optional[int] = None,
                      serve_channel=None, serve_stats=None,
                      should_stop: Optional[Callable[[], bool]] = None,
                      quant_stats=None):
    """The policy matching ``make_actor_env``'s env; returns ``(policy,
    run_loop)``. ``epsilon`` overrides the scalar path's Ape-X value;
    vector lanes take the ladder's spread (vector_lane_epsilons).

    ``actor.inference="server"``: the same ladder and seeds build a thin
    Remote(Batched)Policy over ``serve_channel`` (client ids = the lanes'
    ladder positions), so a served fleet acts like the local one. At a
    quantized ``network.inference_dtype`` the local policies act with the
    twin; they probe only where a ``quant_stats`` takes the results (thread
    actors: a process child has no way back to the record, and served
    forwards probe on the server)."""
    serve = cfg.actor.inference == "server"
    if serve:
        if serve_channel is None:
            raise ValueError(
                "actor.inference='server' needs a serve_channel (the "
                "spawner connects it to the policy server's transport)")
        kw = dict(stats=serve_stats,
                  timeout_s=cfg.serve.request_timeout_s,
                  max_retry_s=cfg.serve.max_retry_s,
                  should_stop=should_stop,
                  backoff_base_s=cfg.runtime.restart_backoff_base_s,
                  backoff_max_s=cfg.runtime.restart_backoff_max_s,
                  trace_every=(cfg.telemetry.trace_sample_every
                               if tracing_on(cfg) else 0))
    qkw = {}
    if not serve and cfg.network.inference_dtype != "f32":
        qkw = dict(quant_stats=quant_stats,
                   quant_probe_interval=(cfg.telemetry.quant_probe_interval
                                         if quant_stats is not None else 0))
    if cfg.actor.envs_per_actor > 1:
        epsilons = vector_lane_epsilons(actor_idx, cfg.actor, total_actors)
        seeds = [seed + lane for lane in range(cfg.actor.envs_per_actor)]
        if serve:
            from r2d2_tpu_torch.serve.client import RemoteBatchedPolicy
            policy = RemoteBatchedPolicy(
                serve_channel, net.action_dim, epsilons, seeds,
                client_base=actor_idx * cfg.actor.envs_per_actor, **kw)
        else:
            policy = BatchedActorPolicy(net, params, epsilons, seeds=seeds,
                                        copy_updates=copy_updates, **qkw)
        return policy, run_vector_actor
    if epsilon is None:
        epsilon = apex_epsilon(actor_idx,
                               total_actors or cfg.actor.num_actors,
                               cfg.actor.base_eps, cfg.actor.eps_alpha)
    if serve:
        from r2d2_tpu_torch.serve.client import RemotePolicy
        policy = RemotePolicy(serve_channel, net.action_dim, epsilon,
                              seed=seed,
                              client_id=actor_idx * cfg.actor.envs_per_actor,
                              **kw)
    else:
        policy = ActorPolicy(net, params, epsilon, seed=seed,
                             copy_updates=copy_updates, **qkw)
    return policy, run_actor


def instrument_block_sink(sink: Callable, slot: int, board=None,
                          weight_version: Optional[Callable[[], int]] = None,
                          lane_base: Optional[int] = None,
                          telemetry=None,
                          trace_every: int = 0) -> Callable:
    """Health, telemetry and provenance around a block sink, one wrapping
    point for every spawner: ``actor/block_emit`` (outermost, the whole
    call with the queue wait), the heartbeat ("reached the sink alive"),
    then the stamps: ``weight_version()``, the publication the actor acts
    with, and the lane, the loop's lane-relative index offset by
    ``lane_base`` to the fleet's epsilon-ladder position (an unstamped
    -1 stays -1). ``trace_every`` > 0 (tracing on): every block carries
    ``trace_ms``, every trace_every-th one its emission stamp, the rest
    -1; 0 leaves blocks without it."""
    wrapped = sink
    if trace_every > 0:
        from r2d2_tpu_torch.telemetry.tracing import UNTRACED, now_ms
        emitted = [0]

        def sink_with_trace(block, _wrapped=wrapped):
            emitted[0] += 1
            stamp = now_ms() if emitted[0] % trace_every == 0 else UNTRACED
            return _wrapped(with_trace(block, np.int32(stamp)))
        wrapped = sink_with_trace
    if lane_base is not None:
        def sink_with_lane(block, _wrapped=wrapped, _base=int(lane_base)):
            rel = int(np.asarray(block.lane))
            return _wrapped(block if rel < 0 else
                            _with(block, lane=_base + rel))
        wrapped = sink_with_lane
    if weight_version is not None:
        def sink_with_stamp(block, _wrapped=wrapped):
            return _wrapped(_with(block,
                                  weight_version=int(weight_version())))
        wrapped = sink_with_stamp
    if board is not None:
        def sink_with_heartbeat(block, _wrapped=wrapped):
            board.beat(slot)
            return _wrapped(block)
        wrapped = sink_with_heartbeat
    if telemetry is not None and telemetry.enabled:
        def sink_with_telemetry(block, _wrapped=wrapped):
            t0 = time.time()
            try:
                return _wrapped(block)
            finally:
                t1 = time.time()
                telemetry.observe("actor/block_emit", t1 - t0)
                telemetry.record_span("actor/block_emit", t0, t1,
                                      {"slot": slot})
        wrapped = sink_with_telemetry
    return wrapped


def run_actor(cfg: Config, env, policy: ActorPolicy, block_sink: Callable,
              weight_poll: Callable, should_stop: Callable[[], bool],
              max_env_steps: Optional[int] = None, telemetry=None) -> int:
    """Returns the env steps taken. ``block_sink(block)`` ships a finished
    block; ``weight_poll()`` returns fresh weights or None. Owns ``env``
    and closes it on every exit."""
    tele = telemetry if telemetry is not None else NULL_TELEMETRY
    try:
        spec = actor_spec(cfg)
        lb = LocalBuffer(spec, policy.action_dim, cfg.optim.gamma,
                         cfg.optim.priority_eta)
        obs = env.reset()
        policy.observe_reset(obs)
        lb.reset(obs)
        episode_steps = total_steps = counter = 0
        while not should_stop():
            t0 = time.perf_counter()
            action, q, hidden = policy.act()
            t1 = time.perf_counter()
            next_obs, reward, done, _ = env.step(action)
            tele.observe("actor/forward", t1 - t0)
            tele.observe("actor/env_step", time.perf_counter() - t1)
            policy.observe(next_obs, action)
            lb.add(action, reward, next_obs, q, hidden)
            episode_steps += 1
            total_steps += 1
            if done or episode_steps == cfg.actor.max_episode_steps:
                block = _with(lb.finish(None), lane=0)
                if policy.epsilon > cfg.actor.near_greedy_eps:
                    # only near-greedy actors report episode returns
                    block = _with(block, sum_reward=np.nan)
                block_sink(block)
                obs = env.reset()
                policy.observe_reset(obs)
                lb.reset(obs)
                episode_steps = 0
            elif len(lb) == spec.block_length:
                block_sink(_with(lb.finish(policy.bootstrap_q()), lane=0))
            counter += 1
            if counter >= cfg.actor.actor_update_interval:
                t0 = time.perf_counter()
                params = weight_poll()
                if params is not None:
                    policy.update_params(params)
                tele.observe("actor/weight_sync", time.perf_counter() - t0)
                counter = 0
            if max_env_steps is not None and total_steps >= max_env_steps:
                break
        return total_steps
    finally:
        try:
            env.close()
        except Exception:
            pass


def run_vector_actor(cfg: Config, venv, policy: BatchedActorPolicy,
                     block_sink: Callable, weight_poll: Callable,
                     should_stop: Callable[[], bool],
                     max_env_steps: Optional[int] = None,
                     telemetry=None) -> int:
    """The N-lane twin of ``run_actor``: one (N, 1) forward steps every
    lane of a SyncVectorEnv a tick, each lane with its own LocalBuffer, so
    the blocks are those of N scalar actors. Returns the env steps of all
    lanes. Owns ``venv`` and closes it on every exit."""
    tele = telemetry if telemetry is not None else NULL_TELEMETRY
    try:
        spec = actor_spec(cfg)
        n = venv.num_envs
        if n != policy.num_lanes:
            raise ValueError(f"venv has {n} lanes but policy has "
                             f"{policy.num_lanes}")
        buffers = [LocalBuffer(spec, policy.action_dim, cfg.optim.gamma,
                               cfg.optim.priority_eta) for _ in range(n)]
        obs = venv.reset()
        for i in range(n):
            policy.observe_reset_lane(i, obs[i])
            buffers[i].reset(obs[i])
        total_steps = counter = 0
        while not should_stop():
            t0 = time.perf_counter()
            actions, qs, hiddens = policy.act()
            t1 = time.perf_counter()
            next_obs, rewards, dones, infos = venv.step(actions)
            tele.observe("actor/forward", t1 - t0)
            tele.observe("actor/env_step", time.perf_counter() - t1)
            # every lane's state first: the bootstrap reads the post-step
            # state, as the scalar loop's observe-then-bootstrap order
            policy.observe(next_obs, actions)
            boot_q = None       # one forward a tick, shared by the lanes
            for i in range(n):
                lb = buffers[i]
                lb.add(int(actions[i]), float(rewards[i]), next_obs[i],
                       qs[i], hiddens[i])
                if (dones[i] or venv.episode_steps[i]
                        == cfg.actor.max_episode_steps):
                    block = _with(lb.finish(None), lane=i)
                    if policy.epsilons[i] > cfg.actor.near_greedy_eps:
                        block = _with(block, sum_reward=np.nan)
                    block_sink(block)
                    reset_obs = infos[i].get("reset_obs") if dones[i] \
                        else None
                    if reset_obs is None:
                        reset_obs = venv.reset_lane(i)
                    policy.observe_reset_lane(i, reset_obs)
                    lb.reset(reset_obs)
                elif len(lb) == spec.block_length:
                    if boot_q is None:
                        boot_q = policy.bootstrap_q()
                    block_sink(_with(lb.finish(boot_q[i]), lane=i))
            total_steps += n
            counter += n
            if counter >= cfg.actor.actor_update_interval:
                t0 = time.perf_counter()
                params = weight_poll()
                if params is not None:
                    policy.update_params(params)
                tele.observe("actor/weight_sync", time.perf_counter() - t0)
                counter = 0
            if max_env_steps is not None and total_steps >= max_env_steps:
                break
        return total_steps
    finally:
        try:
            venv.close()
        except Exception:
            pass
