"""One actor's tick, timed by part, on the host CPU, the way a process
actor runs (``runtime/actor_main.py``): CUDA hidden, ``--threads`` intra-op
threads (one, as there), the configuration's env and policy through
``make_actor_env``/``make_actor_policy``, and its loop (``run_actor``, or
``run_vector_actor`` with ``actor.envs_per_actor > 1``). Parts: ``act``
(the network's T=1 forward and the epsilon draw), ``bootstrap`` (the
forward at a block boundary), ``env`` (env.step and reset), ``observe``
(the frame-stack roll), ``buffer_add`` and ``buffer_finish`` (the local
buffer), ``send`` (a finished block into the native shm block ring; this
process drains it, untimed), ``poll`` (a fresh copy of the flat weight
vector every ``actor.actor_update_interval`` env steps, as the
subscriber hands one over, and its load into the module); ``rest`` is
the loop's own time. Then the forward alone under torch.profiler: its
top operators by self CPU time.

    python -m r2d2_tpu_torch.tools.actor_profile --seconds=10 \
        [--threads=1] [--ops=15] [--env.game_name=Fake ...]

Prints one JSON line: env steps/s, ms per tick of each part, and the
forward's operators (self CPU ms per forward, calls per forward).
"""

import json
import os
import sys
import time

FORWARDS_PROFILED = 50


def _timed(obj, name: str, spent: dict, part: str) -> None:
    """Wrap ``obj.name`` so its calls add their seconds to spent[part]."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[part] = spent.get(part, 0.0) + time.perf_counter() - t0

    setattr(obj, name, timed)


def profile_actor(cfg, seconds: float, threads: int = 1, ops: int = 15
                  ) -> dict:
    """Run one actor of ``cfg`` for ``seconds``; see the module
    docstring."""
    import torch
    threads_before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return _profile(cfg, seconds, threads, ops)
    finally:
        torch.set_num_threads(threads_before)


def _profile(cfg, seconds: float, threads: int, ops: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from r2d2_tpu_torch.actor import local_buffer
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.actor_loop import (actor_spec,
                                                   make_actor_env,
                                                   make_actor_policy)
    from r2d2_tpu_torch.runtime.feeder import BlockQueue
    from r2d2_tpu_torch.runtime.weights import flat_parameters

    seed = cfg.runtime.seed
    env = make_actor_env(cfg, 0, 0, seed)
    net = NetworkApply(env.action_space.n, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    flat = flat_parameters(net.init(seed))
    policy, run_loop = make_actor_policy(cfg, net, flat.copy(), 0, seed,
                                         copy_updates=False)
    spent: dict = {}
    _timed(policy, "act", spent, "act")
    _timed(policy, "bootstrap_q", spent, "bootstrap")
    _timed(policy, "observe", spent, "observe")
    _timed(policy, "update_params", spent, "poll")
    _timed(env, "step", spent, "env")
    _timed(env, "reset", spent, "env")
    ring = BlockQueue(use_mp=True, shm_spec=actor_spec(cfg))
    blocks = [0]

    def sink(block):
        t0 = time.perf_counter()
        ring.put(block, timeout=5.0)
        spent["send"] = spent.get("send", 0.0) + time.perf_counter() - t0
        blocks[0] += len(ring.drain(64))

    def poll():
        t0 = time.perf_counter()
        fresh = flat.copy()
        spent["poll"] = spent.get("poll", 0.0) + time.perf_counter() - t0
        return fresh

    buffer_cls = local_buffer.LocalBuffer
    originals = {name: getattr(buffer_cls, name) for name in ("add",
                                                             "finish")}
    ticks = [0]
    for name, original in originals.items():
        def method(self, *args, _original=original, _part=f"buffer_{name}",
                   **kwargs):
            t0 = time.perf_counter()
            try:
                return _original(self, *args, **kwargs)
            finally:
                spent[_part] = (spent.get(_part, 0.0)
                                + time.perf_counter() - t0)
                if _part == "buffer_add":
                    ticks[0] += 1
        setattr(buffer_cls, name, method)
    lanes = cfg.actor.envs_per_actor
    try:
        deadline = time.perf_counter() + seconds
        t0 = time.perf_counter()
        env_steps = run_loop(cfg, env, policy, block_sink=sink,
                             weight_poll=poll,
                             should_stop=lambda: time.perf_counter()
                             > deadline)
        wall = time.perf_counter() - t0
    finally:
        for name, original in originals.items():
            setattr(buffer_cls, name, original)
        ring.close()
    ticks = ticks[0] // lanes
    per_tick = {part: s * 1e3 / ticks for part, s in sorted(spent.items())}
    per_tick["rest"] = wall * 1e3 / ticks - sum(per_tick.values())

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(FORWARDS_PROFILED):
            policy.step()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:ops]
    forward_ops = [dict(name=e.key,
                        self_ms=e.self_cpu_time_total / 1e3
                        / FORWARDS_PROFILED,
                        calls=e.count / FORWARDS_PROFILED) for e in rows]
    return dict(threads=threads, lanes=lanes, seconds=wall, ticks=ticks,
                env_steps=env_steps, env_steps_per_s=env_steps / wall,
                blocks=blocks[0], ms_per_tick=wall * 1e3 / ticks,
                parts_ms_per_tick=per_tick, forward_ops=forward_ops,
                params=int(flat.size))


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    # as in actor_main.py: the card is the learner's
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from r2d2_tpu_torch.config import Config, parse_overrides
    flags = {"seconds": "10", "threads": "1", "ops": "15"}
    rest = []
    for arg in argv:
        name, _, value = arg[2:].partition("=")
        if arg.startswith("--") and name in flags:
            flags[name] = value
        else:
            rest.append(arg)
    cfg = parse_overrides(Config(), ["--env.game_name=Fake"] + rest)
    result = profile_actor(cfg, float(flags["seconds"]),
                           int(flags["threads"]), int(flags["ops"]))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
