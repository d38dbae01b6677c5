"""Entry point of a spawned actor process.

Import-light on purpose: the card belongs to the learner process alone, so
the child hides every CUDA device (``CUDA_VISIBLE_DEVICES=""``) before its
first CUDA call and acts on the CPU with one intra-op thread. Importing
torch does not initialize CUDA; the variable is read when something first
does, and nothing in an actor does: a child that finds CUDA initialized
at its end exits with an error.
"""

import os


def actor_process_main(cfg_dict: dict, player_idx: int, actor_idx: int,
                       epsilon: float, shm_name: str, queue, stop_event,
                       health_board=None) -> None:
    # a respawn booting after the parent unlinked the segments exits quietly
    if stop_event.is_set():
        return
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    torch.set_num_threads(1)

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.actor_loop import (instrument_block_sink,
                                                   make_actor_env,
                                                   make_actor_policy)
    from r2d2_tpu_torch.runtime.feeder import put_patient
    from r2d2_tpu_torch.runtime.weights import WeightSubscriber

    cfg = Config.from_dict(cfg_dict)
    seed = cfg.runtime.seed + 10_000 * player_idx + 100 * actor_idx
    env = make_actor_env(cfg, player_idx, actor_idx, seed)
    net = NetworkApply(env.action_space.n, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    template = net.init(cfg.runtime.seed)
    try:
        sub = WeightSubscriber(shm_name, template)
    except FileNotFoundError:
        env.close()
        if stop_event.is_set():
            return      # the parent tore the segments down mid-boot
        raise
    fresh = sub.poll()
    params = template if fresh is None else fresh
    # the subscriber hands over a fresh copy per poll: no second copy
    policy, run_loop = make_actor_policy(cfg, net, params, actor_idx, seed,
                                         epsilon=epsilon, copy_updates=False)
    beat = ((lambda: health_board.touch(actor_idx))
            if health_board is not None else None)
    sink = instrument_block_sink(
        lambda b: put_patient(queue, b, stop_event.is_set, beat=beat),
        actor_idx, board=health_board,
        weight_version=lambda: sub.publish_count,
        lane_base=actor_idx * cfg.actor.envs_per_actor)
    try:
        run_loop(cfg, env, policy, block_sink=sink, weight_poll=sub.poll,
                 should_stop=stop_event.is_set)
    finally:
        sub.close()
    if torch.cuda.is_initialized():
        raise RuntimeError(f"actor process {actor_idx} initialized CUDA")
