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
                       health_board=None, serve_spec=None,
                       health_slot=None, total_actors=None,
                       telemetry_board=None) -> None:
    """``serve_spec`` (``actor.inference="server"``): the policy server's
    rung, {"transport": "shm", "request_ring", "action_dim", "hidden_dim",
    "reply_slots"} or {"transport": "socket", "host", "port"}; the actor
    is then a thin client with no weights and no weight subscriber.
    ``health_slot``: the heartbeat board's slot (``actor_idx`` by
    default); ``total_actors``: the fleet the ladder spreads over
    (``actor.num_actors`` by default; a multi-host controller's actors
    are global actors of every controller's fleet). ``telemetry_board``:
    the learner's ``TelemetryBoard``, whose slot ``health_slot`` this
    process's stage timers publish into; its spans go to
    ``{save_dir}/spans_p{player}_a{actor}.jsonl`` (appended: a respawn
    keeps its predecessor's)."""
    slot = actor_idx if health_slot is None else health_slot
    # a respawn booting after the parent unlinked the segments exits quietly
    if stop_event.is_set():
        return
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    torch.set_num_threads(1)

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models.network import NetworkApply, bundle_size
    from r2d2_tpu_torch.runtime.actor_loop import (instrument_block_sink,
                                                   make_actor_env,
                                                   make_actor_policy)
    from r2d2_tpu_torch.telemetry.tracing import tracing_on
    from r2d2_tpu_torch.runtime.feeder import put_patient
    from r2d2_tpu_torch.runtime.weights import WeightSubscriber
    from r2d2_tpu_torch.telemetry.core import Telemetry

    cfg = Config.from_dict(cfg_dict)
    seed = cfg.runtime.seed + 10_000 * player_idx + 100 * actor_idx
    env = make_actor_env(cfg, player_idx, actor_idx, seed)
    net = NetworkApply(env.action_space.n, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    sub = serve_channel = None
    if cfg.actor.inference == "server":
        params = None
        if serve_spec["transport"] == "shm":
            from r2d2_tpu_torch.serve.transport import ShmServeChannel
            serve_channel = ShmServeChannel(
                serve_spec["request_ring"], serve_spec["action_dim"],
                serve_spec["hidden_dim"],
                reply_slots=serve_spec["reply_slots"])
        else:
            from r2d2_tpu_torch.serve.transport import SocketChannel
            serve_channel = SocketChannel(serve_spec["host"],
                                          serve_spec["port"],
                                          connect_retries=5,
                                          eager_connect=True)
    else:
        template = net.init(cfg.runtime.seed)
        try:
            # the payload's length: the bundle's at a quantized dtype
            sub = WeightSubscriber(shm_name, bundle_size(net))
        except FileNotFoundError:
            env.close()
            if stop_event.is_set():
                return      # the parent tore the segments down mid-boot
            raise
        fresh = sub.poll()
        params = template if fresh is None else fresh
    # the subscriber hands over a fresh copy per poll: no second copy
    policy, run_loop = make_actor_policy(cfg, net, params, actor_idx, seed,
                                         epsilon=epsilon, copy_updates=False,
                                         total_actors=total_actors,
                                         serve_channel=serve_channel,
                                         should_stop=stop_event.is_set)
    beat = ((lambda: health_board.touch(slot))
            if health_board is not None else None)
    tele = Telemetry.from_config(cfg, name=f"actor-p{player_idx}-{actor_idx}",
                                 board=telemetry_board, slot=slot)
    if tele.enabled:
        tele.start_drain(os.path.join(
            cfg.runtime.save_dir or ".",
            f"spans_p{player_idx}_a{actor_idx}.jsonl"), append=True)
    sink = instrument_block_sink(
        lambda b: put_patient(queue, b, stop_event.is_set, beat=beat,
                              telemetry=tele),
        slot, board=health_board, telemetry=tele,
        # the publication the actor acts with: the subscriber's, or the
        # server's riding each reply
        weight_version=((lambda: policy.weight_version) if sub is None
                        else (lambda: sub.publish_count)),
        lane_base=actor_idx * cfg.actor.envs_per_actor,
        trace_every=(cfg.telemetry.trace_sample_every
                     if tracing_on(cfg) else 0))
    try:
        run_loop(cfg, env, policy, block_sink=sink,
                 weight_poll=sub.poll if sub is not None else (lambda: None),
                 should_stop=stop_event.is_set, telemetry=tele)
    except Exception:
        if not stop_event.is_set():
            raise       # a served policy raising at shutdown is a clean stop
    finally:
        tele.close()
        if sub is not None:
            sub.close()
        if serve_channel is not None:
            policy.close()
    if torch.cuda.is_initialized():
        raise RuntimeError(f"actor process {actor_idx} initialized CUDA")
