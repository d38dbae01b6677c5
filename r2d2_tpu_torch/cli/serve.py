"""Standalone policy server of the PyTorch port, the JAX package's
``cli/serve.py`` for one server: serve a checkpoint's policy over TCP (and,
with ``--shm``, the shared-memory rings for clients on the same host).

    python -m r2d2_tpu_torch.cli.serve --ckpt models/Fake3_player0
    python -m r2d2_tpu_torch.cli.serve --seconds 30          # random init
    python -m r2d2_tpu_torch.cli.serve --device=cpu --seconds 10 \\
        --network.inference_dtype=int8 ...

The server runs on the card unless ``--device=cpu`` (without a card it
raises). It prints ``serving on HOST:PORT (action_dim=A)`` and, with
``--shm``, the request ring's name. Clients are
``r2d2_tpu_torch.serve.RemotePolicy`` / ``RemoteBatchedPolicy`` over a
``SocketChannel`` (or a ``ShmServeChannel``). Every
``runtime.log_interval`` seconds a record with the process header
(``proc``: plane, pid, clock anchor), the ``serving`` block (request
latency, batch fill, client churn; with ``telemetry.tracing_enabled`` its
``trace`` sub-block of per-hop latencies) and, at a quantized
``network.inference_dtype``, the ``quant`` block appends to
``serve_metrics.jsonl`` in ``--save-dir``; a final record closes the run,
with the forward's mean ms per dispatch bucket and the kernels' launch
counts. With telemetry and ``telemetry.alerts_enabled`` on, the alert
rules run on each record (its ``alerts`` block; firings to
``serve_alerts.jsonl``). With telemetry on, the server's ``serve/forward``
and ``serve/reply`` spans drain to ``spans_serve.jsonl`` in ``--save-dir``
(every ``telemetry.flush_interval_s``). SIGTERM and SIGINT stop it
cleanly; ``--seconds`` bounds the run.
"""

import argparse
import dataclasses
import json
import os
import signal
import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", default="",
                   help="checkpoint to serve (empty: random weights from "
                        "runtime.seed)")
    p.add_argument("--shm", action="store_true",
                   help="also open the shared-memory request ring; its name "
                        "is printed for clients")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="stop after this long (0 = until signalled)")
    p.add_argument("--save-dir", default=".",
                   help="where serve_metrics.jsonl and serve_alerts.jsonl "
                        "go")
    p.add_argument("--device", default=None,
                   help='"cuda" (default; raises without one) or "cpu"')
    args, config_overrides = p.parse_known_args(argv)

    from r2d2_tpu_torch.config import Config, parse_overrides
    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.ops.launch_counts import launch_counts
    from r2d2_tpu_torch.serve import (InprocEndpoint, PolicyServer,
                                      ServingStats, ShmServeTransport,
                                      SocketServerTransport)
    from r2d2_tpu_torch.utils.device import configure_numerics, resolve_device

    device = resolve_device(args.device)
    configure_numerics()
    cfg = parse_overrides(Config(), config_overrides)
    restored = None
    if args.ckpt:
        from r2d2_tpu_torch.runtime.checkpoint import (load_checkpoint_config,
                                                       restore_checkpoint)
        stored = load_checkpoint_config(args.ckpt)
        if stored is not None:
            # the stored architecture, with this run's inference dtype
            network = dataclasses.replace(
                stored.network,
                inference_dtype=cfg.network.inference_dtype)
            cfg = dataclasses.replace(cfg, env=stored.env, network=network,
                                      sequence=stored.sequence)
        restored = restore_checkpoint(args.ckpt)
    probe = create_env(cfg.env, seed=cfg.runtime.seed)
    action_dim = probe.action_space.n
    probe.close()
    net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    module = net.init(cfg.runtime.seed)
    if restored is not None:
        module.load_state_dict(restored["params"])

    quant_stats = None
    if cfg.network.inference_dtype != "f32":
        from r2d2_tpu_torch.telemetry import QuantStats
        quant_stats = QuantStats(cfg.network.inference_dtype,
                                 cfg.telemetry.quant_probe_interval)

    from r2d2_tpu_torch.telemetry.alerts import AlertEngine, default_rules
    from r2d2_tpu_torch.telemetry.core import Telemetry
    from r2d2_tpu_torch.telemetry.tracing import (ServeTrace, proc_header,
                                                  tracing_on)
    save_dir = args.save_dir or "."
    telemetry = Telemetry.from_config(cfg, name="serve")
    telemetry.start_drain(os.path.join(save_dir, "spans_serve.jsonl"))
    stats = ServingStats()
    tracing = tracing_on(cfg)
    if tracing:
        stats.trace = ServeTrace()
    endpoint = InprocEndpoint()
    server = PolicyServer(cfg, net, module, endpoint=endpoint, stats=stats,
                          quant_stats=quant_stats, telemetry=telemetry)
    del module                      # the server holds its own copy
    transports = [SocketServerTransport(endpoint.submit, cfg.serve.host,
                                        cfg.serve.port)]
    print(f"serving on {transports[0].host}:{transports[0].port} "
          f"(action_dim={action_dim})", flush=True)
    if args.shm:
        shm_t = ShmServeTransport(
            endpoint.submit, (cfg.env.frame_height, cfg.env.frame_width),
            action_dim, cfg.network.hidden_dim,
            request_slots=cfg.serve.request_ring_slots, tracing=tracing)
        transports.append(shm_t)
        print(f"shm request ring: {shm_t.request_ring.name}", flush=True)

    os.makedirs(save_dir, exist_ok=True)
    metrics_path = os.path.join(save_dir, "serve_metrics.jsonl")
    open(metrics_path, "w").close()
    engine = None
    if cfg.telemetry.enabled and cfg.telemetry.alerts_enabled:
        engine = AlertEngine(default_rules(cfg.telemetry),
                             jsonl_path=os.path.join(save_dir,
                                                     "serve_alerts.jsonl"))
    # stamped once, when the listener is live, and carried on every row
    proc = proc_header("serve")

    def record(t0: float, **extra) -> dict:
        out = {"t": round(time.time() - t0, 1),
               "batches": server.batches_dispatched, "proc": proc, **extra}
        block = stats.interval_block(deadline_ms=cfg.serve.deadline_ms,
                                     max_batch=cfg.serve.max_batch)
        if block is not None:       # left out when the interval saw none
            out["serving"] = block
        if quant_stats is not None:
            out["quant"] = quant_stats.interval_block()
        if engine is not None:
            out["alerts"] = engine.evaluate(out)
        with open(metrics_path, "a") as f:
            f.write(json.dumps(out) + "\n")
        return out

    stop = {"flag": False}

    def _on_signal(signum, frame):
        stop["flag"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass

    server.start()
    t0 = last_log = time.time()
    try:
        while not stop["flag"]:
            if args.seconds and time.time() - t0 >= args.seconds:
                break
            time.sleep(0.05)
            if time.time() - last_log >= cfg.runtime.log_interval:
                last_log = time.time()
                record(t0)
    finally:
        server.stop()
        for t in transports:
            t.close()
        telemetry.close()
        final = record(t0, final=True, device=str(device),
                       forward_ms_by_bucket=server.forward_ms_by_bucket(),
                       launches=launch_counts())
        print(f"served {final['batches']} batches in "
              f"{time.time() - t0:.1f}s; records in {metrics_path}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
