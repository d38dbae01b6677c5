"""The replay service's training path on the card, taken apart.

chip_smoke.py's phase 17b trains ``cli.train`` at the reference shape
under the service (``train_under_service``: two shards of a few blocks,
a spill tier of a shard's rows, grouped ingest, spill prefetch, sample
staging, every block traced) with two thread actors. This tool measures,
on the card, where that path's time goes:

1. ``ops``: one shard of the same geometry on an idle card, no learner:
   a sample (the tree descent and the gather), a promotion (one spilled
   page back into the ring) and a write-back of host priorities (the
   staged path's), each timed to the end of its device work.
2. ``idle``: a service-routed ``Learner`` filled with synthetic blocks,
   no actors and no adds: WINDOW steps a window, sample staging off and
   on, each with the promotion churn (``fleet.spill_promote_per_sample``
   1, the default) and without it (0), in turns; seq-updates/s, the
   service's host timings (lock waits and holds by operation), and the
   external step's graph alone on one fixed batch (the median of single
   synced steps), the ceiling of the path.
3. ``actors``: ``cli.train`` at 17b's settings for SECONDS, staging off
   and on in turns (off, on, on, off); seq-updates/s after WARM
   dispatches, the service's host timings over the same window and the
   learner's stage p50s from its last record.

Run on the card (the kernels build on first use)::

    python -m r2d2_tpu_torch.tools.service_probe [--seconds 20]
        [--shard-blocks 2] [--parts ops,idle,actors] [--out FILE]

It prints one JSON line per measurement and, with ``--out``, writes them
all to FILE."""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

SHARDS = 2
LEARNING_STARTS = 400
WINDOW = 48                  # steps a timed window of the idle part
WINDOWS = 2                  # windows of each setting a turn
WARM = 8                     # dispatches before a cli.train window
OPS_REPEATS = 20
FUSED_ARGS = ["--network.pallas_lstm=on", "--network.use_double=true"]


def service_args(shard_blocks: int, staging: bool = True) -> list:
    """``cli.train``'s flags for the service path at the reference shape:
    SHARDS shards of ``shard_blocks`` blocks, a spill tier of a shard's
    rows, grouped ingest at 8, spill prefetch, every block traced, the
    tier stats, thread actors on the Fake env, no saves."""
    from r2d2_tpu_torch.config import Config
    block = Config().replay.block_length
    return FUSED_ARGS + [
        "--actor-mode=thread", "--env.game_name=Fake",
        f"--fleet.replay_shards={SHARDS}",
        f"--replay.capacity={SHARDS * shard_blocks * block}",
        f"--fleet.spill_blocks={shard_blocks}",
        "--fleet.ingest_batch_blocks=8", "--fleet.spill_prefetch=true",
        f"--fleet.sample_staging={'true' if staging else 'false'}",
        "--telemetry.tracing_enabled=true",
        "--telemetry.trace_sample_every=1",
        "--telemetry.replay_tiers_enabled=true", "--runtime.log_interval=2",
        "--runtime.save_interval=0",
        f"--replay.learning_starts={LEARNING_STARTS}"]


def train_under_service(shard_blocks: int, seconds: float, save_dir: str,
                        staging: bool = True):
    """``cli.train`` under ``service_args`` for ``seconds``; (summary, the
    learner's service, dispatch marks (perf_counter, training steps), the
    service's host timings from the WARM-th dispatch to the end, its
    records)."""
    from r2d2_tpu_torch.cli import train
    marks, stacks, timings = [], [], []

    def hook(stack):
        if not stacks:
            stacks.append(stack)
        marks.append((time.perf_counter(), stack.learner.training_steps))
        if len(marks) == WARM + 1:
            stack.learner.service.host_timings(reset=True)

    summary = train.main(service_args(shard_blocks, staging) + [
        f"--max-seconds={seconds}", f"--runtime.save_dir={save_dir}"],
        dispatch_hook=hook)
    service = stacks[0].learner.service if stacks else None
    if service is not None:
        timings = service.host_timings()
    path = os.path.join(save_dir, "metrics_player0.jsonl")
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = [json.loads(line) for line in f if line.strip()]
    return summary, service, marks, timings, records


def window_rate(marks: list, batch: int):
    """seq-updates/s from the WARM-th dispatch mark to the last."""
    if len(marks) <= WARM + 1:
        return None
    (t0, s0), (t1, s1) = marks[WARM], marks[-1]
    return batch * (s1 - s0) / (t1 - t0)


def _reference(shard_blocks: int, **extra):
    from r2d2_tpu_torch.config import Config
    return Config().replace(**{
        "network.pallas_lstm": "on", "network.use_double": True,
        "replay.capacity": SHARDS * shard_blocks
        * Config().replay.block_length,
        "replay.learning_starts": LEARNING_STARTS,
        "fleet.replay_shards": SHARDS, "fleet.spill_blocks": shard_blocks,
        "fleet.ingest_batch_blocks": 8, "fleet.spill_prefetch": True,
        "telemetry.tracing_enabled": True,
        "telemetry.trace_sample_every": 1,
        "telemetry.replay_tiers_enabled": True,
        "runtime.save_interval": 0, **extra})


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stamped(blocks):
    import numpy as np
    from r2d2_tpu_torch.replay.structs import with_trace
    from r2d2_tpu_torch.telemetry.tracing import now_ms
    return [with_trace(b, np.asarray(now_ms(), np.int32)) for b in blocks]


def part_ops(device, shard_blocks: int, overrides=None,
             repeats: int = OPS_REPEATS) -> dict:
    """One shard of 17b's geometry (``overrides`` of the reference
    configuration: the tests' small shape) on an idle card: sample,
    promotion and host write-back, each ms to the end of its device work
    (median of ``repeats``)."""
    import dataclasses
    import numpy as np
    import torch
    from r2d2_tpu_torch.fleet.replay_service import ReplayService
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.tools.bench import synthetic_blocks
    cfg = _reference(shard_blocks, **(overrides or {}))
    spec = dataclasses.replace(
        ReplaySpec.from_config(cfg, device), num_blocks=shard_blocks,
        replay_diag=False)
    svc = ReplayService(spec, 1, device, spill_blocks=shard_blocks,
                        promote_per_sample=0)
    for block in synthetic_blocks(cfg, 2 * shard_blocks, seed=5):
        svc.add_block(block)
    gen = torch.Generator(device=device).manual_seed(0)

    def timed(fn):
        out = []
        for _ in range(repeats):
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    batch, shard, _ = svc.sample(gen)
    idxes = batch.idxes.cpu().numpy()
    prios = np.random.default_rng(0).random(idxes.shape[0]).astype(
        np.float32)
    report = {
        "sample_ms": timed(lambda: svc.sample(gen)),
        "promote_ms": timed(lambda: svc.shards[0].promote(1)),
        "writeback_host_ms": timed(lambda: svc.update_priorities(
            shard, idxes, prios)),
        "writeback_device_ms": timed(lambda: svc.update_priorities(
            shard, batch.idxes, torch.as_tensor(prios, device=device))),
        "page_mb": svc.shards[0].spill.page_bytes / 1e6,
    }
    svc.close()
    return report


def part_idle(device, shard_blocks: int, overrides=None,
              window: int = WINDOW) -> dict:
    """Service-routed Learners without actors (the module docstring),
    ``window`` steps a window; ``overrides`` as ``part_ops``'s."""
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    from r2d2_tpu_torch.tools.bench import ACTION_DIM, synthetic_blocks
    learners = {}
    try:
        for promote in (1, 0):
            for staging in (False, True):
                cfg = _reference(shard_blocks, **{
                    **(overrides or {}), "fleet.sample_staging": staging,
                    "fleet.spill_promote_per_sample": promote})
                net = NetworkApply(ACTION_DIM, cfg.network,
                                   cfg.env.frame_stack,
                                   cfg.env.frame_height,
                                   cfg.env.frame_width, device)
                learner = Learner(cfg, net)
                for block in _stamped(synthetic_blocks(
                        cfg, 2 * SHARDS * shard_blocks, seed=7)):
                    learner.ingest(block)
                for _ in range(3):           # eager, capture, a replay
                    learner.step()
                _settle(learner)
                learners[staging, promote] = learner
        batch_size = cfg.replay.batch_size
        rates = {key: [] for key in learners}
        timings = {key: [] for key in learners}
        order = list(learners) + list(reversed(list(learners)))
        for key in order:
            learner = learners[key]
            learner.service.host_timings(reset=True)
            for _ in range(WINDOWS):
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(window):
                    learner.step()
                _sync(device)
                rates[key].append(batch_size * window
                                  / (time.perf_counter() - t0))
            _settle(learner)
            timings[key].append(learner.service.host_timings())
        # the external step's graph alone on one fixed batch: the median
        # of single synced steps (a step that captures the graph of a new
        # pattern of diagnostic interval steps is an outlier there)
        learner = learners[False, 0]
        batch, _, _ = learner.service.sample(learner._service_gen)
        ts = learner.train_state
        step_ms = []
        for _ in range(window):
            _sync(device)
            t0 = time.perf_counter()
            ts, _ = learner._step_fn(ts, batch)
            _sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        graph_ms = statistics.median(step_ms)
    finally:
        for learner in learners.values():
            learner.stop_background()
    out = {"graph_alone_ms_per_step": graph_ms,
           "graph_alone_seq_updates_per_s": batch_size * 1e3 / graph_ms}
    for staging, promote in learners:
        r = rates[staging, promote]
        out[f"staging={'on' if staging else 'off'} promote={promote}"] = {
            "seq_updates_per_s": r,
            "median_seq_updates_per_s": statistics.median(r),
            "host_timings_by_turn": timings[staging, promote]}
    return out


def _settle(learner, timeout: float = 10.0) -> None:
    """Let a staged learner's write-back queue drain (bounded)."""
    deadline = time.monotonic() + timeout
    q = learner._svc_writeback_q
    while q.unfinished_tasks and time.monotonic() < deadline:
        time.sleep(0.005)


def part_actors(shard_blocks: int, seconds: float) -> dict:
    """cli.train at 17b's settings, staging off and on in turns."""
    import torch
    from r2d2_tpu_torch.config import Config
    batch = Config().replay.batch_size
    runs = []
    for staging in (False, True, True, False):
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="service_probe_") as d:
            summary, service, marks, timings, records = \
                train_under_service(shard_blocks, seconds, d, staging)
        stages = records[-1].get("stages", {}) if records else {}
        runs.append({
            "staging": staging, "steps": summary["steps"],
            "blocks_ingested": summary["blocks_ingested"],
            "seq_updates_per_s": window_rate(marks, batch),
            "host_timings": timings,
            "promotions": sum(s.spill.promotions for s in service.shards),
            "demotions": sum(s.spill.demotions for s in service.shards),
            "stages_p50_ms": {k: v.get("p50_ms") for k, v in stages.items()
                              if k.startswith(("learner/", "ingest/"))}})
    by = {s: [r["seq_updates_per_s"] for r in runs if r["staging"] == s]
          for s in (False, True)}
    return {"runs": runs,
            "staging_off_seq_updates_per_s": by[False],
            "staging_on_seq_updates_per_s": by[True]}


def main(argv=None) -> int:
    import torch
    from r2d2_tpu_torch.tools.bench import card_line
    from r2d2_tpu_torch.utils.device import configure_numerics
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--shard-blocks", type=int, default=2)
    ap.add_argument("--parts", default="ops,idle,actors")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("service_probe: no CUDA device", file=sys.stderr)
        return 2
    configure_numerics()
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    results = {"card": card, "shard_blocks": args.shard_blocks}
    parts = args.parts.split(",")
    for name, fn in (("ops", lambda: part_ops(device, args.shard_blocks)),
                     ("idle", lambda: part_idle(device, args.shard_blocks)),
                     ("actors", lambda: part_actors(args.shard_blocks,
                                                    args.seconds))):
        if name not in parts:
            continue
        t0 = time.perf_counter()
        results[name] = fn()
        results[name]["seconds"] = time.perf_counter() - t0
        print(f"service_probe {name} ({card}): "
              + json.dumps(results[name]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
