"""Seq-updates/s of the port's learner step at the reference shape, on the
card.

    python -m r2d2_tpu_torch.tools.bench [--out FILE]

The reference shape is ``Config()``'s: B=128 sequences of 40+10+5 steps,
84x84x4 frames, Nature convs, cnn_out 1024, LSTM 512, dueling, bf16 on
CUDA; the replay's capacity is cut from 500,000 to 100,000 steps (250
blocks, a 0.83 GB ring) and filled with synthetic blocks
(``replay/synthetic.py``, 18 actions). Paths (``PATHS``): default (single
DQN, Python LSTM loop), double (double DQN, loop), fused_double (double
DQN, ``network.pallas_lstm="on"``) and fused (single DQN, the fused
scan), each at K learner steps per dispatch (``runtime.steps_per_dispatch``:
one CUDA graph of K steps, K = 1 too, built as the ``Learner`` builds its
dispatch); and host, the fused configuration
under ``replay.placement="host"``: a ``Learner`` whose replay is in host
memory (the same blocks), one external-batch step a dispatch (one CUDA
graph of one step) fed by its prefetch thread. Every cell trains from its
own weights, the device paths over the one device replay.

Per cell: ms/step and seq-updates/s (B x steps/s) of WINDOW (32) steps
on the host clock, ending in a sync, in turns over the cells (a b .. z z
.. b a, ROUNDS (2) times, so 4 windows a cell). Then ``torch.profiler``
over 16 more steps: device busy ms/step, the sum of the device's own
kernel and copy events, and the kernels that took the most of it; the
union of those events (where two overlap it counts once); and the
profiled steps' own ms/step on the host clock. The idle share is
1 - busy / (mean unprofiled ms/step), unclipped: it is negative where
busy exceeds the unprofiled step; ``idle_share_union`` is the same from
the union (on the host path the batch copies overlap the step). Kernel
launches per step by wrapper (a graph replay adds its capture's), and on
the host path the prefetch thread's sample ms (host clock) and copy ms
(CUDA events on its stream) per batch, medians over the timed windows.
Peak GB is the replay ring (on the device) plus the most
the cell's state, steps and graph held at once
(``torch.cuda.max_memory_allocated`` while it was built and warmed up).
From the medians it picks what "auto" would resolve to on CUDA
(``config.CUDA_AUTO``), each by a pair measured in this call: K, the
fewest steps per dispatch whose mean speed-up over K=1 across paths is
within 1% of the best; and ``network.pallas_lstm``, fused against default
at that K. The host path takes no part in the choices. With K=1 a graph
too, the K cells tie at the reference shape and the K named is 1, while
``CUDA_AUTO`` keeps 4 for the loops' sake (config.py says why).

Prints the card's name and power limit (``nvidia-smi``), a line per cell,
and last one JSON line with every cell and the choices (``--out``: also
written to that file). Needs a CUDA card; there is no CPU fallback.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

REF_CAPACITY = 100_000     # down from 500,000: the ring fills in seconds
ACTION_DIM = 18            # the synthetic blocks draw actions in [0, 18)
PATHS = {   # label: overrides of the reference configuration
    "default": {},
    "double": {"network.use_double": True},
    "fused_double": {"network.use_double": True,
                     "network.pallas_lstm": "on"},
    "fused": {"network.pallas_lstm": "on"},
    "host": {"network.pallas_lstm": "on", "replay.placement": "host"},
}
HOST_PATH = "host"         # one step a dispatch: K = 1 only
KS = (1, 4, 16)
WINDOW, ROUNDS = 32, 2     # steps a timed window (a multiple of every K)
PROFILE_STEPS = 16
TOP, TOP_NAME = 6, 70      # kernels listed per cell, characters of a name
K_MARGIN = 0.01            # speed-ups within 1% count as a tie


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def reference_config(**overrides):
    from r2d2_tpu_torch.config import Config
    return Config().replace(**{"replay.capacity": REF_CAPACITY, **overrides})


def filled_replay(cfg, device, blocks):
    """The device replay of ``cfg`` on ``device`` with ``blocks`` added by
    replay_add_many, 25 at a time."""
    from r2d2_tpu_torch.replay.device_replay import (replay_add_many,
                                                     replay_init)
    from r2d2_tpu_torch.replay.structs import ReplaySpec, stack_blocks
    spec = ReplaySpec.from_config(cfg, device)
    rs = replay_init(spec, device)
    for i in range(0, len(blocks), 25):
        replay_add_many(spec, rs, stack_blocks(blocks[i:i + 25]))
    return spec, rs


def synthetic_blocks(cfg, count: int, seed: int = 0):
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    spec = ReplaySpec.from_config(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    return [make_synthetic_block(spec, rng) for _ in range(count)]


def build_learner_step(cfg, device, spec, steps_per_dispatch: int = 1,
                       seed: int = 0, eager: bool = False):
    """(train_state, step): the Learner's dispatch of K steps
    (``make_dispatch_step``: one CUDA graph of K steps on the card, K = 1
    too); ``eager``: the eager single step (``make_learner_step``), the
    reference a graph is held against."""
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_dispatch_step,
                                                   make_learner_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    net = NetworkApply(ACTION_DIM, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    ts = create_train_state(net, cfg.optim, seed, cfg.network.use_double)
    use_double = cfg.network.use_double
    if eager:
        return ts, make_learner_step(net, spec, cfg.optim, use_double)
    return ts, make_dispatch_step(net, spec, cfg.optim, use_double,
                                  steps_per_dispatch)


def path_ks(label: str):
    return (1,) if label == HOST_PATH else KS


def host_learner(cfg, device, blocks, seed: int = 0):
    """A host-placement Learner of ``cfg`` on ``device`` with ``blocks``
    in its host replay; its telemetry off, as the other cells build their
    steps without the diagnostics."""
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    net = NetworkApply(ACTION_DIM, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    learner = Learner(cfg.replace(**{"telemetry.enabled": False}), net,
                      seed=seed)
    for block in blocks:
        learner.ingest(block)
    return learner


def profile_steps(dispatch, dispatches: int):
    """torch.profiler (CPU and CUDA) over ``dispatches`` calls of
    ``dispatch()``; returns the profiler and the calls' wall ms on the
    host clock (from before the first to a sync after the last)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(dispatches):
            dispatch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def device_kernels(prof):
    """The device's own events of a profile (operator rows repeat their
    kernels), in time order. Not the user annotations' device spans (an
    eager ``Optimizer.step#Adam.step`` covers the optimizer's kernels,
    which would then count twice)."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=lambda e: e.time_range.start)


def device_busy_ms(prof) -> float:
    """The sum of the device's kernel and copy time in a profile, ms."""
    return sum(e.time_range.elapsed_us() for e in device_kernels(prof)) / 1e3


def device_union_ms(prof) -> float:
    """The time in a profile when at least one kernel or copy ran, ms:
    ``device_busy_ms`` with overlapping events counted once."""
    total, end = 0, None
    for e in device_kernels(prof):      # in order of start
        start, stop = e.time_range.start, e.time_range.end
        if end is None or start >= end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total / 1e3


class Cell:
    """One path at one K: its train state, its step and its numbers. The
    host path's cell holds a host-placement ``Learner`` filled with
    ``blocks``."""

    def __init__(self, label: str, k: int, cfg, device, spec, rs,
                 blocks=None):
        import torch
        self.label, self.k = label, k
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        self.learner = None
        if cfg.replay.placement == "host":
            self.learner = host_learner(cfg, device, blocks)
            self.ts = self.learner.train_state
        else:
            self.ts, self.step = build_learner_step(cfg, device, spec, k)
        # warm-up: a graph's eager dispatch, its capture and one replay
        self.losses = []
        for _ in range(3):
            self.losses.append(self.dispatch(rs))
        torch.cuda.synchronize()
        ring = 0 if self.learner is not None else spec.device_ring_bytes
        self.peak_gb = (torch.cuda.max_memory_allocated(device) - base
                        + ring) / 1e9
        self.step_ms = []
        self.window_steps = 0
        self.launches = {}
        self.busy_ms = self.union_ms = self.profiled_ms = None
        self.top = []
        if self.learner is not None:
            for kept in self.learner.timings.values():
                kept.clear()

    def dispatch(self, rs):
        """One dispatch; its loss (a device tensor)."""
        if self.learner is not None:
            return self.learner.step()["loss"]
        return self.step(self.ts, rs)[2]["loss"]

    def window(self, rs, steps: int) -> None:
        import torch
        from r2d2_tpu_torch.ops.launch_counts import launch_counts
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps // self.k):
            self.losses.append(self.dispatch(rs))
        torch.cuda.synchronize()
        self.step_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        self.window_steps += steps
        for name, n in launch_counts().items():
            self.launches[name] = (self.launches.get(name, 0) + n
                                   - before[name])

    def profile(self, rs) -> None:
        dispatches = max(1, PROFILE_STEPS // self.k)
        prof, wall_ms = profile_steps(lambda: self.dispatch(rs), dispatches)
        steps = dispatches * self.k
        self.busy_ms = device_busy_ms(prof) / steps
        self.union_ms = device_union_ms(prof) / steps
        self.profiled_ms = wall_ms / steps
        by_name = {}
        for event in device_kernels(prof):
            name = event.name[:TOP_NAME]
            by_name[name] = (by_name.get(name, 0.0)
                             + event.time_range.elapsed_us() / 1e3 / steps)
        self.top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    def close(self) -> None:
        if self.learner is not None:
            self.learner.stop_background()

    def result(self, batch: int) -> dict:
        import torch
        losses = torch.cat([x.reshape(-1) for x in self.losses]).tolist()
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{self.label} K={self.k}: non-finite loss")
        mean_ms = statistics.mean(self.step_ms)
        r = dict(path=self.label, k=self.k, ms_per_step=self.step_ms,
                 seq_updates_per_s=[batch * 1e3 / ms for ms in self.step_ms],
                 median_seq_updates_per_s=statistics.median(
                     batch * 1e3 / ms for ms in self.step_ms),
                 device_busy_ms_per_step=self.busy_ms,
                 device_union_ms_per_step=self.union_ms,
                 profiled_ms_per_step=self.profiled_ms,
                 idle_share=(None if self.busy_ms is None else
                             1.0 - self.busy_ms / mean_ms),
                 idle_share_union=(None if self.union_ms is None else
                                   1.0 - self.union_ms / mean_ms),
                 launches_per_step={name: n / self.window_steps
                                    for name, n in self.launches.items()},
                 peak_gb=self.peak_gb, top_kernels_ms_per_step=self.top,
                 steps=len(losses),
                 loss_first=losses[0], loss_last=losses[-1])
        if self.learner is not None:
            timings = self.learner.timings
            r.update(sample_ms=statistics.median(timings["sample_ms"]),
                     h2d_ms=statistics.median(timings["h2d_ms"]),
                     batches_timed=len(timings["sample_ms"]),
                     dropped_priority_updates=(
                         self.learner.dropped_priority_updates))
        return r


def choose_autos(cells: dict) -> dict:
    """What "auto" resolves to on CUDA, each from a pair of this call's
    medians (see the module docstring); ``cells`` by (path, K)."""
    rate = {key: c["median_seq_updates_per_s"] for key, c in cells.items()}
    speedup = {k: statistics.mean(rate[p, k] / rate[p, KS[0]]
                                  for p in PATHS if p != HOST_PATH)
               for k in KS}
    # the fewest steps a dispatch within K_MARGIN of the best: a larger K
    # coarsens what the host sees (losses, weights) for no measured gain
    best = max(speedup.values())
    k = min(k for k in KS if speedup[k] >= (1 - K_MARGIN) * best)
    return {
        "runtime.steps_per_dispatch": {"value": k,
                                       "mean_speedup_over_k1": speedup},
        "network.pallas_lstm": {
            "value": rate["fused", k] > rate["default", k],
            "fused": rate["fused", k], "default": rate["default", k]},
    }


def run() -> dict:
    import torch
    from r2d2_tpu_torch.utils.device import configure_numerics
    configure_numerics()
    device = torch.device("cuda", 0)
    base = reference_config()
    t0 = time.perf_counter()
    blocks = synthetic_blocks(base, base.num_blocks)
    spec, rs = filled_replay(base, device, blocks)
    torch.cuda.synchronize()
    print(f"reference replay: {spec.num_blocks} blocks, ring "
          f"{spec.device_ring_bytes / 1e9:.2f} GB, filled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cells = {}
    try:
        for label in PATHS:
            for k in path_ks(label):
                cfg = base.replace(**PATHS[label])
                cells[label, k] = Cell(label, k, cfg, device, spec, rs,
                                       blocks)
        order = list(cells) + list(reversed(list(cells)))
        for _ in range(ROUNDS):
            for key in order:
                cells[key].window(rs, WINDOW)
        for cell in cells.values():
            cell.profile(rs)
        results = {key: cell.result(spec.batch_size)
                   for key, cell in cells.items()}
    finally:
        for cell in cells.values():
            cell.close()
    for r in results.values():
        print(f"bench {r['path']} K={r['k']}: "
              f"{r['median_seq_updates_per_s']:.2f} seq-updates/s, ms/step "
              + ", ".join(f"{ms:.3f}" for ms in r["ms_per_step"])
              + f"; device busy {r['device_busy_ms_per_step']:.3f} ms/step "
              f"(union {r['device_union_ms_per_step']:.3f}, profiled steps "
              f"{r['profiled_ms_per_step']:.3f} ms), idle "
              f"{r['idle_share']:.4f} (union {r['idle_share_union']:.4f}), "
              f"peak {r['peak_gb']:.3f} GB, launches/step "
              f"{r['launches_per_step']}"
              + (f"; sample {r['sample_ms']:.3f} ms, H2D {r['h2d_ms']:.3f} "
                 "ms per batch" if "sample_ms" in r else ""), flush=True)
    return dict(card=card_line(), device=torch.cuda.get_device_name(0),
                torch=torch.__version__, cuda=torch.version.cuda,
                shape=dict(batch=spec.batch_size, window=spec.seq_window,
                           frame=[spec.frame_height, spec.frame_width,
                                  spec.frame_stack],
                           cnn_out=base.network.cnn_out_dim,
                           hidden=base.network.hidden_dim,
                           capacity=REF_CAPACITY),
                window_steps=WINDOW, windows=2 * ROUNDS,
                cells=list(results.values()),
                auto=choose_autos(results))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="",
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tools/bench.py measures the card: no CUDA device")
    print(card_line(), flush=True)
    line = json.dumps(run())
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
