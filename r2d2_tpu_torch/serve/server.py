"""The central policy server, the JAX package's ``serve/server.py`` for one
server: micro-batched forwards over a server-held state cache.

One loop owns the server's own copy of the weights and the ``StateCache``;
requests from any transport (serve/transport.py) land in one inbox, and
the micro-batcher folds them into one gather-state -> forward ->
scatter-state dispatch:

    dispatch when the batch fills (``serve.max_batch``)
    or the oldest pending request is ``serve.deadline_ms`` old

A batch pads up to a power-of-two bucket. The forward is the one acting
forward (``actor.policy.make_forward_fn``), the program the local policies
run, so served and local actions agree. Weights come from the weight
service (runtime/weights.py): the server polls its reader every
``serve.weight_poll_interval_s`` and stamps every reply with the adopted
publication.

On the card the server holds its own device copy of the published weights,
never the learner's live module, in the learner's compute dtype (bf16 on
CUDA, as the JAX package serves in bf16 on the TPU; f32 on the CPU, as its
``_force_f32``). The JAX package compiles every bucket ahead of time
(``_warmup``); here each bucket is one CUDA graph over static input
buffers, captured when the server is built. The orchestrator builds the
server before the learner's first dispatch, and the server runs on a
stream of its own; the capture uses ``capture_error_mode="thread_local"``
all the same, so that another thread's CUDA calls (the learner's, the
weight publisher's) cannot fail it. A dispatch gathers the batch's rows
from the cache into pinned staging, copies them into its bucket's static
buffers, replays the graph, copies actions, Q and h' back and writes the
hidden states into the cache. Adopting weights copies into the captured
storage, and the addresses the graph reads are checked before each
replay. The quantized forward's accuracy probe is not in the graph: on a
probe tick (every ``telemetry.quant_probe_interval`` dispatches) the
forward runs once more, eagerly and with its probe (the f32 twin), on the
bucket's inputs after the replay; the graph equals the eager forward bit
for bit, so the probe measures what was served. That costs two eager
forwards every 256 dispatches by default, where a second graph per bucket
would hold a second set of static buffers and captures for a branch that
runs 0.4% of the time.

``ServingStats`` gathers request latency and batch fill on the shared
64-bucket log histogram (telemetry/histogram.py) and the client churn:
the periodic record's ``serving`` block. With a ``telemetry``
(telemetry/core.py) each dispatch observes ``serve/batch_wait`` (the
oldest request's wait), ``serve/enqueue`` (each request's), and around
the replay ``serve/forward`` and ``serve/reply`` (with spans): host time
around the graph's replay, whose readback the forward already waits for.
"""

import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.serve.state_cache import MisroutedClient, StateCache
from r2d2_tpu_torch.telemetry.core import NULL_TELEMETRY
from r2d2_tpu_torch.serve.transport import (KIND_DISCONNECT, KIND_STEP, Reply,
                                            Request, STATUS_EXPIRED,
                                            STATUS_OK, STATUS_RETRY)
from r2d2_tpu_torch.telemetry.histogram import (NBUCKETS, bucket_index,
                                                summarize, value_counts_np,
                                                value_summary)
from r2d2_tpu_torch.telemetry.compile import compile_event
from r2d2_tpu_torch.utils.device import gc_paused


def serve_buckets(max_batch: int) -> List[int]:
    """Power-of-two dispatch widths up to ``max_batch`` (itself the last
    bucket when not a power of two)."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def collect_batch(inbox: "queue.Queue", first, max_batch: int,
                  deadline_s: float, expected: Optional[int] = None) -> list:
    """The micro-batch fill loop: from ``first`` (already popped), keep
    pulling until the batch fills or the oldest request (``first``) is
    ``deadline_s`` past its arrival.

    ``expected``: how many clients can have a request outstanding (a
    blocking client holds at most one); once that many are in, waiting
    longer only adds latency, so the wait stops, but what is already
    pending is still taken up to ``max_batch``. The deadline bounds the
    wait only: a backlog is drained even when ``first`` arrived long ago,
    or a busy server would fall into dispatches of one stale request."""
    batch = [first]
    deadline = first[0].t_recv + deadline_s
    target = (max_batch if expected is None
              else min(max_batch, max(int(expected), 1)))
    while len(batch) < max_batch:
        remaining = deadline - time.monotonic()
        if len(batch) >= target or remaining <= 0:
            try:
                batch.append(inbox.get_nowait())
                continue           # a backlog: take it, don't wait
            except queue.Empty:
                break
        try:
            batch.append(inbox.get(timeout=remaining))
        except queue.Empty:
            break
    return batch


class ServingStats:
    """Thread-safe serving aggregator, shared by the server loop and (in
    process) its clients: request latency and batch fill on the 64-bucket
    log histogram, dispatch causes and client churn. ``interval_block``
    consumes the interval; ``timeouts`` and ``disconnects`` stay
    cumulative in it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lat = np.zeros(NBUCKETS, np.int64)
        self._fill = np.zeros(NBUCKETS, np.int64)
        self._fill_sum = 0
        self._batches = 0
        self._full = 0
        self._deadline = 0
        self._starved = 0
        self._requests = 0
        self._replies = 0
        self._expired = 0
        self.timeouts_total = 0
        self.disconnects_total = 0
        self._connects = 0
        self._reconnects = 0
        self._evictions = 0
        self.active_clients = 0
        # the admission sub-block exists only with admission control on
        self.admission_enabled = False
        self._shed = 0
        self._adm_lat = np.zeros(NBUCKETS, np.int64)
        # a ServeTrace with telemetry.tracing_enabled: the block then has
        # a trace sub-block; None keeps it what it is without tracing
        self.trace = None

    def on_request_latency(self, seconds: float) -> None:
        """One client-visible completion (or timed-out attempt)."""
        with self._lock:
            self._lat[bucket_index(seconds)] += 1

    def on_timeout(self, seconds: float) -> None:
        with self._lock:
            self.timeouts_total += 1
        self.on_request_latency(seconds)

    def on_batch(self, fill: int, hit_full: bool, hit_deadline: bool,
                 starved: bool) -> None:
        counts = value_counts_np(np.asarray([fill], np.float64))
        with self._lock:
            self._fill += counts
            self._fill_sum += fill
            self._batches += 1
            self._full += int(hit_full)
            self._deadline += int(hit_deadline)
            self._starved += int(starved)

    def on_requests(self, n: int = 1) -> None:
        with self._lock:
            self._requests += n

    def on_replies(self, n: int = 1) -> None:
        with self._lock:
            self._replies += n

    def on_expired(self, n: int = 1) -> None:
        with self._lock:
            self._expired += n

    def on_shed(self, n: int = 1) -> None:
        """Requests refused at the queue-depth bound (STATUS_RETRY): seen,
        never dispatched."""
        with self._lock:
            self._shed += n
            self._requests += n

    def on_admitted_latency(self, seconds: float) -> None:
        """Server-side receive -> reply latency of an admitted request."""
        with self._lock:
            self._adm_lat[bucket_index(seconds)] += 1

    def on_clients(self, connects: int = 0, reconnects: int = 0,
                   disconnects: int = 0, evictions: int = 0) -> None:
        with self._lock:
            self._connects += connects
            self._reconnects += reconnects
            self.disconnects_total += disconnects
            self._evictions += evictions

    def interval_block(self, deadline_ms: Optional[float] = None,
                       max_batch: Optional[int] = None) -> Optional[dict]:
        """The record's ``serving`` block; consumes the interval. None when
        the interval saw no serving traffic (the block is then left
        out)."""
        with self._lock:
            if (self._requests == 0 and self._batches == 0
                    and not self._lat.any()):
                return None
            fill = value_summary(self._fill)
            n = self._batches
            block = {
                "requests": self._requests,
                "replies": self._replies,
                "expired": self._expired,
                "timeouts": self.timeouts_total,       # cumulative
                "latency": summarize(self._lat),
                "batch": {
                    "count": n,
                    "fill_mean": (round(self._fill_sum / n, 2) if n
                                  else None),
                    "fill_p50": fill.get("p50") if fill else None,
                    "fill_p99": fill.get("p99") if fill else None,
                    "full_frac": round(self._full / n, 3) if n else None,
                    "deadline_frac": (round(self._deadline / n, 3) if n
                                      else None),
                    "starved_frac": (round(self._starved / n, 3) if n
                                     else None),
                },
                "clients": {
                    "active": self.active_clients,
                    "connects": self._connects,
                    "reconnects": self._reconnects,
                    "disconnects": self.disconnects_total,  # cumulative
                    "evictions": self._evictions,
                },
            }
            if deadline_ms is not None:
                block["deadline_ms"] = deadline_ms
            if max_batch is not None:
                block["max_batch"] = max_batch
            if self.admission_enabled:
                block["admission"] = {
                    "shed": self._shed,
                    "shed_frac": (round(self._shed / self._requests, 3)
                                  if self._requests else 0.0),
                    "misrouted": 0,
                    "admitted_latency": summarize(self._adm_lat),
                }
            if self.trace is not None:
                tr = self.trace.interval_block()
                if tr is not None:
                    block["trace"] = tr
            self._lat[:] = 0
            self._fill[:] = 0
            self._fill_sum = 0
            self._batches = self._full = self._deadline = self._starved = 0
            self._requests = self._replies = self._expired = 0
            self._connects = self._reconnects = self._evictions = 0
            self._shed = 0
            self._adm_lat[:] = 0
        return block


def serving_network(net, device):
    """The server's network on ``device``: the learner's compute policy on
    CUDA (bf16 by default), f32 on the CPU."""
    import dataclasses

    from r2d2_tpu_torch.models.network import NetworkApply
    device = torch.device(device)
    config = net.config
    if device.type != "cuda":
        config = dataclasses.replace(config, bf16="off")
    h, w, s = net.obs_hw
    return NetworkApply(net.action_dim, config, s, h, w, device)


class _BucketGraph:
    """One dispatch bucket on the card: static input buffers, the CUDA
    graph of the forward over them, its outputs, pinned host staging both
    ways, and the launches its capture counted (added once a replay)."""

    def __init__(self, server: "PolicyServer", bucket: int):
        from r2d2_tpu_torch.ops.launch_counts import (add_launch_counts,
                                                      captured_launches,
                                                      launch_counts)
        dev = server.device
        h, w, s = server.net.obs_hw
        hd = server.net.config.hidden_dim
        a = server.net.action_dim
        self.bucket = bucket
        self.obs = torch.zeros((bucket, h, w, s), device=dev)
        self.last_action = torch.full((bucket,), -1, dtype=torch.int64,
                                      device=dev)
        self.hidden = torch.zeros((bucket, 2, hd), device=dev)
        self.obs_h = torch.zeros(self.obs.shape, pin_memory=True)
        self.last_action_h = torch.full((bucket,), -1, dtype=torch.int64,
                                        pin_memory=True)
        self.hidden_h = torch.zeros(self.hidden.shape, pin_memory=True)
        self.actions_h = torch.zeros((bucket,), dtype=torch.int64,
                                     pin_memory=True)
        self.q_h = torch.zeros((bucket, a), pin_memory=True)
        self.h_h = torch.zeros((bucket, 2, hd), pin_memory=True)
        # warm-up on the server's stream, then the capture
        for _ in range(2):
            server._eager(self.obs, self.last_action, self.hidden)
        server.stream.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        with compile_event("serve_forward",
                           f"bucket={bucket} quant={server._quant}"), \
                gc_paused(), captured_launches(server.stream) as counted, \
                torch.cuda.graph(self.graph, stream=server.stream,
                                 capture_error_mode="thread_local"):
            self.out = server._eager(self.obs, self.last_action, self.hidden)
        # the static buffers and what the capture reserved
        self.nbytes = (sum(t.nbytes for t in (self.obs, self.last_action,
                                              self.hidden, *self.out))
                       + max(torch.cuda.memory_reserved(dev) - reserved, 0))
        self.launches = {name: counted.get(name, 0)
                         for name in launch_counts()}
        # a capture launches nothing: its counts come back once a replay
        add_launch_counts({name: -n for name, n in self.launches.items()})
        self.addresses = server._weight_addresses()


class PolicyServer:
    """The server loop. Construction copies the weights onto the server's
    device and (``serve.warmup``) captures every bucket's graph on CUDA or
    runs every bucket once on the CPU; ``start()`` starts the loop's
    thread, ``stop()`` ends it. The inbox (an ``InprocEndpoint``) and the
    shm/socket transports are outside the server and outlive it.

    ``weight_poll``/``weight_version``: the weight service's reader pair
    (``lambda: store.poll("serve")`` and ``lambda:
    store.reader_version("serve")``, or a ``WeightSubscriber``'s ``poll``
    and ``publish_count``). ``client_timed=True``: in-process clients feed
    the latency histogram themselves (round trip with queueing and
    retries), so the server does not. ``device``: the server's device
    (default: ``net``'s). ``telemetry``: where the ``serve/*`` stages go
    (none by default)."""

    def __init__(self, cfg, net, params, *, endpoint,
                 weight_poll: Optional[Callable] = None,
                 weight_version: Optional[Callable[[], int]] = None,
                 stats: Optional[ServingStats] = None,
                 client_timed: bool = False, warmup: Optional[bool] = None,
                 quant_stats=None, cache=None,
                 queue_depth_bound: Optional[int] = None, device=None,
                 telemetry=None):
        from r2d2_tpu_torch.actor.policy import (InferenceTwin, as_bundle,
                                                 make_forward_fn)
        sv = cfg.serve
        self.cfg = cfg
        self.max_batch = sv.max_batch
        self.deadline_s = sv.deadline_ms / 1e3
        self.ttl_s = sv.request_ttl_s
        self._weight_poll = weight_poll
        self._weight_version_fn = weight_version
        self.weight_version = int(weight_version()) if weight_version else 0
        self.stats = stats if stats is not None else ServingStats()
        self.telemetry = (telemetry if telemetry is not None
                          else NULL_TELEMETRY)
        self._client_timed = client_timed
        self.endpoint = endpoint
        self.queue_depth_bound = (sv.queue_depth_bound
                                  if queue_depth_bound is None
                                  else queue_depth_bound)
        if self.queue_depth_bound > 0:
            self.stats.admission_enabled = True
        self.device = torch.device(device if device is not None
                                   else net.device)
        self.net = serving_network(net, self.device)
        self.action_dim = self.net.action_dim
        self._quant = self.net.config.inference_dtype != "f32"
        self.quant_stats = quant_stats
        self._quant_probe_interval = (cfg.telemetry.quant_probe_interval
                                      if self._quant else 0)
        # the forward without the probe (what the graphs capture), and
        # with it (a probe tick runs it after, on the same inputs)
        self._fwd = make_forward_fn(self.net)
        self._fwd_probe = make_forward_fn(
            self.net, probe_interval=self._quant_probe_interval)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        with self._on_stream():
            if self._quant:
                self.twin = InferenceTwin(self.net,
                                          as_bundle(self.net, params),
                                          self.device)
                self.module = None
            else:
                self.twin = None
                self.module = self.net.build().eval().requires_grad_(False)
                self._load_module(params)
        h, w, s = self.net.obs_hw
        self.cache = (cache if cache is not None
                      else StateCacheFromConfig(cfg, (h, w), s,
                                                self.net.config.hidden_dim,
                                                self.action_dim))
        self.buckets = serve_buckets(self.max_batch)
        self._graphs: Dict[int, _BucketGraph] = {}
        self.warmed_buckets: List[int] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_weight_poll = 0.0
        self._last_sweep = 0.0
        self.batches_dispatched = 0
        self.rows_served = 0             # replies of dispatched forwards
        # per bucket: dispatches and the forward's ms (CUDA events on the
        # card, the host clock on the CPU)
        self.forward_ms: Dict[int, List[float]] = {b: [0, 0.0]
                                                    for b in self.buckets}
        if warmup if warmup is not None else sv.warmup:
            self._warmup()

    # -- weights --

    def _on_stream(self):
        import contextlib
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _load_module(self, params) -> None:
        """Copy weights into the server's module, in place."""
        from r2d2_tpu_torch.models.network import named_params
        source = named_params(self.net, params if not isinstance(
            params, np.ndarray) else torch.from_numpy(params))
        with torch.no_grad():
            for p, v in zip(self.module.parameters(), source.values()):
                p.copy_(v)

    def _adopt(self, fresh) -> None:
        from r2d2_tpu_torch.actor.policy import as_bundle
        with self._on_stream():
            if self._quant:
                bundle = as_bundle(self.net, torch.as_tensor(fresh))
                if self.quant_stats is not None:
                    self.quant_stats.on_stamp(bundle["stamp"])
                self.twin.load_(bundle)
            else:
                self._load_module(fresh)

    def _weight_tensors(self) -> List[torch.Tensor]:
        if self._quant:
            return self.twin.tensors()
        return list(self.module.parameters())

    def _weight_addresses(self) -> List[int]:
        return [t.data_ptr() for t in self._weight_tensors()]

    # -- the forward --

    def _eager(self, obs, last_action, hidden):
        """The forward on device tensors (or host arrays on the CPU):
        (actions, q, h')."""
        if self._quant:
            actions, q, h, _ = self._fwd(self.twin, obs, last_action, hidden,
                                         1, 0)
            return actions, q, h
        return self._fwd(self.module, obs, last_action, hidden)

    def eager_forward(self, obs, last_action, hidden):
        """The same forward without the graph, on the server's stream and
        synchronised (the check against the bucket graphs)."""
        with self._on_stream():
            out = self._eager(obs, last_action, hidden)
        if self.stream is not None:
            self.stream.synchronize()
        return out

    def _warmup(self) -> None:
        """Every dispatch bucket at start: on CUDA its graph is captured,
        on the CPU it runs once."""
        h, w, s = self.net.obs_hw
        hd = self.net.config.hidden_dim
        for b in self.buckets:
            if self.device.type == "cuda":
                with self._on_stream():
                    self._graphs[b] = _BucketGraph(self, b)
            else:
                self._eager(np.zeros((b, h, w, s), np.float32),
                            np.full(b, -1, np.int64),
                            np.zeros((b, 2, hd), np.float32))
            self.warmed_buckets.append(b)
        if (self._graphs and self.cfg.telemetry.enabled
                and self.cfg.telemetry.resources_enabled):
            from r2d2_tpu_torch.telemetry.resources import register_buffer
            register_buffer("serve/graphs",
                            sum(g.nbytes for g in self._graphs.values()))

    def aot_coverage(self) -> dict:
        """The buckets made at start (captured on CUDA, run once on the
        CPU) against the buckets a dispatch can take: a missing one would
        be made mid-run."""
        from r2d2_tpu_torch.telemetry.compile import aot_coverage
        return aot_coverage(self.buckets, self.warmed_buckets)

    def graph_forward(self, bucket: int, obs, last_action, hidden):
        """One replay of ``bucket``'s graph on these inputs (host arrays,
        ``bucket`` rows): (actions, q, h') as host arrays. Only while the
        loop is stopped: it uses the loop's staging buffers."""
        g = self._graphs[bucket]
        g.obs_h.numpy()[:] = obs
        g.last_action_h.numpy()[:] = last_action
        g.hidden_h.numpy()[:] = hidden
        return self._replay(g)

    def _replay(self, g: _BucketGraph):
        """Copy the staged inputs in, replay, copy out: host (actions, q,
        h')."""
        from r2d2_tpu_torch.ops.launch_counts import add_launch_counts
        if self._weight_addresses() != g.addresses:
            raise RuntimeError("the serving graph reads weights that have "
                               "moved since its capture")
        with torch.cuda.stream(self.stream):
            g.obs.copy_(g.obs_h, non_blocking=True)
            g.last_action.copy_(g.last_action_h, non_blocking=True)
            g.hidden.copy_(g.hidden_h, non_blocking=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.graph.replay()
            end.record()
            add_launch_counts(g.launches)
            actions, q, h = g.out
            g.actions_h.copy_(actions, non_blocking=True)
            g.q_h.copy_(q, non_blocking=True)
            g.h_h.copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        stat = self.forward_ms[g.bucket]
        stat[0] += 1
        stat[1] += start.elapsed_time(end)
        return g.actions_h.numpy(), g.q_h.numpy(), g.h_h.numpy()

    def _forward(self, bucket: int, slots: List[int]):
        """The batch's rows through ``bucket``'s forward: host (actions, q,
        h') of ``bucket`` rows (padding rows after the batch's). On a
        probe tick the quantized forward runs once more, eagerly with its
        probe, on the same inputs."""
        from r2d2_tpu_torch.actor.policy import feed_quant_probe
        fill = len(slots)
        tick = self.batches_dispatched
        idx = np.asarray(slots, np.int64)
        cache = self.cache
        g = self._graphs.get(bucket)
        if g is not None:
            obs, la, hid = (g.obs_h.numpy(), g.last_action_h.numpy(),
                            g.hidden_h.numpy())
            np.take(cache.stacked, idx, axis=0, out=obs[:fill])
            la[:fill] = cache.last_action[idx]          # int32 -> int64
            np.take(cache.hidden, idx, axis=0, out=hid[:fill])
            obs[fill:] = 0.0
            la[fill:] = -1
            hid[fill:] = 0.0
            actions, q, h = self._replay(g)
            inputs = (g.obs, g.last_action, g.hidden)
        else:
            stacked, last_action, hidden = cache.gather(slots)
            if bucket > fill:
                pad = bucket - fill
                stacked = np.concatenate(
                    [stacked, np.zeros((pad,) + stacked.shape[1:],
                                       stacked.dtype)])
                last_action = np.concatenate(
                    [last_action, np.full(pad, -1, last_action.dtype)])
                hidden = np.concatenate(
                    [hidden, np.zeros((pad,) + hidden.shape[1:],
                                      hidden.dtype)])
            t0 = time.perf_counter()
            with self._on_stream():
                actions, q, h = (t.cpu().numpy() for t in self._eager(
                    stacked, last_action, hidden))
            stat = self.forward_ms[bucket]
            stat[0] += 1
            stat[1] += (time.perf_counter() - t0) * 1e3
            inputs = (stacked, last_action, hidden)
        if (self._quant_probe_interval > 0
                and tick % self._quant_probe_interval == 0):
            with self._on_stream():
                probe = self._fwd_probe(self.twin, *inputs, 0, fill)[3]
                probe = tuple(float(x) for x in probe)
            feed_quant_probe(self.quant_stats, self._quant_probe_interval,
                             probe, lanes=fill)
        return actions, q, h

    # -- lifecycle --

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "PolicyServer":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="policy-server")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- the loop --

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    first = self.endpoint.inbox.get(timeout=0.1)
                except queue.Empty:
                    self._idle_work()
                    continue
                batch = collect_batch(self.endpoint.inbox, first,
                                      self.max_batch, self.deadline_s,
                                      expected=self.cache.active_clients)
                self._shed_overflow()
                self._dispatch(batch)
                self._idle_work()
        except Exception:
            logging.getLogger(__name__).exception(
                "policy server loop died; clients will time out and back "
                "off until a replacement starts")

    def _release(self, req: Request, cb: Callable, now: float) -> None:
        try:
            if self.cache.release(req.client_id, now):
                self.stats.on_clients(disconnects=1)
        except MisroutedClient:
            pass                    # not this cache's client: a no-op
        self._safe_reply(cb, Reply(req.req_id, STATUS_OK,
                                   weight_version=self.weight_version))

    def _shed_overflow(self) -> None:
        """Admission control: after a batch fill, shed the oldest queued
        requests while the backlog exceeds ``queue_depth_bound`` (a
        STATUS_RETRY with a retry-after hint of one deadline). Disconnects
        are never shed."""
        bound = self.queue_depth_bound
        if bound <= 0:
            return
        inbox = self.endpoint.inbox
        shed = 0
        while inbox.qsize() > bound:
            try:
                req, cb = inbox.get_nowait()
            except queue.Empty:
                break
            if req.kind == KIND_DISCONNECT:
                self._release(req, cb, time.monotonic())
                continue
            shed += 1
            self._safe_reply(cb, Reply(
                req.req_id, STATUS_RETRY,
                retry_after_ms=self.cfg.serve.deadline_ms))
        if shed:
            self.stats.on_shed(shed)

    def _idle_work(self) -> None:
        now = time.monotonic()
        sv = self.cfg.serve
        if (self._weight_poll is not None
                and now - self._last_weight_poll >= sv.weight_poll_interval_s):
            self._last_weight_poll = now
            fresh = self._weight_poll()
            if fresh is not None:
                self._adopt(fresh)
                if self._weight_version_fn is not None:
                    self.weight_version = int(self._weight_version_fn())
        if now - self._last_sweep >= 1.0:
            self._last_sweep = now
            evicted = self.cache.sweep(now)
            if evicted:
                self.stats.on_clients(evictions=evicted)
            self.stats.active_clients = self.cache.active_clients

    def _dispatch(self, batch: list) -> None:
        now = time.monotonic()
        tele = self.telemetry
        tele.observe("serve/batch_wait", max(now - batch[0][0].t_recv, 0.0))
        for req, _cb in batch:
            tele.observe("serve/enqueue", max(now - req.t_recv, 0.0))
        self.stats.on_requests(len(batch))
        live: List[Tuple[Request, Callable, int]] = []
        cache = self.cache
        ev0, co0, rc0 = cache.evictions, cache.connects, cache.reconnects
        for req, cb in batch:
            if req.kind == KIND_DISCONNECT:
                self._release(req, cb, now)
                continue
            if self.ttl_s > 0 and now - req.t_recv > self.ttl_s:
                # a stale backlog (queued against a dead server): dropped
                # without touching state; the client resends its state
                self.stats.on_expired()
                self._safe_reply(cb, Reply(req.req_id, STATUS_EXPIRED))
                continue
            try:
                slot, fresh = cache.lease(req.client_id, now)
            except MisroutedClient:
                self.stats.on_expired()
                self._safe_reply(cb, Reply(req.req_id, STATUS_EXPIRED))
                continue
            if fresh:
                # first contact, after an eviction, or a server that lost
                # its cache: the episode-reset state
                cache.reset_slot(slot)
                cache.reset_op(slot)
            elif req.op_seq >= 0:
                last = int(cache.op_seq[slot])
                if req.op_seq == last:
                    # a retry of an operation already applied (its reply
                    # was lost): the cached reply, the state untouched
                    action, q = cache.cached_reply(slot)
                    self._safe_reply(cb, Reply(
                        req.req_id, STATUS_OK, action, q,
                        cache.hidden[slot].copy(),
                        weight_version=self.weight_version))
                    self.stats.on_replies(1)
                    continue
                if req.op_seq < last:
                    # older than what was applied: never applied again
                    self.stats.on_expired()
                    self._safe_reply(cb, Reply(req.req_id, STATUS_EXPIRED))
                    continue
            if req.reset_obs is not None:
                cache.reset_slot(slot, req.reset_obs)
            elif req.obs is not None:
                cache.observe(slot, req.obs, req.action)
            live.append((req, cb, slot))
        self.stats.on_clients(connects=cache.connects - co0,
                              reconnects=cache.reconnects - rc0,
                              evictions=cache.evictions - ev0)
        self.stats.active_clients = cache.active_clients
        if not live:
            return
        # tracing: each traced request's route/transit hops and its
        # micro-batch wait (the server's own monotonic clock); the batch's
        # forward and reply hops follow below if any request was traced
        trace = self.stats.trace
        traced_any = False
        if trace is not None:
            for req, _cb, _slot in live:
                tr = getattr(req, "trace", None)
                if tr is not None:
                    traced_any = True
                    trace.on_request(tr, max(now - req.t_recv, 0.0))
        fill = len(live)
        bucket = next(b for b in self.buckets if b >= fill)
        t0 = time.perf_counter()
        actions, q, h = self._forward(bucket, [slot for _, _, slot in live])
        t1 = time.perf_counter()
        tele.observe("serve/forward", t1 - t0)
        if tele.spans.enabled:
            wall = time.time()
            tele.record_span("serve/forward", wall - (t1 - t0), wall,
                             {"fill": fill})
        reply_t = time.monotonic()
        for i, (req, cb, slot) in enumerate(live):
            if req.kind == KIND_STEP:
                cache.write_hidden(slot, h[i])
            if req.op_seq >= 0:
                cache.record_op(slot, req.op_seq, int(actions[i]), q[i])
            self._safe_reply(cb, Reply(
                req.req_id, STATUS_OK, int(actions[i]), q[i].copy(),
                h[i].copy(), weight_version=self.weight_version))
            lat = max(reply_t - req.t_recv, 0.0)
            if not self._client_timed:
                self.stats.on_request_latency(lat)
            if self.stats.admission_enabled:
                self.stats.on_admitted_latency(lat)
        reply_s = time.perf_counter() - t1
        tele.observe("serve/reply", reply_s)
        if tele.spans.enabled:
            wall = time.time()
            tele.record_span("serve/reply", wall - reply_s, wall)
        if traced_any:
            trace.on_batch(t1 - t0, reply_s)
        self.stats.on_replies(fill)
        self.rows_served += fill
        self.stats.on_batch(
            fill, hit_full=len(batch) >= self.max_batch,
            hit_deadline=(len(batch) < self.max_batch
                          and now - batch[0][0].t_recv >= self.deadline_s),
            starved=(fill == 1 and cache.active_clients > 1))
        self.batches_dispatched += 1

    def forward_ms_by_bucket(self) -> Dict[int, Optional[float]]:
        """Mean forward ms per dispatched bucket (None: never used)."""
        return {b: (round(total / n, 4) if n else None)
                for b, (n, total) in self.forward_ms.items()}

    @staticmethod
    def _safe_reply(cb: Callable, reply: Reply) -> None:
        try:
            cb(reply)
        except Exception:
            pass                    # a dead client must not kill the server


def StateCacheFromConfig(cfg, frame_hw, frame_stack, hidden_dim,
                         action_dim: int = 1) -> StateCache:
    sv = cfg.serve
    return StateCache(sv.state_slots, sv.state_shards, frame_hw,
                      frame_stack, hidden_dim,
                      lease_timeout_s=sv.lease_timeout_s,
                      action_dim=action_dim)
