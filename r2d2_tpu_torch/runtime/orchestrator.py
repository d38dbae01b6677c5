"""System bring-up, the JAX package's ``runtime/orchestrator.py`` for one
player: a Learner on the card, a weight service, a block queue, and N
actors on host CPUs with the Ape-X epsilon ladder. Actors start first;
training begins once the replay holds ``replay.learning_starts`` steps;
the loop logs every ``runtime.log_interval`` seconds and supervises the
actors every ``runtime.supervise_interval_s``.

The actors, their weight service, block queue and supervision are an
``ActorPool``; a multi-host controller runs one over its share of the
fleet (parallel/multihost.py). Actor modes:
  * "thread"  actors are threads of this process with CPU policies; they
    read weights from an in-process store and put blocks on a
    ``queue.Queue``.
  * "process" spawned OS processes that never touch CUDA
    (``actor_main.py``): weights through the shared-memory seqlock
    segment, blocks through the native shm ring
    (``runtime.shm_transport``; a ``multiprocessing.Queue`` with it off).

With ``replay.ingest_batch_blocks`` > 1 the learner's stager thread pops
the queue (runtime/learner_loop.py), and the warm-up's ``drain`` commits
what it staged, as the training loop's does. With
``runtime.snapshot_interval`` the record gains the learner's ``recovery``
block; a failed final checkpoint or snapshot fails the run once every
actor is reaped.

The learner publishes through a ``SnapshotPublisher``: a device-side
snapshot on the step's stream, the host copy and the write on a thread of
their own, so actors only ever read host snapshots. At a quantized
``network.inference_dtype`` the publication is the inference bundle,
quantized on the card inside that snapshot.

``actor.inference="server"``: one ``PolicyServer`` (serve/) in this
process, built before the learner's first dispatch, on the card beside
the learner with its own copy of the published weights (it polls the
weight service every ``serve.weight_poll_interval_s``). Actors are thin
clients: thread actors on in-process channels, process actors over the
shm request/reply rings or TCP (``serve.transport``). The periodic record
then has a ``serving`` block, and at a quantized inference dtype a
``quant`` block.

Telemetry (telemetry/core.py, on by default): one ``Telemetry`` in this
process, shared by the learner's threads, thread actors and the server;
process actors publish their stage timers through a ``TelemetryBoard``
that the record's ``stages`` block folds in. Spans drain to
``{save_dir}/spans_player{p}.jsonl`` (process actors: their own
``spans_p{p}_a{i}.jsonl``). The profiler's capture triggers
(telemetry/profiler.py: ``runtime.profile_dir``,
``runtime.profile_at_step``, SIGUSR2) ride the training loop.
"""

import glob
import logging
import multiprocessing as mp
import os
import signal
import threading
import time
from typing import Callable, List, Optional

from r2d2_tpu_torch.config import Config, apex_epsilon
from r2d2_tpu_torch.envs.factory import create_env
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.runtime.actor_loop import (instrument_block_sink,
                                               make_actor_env,
                                               make_actor_policy)
from r2d2_tpu_torch.runtime.actor_main import actor_process_main
from r2d2_tpu_torch.runtime.data_parallel import data_parallel
from r2d2_tpu_torch.runtime.feeder import (BlockQueue, HeartbeatBoard,
                                           IngestStallDetector,
                                           RingRecoveryScheduler,
                                           WorkerHealth, supervise_workers)
from r2d2_tpu_torch.runtime.learner_loop import Learner
from r2d2_tpu_torch.runtime.metrics import TrainMetrics
from r2d2_tpu_torch.telemetry.board import TelemetryBoard
from r2d2_tpu_torch.telemetry.core import NULL_TELEMETRY, Telemetry
from r2d2_tpu_torch.telemetry.profiler import CaptureTriggers
from r2d2_tpu_torch.telemetry.resources import HealthPlane
from r2d2_tpu_torch.telemetry.tracing import tracing_on
from r2d2_tpu_torch.runtime.weights import (InProcWeightStore,
                                            SnapshotPublisher,
                                            WeightPublisher,
                                            WeightSubscriber,
                                            make_publish_preparer)
from r2d2_tpu_torch.utils.device import configure_numerics, resolve_device

JOIN_S = 5.0                # a worker's join before terminate/kill


class ActorPool:
    """One player's actors with their weight service, block queue and
    supervision. Actor i is the fleet's global actor ``actor_base + i`` of
    ``total_actors``: its Ape-X epsilon, seed, env and lanes. One host
    runs the whole fleet (``actor_base`` 0, ``total_actors`` =
    ``actor.num_actors``); a multi-host controller runs its share
    (parallel/multihost.py). Heartbeat slot i is actor i's.

    ``open_threads``/``open_processes`` build the weight service and the
    queue (and for process actors, with ``telemetry`` on, the board they
    publish their stage timers to), ``spawn_actors`` starts one actor a
    slot; ``close`` (after the stop event is set) reaps them and unlinks
    every segment."""

    def __init__(self, cfg: Config, net, player_idx: int = 0, *,
                 actor_base: int = 0, total_actors: Optional[int] = None,
                 quant_stats=None, telemetry=None):
        self.cfg = cfg
        self.net = net
        self.player_idx = player_idx
        self.n_slots = cfg.actor.num_actors
        self.actor_base = actor_base
        self.total_actors = total_actors or self.n_slots
        self.quant_stats = quant_stats
        self.telemetry = telemetry if telemetry is not None \
            else NULL_TELEMETRY
        self.tele_board: Optional[TelemetryBoard] = None
        self.threads: List[threading.Thread] = []
        self.processes: List[mp.Process] = []
        self._seen_dead: set = set()
        self._ring_recovery = RingRecoveryScheduler()
        self.heartbeats = HeartbeatBoard(self.n_slots)
        # the shared-memory segments this pool creates (close unlinks)
        self.segment_names = [self.heartbeats.name]
        self.health = WorkerHealth.from_runtime(self.n_slots, self.heartbeats,
                                                cfg.runtime)
        self.store: Optional[InProcWeightStore] = None
        self.publisher: Optional[WeightPublisher] = None
        self.queue: Optional[BlockQueue] = None
        self._stop = None
        self._ctx = None
        # served actors (PlayerStack's policy server): thread actors'
        # in-process endpoint, process actors' rung to it
        self.serve_endpoint = self.serve_stats = None
        self._serve_spec = None
        # the resources/compile/alerts plane (PlayerStack's; a multi-host
        # controller's pool has its own)
        self.health_plane: Optional[HealthPlane] = None

    def open_threads(self, stop: threading.Event, initial) -> None:
        """Thread actors' weight store, ``initial`` its first publication,
        and queue; ``stop`` ends every actor."""
        self.store = InProcWeightStore(initial)
        self.queue = BlockQueue(use_mp=False)
        self._stop = stop

    def open_processes(self, stop_event, initial, shm_spec) -> None:
        """Process actors' weight segment and queue (the native shm ring of
        ``shm_spec`` with ``runtime.shm_transport``)."""
        cfg = self.cfg
        self._ctx = mp.get_context("spawn")
        self.publisher = WeightPublisher(initial)
        self.segment_names.append(self.publisher.name)
        self.queue = BlockQueue(
            use_mp=True, ctx=self._ctx,
            shm_spec=shm_spec if cfg.runtime.shm_transport else None,
            tracing=tracing_on(cfg))
        if cfg.runtime.shm_transport:
            self.segment_names.append(self.queue._q.name)
        if self.telemetry.enabled:
            self.tele_board = TelemetryBoard(self.n_slots)
            self.segment_names.append(self.tele_board.name)
            self.telemetry.attach_board(self.tele_board)
            if self.health_plane is not None:
                self.health_plane.resources.attach_board(self.tele_board)
        self._stop = stop_event

    def publication(self):
        """(publish, publish_count) of the weight service."""
        if self.publisher is not None:
            return (self.publisher.publish,
                    lambda: self.publisher.publish_count)
        return self.store.publish, lambda: self.store.publish_count

    def spawn_actors(self) -> None:
        if self._ctx is not None:
            workers, spawn = self.processes, self._spawn_process_actor
        else:
            workers, spawn = self.threads, self._spawn_thread_actor
        for i in range(self.n_slots):
            workers.append(spawn(i))

    def _spawn_thread_actor(self, i: int) -> threading.Thread:
        cfg = self.cfg
        gidx = self.actor_base + i
        seed = cfg.runtime.seed + 10_000 * self.player_idx + 100 * gidx
        # create_env through this module's symbol: tests monkeypatch it
        env = make_actor_env(cfg, self.player_idx, gidx, seed,
                             env_factory=create_env)
        # the watchdog cannot kill a thread: it sets this event and
        # abandons the incarnation
        cancel = threading.Event()

        def should_stop(cancel=cancel):
            return self._stop.is_set() or cancel.is_set()

        served = self.serve_endpoint is not None
        # the current snapshot, fresh on a respawn too (adopted: its
        # version is the stamp until the next poll)
        policy, run_loop = make_actor_policy(
            cfg, self.net,
            None if served else self.store.current(reader_id=i), gidx, seed,
            total_actors=self.total_actors,
            serve_channel=self.serve_endpoint.connect() if served else None,
            serve_stats=self.serve_stats, should_stop=should_stop,
            quant_stats=self.quant_stats)
        self.heartbeats.reset_slot(i)
        tele = self.telemetry
        sink = instrument_block_sink(
            lambda b: self.queue.put_patient(
                b, should_stop, beat=lambda: self.heartbeats.touch(i),
                telemetry=tele),
            i, board=self.heartbeats, telemetry=tele,
            # served: the server's publication, riding each reply
            weight_version=((lambda: policy.weight_version) if served
                            else (lambda: self.store.reader_version(i))),
            lane_base=gidx * cfg.actor.envs_per_actor,
            trace_every=(cfg.telemetry.trace_sample_every
                         if tracing_on(cfg) else 0))

        def loop():
            try:
                run_loop(cfg, env, policy, block_sink=sink,
                         weight_poll=((lambda: None) if served
                                      else (lambda: self.store.poll(i))),
                         should_stop=should_stop, telemetry=tele)
            except Exception:
                if not should_stop():
                    raise
            finally:
                if served:
                    policy.close()

        t = threading.Thread(target=loop, daemon=True,
                             name=f"actor-p{self.player_idx}-{gidx}")
        t.health_cancel = cancel
        t.start()
        return t

    def _spawn_process_actor(self, i: int) -> mp.Process:
        cfg = self.cfg
        gidx = self.actor_base + i
        eps = apex_epsilon(gidx, self.total_actors, cfg.actor.base_eps,
                           cfg.actor.eps_alpha)
        self.heartbeats.reset_slot(i)
        if self.tele_board is not None:
            # a fresh incarnation's cumulative counts start at zero
            self.tele_board.reset_slot(i)
        p = self._ctx.Process(
            target=actor_process_main,
            args=(cfg.to_dict(), self.player_idx, gidx, eps,
                  self.publisher.name, self.queue._q, self._stop),
            kwargs={"health_board": self.heartbeats, "health_slot": i,
                    "total_actors": self.total_actors,
                    "serve_spec": self._serve_spec,
                    "telemetry_board": self.tele_board},
            daemon=True, name=f"actor-p{self.player_idx}-{gidx}")
        p.start()
        return p

    def _respawn(self, i: int):
        """Slot i's next actor, of the pool's mode."""
        if self._ctx is not None:
            return self._spawn_process_actor(i)
        return self._spawn_thread_actor(i)

    def supervise(self) -> int:
        """One health pass: respawn dead actors (with
        runtime.restart_dead_actors), kill and respawn hung ones, apply
        the backoff and the breaker, and reclaim the shm ring slots of dead
        producers (whether or not they respawn). Returns the restarts."""
        if self._stop is None or self._stop.is_set():
            return 0
        processes = self._ctx is not None
        restarted = supervise_workers(
            self.processes if processes else self.threads, self._seen_dead,
            respawn=(self._respawn if self.cfg.runtime.restart_dead_actors
                     else None),
            ring=self._ring_recovery if processes else None,
            health=self.health)
        self.health.ring_slots_recovered += self._ring_recovery.tick(
            self.queue)
        return restarted

    def close(self) -> None:
        """Close the weight service, stop and reap every actor, and unlink
        every segment. Set the stop event first."""
        if self.publisher is not None:
            self.publisher.close()
        deadline = time.monotonic() + JOIN_S
        while (any(p.is_alive() for p in self.processes)
               and time.monotonic() < deadline):
            # a child may wait on a full queue: drain it while they exit
            if self.queue is not None:
                self.queue.drain(64)
            for p in self.processes:
                p.join(timeout=0.05)
        for p in self.processes:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=2.0)
        for t in self.threads:
            t.join(timeout=JOIN_S)
        if self.queue is not None:
            self.queue.close()
        self.heartbeats.close()
        if self.tele_board is not None:
            self.tele_board.close()


def start_span_drain(telemetry, save_dir: str, own: str, actor_files,
                     resume: bool) -> None:
    """Start ``telemetry``'s drain into ``{save_dir}/{own}``; a fresh run
    first removes an earlier run's actor span files there, those the glob
    patterns ``actor_files`` match (process actors append, so that a
    respawn keeps its predecessor's spans: this is the one place that
    clears them)."""
    if not telemetry.enabled:
        return
    save_dir = save_dir or "."
    if not resume:
        stale_files = [path for pattern in actor_files
                       for path in glob.glob(os.path.join(save_dir, pattern))]
        for stale in stale_files:
            try:
                os.remove(stale)
            except OSError:
                pass
    telemetry.start_drain(os.path.join(save_dir, own), append=resume)


class PlayerStack(ActorPool):
    """One player's learner, metrics, weight service, block queue and
    actors (the whole fleet: ``ActorPool``), and its policy server."""

    def __init__(self, cfg: Config, player_idx: int, action_dim: int,
                 device, mesh=None):
        net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                           cfg.env.frame_height, cfg.env.frame_width, device)
        self.metrics = TrainMetrics(player_idx, cfg.runtime.save_dir,
                                    resume=bool(cfg.runtime.resume))
        # one Telemetry for this process, attached before the learner is
        # built so that none of its observations is lost
        telemetry = Telemetry.from_config(cfg, name=f"learner-p{player_idx}")
        self.metrics.set_telemetry(telemetry)
        self.learner = Learner(cfg, net, player_idx=player_idx,
                               metrics=self.metrics, mesh=mesh)
        if cfg.runtime.snapshot_interval > 0:
            self.metrics.set_recovery(self.learner.recovery_block)
        # the replay service's socket rung (remote producers route blocks
        # in) and the record's replay_service block
        self.service_server = None
        if (cfg.fleet.service_transport == "socket"
                and self.learner.service is not None):
            from r2d2_tpu_torch.fleet.replay_service import (
                ReplayServiceServer)
            self.service_server = ReplayServiceServer(
                self.learner.service, cfg.fleet.service_host,
                cfg.fleet.service_port)
        if cfg.fleet.active and cfg.telemetry.enabled:
            self.metrics.set_replay_service(self._replay_service_block)
        # the quantized plane: the probe's aggregator, shared by thread
        # actors and the server
        quant_stats = None
        if cfg.network.inference_dtype != "f32":
            from r2d2_tpu_torch.telemetry import QuantStats
            quant_stats = QuantStats(cfg.network.inference_dtype,
                                     cfg.telemetry.quant_probe_interval)
            self.metrics.set_quant(quant_stats.interval_block)
        super().__init__(cfg, net, player_idx, quant_stats=quant_stats,
                         telemetry=telemetry)
        self._stall = IngestStallDetector(cfg.runtime.ingest_stall_timeout_s)
        self.snapshots: Optional[SnapshotPublisher] = None
        # the publish-time quantizer (None at "f32")
        self._prepare = make_publish_preparer(self.net)
        # the serving plane: the endpoint and the stats outlive a server;
        # in-process clients share the stats, so the serving block's
        # latency is the clients' round trip
        self.serve_server = None
        self._serve_transport = None
        self._serve_sub: Optional[WeightSubscriber] = None
        if cfg.actor.inference == "server":
            from r2d2_tpu_torch.serve import InprocEndpoint, ServingStats
            self.serve_stats = ServingStats()
            if tracing_on(cfg):
                from r2d2_tpu_torch.telemetry.tracing import ServeTrace
                self.serve_stats.trace = ServeTrace()
            self.serve_endpoint = InprocEndpoint()
            self.metrics.set_serving(lambda: self.serve_stats.interval_block(
                deadline_ms=cfg.serve.deadline_ms,
                max_batch=cfg.serve.max_batch))
        start_span_drain(telemetry, cfg.runtime.save_dir,
                         f"spans_player{player_idx}.jsonl",
                         [f"spans_p{player_idx}_a*.jsonl"],
                         bool(cfg.runtime.resume))
        # the resources block and the alert engine, wired last (the alert
        # stream's truncation is file I/O); the server's buckets are its
        # pre-capture coverage
        self.health_plane = HealthPlane.from_config(
            cfg, self.metrics, player_idx, devices=[device],
            aot_coverage_fn=lambda: (self.serve_server.aot_coverage()
                                     if self.serve_server is not None
                                     else None))

    def _replay_service_block(self) -> Optional[dict]:
        """The record's ``replay_service`` block: the service's shards,
        spill tier and grouped ingest, and the socket rung's interval
        stats (membership and fan-out are ROADMAP A.6's second part)."""
        if self.learner.service is None:
            return None
        block = self.learner.service.interval_block()
        if self.service_server is not None:
            block["socket"] = self.service_server.interval_stats()
        return block

    def _initial_payload(self):
        """The weight service's first publication: the learner's module,
        or at a quantized dtype the bundle stamped 1."""
        module = self.learner.full_params()
        return module if self._prepare is None else self._prepare(module, 1)

    def _wire_publish(self) -> None:
        publish, publish_count = self.publication()
        self.snapshots = SnapshotPublisher(publish,
                                           self.learner.full_params(),
                                           net=self.net,
                                           publish_count=publish_count)
        self.learner.publish = self.snapshots
        self.learner.weight_version_fn = publish_count

    def _start_serve_server(self, weight_poll, weight_version,
                            client_timed: bool) -> None:
        """The one PolicyServer, on the learner's device with its own copy
        of the current weights (its bucket graphs are captured here,
        before the learner's first dispatch)."""
        from r2d2_tpu_torch.serve import PolicyServer
        self.serve_server = PolicyServer(
            self.cfg, self.net, self.learner.full_params(),
            endpoint=self.serve_endpoint, weight_poll=weight_poll,
            weight_version=weight_version, stats=self.serve_stats,
            client_timed=client_timed, quant_stats=self.quant_stats,
            telemetry=self.telemetry).start()

    # -- thread actors --

    def start_actors_threads(self, stop: threading.Event) -> None:
        self.open_threads(stop, self._initial_payload())
        self._wire_publish()
        if self.serve_endpoint is not None:
            # the server reads the store under a reader id of its own
            self._start_serve_server(
                lambda: self.store.poll("serve"),
                lambda: self.store.reader_version("serve"),
                client_timed=True)
        self.spawn_actors()

    # -- process actors --

    def start_actors_processes(self, stop_event) -> None:
        self.open_processes(stop_event, self._initial_payload(),
                            self.learner.spec)
        self._wire_publish()
        if self.serve_endpoint is not None:
            self._start_serve_transport()
        self.spawn_actors()

    def _start_serve_transport(self) -> None:
        """Process actors' rung to the server in this process: the shm
        request/reply rings (``serve.transport`` "shm", or "auto" where
        the native ring builds) or TCP on loopback. The server reads the
        weights through one more subscriber of the publisher's segment
        and times requests itself (its clients are elsewhere)."""
        cfg = self.cfg
        sub = self._serve_sub = WeightSubscriber(
            self.publisher.name, self.publisher.num_weights, untrack=False)
        if cfg.serve.transport in ("auto", "shm"):
            try:
                from r2d2_tpu_torch.serve import ShmServeTransport
                self._serve_transport = ShmServeTransport(
                    self.serve_endpoint.submit,
                    (cfg.env.frame_height, cfg.env.frame_width),
                    self.net.action_dim, cfg.network.hidden_dim,
                    request_slots=cfg.serve.request_ring_slots,
                    clients_are_children=True, tracing=tracing_on(cfg))
                self._serve_spec = {
                    "transport": "shm",
                    "request_ring": self._serve_transport.request_ring,
                    "action_dim": self.net.action_dim,
                    "hidden_dim": cfg.network.hidden_dim,
                    "reply_slots": max(cfg.serve.reply_ring_slots,
                                       cfg.actor.envs_per_actor)}
                self.segment_names.append(
                    self._serve_transport.request_ring.name)
            except Exception as e:
                if cfg.serve.transport == "shm":
                    raise
                logging.getLogger(__name__).warning(
                    "the native shm serve transport is unavailable (%s); "
                    "serving over TCP on loopback", e)
        if self._serve_spec is None:
            from r2d2_tpu_torch.serve import SocketServerTransport
            self._serve_transport = SocketServerTransport(
                self.serve_endpoint.submit, cfg.serve.host, cfg.serve.port)
            self._serve_spec = {"transport": "socket",
                                "host": self._serve_transport.host,
                                "port": self._serve_transport.port}
        self._start_serve_server(sub.poll, lambda: sub.publish_count,
                                 client_timed=False)

    # -- supervision --

    def supervise(self) -> int:
        """The pool's health pass, then the stall detector; the counters go
        into the metrics. Returns the restarts."""
        if self._stop is None or self._stop.is_set():
            return 0
        restarted = super().supervise()
        workers = self.processes or self.threads
        self._stall.check(
            self.metrics.ingest_blocks_total,
            sum(1 for w in workers if w.is_alive()),
            self.learner.ingestion_paused,
            diagnostics=self._stall_diagnostics)
        self.metrics.set_actor_health(
            {**self.health.snapshot(),
             "ingest_stall_dumps": self._stall.dumps})
        if self.health_plane is not None:
            self.health_plane.tick(self.learner.warm)
        return restarted

    def _stall_diagnostics(self) -> dict:
        return {
            "heartbeat_ages_s": [round(float(a), 1)
                                 for a in self.heartbeats.ages()],
            "queue_depth": self.queue.qsize(),
            "buffer_steps": self.learner.ring.buffer_steps,
            "ingestion_paused": self.learner.ingestion_paused,
            "training_steps": self.learner.training_steps,
        }

    def close(self) -> None:
        """Stop the learner's threads, write out queued publications, then
        the pool's close (actors reaped, segments unlinked); the server
        last, so an actor still in an exchange gets its reply. Set the
        stop event first."""
        if self.service_server is not None:
            self.service_server.close()
        self.learner.stop_background()
        if self.snapshots is not None:
            self.snapshots.close()
        super().close()
        if self.serve_server is not None:
            self.serve_server.stop()
        if self._serve_transport is not None:
            self._serve_transport.close()
        if self._serve_sub is not None:
            self._serve_sub.close()
        self.telemetry.close()      # the drain thread, the final flush
        if self.health_plane is not None:
            self.health_plane.close()
        self.metrics.close()


def train(cfg: Config, *, max_training_steps: Optional[int] = None,
          max_seconds: Optional[float] = None, actor_mode: str = "thread",
          device=None, log_fn: Optional[Callable[[dict], None]] = None,
          dispatch_hook: Optional[Callable[[PlayerStack], None]] = None,
          mesh_devices=None, mesh_backend: Optional[str] = None
          ) -> PlayerStack:
    """Run the system until ``max_training_steps`` learner steps
    (optim.training_steps), ``max_seconds``, or SIGTERM/SIGINT; returns
    the player's stack, closed, its learner holding the final state.
    ``device``: CUDA by default (raises without one). ``dispatch_hook``
    is called after every learner dispatch with the stack. With
    ``actor.on_device`` the fused act+train loop runs instead
    (runtime/anakin_loop.py), before any env, actor, queue or weight
    service is built; ``actor_mode`` has no meaning there.

    ``mesh.dp`` > 1: this process is rank 0 of a data-parallel run
    (runtime/data_parallel.py starts the other ranks, one GPU each by
    default; ``mesh_devices``/``mesh_backend`` place them explicitly, as
    ``parallel.mesh.make_mesh`` takes them). It keeps the actors, the
    weight service and the log; a stop (deadline, signal, max steps)
    reaches every rank through its commands, and every rank is gone when
    this returns or raises."""
    if cfg.actor.on_device:
        from r2d2_tpu_torch.runtime import anakin_loop
        return anakin_loop.run_anakin_train(
            cfg, max_training_steps=max_training_steps,
            max_seconds=max_seconds, device=device, log_fn=log_fn,
            dispatch_hook=dispatch_hook, mesh_devices=mesh_devices,
            mesh_backend=mesh_backend)
    if actor_mode not in ("thread", "process"):
        raise ValueError(f"actor_mode must be 'thread' or 'process'; got "
                         f"{actor_mode!r}")
    device = resolve_device(device)
    configure_numerics()
    probe = create_env(cfg.env, seed=cfg.runtime.seed)
    action_dim = probe.action_space.n
    probe.close()
    with data_parallel(cfg, device, mesh_devices, mesh_backend) as mesh:
        return _lead(cfg, mesh.device if mesh else device, mesh, action_dim,
                     max_training_steps, max_seconds, actor_mode, log_fn,
                     dispatch_hook)


def _lead(cfg: Config, device, mesh, action_dim: int, max_training_steps,
          max_seconds, actor_mode: str, log_fn, dispatch_hook
          ) -> PlayerStack:
    """The run's one player on rank 0 (the only rank on one device)."""
    stop = (threading.Event() if actor_mode == "thread"
            else mp.get_context("spawn").Event())
    prev_handlers = {}
    st: Optional[PlayerStack] = None
    final_error: Optional[Exception] = None
    triggers = CaptureTriggers(cfg.runtime)
    try:
        if threading.current_thread() is threading.main_thread():
            def _on_signal(signum, frame):
                if stop.is_set():
                    # a second signal: hand back to the previous handler
                    signal.signal(signum,
                                  prev_handlers.get(signum) or signal.SIG_DFL)
                    if signum == signal.SIGINT:
                        raise KeyboardInterrupt
                    return
                stop.set()
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev_handlers[sig] = signal.signal(sig, _on_signal)
                except (ValueError, OSError):
                    pass
        # SIGUSR2's flag handler (main thread only; restored in finally)
        triggers.install()

        t_stack = time.time()
        st = PlayerStack(cfg, 0, action_dim, device, mesh=mesh)
        t_actors = time.time()
        if actor_mode == "thread":
            st.start_actors_threads(stop)
        else:
            st.start_actors_processes(stop)
        learner = st.learner
        # where a start-up's seconds go: the stack (the Learner, its
        # replay and kernels), the actors, then the fill below
        t_fill = time.time()
        st.telemetry.record_span("startup/stack", t_stack, t_actors)
        st.telemetry.record_span("startup/actors", t_actors, t_fill)

        start = time.time()
        deadline = start + max_seconds if max_seconds else None
        last_log = last_supervise = start

        def should_stop() -> bool:
            return stop.is_set() or (deadline is not None
                                     and time.time() > deadline)

        def supervise_if_due() -> None:
            nonlocal last_supervise
            if time.time() - last_supervise >= \
                    cfg.runtime.supervise_interval_s:
                last_supervise = time.time()
                st.supervise()

        # warm-up: fill the replay to learning_starts
        while not learner.ready and not should_stop():
            learner.drain(st.queue)
            supervise_if_due()
            time.sleep(0.02)
        st.telemetry.record_span("startup/fill", t_fill, time.time())

        def on_dispatch() -> None:
            nonlocal last_log
            if dispatch_hook is not None:
                dispatch_hook(st)
            supervise_if_due()
            now = time.time()
            # end a capture's window, fire profile_at_step, serve SIGUSR2
            triggers.poll(now, learner.training_steps)
            if now - last_log >= cfg.runtime.log_interval:
                learner.flush_metrics()
                record = st.metrics.log(now - last_log)
                if log_fn:
                    log_fn({"player": st.player_idx, **record})
                last_log = now

        # the profile_dir capture of the first interval; then the step-0
        # checkpoint, drain and train
        triggers.start_first_interval()
        learner.run(st.queue, should_stop,
                    max_training_steps or cfg.optim.training_steps,
                    on_dispatch=on_dispatch)
    finally:
        triggers.uninstall()    # stop a running capture, restore SIGUSR2
        stop.set()
        if st is not None:
            try:
                if cfg.runtime.save_interval:
                    st.learner.save_final()
            except Exception as e:
                logging.getLogger(__name__).exception(
                    "final checkpoint for player %d failed", st.player_idx)
                final_error = e
            st.close()
        for sig, handler in prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
    if final_error is not None:
        # the actors are reaped and the segments unlinked: now fail the run
        raise RuntimeError("the final checkpoint or replay snapshot failed"
                           ) from final_error
    return st
