"""System bring-up, the JAX package's ``runtime/orchestrator.py`` for one
player: a Learner on the card, a weight service, a block queue, and N
actors on host CPUs with the Ape-X epsilon ladder. Actors start first;
training begins once the replay holds ``replay.learning_starts`` steps;
the loop logs every ``runtime.log_interval`` seconds and supervises the
actors every ``runtime.supervise_interval_s``.

Actor modes:
  * "thread"  actors are threads of this process with CPU policies; they
    read weights from an in-process store and put blocks on a
    ``queue.Queue``.
  * "process" spawned OS processes that never touch CUDA
    (``actor_main.py``): weights through the shared-memory seqlock
    segment, blocks through the native shm ring
    (``runtime.shm_transport``; a ``multiprocessing.Queue`` with it off).

The learner publishes through a ``SnapshotPublisher``: a device-side
snapshot on the step's stream, the host copy and the write on a thread of
their own, so actors only ever read host snapshots.
"""

import logging
import multiprocessing as mp
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
from r2d2_tpu_torch.runtime.feeder import (BlockQueue, HeartbeatBoard,
                                           IngestStallDetector,
                                           RingRecoveryScheduler,
                                           WorkerHealth, supervise_workers)
from r2d2_tpu_torch.runtime.learner_loop import Learner
from r2d2_tpu_torch.runtime.metrics import TrainMetrics
from r2d2_tpu_torch.runtime.weights import (InProcWeightStore,
                                            SnapshotPublisher,
                                            WeightPublisher)
from r2d2_tpu_torch.utils.device import configure_numerics, resolve_device

JOIN_S = 5.0                # a worker's join before terminate/kill


class PlayerStack:
    """One player's learner, metrics, weight service, block queue and
    actors."""

    def __init__(self, cfg: Config, player_idx: int, action_dim: int,
                 device):
        self.cfg = cfg
        self.player_idx = player_idx
        self.net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                                cfg.env.frame_height, cfg.env.frame_width,
                                device)
        self.metrics = TrainMetrics(player_idx, cfg.runtime.save_dir,
                                    resume=bool(cfg.runtime.resume))
        self.learner = Learner(cfg, self.net, player_idx=player_idx,
                               metrics=self.metrics)
        self.n_slots = cfg.actor.num_actors
        self.threads: List[threading.Thread] = []
        self.processes: List[mp.Process] = []
        self._seen_dead: set = set()
        self._ring_recovery = RingRecoveryScheduler()
        self._stall = IngestStallDetector(cfg.runtime.ingest_stall_timeout_s)
        self.heartbeats = HeartbeatBoard(self.n_slots)
        # the shared-memory segments this stack creates (close unlinks)
        self.segment_names = [self.heartbeats.name]
        self.health = WorkerHealth.from_runtime(self.n_slots, self.heartbeats,
                                                cfg.runtime)
        self.store: Optional[InProcWeightStore] = None
        self.publisher: Optional[WeightPublisher] = None
        self.snapshots: Optional[SnapshotPublisher] = None
        self.queue: Optional[BlockQueue] = None
        self._stop = None
        self._ctx = None

    def _wire_publish(self, publish: Callable) -> None:
        self.snapshots = SnapshotPublisher(publish,
                                           self.learner.train_state.params)
        self.learner.publish = self.snapshots


    # -- thread actors --

    def start_actors_threads(self, stop: threading.Event) -> None:
        self.store = InProcWeightStore(self.learner.train_state.params)
        self._wire_publish(self.store.publish)
        self.queue = BlockQueue(use_mp=False)
        self._stop = stop
        for i in range(self.n_slots):
            self._spawn_thread_actor(i)

    def _spawn_thread_actor(self, i: int) -> threading.Thread:
        cfg = self.cfg
        seed = cfg.runtime.seed + 10_000 * self.player_idx + 100 * i
        # create_env through this module's symbol: tests monkeypatch it
        env = make_actor_env(cfg, self.player_idx, i, seed,
                             env_factory=create_env)
        # the watchdog cannot kill a thread: it sets this event and
        # abandons the incarnation
        cancel = threading.Event()

        def should_stop(cancel=cancel):
            return self._stop.is_set() or cancel.is_set()

        # the current snapshot, fresh on a respawn too (adopted: its
        # version is the stamp until the next poll)
        policy, run_loop = make_actor_policy(
            cfg, self.net, self.store.current(reader_id=i), i, seed,
            total_actors=self.n_slots)
        self.heartbeats.reset_slot(i)
        sink = instrument_block_sink(
            lambda b: self.queue.put_patient(
                b, should_stop, beat=lambda: self.heartbeats.touch(i)),
            i, board=self.heartbeats,
            weight_version=lambda: self.store.reader_version(i),
            lane_base=i * cfg.actor.envs_per_actor)

        def loop():
            try:
                run_loop(cfg, env, policy, block_sink=sink,
                         weight_poll=lambda: self.store.poll(i),
                         should_stop=should_stop)
            except Exception:
                if not should_stop():
                    raise

        t = threading.Thread(target=loop, daemon=True,
                             name=f"actor-p{self.player_idx}-{i}")
        t.health_cancel = cancel
        t.start()
        if i < len(self.threads):
            self.threads[i] = t
        else:
            self.threads.append(t)
        return t

    # -- process actors --

    def start_actors_processes(self, stop_event) -> None:
        cfg = self.cfg
        self._ctx = mp.get_context("spawn")
        self.publisher = WeightPublisher(self.learner.train_state.params)
        self._wire_publish(self.publisher.publish)
        self.queue = BlockQueue(
            use_mp=True, ctx=self._ctx,
            shm_spec=self.learner.spec if cfg.runtime.shm_transport else None)
        self.segment_names.append(self.publisher.name)
        if cfg.runtime.shm_transport:
            self.segment_names.append(self.queue._q.name)
        self._stop = stop_event
        for i in range(self.n_slots):
            self._spawn_process_actor(i)

    def _spawn_process_actor(self, i: int) -> mp.Process:
        cfg = self.cfg
        eps = apex_epsilon(i, self.n_slots, cfg.actor.base_eps,
                           cfg.actor.eps_alpha)
        self.heartbeats.reset_slot(i)
        p = self._ctx.Process(
            target=actor_process_main,
            args=(cfg.to_dict(), self.player_idx, i, eps,
                  self.publisher.name, self.queue._q, self._stop),
            kwargs={"health_board": self.heartbeats},
            daemon=True, name=f"actor-p{self.player_idx}-{i}")
        p.start()
        if i < len(self.processes):
            self.processes[i] = p
        else:
            self.processes.append(p)
        return p

    # -- supervision --

    def supervise(self) -> int:
        """One health pass: respawn dead actors (with
        runtime.restart_dead_actors), kill and respawn hung ones, apply
        the backoff and the breaker, reclaim shm ring slots of dead
        producers (whether or not they respawn), run the stall detector,
        and put the counters into the metrics. Returns the restarts."""
        if self._stop is None or self._stop.is_set():
            return 0
        restart = self.cfg.runtime.restart_dead_actors
        restarted = supervise_workers(
            self.threads, self._seen_dead,
            respawn=self._spawn_thread_actor if restart else None,
            health=self.health)
        restarted += supervise_workers(
            self.processes, self._seen_dead,
            respawn=self._spawn_process_actor if restart else None,
            ring=self._ring_recovery, health=self.health)
        self.health.ring_slots_recovered += self._ring_recovery.tick(
            self.queue)
        workers = self.processes or self.threads
        self._stall.check(
            self.metrics.ingest_blocks_total,
            sum(1 for w in workers if w.is_alive()),
            self.learner.ingestion_paused,
            diagnostics=self._stall_diagnostics)
        self.metrics.set_actor_health(
            {**self.health.snapshot(),
             "ingest_stall_dumps": self._stall.dumps})
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
        """Stop the learner's threads, write out queued publications, stop
        and reap every actor, and unlink every segment. Set the stop
        event first."""
        self.learner.stop_background()
        if self.snapshots is not None:
            self.snapshots.close()
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
        self.metrics.close()


def train(cfg: Config, *, max_training_steps: Optional[int] = None,
          max_seconds: Optional[float] = None, actor_mode: str = "thread",
          device=None, log_fn: Optional[Callable[[dict], None]] = None,
          dispatch_hook: Optional[Callable[[PlayerStack], None]] = None
          ) -> PlayerStack:
    """Run the system until ``max_training_steps`` learner steps
    (optim.training_steps), ``max_seconds``, or SIGTERM/SIGINT; returns
    the player's stack, closed, its learner holding the final state.
    ``device``: CUDA by default (raises without one). ``dispatch_hook``
    is called after every learner dispatch with the stack. With
    ``actor.on_device`` the fused act+train loop runs instead
    (runtime/anakin_loop.py), before any env, actor, queue or weight
    service is built; ``actor_mode`` has no meaning there."""
    if cfg.actor.on_device:
        from r2d2_tpu_torch.runtime import anakin_loop
        return anakin_loop.run_anakin_train(
            cfg, max_training_steps=max_training_steps,
            max_seconds=max_seconds, device=device, log_fn=log_fn,
            dispatch_hook=dispatch_hook)
    if actor_mode not in ("thread", "process"):
        raise ValueError(f"actor_mode must be 'thread' or 'process'; got "
                         f"{actor_mode!r}")
    device = resolve_device(device)
    configure_numerics()
    probe = create_env(cfg.env, seed=cfg.runtime.seed)
    action_dim = probe.action_space.n
    probe.close()
    stop = (threading.Event() if actor_mode == "thread"
            else mp.get_context("spawn").Event())
    prev_handlers = {}
    st: Optional[PlayerStack] = None
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

        st = PlayerStack(cfg, 0, action_dim, device)
        if actor_mode == "thread":
            st.start_actors_threads(stop)
        else:
            st.start_actors_processes(stop)
        learner = st.learner

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

        def on_dispatch() -> None:
            nonlocal last_log
            if dispatch_hook is not None:
                dispatch_hook(st)
            supervise_if_due()
            now = time.time()
            if now - last_log >= cfg.runtime.log_interval:
                learner.flush_metrics()
                record = st.metrics.log(now - last_log)
                if log_fn:
                    log_fn({"player": st.player_idx, **record})
                last_log = now

        # the step-0 checkpoint, then drain and train
        learner.run(st.queue, should_stop,
                    max_training_steps or cfg.optim.training_steps,
                    on_dispatch=on_dispatch)
    finally:
        stop.set()
        if st is not None:
            try:
                if cfg.runtime.save_interval:
                    st.learner.save_final()
            except Exception:
                logging.getLogger(__name__).exception(
                    "final checkpoint for player %d failed", st.player_idx)
            st.close()
        for sig, handler in prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
    return st
