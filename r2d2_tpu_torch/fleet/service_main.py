"""The replay service as a process of its own, the JAX package's
``fleet/service_main.py``:

    python -m r2d2_tpu_torch.fleet.service_main --fleet.replay_shards=2 \\
        --runtime.snapshot_interval=64 --runtime.save_dir=DIR \\
        [--device=cpu] [--max-seconds=S] [--player=P] [overrides]

The service's shards live on the card (CUDA device 0 by default; without
one it raises unless ``--device=cpu``). Once its listener is up it prints
``replay service: HOST:PORT {...}`` (shards, device, the blocks restored,
the restore's seconds and the restored cut's ``cut_digest``); producers
feed it through ``RemoteReplayProducer``.

Lifecycle:

  * start: the service built as the learner builds it (equal slices of
    the ring per shard); with ``runtime.snapshot_interval`` > 0 the
    newest committed service snapshot in ``runtime.save_dir`` is loaded
    first, so a restarted service comes back with its experience;
  * run: a snapshot every ``runtime.snapshot_interval`` committed blocks
    (the process has no step clock; adds are its commit boundary),
    written by the learner's ``SnapshotWriter``; one
    ``service_metrics_p{player}.jsonl`` row every ``runtime.log_interval``
    seconds (the ``replay_service`` block with its socket stats);
  * stop (SIGTERM, SIGINT or the deadline): a last synchronous snapshot.

Its pid is in ``{save_dir}/replay_service.pid``. ``run_kill_drill``
(the JAX package's ``tools/chaos.py`` replay-service drill) starts it as
a child, streams blocks into it through a windowed producer, SIGKILLs it
mid-ingest and restarts it: the producer must survive, the restart must
restore the snapshot's shards bit for bit (``cut_digest``), and the loss
must stay within a snapshot interval and a window of groups.

The JAX package's host also announces its address to the fleet lease
board (``fleet.lease_transport``); the lease board is ROADMAP A.6's
second part, so this host does not.
"""

import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


def _pid_path(save_dir: str) -> str:
    return os.path.join(save_dir or ".", "replay_service.pid")


class ReplayServiceHost:
    """One incarnation of the standalone service: the service, its socket
    listener and its snapshots. ``player_idx`` names the snapshot files
    (one host a player)."""

    def __init__(self, cfg, player_idx: int = 0, host: Optional[str] = None,
                 port: Optional[int] = None, device=None):
        from r2d2_tpu_torch.fleet.replay_service import (ReplayServiceServer,
                                                         build_service)
        from r2d2_tpu_torch.telemetry.core import Telemetry
        from r2d2_tpu_torch.telemetry.tracing import proc_header
        from r2d2_tpu_torch.utils.device import resolve_device
        if cfg.fleet.replay_shards < 1:
            raise ValueError(
                "ReplayServiceHost requires fleet.replay_shards >= 1")
        self.cfg = cfg
        self.player_idx = player_idx
        self.device = resolve_device(device)
        self.proc = proc_header("replay_service")
        self.telemetry = Telemetry.from_config(cfg, name="replay_service")
        self.service = build_service(cfg, self.device)
        self.restored_blocks = 0
        self.restore_s = 0.0
        self.restored_digest: Optional[str] = None
        self._snap_writer = None
        self._snap_adds = 0
        save_dir = cfg.runtime.save_dir or "."
        if cfg.runtime.snapshot_interval > 0:
            from r2d2_tpu_torch.replay.snapshot import (SnapshotWriter,
                                                        load_snapshot)
            self._snap_writer = SnapshotWriter(save_dir, player_idx)
            t0 = time.perf_counter()
            snap = load_snapshot(save_dir, player_idx)
            if snap is not None and snap.get("kind") == "service":
                from r2d2_tpu_torch.replay.snapshot import (cut_digest,
                                                            wait_ready)
                self.service.restore_state(snap)
                self.restored_blocks = self.service.total_adds
                self._snap_adds = self.service.total_adds
                self.restore_s = time.perf_counter() - t0
                # what the service now holds, read back from the device
                self.restored_digest = cut_digest(wait_ready(
                    self.service.snapshot_state(0)))
                log.warning("replay service restored %d committed blocks "
                            "from the step-%s snapshot",
                            self.restored_blocks, snap.get("step"))
        self.server = ReplayServiceServer(
            self.service,
            cfg.fleet.service_host if host is None else host,
            cfg.fleet.service_port if port is None else port,
            telemetry=self.telemetry)

    def maybe_snapshot(self) -> bool:
        """Submit a snapshot once ``snapshot_interval`` blocks committed
        since the last; True when one was submitted."""
        if self._snap_writer is None:
            return False
        adds = self.service.total_adds
        if adds - self._snap_adds < self.cfg.runtime.snapshot_interval:
            return False
        t0 = time.time()
        self._snap_writer.submit(self.service.snapshot_state(adds))
        self.telemetry.record_span("recovery/snapshot_capture", t0,
                                   time.time(), {"adds": adds})
        self._snap_adds = adds
        return True

    def run(self, max_seconds: Optional[float] = None,
            stop: Optional[threading.Event] = None,
            poll_s: float = 0.1) -> None:
        """Serve until ``stop`` or the deadline: the listener's threads
        ingest; this loop keeps the snapshot cadence and writes the
        metrics rows (the process header first in each)."""
        stop = stop or threading.Event()
        deadline = time.time() + max_seconds if max_seconds else None
        save_dir = self.cfg.runtime.save_dir or "."
        os.makedirs(save_dir, exist_ok=True)
        metrics_path = os.path.join(
            save_dir, f"service_metrics_p{self.player_idx}.jsonl")
        open(metrics_path, "w").close()
        self.telemetry.start_drain(
            os.path.join(save_dir, "spans_replay_service.jsonl"))
        t0 = time.time()
        last_log = t0

        def write_row(final: bool = False) -> None:
            row = {"t": round(time.time() - t0, 1), "proc": self.proc,
                   "restored_blocks": self.restored_blocks,
                   "replay_service": {
                       **self.service.interval_block(),
                       "socket": self.server.interval_stats()}}
            if final:
                row["final"] = True
            with open(metrics_path, "a") as f:
                f.write(json.dumps(row) + "\n")

        try:
            while not stop.is_set():
                now = time.time()
                if deadline is not None and now >= deadline:
                    break
                self.maybe_snapshot()
                if now - last_log >= self.cfg.runtime.log_interval:
                    last_log = now
                    write_row()
                time.sleep(poll_s)
        finally:
            write_row(final=True)

    def close(self) -> None:
        """A last synchronous snapshot, then the listener, the service
        and the telemetry."""
        try:
            if self._snap_writer is not None:
                try:
                    self._snap_writer.write_now(self.service.snapshot_state(
                        self.service.total_adds))
                finally:
                    self._snap_writer.stop()
        finally:
            self.server.close()
            self.service.close()
            self.telemetry.close()


def run_replay_service(cfg, player_idx: int = 0,
                       max_seconds: Optional[float] = None,
                       device=None) -> None:
    """Host the service until SIGTERM/SIGINT or the deadline, snapshots on
    their cadence and a last one at the end."""
    host = ReplayServiceHost(cfg, player_idx, device=device)
    save_dir = cfg.runtime.save_dir or "."
    os.makedirs(save_dir, exist_ok=True)
    pid_file = _pid_path(save_dir)
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    stop = threading.Event()
    prev = {}
    if threading.current_thread() is threading.main_thread():
        def _on_signal(signum, frame):
            stop.set()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, _on_signal)
            except (ValueError, OSError):
                pass
    print(f"replay service: {host.server.host}:{host.server.port} "
          + json.dumps({"shards": cfg.fleet.replay_shards,
                        "device": str(host.device),
                        "restored_blocks": host.restored_blocks,
                        "restore_s": round(host.restore_s, 6),
                        "restored_digest": host.restored_digest}),
          flush=True)
    try:
        host.run(max_seconds=max_seconds, stop=stop)
    finally:
        host.close()
        try:
            os.remove(pid_file)
        except OSError:
            pass
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_child(args, log_path: str):
    import subprocess
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "r2d2_tpu_torch.fleet.service_main", *args],
        stdout=log_file, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    return proc, log_file


def _ready_line(log_path: str) -> Optional[dict]:
    """The child's ``replay service:`` line as (address, fields), once it
    printed it."""
    try:
        with open(log_path) as f:
            for line in f:
                if line.startswith("replay service: "):
                    addr, _, rest = line[len("replay service: "):].partition(
                        " ")
                    return {"address": addr, **json.loads(rest)}
    except (OSError, ValueError):
        pass
    return None


def run_kill_drill(overrides: dict, device: str = "cuda",
                   save_dir: Optional[str] = None, interval: int = 8,
                   window: int = 4, group: int = 2,
                   timeout_s: float = 120.0) -> dict:
    """Kill and restart a standalone service mid-ingest (the module
    docstring). ``overrides``: the service's config (``section.field``:
    value; the replay geometry and ``fleet.replay_shards``); the drill
    sets the address, ``runtime.snapshot_interval`` = ``interval`` and
    the save directory. A producer thread sends groups of ``group``
    synthetic blocks, ``window`` frames in flight. The report's
    ``verdict`` holds each criterion; nothing is raised for a failed one.
    Every child is gone when it returns."""
    import shutil
    import tempfile

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.fleet.replay_service import RemoteReplayProducer
    from r2d2_tpu_torch.replay.snapshot import (cut_digest, load_snapshot,
                                                read_manifest)
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    import numpy as np

    own_dir = save_dir is None
    save_dir = save_dir or tempfile.mkdtemp(prefix="r2d2_service_drill_")
    port = _free_port()
    over = {**overrides, "fleet.service_host": "127.0.0.1",
            "fleet.service_port": port, "runtime.save_dir": save_dir,
            "runtime.snapshot_interval": interval,
            "runtime.log_interval": 1.0}
    cfg = Config().replace(**over)
    args = [f"--{k}={_cli_value(v)}" for k, v in over.items()]
    args.append(f"--device={device}")
    rng = np.random.default_rng(0)
    spec = ReplaySpec.from_config(cfg, "cpu")
    pool = [make_synthetic_block(spec, rng) for _ in range(12)]
    t0 = time.time()
    logs = [os.path.join(save_dir, f"service_{i}.log") for i in range(2)]
    children = []
    children.append(_start_child(args, logs[0]))
    state = {"sent": 0, "error": None}
    stop_send = threading.Event()
    producer = RemoteReplayProducer(
        "127.0.0.1", port, window=window, connect_retries=400,
        backoff_base_s=0.05, backoff_max_s=0.25, eager_connect=True)

    def sender():
        i = 0
        try:
            while not stop_send.is_set():
                producer.add_blocks([pool[(i + j) % len(pool)]
                                     for j in range(group)])
                state["sent"] += group
                i += group
                time.sleep(0.02)
        except Exception as e:           # the report's producer_error
            state["error"] = repr(e)

    def wait(pred, timeout) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        return pred()

    thread = threading.Thread(target=sender, daemon=True,
                              name="drill-producer")
    thread.start()
    killed = restarted = False
    adds_at_kill = sent_at_kill = digest_at_kill = None
    restart_line = None
    kill_to_ready_s = None
    try:
        ready = wait(lambda: ((read_manifest(save_dir, 0) or {})
                              .get("total_adds", 0) >= interval
                              and state["sent"] >= 2 * interval
                              and state["error"] is None), timeout_s)
        if ready:
            children[0][0].kill()            # SIGKILL, mid-ingest
            children[0][0].wait(timeout=30.0)
            t_kill = time.time()
            killed = True
            sent_at_kill = state["sent"]
            snap = load_snapshot(save_dir, 0)
            adds_at_kill = sum(s["ring"]["total_adds"]
                               for s in snap["shards"])
            digest_at_kill = cut_digest(snap)
            children.append(_start_child(args, logs[1]))
            up = wait(lambda: _ready_line(logs[1]) is not None, timeout_s)
            if up:
                kill_to_ready_s = time.time() - t_kill
                restart_line = _ready_line(logs[1])
            restarted = up and wait(
                lambda: (state["sent"] > sent_at_kill + 2 * interval
                         and state["error"] is None), timeout_s)
    finally:
        stop_send.set()
        thread.join(timeout=60.0)
        try:
            if state["error"] is None:
                producer.flush(timeout=30.0)
        except OSError as e:
            state["error"] = repr(e)
        producer.close()
        for proc, log_file in children:
            if proc.poll() is None:
                proc.terminate()        # the last synchronous snapshot
                try:
                    proc.wait(timeout=60.0)
                except Exception:
                    proc.kill()
                    proc.wait(timeout=10.0)
            log_file.close()
    final = read_manifest(save_dir, 0) or {}
    final_adds = final.get("total_adds", 0)
    lost_est = max(0, state["sent"] - final_adds)
    report = {
        "duration_s": round(time.time() - t0, 3),
        "blocks_sent": state["sent"],
        "blocks_acked": producer.blocks_acked,
        "blocks_resent": producer.blocks_resent,
        "reconnects": producer.reconnects,
        "producer_error": state["error"],
        "snapshot_adds_at_kill": adds_at_kill,
        "restored_blocks": (restart_line or {}).get("restored_blocks"),
        "restore_s": (restart_line or {}).get("restore_s"),
        "kill_to_ready_s": (None if kill_to_ready_s is None
                            else round(kill_to_ready_s, 3)),
        "final_total_adds": final_adds,
        "lost_blocks_est": lost_est,
        "loss_bound": interval + window * group,
        "child_exit_codes": [proc.returncode for proc, _ in children],
    }
    report["verdict"] = {
        "killed": killed,
        "producer_survived": (killed and state["error"] is None
                              and producer.reconnects >= 1),
        "all_sent_acked": (state["sent"] > 0
                           and producer.blocks_acked == state["sent"]),
        "restored_bit_for_bit": (
            restart_line is not None and digest_at_kill is not None
            and restart_line.get("restored_digest") == digest_at_kill
            and restart_line.get("restored_blocks") == adds_at_kill),
        "adds_monotone": (restarted and adds_at_kill is not None
                          and adds_at_kill > 0
                          and final_adds >= adds_at_kill),
        "bounded_loss": killed and lost_est <= interval + window * group,
    }
    if own_dir:
        shutil.rmtree(save_dir, ignore_errors=True)
    return report


def _cli_value(v) -> str:
    """A config value as ``parse_overrides`` reads it."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, tuple):
        return ";".join(",".join(str(x) for x in t) for t in v)
    return str(v)


def main(argv=None) -> None:
    from r2d2_tpu_torch.config import Config, parse_overrides
    argv = list(sys.argv[1:] if argv is None else argv)
    player_idx, max_seconds, device, rest = 0, None, None, []
    for arg in argv:
        if arg.startswith("--player="):
            player_idx = int(arg.split("=", 1)[1])
        elif arg.startswith("--max-seconds="):
            max_seconds = float(arg.split("=", 1)[1])
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    cfg = parse_overrides(Config(), rest)
    run_replay_service(cfg, player_idx, max_seconds=max_seconds,
                       device=device)


if __name__ == "__main__":
    main()
