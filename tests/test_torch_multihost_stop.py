"""How a multi-host job ends, on the CPU over gloo: SIGTERM to one
controller stops both on the same iteration with exit code 0 (the stop
consensus); a controller that raises gets its peer killed by the launcher,
which fails and leaves no process; and ``cli.train --mesh.multihost=true``
runs a controller a command."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from r2d2_tpu_torch.parallel.mesh import pick_coordinator
from r2d2_tpu_torch.parallel.multihost import (ControllerProcesses,
                                               demo_argv, read_digests)
from tests.test_torch_train import TINY_ARGS

pytestmark = pytest.mark.torch_port

TIMEOUT_S = 60.0            # a collective's wait in each controller
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sigterm_to_one_controller_stops_both_on_one_iteration(tmp_path):
    """Once rank 0 has saved its step-4 checkpoint, SIGTERM to controller
    1: both leave the loop on the same iteration (equal steps and
    iteration counts, equal digests), write the final checkpoint, and exit
    with 0; controller 1 names the signal, controller 0 only followed."""
    save_dir = str(tmp_path / "mh_term")
    argv_of = demo_argv(2, save_dir, max_steps=100_000, max_seconds=120.0,
                        device="cpu",
                        collective_timeout=TIMEOUT_S)
    first = os.path.join(save_dir, "Fake1_player0")
    with ControllerProcesses(argv_of, 2) as ctl:
        deadline = time.monotonic() + 120.0
        while not os.path.exists(first) and time.monotonic() < deadline:
            assert all(p.poll() is None for p in ctl.procs)
            time.sleep(0.1)
        assert os.path.exists(first), "no step-4 checkpoint in time"
        ctl.procs[1].send_signal(signal.SIGTERM)
        rcs = ctl.wait(time.monotonic() + 90.0)
    assert rcs == [0, 0]
    assert all(p.poll() is not None for p in ctl.procs)
    records = read_digests(save_dir, 2)
    assert records[0]["step"] == records[1]["step"] >= 4
    assert records[0]["iterations"] == records[1]["iterations"]
    assert records[0]["digest"] == records[1]["digest"]
    assert [r["stop_reason"] for r in records] == ["", "signal"]


def test_a_raising_controller_fails_the_launch_and_leaves_none(tmp_path):
    """Controller 1 raises (a checkpoint to resume that is not there) while
    controller 0 waits in the first collective: the launcher sees the
    failure, kills controller 0 and every process is gone."""
    save_dir = str(tmp_path / "mh_raise")
    good = demo_argv(2, save_dir, max_steps=8, device="cpu",
                     collective_timeout=TIMEOUT_S)
    bad = demo_argv(2, save_dir, max_steps=8, device="cpu",
                    collective_timeout=TIMEOUT_S,
                    resume=str(tmp_path / "missing_checkpoint"))

    def argv_of(pid, coordinator):
        return (bad if pid == 1 else good)(pid, coordinator)

    t0 = time.monotonic()
    with ControllerProcesses(argv_of, 2) as ctl:
        rcs = ctl.wait_any_failure(time.monotonic() + 120.0)
    assert rcs[1] not in (None, 0)
    assert all(p.poll() is not None for p in ctl.procs)
    assert ctl.procs[0].returncode != 0     # killed, not finished
    assert time.monotonic() - t0 < TIMEOUT_S


def test_cli_train_routes_multihost_controllers(tmp_path):
    """``python -m r2d2_tpu_torch.cli.train --mesh.multihost=true
    --mesh.num_processes=2`` once a controller: each prints its own
    summary (thread actors by default), both at 4 steps with one train
    state."""
    address = pick_coordinator()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "r2d2_tpu_torch.cli.train", *TINY_ARGS,
         "--device=cpu", "--max-steps=4", "--mesh.multihost=true",
         "--mesh.num_processes=2", "--mesh.dp=2", f"--mesh.process_id={r}",
         f"--mesh.coordinator_address={address}",
         "--runtime.steps_per_dispatch=2",
         f"--runtime.save_dir={tmp_path}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs[1][1][-2000:]
    summaries = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert [s["rank"] for s in summaries] == [0, 1]
    assert all(s["multihost"] and s["step"] == 4 for s in summaries)
    assert summaries[0]["digest"] == summaries[1]["digest"]
    assert summaries[0]["final_loss"] is not None
