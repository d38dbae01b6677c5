"""The port's dryruns (r2d2_tpu_torch/parallel/dryrun.py, the counterpart
of the JAX package's ``parallel/dryrun.py``) on gloo ranks of the CPU, and
the loopback multi-host dryrun (``parallel/multihost_dryrun.py``) with two
controller interpreters. ``cli.train --mesh.mp`` is
tests/test_torch_tensor_parallel_loop.py's."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from r2d2_tpu.parallel.dryrun import tp_dryrun_fits as j_tp_dryrun_fits
from r2d2_tpu_torch.parallel import dryrun
from r2d2_tpu_torch.parallel.mesh import run_ranks

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", range(1, 9))
def test_tp_dryrun_fits_is_jax(n):
    assert dryrun.tp_dryrun_fits(n) == j_tp_dryrun_fits(n)


@pytest.mark.parametrize("fn,dp,mp", [
    ("run_tiny_sharded_step", 2, 1), ("run_tiny_sp_step", 3, 1),
    ("run_tiny_device_mp_step", 2, 2), ("run_tiny_tp_step", 2, 2),
    ("run_tiny_tp_step", 1, 2)])
def test_tiny_dryruns_on_gloo_ranks(fn, dp, mp, tmp_path):
    """Each dryrun on its world: a finite result, the same on every rank
    (each checks its own replicas: bit-equal train states, a sharded
    leaf, the sp unroll against the unsharded scan bit for bit)."""
    out = run_ranks(getattr(dryrun, fn), dp, mp=mp,
                    rendezvous_dir=str(tmp_path))
    assert len(out) == dp * mp
    assert np.isfinite(out[0]) and len(set(out)) == 1


def test_tiny_plstm_step_on_the_cpu():
    """The fused-LSTM learner step (the scan's plain versions here; K4, K4
    lean and K5 on the card) gives a finite loss on the CPU it is asked
    for; without a mesh or a device it takes CUDA, which is not here."""
    assert np.isfinite(dryrun.run_tiny_plstm_step(device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.run_tiny_plstm_step()


def test_multihost_dryrun_two_controllers():
    """``python -m r2d2_tpu_torch.parallel.multihost_dryrun``: two
    controller interpreters over a loopback tcp rendezvous, one sharded
    step, the train state bit-equal on both (asserted in each)."""
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.parallel.multihost_dryrun",
         "--num-processes=2", "--device=cpu"], capture_output=True,
        text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("multihost dryrun ok") == 2
    assert proc.stdout.strip().splitlines()[-1] == \
        "multihost dryrun: 2 processes on cpu ok"


def test_multihost_dryrun_takes_the_card_by_default():
    """Without ``--device`` the launcher asks for CUDA: with no card it
    raises before it starts a controller (every card hidden)."""
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.parallel.multihost_dryrun"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "multihost dryrun ok" not in proc.stdout
