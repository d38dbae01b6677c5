"""The port's trainer entry points on the CPU (the synchronous
``tools.sync_train`` and the orchestrated ``cli.train``), their device
rule, and the port's isolation from JAX and from the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.cli import train
from r2d2_tpu_torch.tools import sync_train
from r2d2_tpu_torch.utils.device import gc_paused, resolve_device

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent
TINY_ARGS = [
    "--env.game_name=Fake", "--env.frame_height=24", "--env.frame_width=24",
    "--env.frame_stack=2", "--network.hidden_dim=16",
    "--network.cnn_out_dim=32", "--network.conv_layers=8,4,2;16,3,1",
    "--sequence.burn_in_steps=4", "--sequence.learning_steps=5",
    "--sequence.forward_steps=3", "--replay.capacity=800",
    "--replay.block_length=20", "--replay.batch_size=8",
    "--replay.learning_starts=100", "--replay.max_env_steps_per_train_step=2",
    "--optim.lr=1e-3"]


def test_cli_train_on_cpu_is_reproducible():
    """N learner steps of the synchronous trainer's entry point
    (``tools.sync_train``, where the synchronous loop moved from
    ``cli.train``) at the tiny shape; the same seed gives the same losses
    twice."""
    args = TINY_ARGS + ["--device=cpu", "--max-steps=4", "--seed=3"]
    a = sync_train.main(args)
    b = sync_train.main(args)
    assert a["steps"] == 4 and a["device"] == "cpu"
    assert len(a["losses"]) == 4 and np.all(np.isfinite(a["losses"]))
    assert a["losses"] == b["losses"]
    assert a["env_steps"] >= 100


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(TINY_ARGS + ["--max-steps=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sync_train.main(TINY_ARGS + ["--max-steps=1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_gc_paused_collects_first_and_holds_the_collector():
    """The guard of every CUDA graph capture: a dead reference cycle is
    collected on entry (not inside the capture), the collector stays off
    inside and is on again after, also when the block raises."""
    import gc
    import weakref

    class Node:
        pass

    a, b = Node(), Node()
    a.other, b.other = b, a
    dead = weakref.ref(a)
    del a, b
    assert gc.isenabled()
    with gc_paused():
        assert dead() is None and not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(RuntimeError):
        with gc_paused():
            raise RuntimeError("a failed capture")
    assert gc.isenabled()


def test_port_imports_nothing_of_jax():
    """Every module of r2d2_tpu_torch, cli.train and chip_smoke imported in
    a fresh interpreter: no jax*, flax*, optax* or r2d2_tpu module loads."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import r2d2_tpu_torch\n"
        "for m in pkgutil.walk_packages(r2d2_tpu_torch.__path__, "
        "'r2d2_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import r2d2_tpu_torch.cli.train, r2d2_tpu_torch.cli.evaluate\n"
        "import r2d2_tpu_torch.cli.serve\n"
        "import r2d2_tpu_torch.runtime.orchestrator, chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'r2d2_tpu'))\n"
        "assert not bad, bad\n"
        "for name in ('replay.device_replay', 'runtime.orchestrator',\n"
        "             'runtime.actor_main', 'runtime.shm_feeder',\n"
        "             'envs.vector', 'cli.evaluate', 'tools.learnability',\n"
        "             'tools.actor_profile', 'envs.device_env',\n"
        "             'actor.anakin', 'runtime.anakin_loop',\n"
        "             'serve.server', 'serve.transport', 'serve.client',\n"
        "             'serve.state_cache', 'cli.serve', 'telemetry.quant',\n"
        "             'telemetry.histogram', 'ops.quant_kernels',\n"
        "             'replay.snapshot', 'runtime.supervisor',\n"
        "             'runtime.learner_loop', 'runtime.feeder',\n"
        "             'parallel.multihost', 'tools.mh_check',\n"
        "             'fleet.replay_service', 'fleet.service_main'):\n"
        "    assert 'r2d2_tpu_torch.' + name in sys.modules, name\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card chip_smoke.py exits nonzero and prints no result; in
    a directory holding nothing else of the repo it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_entry_points_turn_tf32_off(tmp_path):
    """f32 means f32: cli.train (thread actors), tools.sync_train and
    Learner construction each turn both TF32 flags off
    (utils/device.configure_numerics), whatever they were."""
    from r2d2_tpu_torch.config import Config, parse_overrides
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        train.main(TINY_ARGS + [
            "--device=cpu", "--max-steps=1", "--actor-mode=thread",
            "--actor.num_actors=1", "--runtime.save_interval=0",
            f"--runtime.save_dir={tmp_path}", "--max-seconds=120"])
        assert [f.allow_tf32 for f in flags] == [False, False]
        for f in flags:
            f.allow_tf32 = True
        sync_train.main(TINY_ARGS + ["--device=cpu", "--max-steps=1"])
        assert [f.allow_tf32 for f in flags] == [False, False]
        for f in flags:
            f.allow_tf32 = True
        cfg = parse_overrides(Config(), TINY_ARGS)
        net = NetworkApply(6, cfg.network, cfg.env.frame_stack,
                           cfg.env.frame_height, cfg.env.frame_width, "cpu")
        Learner(cfg, net)
        assert [f.allow_tf32 for f in flags] == [False, False]
    finally:
        for f, value in zip(flags, saved):
            f.allow_tf32 = value
