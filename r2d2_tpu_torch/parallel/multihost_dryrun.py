"""Loopback multi-host bring-up dryrun, the JAX package's
``parallel/multihost_dryrun.py``.

Launches ``--num-processes`` controller processes on the local host, each
its own interpreter, joins them into one ``torch.distributed`` job over a
loopback tcp rendezvous (``parallel/mesh.py init_distributed``, as
``jax.distributed.initialize``) and runs one dp-sharded fused training
step across them (``dryrun.run_tiny_sharded_step``), which checks that
the train state is bit-equal on every controller: the multi-controller
path a multi-host job takes, one card a controller.

    python -m r2d2_tpu_torch.parallel.multihost_dryrun    # a card each
    python -m r2d2_tpu_torch.parallel.multihost_dryrun --backend=gloo \\
        --device=cuda:0                 # controllers sharing one card
    python -m r2d2_tpu_torch.parallel.multihost_dryrun --device=cpu
    python -m r2d2_tpu_torch.parallel.multihost_dryrun --process-id=0 ...

The controllers run on CUDA unless ``--device=cpu``: without a card the
launcher raises before it starts any. ``--device=cuda`` (the default)
gives controller r the card r under NCCL; under gloo, or with an index
(``cuda:0``), every controller takes the named device.
"""

import argparse
import sys
import time
from typing import Optional

MODULE = "r2d2_tpu_torch.parallel.multihost_dryrun"


def _worker(process_id: int, num_processes: int, coordinator: str,
            device: str, backend: Optional[str]) -> None:
    import torch

    from r2d2_tpu_torch.config import MeshConfig
    from r2d2_tpu_torch.parallel.dryrun import run_tiny_sharded_step
    from r2d2_tpu_torch.parallel.mesh import close_mesh, init_distributed
    from r2d2_tpu_torch.utils.device import (configure_numerics,
                                             resolve_device)

    torch.set_num_threads(1)
    configure_numerics()
    if device == "cuda" and backend != "gloo":
        device = f"cuda:{process_id}"       # one card a controller
    device = resolve_device(device)
    mesh = init_distributed(MeshConfig(
        multihost=True, coordinator_address=coordinator,
        num_processes=num_processes, process_id=process_id,
        dp=num_processes), device, backend)
    try:
        loss = run_tiny_sharded_step(mesh)
    finally:
        close_mesh()
    # one write: the controllers share the launcher's stdout
    sys.stdout.write(f"[proc {process_id}] multihost dryrun ok, "
                     f"loss={loss:.5f}\n")
    sys.stdout.flush()


def launch(num_processes: int = 2, device: str = "cuda",
           backend: Optional[str] = None, timeout: float = 300.0) -> None:
    """Run the controllers to their end on ``device`` ("cuda" unless the
    caller asks for "cpu"; a CUDA device that is not there raises here);
    raises SystemExit if one fails or the deadline passes (the survivors
    are killed)."""
    from r2d2_tpu_torch.parallel.multihost import ControllerProcesses
    from r2d2_tpu_torch.utils.device import resolve_device
    resolve_device(device)

    def argv_of(pid: int, coordinator: str):
        return ([f"--process-id={pid}", f"--num-processes={num_processes}",
                 f"--coordinator={coordinator}", f"--device={device}"]
                + ([f"--backend={backend}"] if backend else []))

    with ControllerProcesses(argv_of, num_processes, MODULE) as procs:
        rcs = procs.wait(time.monotonic() + timeout)
    if any(rc != 0 for rc in rcs):
        raise SystemExit(
            f"multihost dryrun failed: worker rcs={rcs} (None = timed out "
            f"after {timeout:.0f}s and was killed)")
    print(f"multihost dryrun: {num_processes} processes on {device} ok",
          flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default; raises without one) or "cpu"')
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    if args.process_id is None:
        launch(args.num_processes, args.device, args.backend)
    else:
        _worker(args.process_id, args.num_processes, args.coordinator,
                args.device, args.backend)


if __name__ == "__main__":
    main()
