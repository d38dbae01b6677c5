"""Checks of the multi-host lockstep path that run on every rank of a world
(``parallel.mesh.run_ranks``): the lockstep ingest over a script of
iterations (``rank_ingest``), the consensus (``rank_consensus``), the
scripted lockstep core, ingest to dispatch (``rank_core``), and the
sharded external-batch step (``rank_external``). The tests hold their
results against the JAX package's ``parallel/multihost.py`` on the CPU;
``chip_smoke.py`` runs ``rank_core`` with ranks on the card.

Each function takes this rank's ``Mesh`` and a picklable case and returns
numpy results. A script lists, for each iteration and rank, the blocks
that arrive in the rank's queue and its stop flag; the rank drains one
block an iteration unless the core is paused, as the trainer's loop does.
"""

import numpy as np
import torch

from r2d2_tpu_torch.config import NetworkConfig, OptimConfig
from r2d2_tpu_torch.learner.train_step import TrainState, make_optimizer
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.ops.launch_counts import launch_counts
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.parallel.multihost import (LockstepCore, HostFeed,
                                               make_lockstep_consensus,
                                               make_lockstep_ingest)
from r2d2_tpu_torch.parallel.sharded import (
    make_sharded_external_batch_step, make_sharded_learner_step,
    sharded_replay_init, state_digest)
from r2d2_tpu_torch.replay.structs import ReplaySpec, SampleBatch
from r2d2_tpu_torch.tools.dp_check import _np, numpy_state
from r2d2_tpu_torch.utils.device import configure_numerics


def _train_state(case: dict, mesh: Mesh):
    """The network and a train state on this rank's device from the case's
    weights (a state dict of numpy arrays)."""
    device = mesh.device
    spec = ReplaySpec(**case["spec"])
    net = NetworkApply(case["action_dim"], NetworkConfig(**case["network"]),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       device)
    optim = OptimConfig(**case["optim"])
    params = {name: torch.from_numpy(np.array(v))
              for name, v in case["params"].items()}
    online = net.build()
    online.load_state_dict(params)
    target = online
    if net.config.use_double:
        target = net.build()
        target.load_state_dict(params)
    ts = TrainState(params=online, target_params=target,
                    opt=make_optimizer(optim, online), step=0,
                    generator=torch.Generator(device=device).manual_seed(
                        mesh.rank))
    return spec, net, optim, ts


def _blocks(case: dict, rank: int, it: int) -> list:
    return list(case["arrivals"][it][rank])


def rank_ingest(mesh: Mesh, case: dict) -> dict:
    """The lockstep ingest over ``case["arrivals"]`` and ``case["stops"]``
    (one block drained an iteration, no limiter): per iteration the
    ``info`` and this rank's ``cum_env``; the shard's fields at the end."""
    spec = ReplaySpec(**case["spec"])
    ingest = make_lockstep_ingest(spec, mesh)
    feed = HostFeed(spec, mesh)
    state = sharded_replay_init(spec, mesh)
    cum_env, queue, trace = 0, [], []
    for it in range(len(case["arrivals"])):
        queue += _blocks(case, mesh.rank, it)
        block = queue.pop(0) if queue else None
        state, cum_env, info = ingest(
            state, cum_env, *feed.build(block, case["stops"][it][mesh.rank]))
        trace.append({"info": info, "cum_env": cum_env})
    return {"trace": trace, "state": numpy_state(state),
            "ring_steps": ingest.ring.buffer_steps}


def rank_consensus(mesh: Mesh, case: dict) -> dict:
    """``make_lockstep_consensus`` on this rank's ``case["values"]``."""
    consense = make_lockstep_consensus(mesh)
    return consense(*case["values"][mesh.rank])


def rank_core(mesh: Mesh, case: dict) -> dict:
    """The lockstep core (device placement, ``case["k"]`` steps a
    dispatch) over a script: per iteration the ``info``, whether it
    stepped, paused or stopped; per dispatch the losses, params and
    target; the iteration the loop stopped on, the train state's digest
    and this process's launch counts. ``case["jitter"][rank][d]``: the
    (K, B) jitter of dispatch d."""
    configure_numerics()
    spec, net, optim, ts = _train_state(case, mesh)
    step = make_sharded_learner_step(net, spec, optim, net.config.use_double,
                                     mesh, case["k"])
    core = LockstepCore(mesh, ts, step, case["k"],
                        learning_starts=case["learning_starts"],
                        ratio=case["ratio"],
                        rs=sharded_replay_init(spec, mesh), spec=spec)
    queue, trace, dispatches = [], [], []
    stopped_at = None
    for it in range(len(case["arrivals"])):
        queue += _blocks(case, mesh.rank, it)
        block = None
        if not core.paused and queue:
            block = queue.pop(0)
        uniform = None
        if case.get("jitter") is not None:
            d = min(len(dispatches), len(case["jitter"][mesh.rank]) - 1)
            uniform = torch.from_numpy(np.array(
                case["jitter"][mesh.rank][d])).to(mesh.device)
        out = core.iterate(block, case["stops"][it][mesh.rank], uniform)
        trace.append({"info": out["info"], "stepped": out["stepped"],
                      "paused": core.paused, "drained": block is not None})
        if out["stop"]:
            stopped_at = it
            break
        if out["stepped"]:
            m = out["metrics"]
            dispatches.append({
                "loss": _np(m["loss"]), "grad_norm": _np(m["grad_norm"]),
                "params": {n: _np(v)
                           for n, v in core.ts.params.state_dict().items()},
                "target": {n: _np(v) for n, v in
                           core.ts.target_params.state_dict().items()},
                "tree": _np(core.rs.tree)})
    return {"trace": trace, "dispatches": dispatches,
            "stopped_at": stopped_at, "step": core.ts.step,
            "digest": state_digest(core.ts), "graphed": step.graphed,
            "launches": launch_counts(), "state": numpy_state(core.rs)}


def rank_external(mesh: Mesh, case: dict) -> dict:
    """The sharded external-batch step on this rank's rows of each global
    batch of ``case["batches"]`` (numpy fields): per step the loss, grad
    norm, this rank's priorities, params and target; the digest."""
    configure_numerics()
    spec, net, optim, ts = _train_state(case, mesh)
    step = make_sharded_external_batch_step(net, spec, optim,
                                            net.config.use_double, mesh)
    lo = mesh.rank * step.local_batch
    hi = lo + step.local_batch
    trace = []
    for fields in case["batches"]:
        batch = SampleBatch(**{
            name: torch.from_numpy(np.array(a[lo:hi])).to(mesh.device)
            for name, a in fields.items()})
        ts, m = step(ts, batch)
        trace.append({
            "loss": _np(m["loss"]), "grad_norm": _np(m["grad_norm"]),
            "priorities": _np(m["priorities"]),
            "params": {n: _np(v) for n, v in ts.params.state_dict().items()},
            "target": {n: _np(v)
                       for n, v in ts.target_params.state_dict().items()}})
    return {"trace": trace, "digest": state_digest(ts),
            "graphed": step.graphed, "launches": launch_counts()}
