"""Checks of the data-parallel path that run on every rank of a world
(``parallel.mesh.run_ranks``): the sharded learner step from given shards,
weights and jitter (``rank_steps``), and the sharded block ingest against
per-block adds (``rank_adds``). The tests hold their results against the
JAX package's sharded step on the CPU; ``chip_smoke.py`` runs them with
ranks on the card.

Each function takes this rank's ``Mesh`` and a picklable case and returns
numpy results.
"""

import types
from typing import Dict

import numpy as np
import torch

from r2d2_tpu_torch.config import NetworkConfig, OptimConfig
from r2d2_tpu_torch.learner.train_step import TrainState, make_optimizer
from r2d2_tpu_torch.models.convert import replay_state_from_jax
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.ops.launch_counts import launch_counts
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.parallel.sharded import (make_sharded_learner_step,
                                             make_sharded_replay_add,
                                             make_sharded_replay_add_many,
                                             sharded_buffer_steps,
                                             sharded_replay_init,
                                             state_digest)
from r2d2_tpu_torch.replay.structs import ReplaySpec, stack_blocks
from r2d2_tpu_torch.utils.device import configure_numerics

REPLAY_FIELDS = ("tree", "obs", "last_action", "hidden", "action", "reward",
                 "gamma", "burn_in_steps", "learning_steps", "forward_steps",
                 "seq_start", "weight_version", "lane")


def _np(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (a CPU tensor's .numpy() shares its storage, which the
    next dispatch updates in place)."""
    return t.detach().cpu().numpy().copy()


def numpy_state(state) -> Dict[str, np.ndarray]:
    out = {name: _np(getattr(state, name)) for name in REPLAY_FIELDS}
    out["block_ptr"] = np.asarray(state.block_ptr)
    return out


def rank_steps(mesh: Mesh, case: dict) -> dict:
    """``case["dispatches"]`` dispatches of ``case["k"]`` data-parallel
    steps on this rank's shard ``case["shards"][rank]`` (numpy replay
    fields), from the weights ``case["params"]`` (a state dict of numpy
    arrays), with the jitter ``case["jitter"][rank]`` (D, K, B) or this
    rank's generator (seeded ``case["seed"]``) when it is None. Returns,
    per dispatch, the stacked losses and grad norms, the params, target
    params and the shard's tree; the train state's digest and this
    process's kernel launch counts."""
    configure_numerics()
    device = mesh.device
    spec = ReplaySpec(**case["spec"])
    net = NetworkApply(case["action_dim"], NetworkConfig(**case["network"]),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       device)
    optim = OptimConfig(**case["optim"])
    use_double = net.config.use_double
    params = {name: torch.from_numpy(np.array(v))
              for name, v in case["params"].items()}
    online = net.build()
    online.load_state_dict(params)
    target = online
    if use_double:
        target = net.build()
        target.load_state_dict(params)
    seed = case.get("seed", 0)
    ts = TrainState(params=online, target_params=target,
                    opt=make_optimizer(optim, online), step=0,
                    generator=torch.Generator(device=device).manual_seed(
                        seed + mesh.rank))
    rs = replay_state_from_jax(types.SimpleNamespace(
        **case["shards"][mesh.rank]), spec, device)
    step = make_sharded_learner_step(net, spec, optim, use_double, mesh,
                                     case["k"])
    jitter = case.get("jitter")
    trace = []
    for d in range(case["dispatches"]):
        uniform = None
        if jitter is not None:
            uniform = torch.from_numpy(np.array(jitter[mesh.rank][d])
                                       ).to(device)
        ts, rs, m = step(ts, rs, uniform)
        trace.append({
            "loss": _np(m["loss"]), "grad_norm": _np(m["grad_norm"]),
            "params": {n: _np(v) for n, v in ts.params.state_dict().items()},
            "target": {n: _np(v)
                       for n, v in ts.target_params.state_dict().items()},
            "tree": _np(rs.tree)})
    return {"trace": trace, "digest": state_digest(ts), "step": ts.step,
            "graphed": step.graphed, "launches": launch_counts(),
            "buffer_steps": sharded_buffer_steps(rs, mesh)}


def rank_adds(mesh: Mesh, case: dict) -> list:
    """For each start shard of ``case["starts"]``, rank 0's
    ``case["blocks"]`` (numpy Blocks) into empty shards twice: one
    ``make_sharded_replay_add_many`` from that start, and one
    ``make_sharded_replay_add`` a block at shards ``(start + i) % dp``.
    Returns this rank's two shards as numpy fields, a pair a start."""
    spec = ReplaySpec(**case["spec"])
    blocks = case["blocks"]
    lead = mesh.leader
    add_many = make_sharded_replay_add_many(spec, mesh)
    add = make_sharded_replay_add(spec, mesh)
    out = []
    for start in case["starts"]:
        batch = sharded_replay_init(spec, mesh)
        add_many(batch, stack_blocks(blocks) if lead else None, start,
                 len(blocks))
        single = sharded_replay_init(spec, mesh)
        for i, block in enumerate(blocks):
            add(single, block if lead else None, (start + i) % mesh.dp)
        out.append({"batch": numpy_state(batch),
                    "single": numpy_state(single)})
    return out
