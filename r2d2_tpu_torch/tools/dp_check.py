"""Checks of the data- and tensor-parallel paths that run on every rank of
a world (``parallel.mesh.run_ranks``): the sharded learner step from given
shards, weights and jitter, dp x mp with ``mesh.mp`` > 1 (``rank_steps``),
the sharded block ingest against per-block adds (``rank_adds``), the
tensor-parallel host-batch step (``rank_tp_external``) and the
sequence-parallel unroll (``rank_sp_lstm``). The tests hold
their results against the JAX package's sharded and tensor-parallel steps
on the CPU; ``chip_smoke.py`` runs them with ranks on the card.

Each function takes this rank's ``Mesh`` and a picklable case and returns
numpy results. ``case["diag"]`` / ``case["rdiag"]`` (the fields of
``LearningDiag`` / ``ReplayDiag``) turn the diagnostics on in the steps of
``rank_steps`` and ``rank_tp_external``; each dispatch's ``ld/`` and
``rd/`` values are then in its record's ``diag``.
"""

import contextlib
import hashlib
import time
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
from r2d2_tpu_torch.parallel.sharded import (gather_objects,
                                             make_sharded_learner_step,
                                             make_sharded_replay_add,
                                             make_sharded_replay_add_many,
                                             sharded_buffer_steps,
                                             sharded_replay_init,
                                             state_digest)
from r2d2_tpu_torch.parallel.tensor_parallel import (
    all_gather_features, make_tp_external_batch_step, place_train_state)
from r2d2_tpu_torch.replay.structs import (DIAG_LEAVES, ReplaySpec,
                                           SampleBatch, stack_blocks)
from r2d2_tpu_torch.telemetry.learning import LearningDiag
from r2d2_tpu_torch.telemetry.replaydiag import ReplayDiag
from r2d2_tpu_torch.utils.device import configure_numerics

REPLAY_FIELDS = ("tree", "obs", "last_action", "hidden", "action", "reward",
                 "gamma", "burn_in_steps", "learning_steps", "forward_steps",
                 "seq_start", "weight_version", "lane")


def _np(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (a CPU tensor's .numpy() shares its storage, which the
    next dispatch updates in place)."""
    return t.detach().cpu().numpy().copy()


def numpy_state(state) -> Dict[str, np.ndarray]:
    """A replay shard's fields as numpy, the replay diagnostics' leaves
    where it holds them."""
    out = {name: _np(getattr(state, name)) for name in REPLAY_FIELDS}
    out.update({name: _np(getattr(state, name)) for name in DIAG_LEAVES
                if getattr(state, name, None) is not None})
    out["block_ptr"] = np.asarray(state.block_ptr)
    return out


def _sha(arrays: Dict[str, np.ndarray]) -> str:
    """sha256 of named arrays, by name."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        h.update(name.encode())
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()


def replay_digest(state) -> str:
    """sha256 of a replay shard's fields: equal on a dp row's replicas."""
    return _sha(numpy_state(state))


def full_params(module) -> Dict[str, np.ndarray]:
    """A module's full parameters as numpy (a tensor-parallel module's
    gathered over its row: every rank of the row calls this)."""
    state = (module.full_state_dict() if hasattr(module, "full_state_dict")
             else module.state_dict())
    return {name: _np(v) for name, v in state.items()}


def _diags(case: dict):
    """The case's (LearningDiag, ReplayDiag), None where it has none."""
    diag, rdiag = case.get("diag"), case.get("rdiag")
    return (None if diag is None else LearningDiag(**diag),
            None if rdiag is None else ReplayDiag(**rdiag))


def _diag_record(metrics: dict) -> dict:
    """A dispatch's diagnostic values as numpy, by key."""
    return {k: _np(v) for k, v in metrics.items()
            if k.startswith(("ld/", "rd/"))}


def _params_record(ts, mesh: Mesh, case: dict, last: bool) -> dict:
    """A step's record of the full params and target: their sha256 on
    every rank and the arrays; ``case["light"]`` (the reference widths)
    keeps them to the last step, the arrays to rank 0's."""
    rec = {}
    if case.get("light") and not last:
        return rec
    for key, module in (("params", ts.params), ("target", ts.target_params)):
        full = full_params(module)
        rec[key + "_sha"] = _sha(full)
        if not case.get("light") or (mesh.leader and last):
            rec[key] = full
    return rec


def _network(case: dict, mesh: Mesh):
    """(spec, net, optim, train state) on this rank's device, the weights
    ``case["params"]`` (a state dict of numpy arrays) or, without them,
    ``net.init(case["init_seed"])``; the sampling generator seeded
    ``case.get("seed", 0)`` + the dp row."""
    device = mesh.device
    spec = ReplaySpec(**case["spec"])
    net = NetworkApply(case["action_dim"], NetworkConfig(**case["network"]),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       device)
    optim = OptimConfig(**case["optim"])
    if "params" in case:
        online = net.build()
        online.load_state_dict({name: torch.from_numpy(np.array(v))
                                for name, v in case["params"].items()})
    else:
        online = net.init(case["init_seed"])
    target = online
    if net.config.use_double:
        target = net.build()
        target.load_state_dict(online.state_dict())
    ts = TrainState(params=online, target_params=target,
                    opt=make_optimizer(optim, online), step=0,
                    generator=torch.Generator(device=device).manual_seed(
                        case.get("seed", 0) + mesh.dp_rank))
    return spec, net, optim, ts


def host_batches(spec: ReplaySpec, blocks: int, count: int,
                 seed: int) -> list:
    """``count`` batches (numpy fields by name) that a host replay of
    ``blocks`` synthetic blocks (from ``seed``) samples: the same in every
    process."""
    from r2d2_tpu_torch.replay.host_replay import HostReplay
    from r2d2_tpu_torch.replay.structs import batch_fields
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    host = HostReplay(spec, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(blocks):
        host.add(make_synthetic_block(spec, rng))
    return [{name: np.array(a) for name, a in
             batch_fields(host.sample()[0]).items()} for _ in range(count)]


def rank_steps(mesh: Mesh, case: dict) -> dict:
    """``case["dispatches"]`` dispatches of ``case["k"]`` data-parallel
    steps on this rank's shard ``case["shards"][dp]`` (numpy replay
    fields; dp = ``mesh.dp_rank``), from ``_network``'s weights, with the
    jitter ``case["jitter"][dp]`` (D, K, B) or this dp row's generator
    when it is None. ``mesh.mp`` > 1: the dp x mp step, the train state
    sharded by ``case["min_shard_width"]``. Returns, per dispatch, the
    stacked losses and grad norms, the shard's tree, the (full) params and
    target (``_params_record``) and the dispatch's seconds (host clock,
    synced by the copy of its losses); the train state's and the replay's
    digests, the shapes this rank holds and this process's kernel launch
    counts."""
    configure_numerics()
    device = mesh.device
    spec, net, optim, ts = _network(case, mesh)
    if mesh.mp > 1:
        ts = place_train_state(ts, net, optim, mesh,
                               case.get("min_shard_width", 32))
    rs = replay_state_from_jax(types.SimpleNamespace(
        **case["shards"][mesh.dp_rank]), spec, device)
    diag, rdiag = _diags(case)
    step = make_sharded_learner_step(net, spec, optim, net.config.use_double,
                                     mesh, case["k"], diag=diag, rdiag=rdiag)
    jitter = case.get("jitter")
    trace = []
    for d in range(case["dispatches"]):
        uniform = None
        if jitter is not None:
            uniform = torch.from_numpy(np.array(jitter[mesh.dp_rank][d])
                                       ).to(device)
        t0 = time.perf_counter()
        ts, rs, m = step(ts, rs, uniform)
        rec = {"loss": _np(m["loss"]), "seconds": time.perf_counter() - t0,
               "grad_norm": _np(m["grad_norm"]), "tree": _np(rs.tree),
               "diag": _diag_record(m)}
        rec.update(_params_record(ts, mesh, case,
                                  d == case["dispatches"] - 1))
        trace.append(rec)
    return {"trace": trace, "digest": state_digest(ts), "step": ts.step,
            "graphed": step.graphed, "launches": launch_counts(),
            "buffer_steps": sharded_buffer_steps(rs, mesh),
            "replay_digest": replay_digest(rs),
            "shapes": {n: tuple(p.shape)
                       for n, p in ts.params.named_parameters()}}


@contextlib.contextmanager
def pre_clip_gradients(out: list):
    """While it is open, every train body's step appends its gradients as
    they reach the clip (after the data- and tensor-parallel reductions),
    cloned, to ``out``: what clip and Adam start from. The body looks
    the clip up at each step, so it is wrapped for the duration."""
    from r2d2_tpu_torch.learner import train_step
    clip = train_step.clip_by_global_norm_

    def tap(grads, max_norm, sq_norm=None):
        out.append([g.detach().clone() for g in grads])
        return clip(grads, max_norm, sq_norm)

    train_step.clip_by_global_norm_ = tap
    try:
        yield out
    finally:
        train_step.clip_by_global_norm_ = clip


def _tp_external_run(mesh: Mesh, case: dict, batches) -> tuple:
    """``rank_tp_external``'s steps over ``batches``: (trace, train
    state)."""
    spec, net, optim, ts = _network(case, mesh)
    diag, rdiag = _diags(case)
    step, place_state, place_batch = make_tp_external_batch_step(
        net, spec, optim, net.config.use_double, mesh,
        case.get("min_shard_width", 32), diag=diag, rdiag=rdiag)
    ts = place_state(ts)
    trace = []
    for i, fields in enumerate(batches):
        batch = (SampleBatch(**{name: np.array(a)
                                for name, a in fields.items()})
                 if mesh.leader else None)
        t0 = time.perf_counter()
        ts, m = step(ts, place_batch(batch))
        rec = {"loss": _np(m["loss"]), "seconds": time.perf_counter() - t0,
               "grad_norm": _np(m["grad_norm"]),
               "priorities": _np(m["priorities"]), "diag": _diag_record(m)}
        rec.update(_params_record(ts, mesh, case, i == len(batches) - 1))
        trace.append(rec)
    return trace, ts


def rank_tp_external(mesh: Mesh, case: dict) -> dict:
    """The tensor-parallel host-batch step (``make_tp_external_batch_step``
    with ``case["min_shard_width"]``) from ``_network``'s weights over
    rank 0's global batches, ``case["batches"]`` (numpy fields by name) or
    ``host_batches(spec, *case["host_batches"])``; each dp row trains on
    its rows. Per step: the loss, grad norm, the whole batch's priorities,
    the full params and target (``_params_record``) and the step's seconds
    (host clock, synced by the copy of the loss); the shapes this rank
    holds, its digest and its launch counts. ``case["control"]``: then
    the same steps again from the same weights with each sharded layer's
    partial input gradients left unsummed over the row (``_CopyToMP``'s
    backward without its all-reduce), a negative control that a parity
    check of the backward must fail; their final full params are
    ``control_params`` (rank 0), their launches not counted.
    ``case["f32_grads"]``: then the first step again from the same
    weights with that network config (f32 compute) and no diagnostics,
    its gradients taken before the clip (``pre_clip_gradients``) and
    gathered over the row: ``f32_grads`` (full, by name) and
    ``f32_grad_loss`` (rank 0), its launches not counted."""
    configure_numerics()
    batches = case.get("batches")
    if batches is None:
        blocks, count, seed = case["host_batches"]
        batches = (host_batches(ReplaySpec(**case["spec"]), blocks, count,
                                seed) if mesh.leader else [None] * count)
    trace, ts = _tp_external_run(mesh, case, batches)
    out = {"trace": trace, "digest": state_digest(ts),
           "shapes": {n: tuple(p.shape)
                      for n, p in ts.params.named_parameters()},
           "launches": launch_counts()}
    if case.get("control"):
        from r2d2_tpu_torch.parallel import tensor_parallel
        saved = tensor_parallel._CopyToMP.__dict__["backward"]
        tensor_parallel._CopyToMP.backward = staticmethod(
            lambda ctx, grad: (grad, None))
        try:
            control, _ = _tp_external_run(mesh, {**case, "light": True},
                                          batches)
        finally:
            tensor_parallel._CopyToMP.backward = saved
        out["control_params"] = control[-1].get("params")
    if case.get("f32_grads"):
        f32_case = {k: v for k, v in case.items()
                    if k not in ("diag", "rdiag")}
        taps: list = []
        with pre_clip_gradients(taps):
            f32, ts32 = _tp_external_run(
                mesh, {**f32_case, "light": True,
                       "network": case["f32_grads"]}, batches[:1])
        dims = ts32.params.shard_dims
        full = {name: (g if dims[name] is None
                       else all_gather_features(g, dims[name], mesh))
                for (name, _), g in zip(ts32.params.named_parameters(),
                                        taps[0])}
        if mesh.leader:
            out["f32_grads"] = {name: _np(g) for name, g in full.items()}
            out["f32_grad_loss"] = f32[0]["loss"]
    return out


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



def sp_inputs(batch: int, steps: int, hidden: int, seed: int) -> dict:
    """``make_sp_lstm``'s arguments from ``seed`` (f32, the CPU): the same
    in every process."""
    gen = torch.Generator().manual_seed(seed)
    return {"w_rec": torch.randn((hidden, 4 * hidden), generator=gen)
            / hidden ** 0.5,
            "bias": torch.randn((4 * hidden,), generator=gen),
            "x_proj": torch.randn((batch, steps, 4 * hidden), generator=gen),
            "carry0": torch.randn((2, batch, hidden), generator=gen)}


def rank_sp_lstm(mesh: Mesh, case: dict):
    """This stage's ``make_sp_lstm`` run with ``case["microbatches"]`` on
    ``case["inputs"]`` (numpy ``w_rec``, ``bias``, ``x_proj``, ``carry0``)
    or ``sp_inputs(*case["sp_inputs"])``, on its device: (outputs, final
    carry) as numpy, the ValueErrors of the window and the batch cut by one
    (T % S != 0 and B % M != 0 where S and M exceed 1; raised before any
    collective), the run's seconds (host clock, synced) and this process's
    launch counts."""
    from r2d2_tpu_torch.parallel.sequence_parallel import make_sp_lstm
    run = make_sp_lstm(mesh, case["microbatches"])
    args = ({k: torch.from_numpy(np.array(v))
             for k, v in case["inputs"].items()} if "inputs" in case
            else sp_inputs(*case["sp_inputs"]))
    args = {k: v.to(mesh.device) for k, v in args.items()}
    errors = []
    for cut in ({"x_proj": args["x_proj"][:, :-1]},
                {"x_proj": args["x_proj"][:-1],
                 "carry0": args["carry0"][:, :-1]}):
        try:
            run(**{**args, **cut})
        except ValueError as e:
            errors.append(str(e))
    t0 = time.perf_counter()
    out, final = run(**args)
    out, final = _np(out), _np(final)
    return out, final, errors, time.perf_counter() - t0, launch_counts()


def rank_snapshot_twin(mesh: Mesh, case: dict) -> dict:
    """The crash-recovery twin of a data- or tensor-parallel ``Learner``
    (``case["cfg"]``, a Config dict; either placement): rank 0 ingests
    ``case["blocks"]`` round-robin, cuts the replay when snapshots are on
    (the capture it returns unless ``case["cut"]`` is false), takes
    ``case["steps"]`` steps, publishes (``full_params``: under mp > 1 dp
    row 0 gathers the shards), checkpoints (under mp > 1 the gathered
    train state), snapshots when they are on, then ingests
    ``case["extra_block"]`` and takes ``case.get("after", 3)`` more steps
    (the twin's losses). A second Learner resumed from that checkpoint
    (and snapshot) publishes, ingests the same block and takes as many. Every other
    rank follows both. Rank 0 returns the cut, both loss lists, the
    published full parameters' sha256 at the save and the resumed
    learner's at its start, their shapes, and the resumed learner's
    restores and ``next_shard`` as it was restored; every rank the shapes
    it holds and its launch counts over both learners."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    cfg = Config.from_dict(case["cfg"])
    net = NetworkApply(case["action_dim"], cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width,
                       mesh.device)
    out, after = {}, case.get("after", 3)
    learner = Learner(cfg, net, mesh=mesh)
    snapshots = cfg.runtime.snapshot_interval > 0
    ckpt = None
    try:
        if mesh.leader:
            for block in case["blocks"]:
                learner.ingest(block)
            if snapshots and case.get("cut", True):
                out["cut"] = learner._capture_replay()
            out["losses"] = [learner.step()["loss"].item()
                             for _ in range(case["steps"])]
            published = learner.full_params()
            out["published_sha"] = _sha(full_params(published))
            out["full_shapes"] = {n: tuple(p.shape) for n, p in
                                  published.named_parameters()}
            ckpt = learner.save(1)
            if snapshots:
                learner.snapshot_replay()
                if not learner._snap_writer.drain(30.0):
                    raise RuntimeError("the snapshot was not written")
            learner.ingest(case["extra_block"])
            out["twin"] = [learner.step()["loss"].item()
                           for _ in range(after)]
        else:
            learner.follow()
    finally:
        learner.stop_background()
    out["shapes"] = {n: tuple(p.shape) for n, p in
                     learner.train_state.params.named_parameters()}
    ckpt = gather_objects(ckpt, mesh)[0]
    resumed = Learner(cfg.replace(**{"runtime.resume": ckpt}), net,
                      mesh=mesh)
    try:
        if mesh.leader:
            out["next_shard"] = resumed._next_shard
            out["restores"] = resumed._restores
            out["resumed_sha"] = _sha(full_params(resumed.full_params()))
            resumed.ingest(case["extra_block"])
            out["resumed"] = [resumed.step()["loss"].item()
                              for _ in range(after)]
            if snapshots:
                out["capture_ms"] = learner.snapshot_capture_ms[-1]
                out["written"] = learner._snap_writer.last_meta
        else:
            resumed.follow()
    finally:
        resumed.stop_background()
    out["launches"] = launch_counts()
    return out
