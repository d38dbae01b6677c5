"""Tiny-shape validation steps of the parallel paths, the JAX package's
``parallel/dryrun.py``: the dp-sharded fused step, the sequence-parallel
unroll, the dp x mp device-replay step, the tensor-parallel host-batch
step and the fused-LSTM step, each at toy sizes.

Each ``run_tiny_*`` function is a rank function: it takes this rank's
``Mesh`` and runs on every rank of a world started by
``parallel.mesh.run_ranks`` (gloo on the CPU; on one card, gloo ranks
sharing it) or joined by ``init_distributed`` (``multihost_dryrun``). It
asserts a finite loss and the replicas' agreement, and returns the loss.
The blocks come from one seeded generator, so every process builds the
same ones.
"""

from typing import Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import NetworkConfig, OptimConfig
from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                               make_learner_step)
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.replay.structs import ReplaySpec
from r2d2_tpu_torch.replay.synthetic import make_synthetic_block

_TINY_BATCH = 4   # _tiny_setup's batch size; the TP dryrun shards it over dp
ACTIONS = 18    # make_synthetic_block draws actions below 18
MIN_SHARD_WIDTH = 8   # the tiny network's 4H = 64 and cnn 32 shard at mp 2


def tp_dryrun_fits(n_devices: int) -> bool:
    """True when a dp=(n/2) x mp=2 mesh can shard the tiny batch evenly."""
    return n_devices % 2 == 0 and _TINY_BATCH % (n_devices // 2) == 0


def _tiny_setup(device, **network):
    """The dryruns' (spec, optim, net) on ``device``: one source of the
    shapes."""
    spec = ReplaySpec(
        num_blocks=4, seqs_per_block=2, block_length=10, burn_in=4,
        learning=5, forward=3, frame_stack=2, frame_height=20, frame_width=20,
        hidden_dim=16, batch_size=_TINY_BATCH, prio_exponent=0.9,
        is_exponent=0.6)
    ncfg = NetworkConfig(hidden_dim=16, cnn_out_dim=32,
                         conv_layers=((8, 4, 2), (16, 3, 1)), use_double=True,
                         **network)
    optim = OptimConfig(target_net_update_interval=2)
    net = NetworkApply(ACTIONS, ncfg, spec.frame_stack, spec.frame_height,
                       spec.frame_width, device)
    return spec, optim, net


def _check_finite(loss: float, what: str) -> float:
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite {what} loss {loss}")
    return loss


def _sharded_replay(spec, mesh: Mesh):
    """This rank's replay shard, one synthetic block written into every
    shard."""
    from r2d2_tpu_torch.parallel.sharded import (make_sharded_replay_add,
                                                 sharded_replay_init)
    rs = sharded_replay_init(spec, mesh)
    add = make_sharded_replay_add(spec, mesh)
    rng = np.random.default_rng(0)
    for d in range(mesh.dp):
        block = make_synthetic_block(spec, rng)
        add(rs, block if mesh.leader else None, d)
    return rs


def run_tiny_sharded_step(mesh: Mesh) -> float:
    """One dp-sharded fused step (sample, unroll, loss, gradient mean,
    Adam, priority write-back) over the mesh; asserts a finite loss and
    the train state bit-equal on every rank."""
    from r2d2_tpu_torch.parallel.sharded import (gather_objects,
                                                 make_sharded_learner_step,
                                                 state_digest)
    spec, optim, net = _tiny_setup(mesh.device)
    ts = create_train_state(net, optim, 1, True)
    rs = _sharded_replay(spec, mesh)
    step = make_sharded_learner_step(net, spec, optim, True, mesh)
    ts, rs, metrics = step(ts, rs)
    loss = _check_finite(float(metrics["loss"]), "sharded")
    digests = gather_objects(state_digest(ts), mesh)
    if len(set(digests)) != 1:
        raise AssertionError(f"the ranks' train states differ: {digests}")
    return loss


def run_tiny_sp_step(mesh: Mesh) -> float:
    """One pipelined sequence-parallel LSTM unroll over the mesh's ranks
    (parallel/sequence_parallel.py, 4 microbatches), checked against the
    unsharded lean scan: bit for bit on the CPU, f32 atol 2e-6 on the
    card. Returns the |outputs| sum."""
    from r2d2_tpu_torch.ops.lstm_kernels import lstm_fwd
    from r2d2_tpu_torch.parallel.sequence_parallel import make_sp_lstm
    batch, steps, width, hidden = 8, 2 * mesh.world, 10, 8
    gen = torch.Generator().manual_seed(0)
    xs = torch.randn((batch, steps, width), generator=gen)
    w_in = torch.randn((width, 4 * hidden), generator=gen) / width ** 0.5
    w_rec = torch.randn((hidden, 4 * hidden), generator=gen) / hidden ** 0.5
    bias = torch.randn((4 * hidden,), generator=gen)
    carry0 = torch.randn((2, batch, hidden), generator=gen)
    x_proj, w_rec, bias, carry0 = (t.to(mesh.device) for t in
                                   (xs @ w_in, w_rec, bias, carry0))
    out, final = make_sp_lstm(mesh, microbatches=4)(w_rec, bias, x_proj,
                                                    carry0)
    hseq, c_fin = lstm_fwd((x_proj + bias).transpose(0, 1).contiguous(),
                           w_rec, carry0[0], carry0[1],
                           save_residuals=False)
    atol = 0.0 if mesh.device.type == "cpu" else 2e-6
    torch.testing.assert_close(out, hseq.transpose(0, 1), atol=atol, rtol=0)
    torch.testing.assert_close(final, torch.stack([c_fin, hseq[-1]]),
                               atol=atol, rtol=0)
    return float(out.abs().sum())


def run_tiny_device_mp_step(mesh: Mesh) -> float:
    """One fused device-replay step over a dp x mp mesh with mp > 1: the
    replay dp-sharded (each dp row's ranks hold replicas), the wide
    parameters feature-sharded over mp (parallel/sharded.py's dp x mp
    step). Asserts a finite loss and a parameter genuinely sharded."""
    from r2d2_tpu_torch.parallel.sharded import make_sharded_learner_step
    from r2d2_tpu_torch.parallel.tensor_parallel import place_train_state
    spec, optim, net = _tiny_setup(mesh.device)
    ts = place_train_state(create_train_state(net, optim, 1, True), net,
                           optim, mesh, MIN_SHARD_WIDTH)
    rs = _sharded_replay(spec, mesh)
    step = make_sharded_learner_step(net, spec, optim, True, mesh)
    ts, rs, metrics = step(ts, rs)
    loss = _check_finite(float(metrics["loss"]), "device-mp")
    full = dict(net.param_specs)
    if not any(tuple(p.shape) != tuple(full[n])
               for n, p in ts.params.named_parameters()):
        raise AssertionError("no parameter is sharded over mp in the "
                             "device-mp dryrun")
    return loss


def run_tiny_tp_step(mesh: Mesh) -> float:
    """One tensor-parallel host-batch step over a dp x mp mesh
    (parallel/tensor_parallel.py): rank 0 samples one batch from a
    single replay and scatters each dp row its rows. Returns the loss."""
    from r2d2_tpu_torch.parallel.tensor_parallel import (
        make_tp_external_batch_step)
    from r2d2_tpu_torch.replay.device_replay import (replay_add,
                                                     replay_init,
                                                     replay_sample)
    spec, optim, net = _tiny_setup(mesh.device)
    batch = None
    if mesh.leader:
        rs = replay_init(spec, torch.device("cpu"))
        replay_add(spec, rs, make_synthetic_block(
            spec, np.random.default_rng(0)))
        batch = replay_sample(spec, rs, generator=torch.Generator()
                              .manual_seed(3))
    step, place_state, place_batch = make_tp_external_batch_step(
        net, spec, optim, True, mesh, MIN_SHARD_WIDTH)
    ts = place_state(create_train_state(net, optim, 1, True))
    ts, metrics = step(ts, place_batch(batch))
    return _check_finite(float(metrics["loss"]), "tp")


def run_tiny_plstm_step(mesh: Optional[Mesh] = None,
                        device: Optional[str] = None) -> float:
    """One fused learner step with the fused LSTM scan (``pallas_lstm=
    "on"``) on the mesh's device, or without a mesh on ``device`` (CUDA
    unless the caller asks for "cpu"; no card raises): on the card its
    residual forward, lean forward and backward kernels (K4, K4 lean, K5)
    inside the step, on the CPU their plain versions. Returns the loss."""
    from r2d2_tpu_torch.replay.device_replay import replay_add, replay_init
    from r2d2_tpu_torch.utils.device import resolve_device
    device = mesh.device if mesh is not None else resolve_device(device)
    spec, optim, net = _tiny_setup(device, pallas_lstm="on")
    ts = create_train_state(net, optim, 1, True)
    rs = replay_init(spec, device)
    rng = np.random.default_rng(0)
    for _ in range(spec.num_blocks):
        replay_add(spec, rs, make_synthetic_block(spec, rng))
    ts, rs, metrics = make_learner_step(net, spec, optim, True)(ts, rs)
    return _check_finite(float(metrics["loss"]), "plstm")

