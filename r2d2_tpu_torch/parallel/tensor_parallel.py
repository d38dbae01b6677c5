"""Tensor (model) parallelism over the mesh's mp axis, the JAX package's
``parallel/tensor_parallel.py`` over ``torch.distributed``.

JAX re-jits the unchanged step with the wide feature dims annotated over
'mp' and lets GSPMD insert the collectives. Here the collectives are
written out, column-parallel, over each dp row's ranks (``mesh.mp_group``,
parallel/mesh.py):

* The rule is JAX's (``leaf_partition_spec``): a leaf's trailing
  (output-feature) axis is sharded over mp when it divides evenly and each
  shard keeps at least ``min_shard_width`` features; everything else stays
  replicated. It is applied to each port parameter's flax counterpart
  (models/convert.py ``flax_shape``), so the sharded dim is dim 0 of a conv
  or Linear weight and of its bias, and dim 1 of the LSTM's (H, 4H)
  recurrent kernel. Adam's moments follow their params.
* The forward (``TPNetwork``, the network's own forward with the layer
  calls of ``_TPCalls``): each rank computes its output-feature slice
  of every sharded conv or dense layer, then all-gathers the slices along
  the feature axis (``_GatherFeatures``, whose backward takes the local
  slice back: every rank of the row computes the same gradient
  downstream). The layer's input passes ``_CopyToMP``, the identity whose
  backward all-reduces the partial input gradients over the row. Narrow
  layers (the 32-wide first conv at mp = 2, the action and value outputs)
  run replicated.
* The LSTM: ``input_proj`` is column-parallel; the recurrent kernel and
  the bias are all-gathered once an unroll, and the fused scan
  (ops/lstm_kernels.py: K4, K4 lean and K5 on the card) then runs on the
  full (T, B, 4H) input, so no collective sits in the T-step serial chain.
* A replicated leaf's gradient is computed on every rank of its row from
  the same values, but cuDNN's weight-gradient algorithms may sum in
  another order in each process; after the dp mean ``TPGradients``
  broadcasts the replicated gradients over the row from its first rank,
  so the row's replicas stay bit-equal.
* The clip's global norm counts every element once
  (``TPGradients.sq_norm``): the sharded leaves' squares summed over the
  row, the replicated ones once.
* The dispatches run eagerly on both backends: gloo's collectives stage
  through the host and cannot be captured in a CUDA graph, and an NCCL
  capture of the step is not built yet. With gloo a collective's tensor
  is copied to host memory and back.
"""

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from r2d2_tpu_torch.config import OptimConfig
from r2d2_tpu_torch.learner.train_step import (TrainState,
                                               make_external_batch_step,
                                               make_optimizer)
from r2d2_tpu_torch.models.convert import OUT_DIM, flax_shape, leaf_kind
from r2d2_tpu_torch.models.network import (LayerCalls, NetworkApply,
                                           R2D2Network)
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.parallel.sharded import (BatchMean, DpRowGather,
                                             broadcast_train_state,
                                             pack_rows, unpack_rows,
                                             wire_layout)
from r2d2_tpu_torch.replay.host_replay import batch_layout
from r2d2_tpu_torch.replay.structs import ReplaySpec, SampleBatch

# the fields of a host batch that the step reads (the scatter's)
_TRAIN_FIELDS = ("obs", "last_action", "hidden", "action", "reward",
                 "gamma", "burn_in_steps", "learning_steps", "forward_steps",
                 "is_weights", "idxes")


# -- the rule ---------------------------------------------------------------


def leaf_partition_spec(shape, mp: int, min_shard_width: int = 32) -> tuple:
    """JAX's rule for one flax leaf, as PartitionSpec's entries: ``(None,
    ..., "mp")`` shards the trailing axis when it divides evenly over
    ``mp`` and each shard is at least ``min_shard_width`` wide; ``()``
    keeps the leaf replicated (scalars, small head outputs, odd shapes)."""
    if mp <= 1 or not shape:
        return ()
    last = shape[-1]
    if last % mp != 0 or last // mp < min_shard_width:
        return ()
    return (None,) * (len(shape) - 1) + ("mp",)


def shard_dim(name: str, shape, mp: int,
              min_shard_width: int = 32) -> Optional[int]:
    """The dim of port parameter ``name`` (of ``shape``) sharded over mp:
    the port's dim of its flax leaf's trailing axis where JAX's rule
    shards that leaf; None where it stays replicated."""
    if not leaf_partition_spec(flax_shape(name, shape), mp, min_shard_width):
        return None
    return OUT_DIM[leaf_kind(name)] % len(shape)


def state_shardings(net: NetworkApply, mp: int,
                    min_shard_width: int = 32) -> Dict[str, Optional[int]]:
    """``shard_dim`` of every parameter of ``net``'s network, by name in
    ``parameters()`` order; the optimizer's moments follow their
    parameter."""
    return {name: shard_dim(name, shape, mp, min_shard_width)
            for name, shape in net.param_specs}


# -- collectives over a dp row ----------------------------------------------


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A contiguous copy of ``t`` as a collective of the mesh takes it:
    on the device with NCCL, in host memory with gloo."""
    t = t.detach()
    if mesh.backend == "gloo":
        return t.to("cpu").contiguous().clone()
    return t.contiguous().clone()


def all_gather_features(t: torch.Tensor, dim: int, mesh: Mesh
                        ) -> torch.Tensor:
    """The row's slices of ``t`` concatenated along ``dim`` in mp order."""
    x = _wire(t, mesh)
    parts = [torch.empty_like(x) for _ in range(mesh.mp)]
    dist.all_gather(parts, x, group=mesh.mp_group)
    return torch.cat(parts, dim).to(t.device, t.dtype)


def all_reduce_row(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the row (a new tensor)."""
    if mesh.mp == 1:
        return t
    x = _wire(t, mesh)
    dist.all_reduce(x, group=mesh.mp_group)
    return x.to(t.device, t.dtype)


def gather_dp_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every dp row's ``t`` concatenated along dim 0 in dp order (the
    ranks of one mp index)."""
    if mesh.dp == 1:
        return t
    x = _wire(t, mesh)
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.dp_group)
    return torch.cat(parts, 0).to(t.device, t.dtype)


class _CopyToMP(torch.autograd.Function):
    """The input of a column-parallel layer: the identity forward, the
    all-reduce over the row of the partial input gradients backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_row(grad, ctx.mesh), None


class _GatherFeatures(torch.autograd.Function):
    """A column-parallel output: the row's slices all-gathered along
    ``dim``; backward keeps this rank's slice of the (row-wide equal)
    gradient."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.width = dim, mesh, x.shape[dim]
        return all_gather_features(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.mp_rank * ctx.width
        return grad.narrow(ctx.dim, start, ctx.width).contiguous(), None, None


# -- the network --------------------------------------------------------------


class _TPCalls(LayerCalls):
    """The layer calls of a ``TPNetwork``'s modules (models/network.py
    ``LayerCalls``): a sharded dense or conv layer takes its input through
    ``_CopyToMP`` and all-gathers its output features (a conv's on the
    NHWC view); the LSTM's recurrent kernel and bias are all-gathered
    where sharded. Replicated layers take the plain calls."""

    def __init__(self, tp: "TPNetwork"):
        self.mesh, dims = tp.mesh, tp.shard_dims
        self.sharded = {tp.get_submodule(name[:-len(".weight")])
                        for name, dim in dims.items()
                        if dim is not None and name.endswith(".weight")}
        self.rec_dim = dims["lstm.recurrent_kernel"]
        self.bias_dim = dims["lstm.bias"]

    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherFeatures.apply(x, dim, self.mesh)

    def dense(self, x, layer, dtype):
        if layer not in self.sharded:
            return super().dense(x, layer, dtype)
        y = super().dense(_CopyToMP.apply(x, self.mesh), layer, dtype)
        return self._gather(y, -1)

    def conv_relu(self, x, conv, weight, stride, dtype):
        if conv not in self.sharded:
            return super().conv_relu(x, conv, weight, stride, dtype)
        y = super().conv_relu(_CopyToMP.apply(x, self.mesh), conv, weight,
                              stride, dtype)
        return self._gather(y.permute(0, 2, 3, 1), -1).permute(0, 3, 1, 2)

    def recurrent(self, lstm, dtype):
        w_rec, bias = super().recurrent(lstm, dtype)
        if self.rec_dim is not None:
            w_rec = self._gather(w_rec, self.rec_dim)
        if self.bias_dim is not None:
            bias = self._gather(bias, self.bias_dim)
        return w_rec, bias


class TPNetwork(R2D2Network):
    """``R2D2Network`` with its wide layers feature-sharded over the
    mesh's dp row: the same modules and parameter names, each sharded
    parameter holding this rank's slice along ``shard_dims[name]`` (mp
    index m holds the m-th contiguous slice, as GSPMD lays a sharded axis
    out), and a column-parallel forward: ``R2D2Network.forward`` with its
    modules' layer calls ``_TPCalls`` (the module docstring), every rank
    of the row computing the same Q. Build one with ``TPNetwork.shard``
    from a full network."""

    def __init__(self, net: NetworkApply, mesh: Mesh,
                 min_shard_width: int = 32):
        h, w, s = net.obs_hw
        super().__init__(net.action_dim, net.config, s, h, w)
        self.mesh = mesh
        self.shard_dims = state_shardings(net, mesh.mp, min_shard_width)
        for name, dim in self.shard_dims.items():
            if dim is not None:
                owner, leaf = self._owner(name)
                full = getattr(owner, leaf)
                setattr(owner, leaf, nn.Parameter(
                    self.local(full.detach(), name).clone()))
        calls = _TPCalls(self)
        for module in (self.torso, self.lstm, self.head):
            module.calls = calls
        self.to(net.device)

    @classmethod
    def shard(cls, net: NetworkApply, full: R2D2Network, mesh: Mesh,
              min_shard_width: int = 32) -> "TPNetwork":
        """This rank's shards of ``full`` (any device)."""
        tp = cls(net, mesh, min_shard_width)
        tp.load_full_(full.state_dict())
        tp.requires_grad_(any(p.requires_grad for p in full.parameters()))
        return tp

    def _owner(self, name: str):
        path, leaf = name.rsplit(".", 1)
        return self.get_submodule(path), leaf

    def local(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the full tensor ``t`` of parameter
        ``name`` (a view; ``t`` itself when replicated)."""
        dim = self.shard_dims[name]
        if dim is None:
            return t
        width = t.shape[dim] // self.mesh.mp
        return t.narrow(dim, self.mesh.mp_rank * width, width)

    def load_full_(self, state_dict) -> None:
        """Copy this rank's slices of a full state dict in."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(self.local(state_dict[name], name))

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The full parameters, by name (a collective over the row: every
        rank of it calls this)."""
        return {name: (p.detach() if self.shard_dims[name] is None
                       else all_gather_features(p, self.shard_dims[name],
                                                self.mesh))
                for name, p in self.named_parameters()}


class TPGradients:
    """The tensor-parallel hooks of the train body (learner/train_step.py):
    called between the backward and the clip, ``inner`` (the dp mean,
    ``GradMean`` or ``BatchMean``; None at dp = 1), then the replicated
    gradients broadcast over the row from its mp index 0 in one buffer
    (the module docstring says why); ``sq_norm``, the clip's squared
    global norm: the sharded gradients' squares summed over the row (one
    all-reduce), the replicated ones' once. ``attach`` reads which
    gradient is which and attaches ``inner``."""

    def __init__(self, mesh: Mesh, inner=None):
        self.mesh, self.inner = mesh, inner
        self.sharded: Optional[list] = None

    def attach(self, module: nn.Module) -> None:
        if not isinstance(module, TPNetwork):
            raise ValueError("under mesh.mp > 1 the train state must be "
                             "tensor-parallel (tensor_parallel."
                             "place_train_state)")
        if self.inner is not None:
            self.inner.attach(module)
        self.sharded = [module.shard_dims[name] is not None
                        for name, _ in module.named_parameters()]

    def __call__(self, grads, loss, mean_abs_td, mean_q, valid_steps=None):
        if self.inner is not None:
            loss, mean_abs_td, mean_q = self.inner(grads, loss, mean_abs_td,
                                                   mean_q, valid_steps)
        rep = [g for g, s in zip(grads, self.sharded) if not s]
        if rep:
            flat = _wire(torch.cat([g.reshape(-1) for g in rep]), self.mesh)
            dist.broadcast(flat, src=self.mesh.dp_rank * self.mesh.mp,
                           group=self.mesh.mp_group)
            flat = flat.to(rep[0].device, rep[0].dtype)
            off = 0
            for g in rep:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        return loss, mean_abs_td, mean_q

    def sq_norm(self, grads) -> torch.Tensor:
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        parts = [zero.clone(), zero.clone()]
        for g, sharded in zip(grads, self.sharded):
            parts[sharded] = parts[sharded] + torch.sum(g.float() ** 2)
        return parts[0] + all_reduce_row(parts[1], self.mesh)

    def group_sq_norms(self, tensors, groups, n: int) -> torch.Tensor:
        """(n,) squared norms of groups of parameter-aligned tensors (the
        learning diagnostics' group norms and target distance), each
        element counted once over the row as ``sq_norm`` counts it: the
        sharded ones' squares summed over the row in one all-reduce."""
        zero = torch.zeros((), dtype=torch.float32,
                           device=tensors[0].device)
        rep, shard = [zero] * n, [zero] * n
        for t, g, sharded in zip(tensors, groups, self.sharded):
            sq = torch.sum(t.float() ** 2)
            if sharded:
                shard[g] = shard[g] + sq
            else:
                rep[g] = rep[g] + sq
        return torch.stack(rep) + all_reduce_row(torch.stack(shard),
                                                 self.mesh)


# -- train states -------------------------------------------------------------


def _moment_names(module: nn.Module) -> list:
    return [name for name, _ in module.named_parameters()]


def place_train_state(ts: TrainState, net: NetworkApply, optim: OptimConfig,
                      mesh: Mesh, min_shard_width: int = 32) -> TrainState:
    """This rank's tensor-parallel train state from a full one: the online
    and target networks as ``TPNetwork`` shards, a new Adam over the
    shards with the full state's moments sliced alike; the step counter
    and the generator are shared with ``ts``."""
    online = TPNetwork.shard(net, ts.params, mesh, min_shard_width)
    target = online
    if ts.target_params is not ts.params:
        target = TPNetwork.shard(net, ts.target_params, mesh,
                                 min_shard_width)
    opt = make_optimizer(optim, online)
    full = ts.opt.state_dict()
    if full["state"]:
        names = _moment_names(online)
        opt.load_state_dict({"param_groups": full["param_groups"], "state": {
            i: {key: (online.local(v, names[i]).clone()
                      if torch.is_tensor(v) and v.dim() else v)
                for key, v in state.items()}
            for i, state in full["state"].items()}})
    return TrainState(params=online, target_params=target, opt=opt,
                      step=ts.step, generator=ts.generator,
                      step_count=ts.step_count)


def gather_train_state(ts: TrainState, net: NetworkApply,
                       optim: OptimConfig) -> TrainState:
    """The full train state of a tensor-parallel one, on its device (a
    collective over the row: every rank of it calls this): what a
    checkpoint holds."""
    online = net.build()
    online.load_state_dict(ts.params.full_state_dict())
    target = online
    if ts.target_params is not ts.params:
        target = net.build()
        target.load_state_dict(ts.target_params.full_state_dict())
        target.requires_grad_(False)
    opt = make_optimizer(optim, online)
    local = ts.opt.state_dict()
    if local["state"]:
        names, dims = _moment_names(ts.params), ts.params.shard_dims
        state = {}
        for i in sorted(local["state"]):
            dim = dims[names[i]]
            state[i] = {key: (all_gather_features(v, dim, ts.params.mesh)
                              if dim is not None and torch.is_tensor(v)
                              and v.dim() else v)
                        for key, v in sorted(local["state"][i].items())}
        opt.load_state_dict({"param_groups": local["param_groups"],
                             "state": state})
    return TrainState(params=online, target_params=target, opt=opt,
                      step=ts.step, generator=ts.generator,
                      step_count=ts.step_count.clone())


# -- the host-placement step ------------------------------------------------


class BatchScatter:
    """``place(batch=None) -> SampleBatch``: rank 0's global batch to every
    rank, each getting its dp row's ``B/dp`` rows (row d: rows ``[d*B/dp,
    (d+1)*B/dp)``) on its device, one byte row a rank in one scatter (the
    byte rows of parallel/sharded.py's block broadcast). Rank 0 passes the
    batch (host-sampled: numpy arrays or tensors, the step's fields), the
    others None."""

    def __init__(self, spec: ReplaySpec, mesh: Mesh, stamps: bool = False):
        self.mesh = mesh
        fields = batch_layout(spec, spec.batch_size // mesh.dp)
        names = _TRAIN_FIELDS + (("weight_version", "lane") if stamps
                                 else ())
        self.layout, self.row_bytes = wire_layout(
            {name: fields[name] for name in names})
        self.wire = (torch.device("cpu") if mesh.backend == "gloo"
                     else mesh.device)

    def __call__(self, batch: Optional[SampleBatch] = None) -> SampleBatch:
        mesh = self.mesh
        buf = torch.empty(self.row_bytes, dtype=torch.uint8,
                          device=self.wire)
        chunks = None
        if mesh.leader:
            packed = pack_rows(self.layout, self.row_bytes, batch, mesh.dp,
                           self.wire)
            chunks = [packed[r // mesh.mp] for r in range(mesh.world)]
        dist.scatter(buf, chunks, src=0, group=mesh.group)
        fields = unpack_rows(self.layout, buf.to(mesh.device)[None])
        return SampleBatch(**{name: v[0] for name, v in fields.items()})


def make_tp_external_batch_step(net: NetworkApply, spec: ReplaySpec,
                                optim: OptimConfig, use_double: bool,
                                mesh: Mesh, min_shard_width: int = 32,
                                diag=None, rdiag=None):
    """Returns ``(step, place_state, place_batch)``, as the JAX package's.

    ``place_state(ts)``: this rank's tensor-parallel train state
    (``place_train_state``). ``place_batch(batch)``: rank 0's host batch,
    its dp row's rows to every rank (``BatchScatter``; None on the other
    ranks); the batch is sharded over dp and replicated over mp.
    ``step(ts, local_batch) -> (ts, metrics)``: the external-batch step
    over the row's shards (eager), the gradient and scalars weighted by
    each dp row's valid steps under dp > 1 (``BatchMean`` over
    ``mesh.dp_group``) and the replicated ones made equal over the row
    (``TPGradients``), ``metrics["priorities"]`` the whole batch's (B,)
    on every rank, in the order of rank 0's batch. ``diag``, ``rdiag``:
    the diagnostics of the global batch, as JAX's GSPMD step computes
    them (its stamps and lanes ride the scatter; under dp > 1 the
    per-sequence values are gathered over the dp rows, ``DpRowGather``);
    the group norms and the target distance count each element once over
    the row (``TPGradients.group_sq_norms``); dQ is NaN (host
    placement)."""
    dp = mesh.dp
    if spec.batch_size % dp:
        raise ValueError(
            f"replay.batch_size={spec.batch_size} is not divisible by the "
            f"mesh dp={dp} — the batch axis cannot shard evenly")
    local = dataclasses.replace(spec, batch_size=spec.batch_size // dp)
    hooks = TPGradients(mesh, BatchMean(mesh) if dp > 1 else None)
    inner = make_external_batch_step(
        net, local, optim, use_double, reduce=hooks, graphed=False,
        sq_norm=hooks.sq_norm, diag=diag, rdiag=rdiag,
        diag_gather=DpRowGather(mesh) if dp > 1 else None,
        group_sq=hooks.group_sq_norms)
    started = []

    def step(ts: TrainState, batch: SampleBatch):
        if not started:
            hooks.attach(ts.params)
            if dp > 1:
                broadcast_train_state(ts, mesh)
            started.append(True)
        ts, metrics = inner(ts, batch)
        metrics["priorities"] = gather_dp_rows(metrics["priorities"], mesh)
        return ts, metrics

    def place_state(ts: TrainState) -> TrainState:
        return place_train_state(ts, net, optim, mesh, min_shard_width)

    return step, place_state, BatchScatter(
        spec, mesh, stamps=diag is not None or rdiag is not None)
