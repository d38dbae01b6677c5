"""The recurrent dueling Q-network: conv torso -> hoisted-input LSTM ->
dueling head, the PyTorch counterpart of the JAX package's
models/network.py.

Compute-dtype policy mirrors flax's ``dtype=``: parameters stay f32, inputs
and weights are cast to the compute dtype at each layer, Q and the packed
hidden come back in f32, and under bf16 the LSTM carry is bf16 as in the
JAX scan. With ``network.pallas_lstm="on"`` the learner's unrolls (T > 1)
run the fused scan of ``ops/lstm_kernels.py`` instead, whose carries are
f32 (the JAX package's Pallas path does the same).

Layout: an observation (B, T, H, W, K) viewed as (B*T, H, W, K) and
permuted to (B*T, K, H, W) is a channels_last NCHW tensor, which
``F.conv2d`` takes with no copy. With K = 4 channels cuDNN's tensor-core
convolutions refuse it and fall back, so where the first conv's kernel and
stride and the frame are even, the torso runs that conv as the same linear
map on the 2x2 space-to-depth input (B*T, H/2, W/2, 4K) with half the
kernel and stride (the JAX package's ``space_to_depth``). The learner's
decode writes that layout directly (``input_layout``); standard-layout
input (the actor's step) is rearranged first. The parameters keep the
standard layout unless ``network.space_to_depth="on"``: the torso
re-indexes the first conv's weight on each call, inside autograd. The last
conv output is flattened from its NHWC view — flax's (h, w, c) order — so a
converted flax Dense kernel needs no row permutation (models/convert.py
relies on this).

The quantized inference plane (``network.inference_dtype`` "bf16" or
"int8", the JAX package's) is at the end of this module: the publication
carries a twin of the weights beside the f32 ones, and the acting forward
runs from the twin with the LSTM carry in f32.
"""

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r2d2_tpu_torch.config import (INFERENCE_DTYPES, NetworkConfig,
                                   check_network, resolve_bf16,
                                   resolve_pallas_lstm,
                                   resolve_space_to_depth)
from r2d2_tpu_torch.ops.indexing import space_to_depth_2x2
from r2d2_tpu_torch.ops.lstm_kernels import lstm_scan
from r2d2_tpu_torch.ops.quant_kernels import int8_linear, pad_int8_weight
from r2d2_tpu_torch.telemetry import scopes

STANDARD, SPACE_TO_DEPTH = "standard", "space_to_depth"


def pack_hidden(carry: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """(c, h) -> (..., 2, hidden) with packed[0] = h, packed[1] = c."""
    c, h = carry
    return torch.stack([h, c], dim=-2)


def unpack_hidden(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return packed[..., 1, :], packed[..., 0, :]


def initial_hidden(batch_size: int, hidden_dim: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((batch_size, 2, hidden_dim), dtype=dtype, device=device)


def action_one_hot(last_action: torch.Tensor, action_dim: int
                   ) -> torch.Tensor:
    """(...,) action indices -> (..., action_dim) f32 one-hot on their
    device; -1 (no action) gives a zero row, as jax.nn.one_hot does."""
    classes = torch.arange(action_dim, device=last_action.device)
    return (last_action.long()[..., None] == classes).float()


def _linear(x, layer: nn.Linear, dtype):
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerCalls:
    """How the network's modules apply a dense layer and a conv and fetch
    the LSTM's recurrent weights: the plain calls, every module's by
    default (``calls``). The tensor-parallel view
    (parallel/tensor_parallel.py ``TPNetwork``) gives its modules calls
    that wrap the sharded layers in its collectives."""

    def dense(self, x, layer: nn.Linear, dtype):
        return _linear(x, layer, dtype)

    def conv_relu(self, x, conv: nn.Conv2d, weight, stride, dtype):
        """relu(conv(x)) on the NCHW view with ``weight`` and ``stride``
        (the first conv's may be re-indexed for space-to-depth)."""
        return F.relu(F.conv2d(x.to(dtype), weight.to(dtype),
                               conv.bias.to(dtype), stride))

    def recurrent(self, lstm: "HoistedLSTM", dtype):
        """(recurrent kernel (H, 4H), bias (4H,)) in ``dtype``."""
        return lstm.recurrent_kernel.to(dtype), lstm.bias.to(dtype)


PLAIN_CALLS = LayerCalls()


def input_layout(conv_layers: Sequence[Tuple[int, int, int]],
                 frame_height: int, frame_width: int) -> str:
    """The first conv's route: SPACE_TO_DEPTH when layer 0's kernel and
    stride and the frame are even (then the rewrite is exact), else
    STANDARD."""
    _, kernel, stride = conv_layers[0]
    even = not (kernel % 2 or stride % 2 or frame_height % 2
                or frame_width % 2)
    return SPACE_TO_DEPTH if even else STANDARD


def conv_weight_space_to_depth(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (O, C, 2k, 2k) -> (O, 4C, k, k) with
    w'[o, (dh*2 + dw)*C + c, ph, pw] = w[o, c, 2ph + dh, 2pw + dw]: the
    conv over the space_to_depth_2x2 input that equals the standard one."""
    o, c, kh, kw = weight.shape
    w = weight.reshape(o, c, kh // 2, 2, kw // 2, 2)       # o c ph dh pw dw
    return w.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, kh // 2, kw // 2)


def convert_params_space_to_depth(state_dict: Dict[str, torch.Tensor],
                                  frame_stack: int
                                  ) -> Dict[str, torch.Tensor]:
    """Migrate a standard-layout state dict to ``network.space_to_depth=
    "on"``: the first conv's weight re-indexed by
    ``conv_weight_space_to_depth`` (the JAX package's
    ``convert_params_space_to_depth``); every other entry as it is."""
    key = "torso.convs.0.weight"
    w = state_dict[key]
    if w.shape[1] != frame_stack:
        raise ValueError(
            f"first conv weight has {w.shape[1]} input channels; expected "
            f"the standard layout's frame_stack={frame_stack} — already "
            "converted?")
    if w.shape[2] % 2 or w.shape[3] % 2:
        raise ValueError(f"first conv kernel {tuple(w.shape[2:])} must be "
                         "even")
    out = dict(state_dict)
    out[key] = conv_weight_space_to_depth(w).contiguous()
    return out


class ConvTorso(nn.Module):
    """Nature-DQN feature extractor: (N, H, W, K) -> (N, cnn_out_dim), or
    the same from (N, H/2, W/2, 4K) on the space-to-depth route.
    ``params_space_to_depth``: the first conv's parameters are held in the
    space-to-depth layout (O, 4K, k/2, k/2) (``network.space_to_depth=
    "on"``)."""

    calls = PLAIN_CALLS

    def __init__(self, frame_stack: int, frame_hw: Tuple[int, int],
                 cnn_out_dim: int, conv_layers,
                 params_space_to_depth: bool = False):
        super().__init__()
        h, w = frame_hw
        self.input_layout = input_layout(conv_layers, h, w)
        self.params_space_to_depth = params_space_to_depth
        convs, channels = [], frame_stack
        for i, (features, kernel, stride) in enumerate(conv_layers):
            if i == 0 and params_space_to_depth:
                convs.append(nn.Conv2d(4 * channels, features, kernel // 2,
                                       stride // 2))
            else:
                convs.append(nn.Conv2d(channels, features, kernel, stride))
            channels = features
            h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(h * w * channels, cnn_out_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                layout: str = STANDARD) -> torch.Tensor:
        """``layout``: what ``x`` is, STANDARD (N, H, W, K) or
        SPACE_TO_DEPTH (N, H/2, W/2, 4K); the latter only on the
        space-to-depth route."""
        if layout not in (STANDARD, SPACE_TO_DEPTH):
            raise ValueError(f"unknown input layout {layout!r}")
        s2d = self.input_layout == SPACE_TO_DEPTH
        if layout == SPACE_TO_DEPTH and not s2d:
            raise ValueError("this torso's first conv takes the standard "
                             "layout")
        if s2d and layout == STANDARD:
            x = space_to_depth_2x2(x)
        x = x.permute(0, 3, 1, 2)                 # channels_last NCHW view
        for i, conv in enumerate(self.convs):
            weight, stride = conv.weight, conv.stride
            if i == 0 and s2d and not self.params_space_to_depth:
                weight = conv_weight_space_to_depth(weight)
                stride = (stride[0] // 2, stride[1] // 2)
            x = self.calls.conv_relu(x, conv, weight, stride, dtype)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        return self.calls.dense(x, self.dense, dtype)


def lstm_cell_step(xp, c, h, w_rec, bias):
    """One LSTM step given the hoisted input projection ``xp`` = x_t @ Wi.
    Gate order i, f, g, o."""
    gates = xp + h @ w_rec + bias
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


class HoistedLSTM(nn.Module):
    """LSTM over (B, T, D) with the input projection computed for the whole
    window as one matmul before the time loop; the loop keeps only the
    (B, H) x (H, 4H) recurrent matmul. ``fused``: a window of T > 1 runs as
    one fused scan (the actor's T=1 step stays on the loop)."""

    calls = PLAIN_CALLS

    def __init__(self, input_dim: int, features: int, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.input_proj = nn.Linear(input_dim, 4 * features, bias=False)
        self.recurrent_kernel = nn.Parameter(torch.empty(features, 4 * features))
        self.bias = nn.Parameter(torch.zeros(4 * features))

    def forward(self, carry, xs: torch.Tensor, dtype: torch.dtype):
        x_proj = self.calls.dense(xs, self.input_proj, dtype)  # (B, T, 4H)
        w_rec, bias = self.calls.recurrent(self, dtype)
        c, h = carry
        if self.fused and xs.shape[1] > 1:
            xpb = (x_proj + bias).transpose(0, 1).contiguous()   # (T, B, 4H)
            hseq, (c, h) = lstm_scan(xpb, w_rec, c, h)
            return (c, h), hseq.transpose(0, 1)
        outputs = []
        for t in range(xs.shape[1]):
            c, h = lstm_cell_step(x_proj[:, t], c, h, w_rec, bias)
            outputs.append(h)
        return (c, h), torch.stack(outputs, dim=1)            # (B, T, H)


class DuelingHead(nn.Module):
    """q = v + a - mean(a), or a alone without dueling; Q in f32."""

    calls = PLAIN_CALLS

    def __init__(self, hidden_dim: int, action_dim: int, use_dueling: bool):
        super().__init__()
        self.use_dueling = use_dueling
        self.adv_hidden = nn.Linear(hidden_dim, hidden_dim)
        self.adv_out = nn.Linear(hidden_dim, action_dim)
        if use_dueling:
            self.val_hidden = nn.Linear(hidden_dim, hidden_dim)
            self.val_out = nn.Linear(hidden_dim, 1)

    def forward(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        dense = self.calls.dense
        adv = dense(F.relu(dense(h, self.adv_hidden, dtype)), self.adv_out,
                    dtype)
        if not self.use_dueling:
            return adv.float()
        val = dense(F.relu(dense(h, self.val_hidden, dtype)), self.val_out,
                    dtype)
        return (val + adv - adv.mean(dim=-1, keepdim=True)).float()


class R2D2Network(nn.Module):
    """Unroll T steps from a packed hidden state; T=1 is the actor's step,
    T=seq_len the learner's sequence pass."""

    def __init__(self, action_dim: int, config: NetworkConfig,
                 frame_stack: int, frame_height: int, frame_width: int):
        super().__init__()
        self.action_dim = action_dim
        self.config = config
        self.compute_dtype = torch.bfloat16 if config.bf16 else torch.float32
        self.torso = ConvTorso(frame_stack, (frame_height, frame_width),
                               config.cnn_out_dim, config.conv_layers,
                               resolve_space_to_depth(config.space_to_depth))
        self.lstm = HoistedLSTM(config.cnn_out_dim + action_dim,
                                config.hidden_dim,
                                resolve_pallas_lstm(config.pallas_lstm))
        self.head = DuelingHead(config.hidden_dim, action_dim,
                                config.use_dueling)

    @property
    def input_layout(self) -> str:
        return self.torso.input_layout

    def forward(self, obs_seq: torch.Tensor, last_action_seq: torch.Tensor,
                hidden: torch.Tensor, layout: str = STANDARD):
        """obs_seq (B, T, H, W, K) in [0, 1], or (B, T, H/2, W/2, 4K) with
        ``layout=SPACE_TO_DEPTH``; last_action_seq (B, T, A) one-hot;
        hidden (B, 2, hidden_dim) packed. Returns Q (B, T, A) f32 and the
        final packed hidden in f32."""
        dtype = self.compute_dtype
        batch, seq = obs_seq.shape[:2]
        with scopes.scope("torso"):
            latent = self.torso(
                obs_seq.reshape(batch * seq, *obs_seq.shape[2:]), dtype,
                layout).reshape(batch, seq, -1)
        with scopes.scope("lstm"):
            rnn_in = torch.cat([latent, last_action_seq.to(dtype)], dim=-1)
            carry, outputs = self.lstm(unpack_hidden(hidden.to(dtype)),
                                       rnn_in, dtype)
        with scopes.scope("head"):
            q = self.head(outputs.reshape(batch * seq, -1), dtype)
        return q.reshape(batch, seq, -1), pack_hidden(carry).float()


def dual_sequence_q(net: "NetworkApply", online: R2D2Network,
                    target: R2D2Network, obs_seq: torch.Tensor,
                    last_action_seq: torch.Tensor, hidden_a: torch.Tensor,
                    hidden_b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The online and the target network unrolled over one decoded
    sequence, the JAX package's ``dual_sequence_q``: (Q_online, Q_target),
    each (B, T, A) f32, the target's outside autograd (the loss stops its
    gradient, as JAX's stop_gradient does). ``obs_seq`` is in
    ``net.input_layout``, the layout the learner's decode emits. JAX
    interleaves the two recurrent chains in one time loop because XLA runs
    two while loops one after the other; eager kernels on one CUDA stream
    queue back to back either way, so here each network runs its own
    unroll."""
    q_online, _ = online(obs_seq, last_action_seq, hidden_a,
                         net.input_layout)
    with torch.no_grad():
        q_target, _ = target(obs_seq, last_action_seq, hidden_b,
                             net.input_layout)
    return q_online, q_target


def _lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=gen)


def init_params_(module: R2D2Network, seed: int) -> R2D2Network:
    """Initialize like the flax module: lecun-normal kernels, zero biases,
    per-gate orthogonal recurrent kernel. Drawn on the CPU from one
    ``torch.Generator``, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in module.modules():
            if isinstance(layer, (nn.Conv2d, nn.Linear)):
                fan_in = layer.weight[0].numel()
                w = torch.empty(layer.weight.shape)
                _lecun_normal_(w, fan_in, gen)
                layer.weight.copy_(w)
                if layer.bias is not None:
                    layer.bias.zero_()
        lstm = module.lstm
        hidden = lstm.recurrent_kernel.shape[0]
        blocks = [nn.init.orthogonal_(torch.empty(hidden, hidden), generator=gen)
                  for _ in range(4)]
        lstm.recurrent_kernel.copy_(torch.cat(blocks, dim=1))
        lstm.bias.zero_()
    return module


class NetworkApply:
    """Binding of a network spec to a device: resolves the bf16,
    pallas_lstm and space_to_depth settings for that device, validates the
    conv pyramid against the frame size, picks the first conv's route
    (``input_layout``, the layout the learner's decode emits) and builds
    initialized modules."""

    def __init__(self, action_dim: int, config: NetworkConfig,
                 frame_stack: int, frame_height: int, frame_width: int,
                 device: torch.device):
        check_network(config)
        self.device = torch.device(device)
        self.config = dataclasses.replace(
            config, bf16=resolve_bf16(config.bf16, self.device),
            pallas_lstm=resolve_pallas_lstm(config.pallas_lstm, self.device),
            space_to_depth=resolve_space_to_depth(config.space_to_depth))
        self.action_dim = action_dim
        self.obs_hw = (frame_height, frame_width, frame_stack)
        self.input_layout = input_layout(config.conv_layers, frame_height,
                                         frame_width)
        if (self.config.space_to_depth
                and self.input_layout != SPACE_TO_DEPTH):
            _, k0, s0 = config.conv_layers[0]
            raise ValueError(
                "network.space_to_depth requires even frame dims and an "
                f"even first-conv kernel/stride; got {frame_height}x"
                f"{frame_width}, kernel {k0}, stride {s0}")
        h, w = frame_height, frame_width
        for i, (_, kernel, stride) in enumerate(config.conv_layers):
            h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
            if h < 1 or w < 1:
                raise ValueError(
                    f"conv layer {i} (kernel {kernel}, stride {stride}) "
                    f"shrinks the {frame_height}x{frame_width} frame to "
                    f"{h}x{w}; use smaller network.conv_layers")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.bf16 else torch.float32

    def build(self) -> R2D2Network:
        h, w, s = self.obs_hw
        return R2D2Network(self.action_dim, self.config, s, h, w).to(self.device)

    def init(self, seed: int) -> R2D2Network:
        h, w, s = self.obs_hw
        module = R2D2Network(self.action_dim, self.config, s, h, w)
        return init_params_(module, seed).to(self.device)

    @property
    def param_specs(self) -> List[Tuple[str, torch.Size]]:
        """(name, shape) of every parameter in ``parameters()`` order (a
        module on the meta device: no memory)."""
        if getattr(self, "_param_specs", None) is None:
            h, w, s = self.obs_hw
            with torch.device("meta"):
                module = R2D2Network(self.action_dim, self.config, s, h, w)
            self._param_specs = [(n, p.shape)
                                 for n, p in module.named_parameters()]
        return self._param_specs

    @property
    def num_params(self) -> int:
        return sum(math.prod(shape) for _, shape in self.param_specs)


# ---------------------------------------------------------------------------
# Quantized inference plane, the JAX package's models/network.py
# ``quantize_params`` .. ``param_tree_bytes``: per-channel symmetric int8
# (or bf16) twins of the weights for the acting forward. The twin is built
# once a publication (runtime/weights.py) and rides the weight service's
# flat f32 payload beside the f32 weights; the learner never sees it.
#
# Layout: the port quantizes the tensors its module holds. The scale axis
# is always the output channel: axis 0 of an nn.Linear weight (out, in) and
# of a conv weight OIHW, axis 1 of ``lstm.recurrent_kernel`` (in, 4H). So
# q and scale equal the JAX package's after models/convert.py's transposes
# (per-channel scales do not care how the input axis is ordered, so a
# space-to-depth first conv quantizes the same either way).


def quant_compute_dtype(device) -> torch.dtype:
    """The quantized forward's matmul dtype: bf16 on CUDA (where the JAX
    package says bf16 on the TPU), f32 on the CPU."""
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def out_channel_axis(name: str) -> int:
    """The output-channel axis of parameter ``name``."""
    return 1 if name.endswith("recurrent_kernel") else 0


def quantize_leaf_int8(w: torch.Tensor, axis: int = 0) -> Dict[str, torch.Tensor]:
    """{"q": int8, "scale": f32} with scale = max|w| over every axis but
    ``axis`` / 127 (floor 1e-12, for all-zero channels), q = round(w /
    scale) (half to even) clipped to +-127; scale keeps its reduced axes
    as size 1."""
    w = w.float()
    dims = tuple(d for d in range(w.dim()) if d != axis)
    scale = torch.clamp_min(w.abs().amax(dim=dims, keepdim=True) / 127.0,
                            1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def is_quant_leaf(leaf) -> bool:
    return isinstance(leaf, Mapping) and "q" in leaf and "scale" in leaf


def dequantize_leaf(leaf, dtype) -> torch.Tensor:
    """int8 -> f32 per-channel rescale -> ``dtype``; a plain tensor (a bias,
    a bf16 twin) is cast."""
    if is_quant_leaf(leaf):
        return (leaf["q"].float() * leaf["scale"]).to(dtype)
    return leaf.to(dtype)


def named_params(net: "NetworkApply", params) -> Dict[str, torch.Tensor]:
    """A module, a name -> tensor mapping or a flat f32 vector in
    ``parameters()`` order -> {name: tensor} (views of the vector)."""
    if isinstance(params, nn.Module):
        return {n: p.detach() for n, p in params.named_parameters()}
    if isinstance(params, Mapping):                 # in parameters() order
        return {name: params[name] for name, _ in net.param_specs}
    flat = torch.as_tensor(params)
    if flat.dim() != 1 or flat.numel() < net.num_params:
        raise ValueError(f"expected a flat vector of {net.num_params} "
                         f"weights; got {tuple(flat.shape)}")
    out, offset = {}, 0
    for name, shape in net.param_specs:
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape)
        offset += n
    return out


def quantize_params(params: Mapping[str, torch.Tensor], inference_dtype: str):
    """The twin for one inference dtype, on ``params``' device:
    "f32" ``params`` unchanged; "bf16" every float tensor cast to bf16;
    "int8" every weight of ndim >= 2 (conv, dense, the LSTM's input
    projection and recurrent kernel) a per-channel {"q", "scale"} pair,
    the 1-D biases in f32."""
    if inference_dtype == "f32":
        return params
    if inference_dtype == "bf16":
        return {n: (w.to(torch.bfloat16) if w.is_floating_point() else w)
                for n, w in params.items()}
    if inference_dtype != "int8":
        raise ValueError(f"inference_dtype must be one of {INFERENCE_DTYPES}"
                         f", got {inference_dtype!r}")
    return {n: (quantize_leaf_int8(w, out_channel_axis(n))
                if w.dim() >= 2 and w.is_floating_point() else w.float())
            for n, w in params.items()}


def is_quant_bundle(tree) -> bool:
    """True for the published {"f32", "quant", "stamp"} bundle."""
    return isinstance(tree, Mapping) and "quant" in tree and "f32" in tree


def make_inference_bundle(net: "NetworkApply", params, stamp: int = 0):
    """What the weight service publishes at ``inference_dtype`` "bf16" or
    "int8": {"f32": the weights (the probe's reference), "quant": the twin
    (the acting forward's), "stamp": the publication the twin was built
    at}. At "f32" the weights themselves."""
    mode = net.config.inference_dtype
    if mode == "f32":
        return params
    named = named_params(net, params)
    return {"f32": named, "quant": quantize_params(named, mode),
            "stamp": int(stamp)}


def param_tree_bytes(tree) -> int:
    """Bytes of a (possibly quantized) parameter tree: the weight bytes a
    forward streams."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, Mapping):
        return sum(param_tree_bytes(v) for v in tree.values())
    return 0


# The bundle as one flat f32 vector, what the weight service carries:
# [f32 weights | twin | stamp]. The twin section is, per parameter in
# ``parameters()`` order, the int8 q values then the scales (weights of
# ndim >= 2 at "int8"), or the values themselves (biases; every tensor at
# "bf16", whose values are exact in f32); int8 values are exact in f32.


def _twin_sizes(net: "NetworkApply", mode: str) -> List[Tuple[str, int, int]]:
    """(name, values, scales) of each parameter's twin section."""
    out = []
    for name, shape in net.param_specs:
        n = math.prod(shape)
        if mode == "int8" and len(shape) >= 2:
            out.append((name, n, shape[out_channel_axis(name)]))
        else:
            out.append((name, n, 0))
    return out


def bundle_size(net: "NetworkApply") -> int:
    """Length of the flat payload at ``net``'s inference dtype."""
    mode = net.config.inference_dtype
    if mode == "f32":
        return net.num_params
    return (net.num_params
            + sum(v + c for _, v, c in _twin_sizes(net, mode)) + 1)


def twin_to_flat(net: "NetworkApply", quant: Mapping) -> torch.Tensor:
    """The twin section of the flat payload (f32, on the twin's device)."""
    parts = []
    for name, _, scales in _twin_sizes(net, net.config.inference_dtype):
        leaf = quant[name]
        if scales:
            parts += [leaf["q"].reshape(-1).float(),
                      leaf["scale"].reshape(-1)]
        else:
            parts.append(leaf.reshape(-1).float())
    return torch.cat(parts)


def bundle_to_flat(net: "NetworkApply", bundle) -> torch.Tensor:
    """A bundle as the flat f32 payload."""
    named = named_params(net, bundle["f32"])
    f32 = torch.cat([p.reshape(-1).float() for p in named.values()])
    stamp = torch.tensor([float(bundle["stamp"])], device=f32.device)
    return torch.cat([f32, twin_to_flat(net, bundle["quant"]).to(f32.device),
                      stamp])


def bundle_from_flat(net: "NetworkApply", flat) -> dict:
    """The flat payload -> {"f32", "quant", "stamp"} (views where the dtype
    allows; int8 and bf16 leaves are copies)."""
    flat = torch.as_tensor(flat)
    mode = net.config.inference_dtype
    if flat.dim() != 1 or flat.numel() != bundle_size(net):
        raise ValueError(f"a {mode} payload has {bundle_size(net)} values; "
                         f"got {tuple(flat.shape)}")
    shapes = dict(net.param_specs)
    offset = net.num_params
    quant = {}
    for name, values, scales in _twin_sizes(net, mode):
        shape = shapes[name]
        data = flat[offset:offset + values].view(shape)
        offset += values
        if scales:
            scale_shape = [1] * len(shape)
            scale_shape[out_channel_axis(name)] = scales
            quant[name] = {"q": data.to(torch.int8),
                           "scale": flat[offset:offset + scales]
                           .view(scale_shape)}
            offset += scales
        elif mode == "bf16":
            quant[name] = data.to(torch.bfloat16)
        else:
            quant[name] = data
    return {"f32": named_params(net, flat[:net.num_params]), "quant": quant,
            "stamp": int(flat[offset].item())}


def f32_reference_module(net: "NetworkApply", device=None) -> R2D2Network:
    """The accuracy probe's reference twin: ``net``'s network in true f32
    whatever the learner's compute policy (the probe measures
    quantization, not bf16's own rounding), on ``device`` (default:
    ``net``'s), for inference."""
    h, w, s = net.obs_hw
    ref = NetworkApply(net.action_dim,
                       dataclasses.replace(net.config, bf16="off"), s, h, w,
                       device=device if device is not None else net.device)
    return ref.build().eval().requires_grad_(False)


class _QLinear:
    """One dense layer of the twin, prepared for the forward: int8 (q padded
    to 16 columns for the kernel, f32 scale and bias) or a weight in the
    compute dtype (the bf16 twin)."""

    def __init__(self, weight, bias, dtype, device, transpose: bool):
        self.int8 = is_quant_leaf(weight)
        self.dtype = dtype
        self._transpose = transpose
        self.q = self.scale = self.weight = None
        if self.int8:
            q = weight["q"].t() if transpose else weight["q"]
            self.q = pad_int8_weight(q.to(device))
            self.scale = torch.empty(q.shape[0], dtype=torch.float32,
                                     device=device)
        else:
            w = weight.t() if transpose else weight
            self.weight = torch.empty(w.shape, dtype=dtype, device=device)
        self.bias = None
        if bias is not None:
            self.bias = torch.empty(bias.shape, device=device,
                                    dtype=torch.float32 if self.int8 else dtype)
        self.load_(weight, bias)

    def load_(self, weight, bias) -> None:
        """Copy a twin's layer into this one's storage (addresses kept)."""
        if self.int8:
            q = weight["q"].t() if self._transpose else weight["q"]
            self.q[:, :q.shape[1]].copy_(q)
            self.scale.copy_(weight["scale"].reshape(-1))
        else:
            w = weight.t() if self._transpose else weight
            self.weight.copy_(w)
        if bias is not None:
            self.bias.copy_(bias)

    def __call__(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        out_dtype = out_dtype or self.dtype
        if self.int8:
            return int8_linear(x, self.q, self.scale, self.bias, out_dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        bias).to(out_dtype)

    def tensors(self) -> List[torch.Tensor]:
        return [t for t in (self.q, self.scale, self.weight, self.bias)
                if t is not None]


_DENSE = ("torso.dense", "lstm.input_proj", "head.adv_hidden",
          "head.adv_out", "head.val_hidden", "head.val_out")


class QuantInference:
    """The twin prepared on a device for the quantized forward, the
    counterpart of the quantized tree JAX's ``quantized_inference_apply``
    reads. Conv weights are dequantized once, here and at each adoption
    (``load_``), into a cached copy in the compute dtype, where JAX
    dequantizes them in every forward: the same numbers, at ~78k weights
    (on the space-to-depth route the copy is re-indexed once too). The
    dense layers keep their int8 weights and go through ``int8_linear``
    (the kernel on the card). ``load_`` copies into the same storage, so a
    CUDA graph captured over the forward sees new weights."""

    def __init__(self, net: "NetworkApply", quant: Mapping, device=None,
                 dtype: Optional[torch.dtype] = None):
        self.net = net
        self.device = torch.device(device if device is not None
                                   else net.device)
        self.dtype = dtype or quant_compute_dtype(self.device)
        cfg = net.config
        h, w, _ = net.obs_hw
        self.input_layout = input_layout(cfg.conv_layers, h, w)
        self._s2d_params = bool(cfg.space_to_depth)
        self.strides = []
        for i, (_, _, stride) in enumerate(cfg.conv_layers):
            if i == 0 and self.input_layout == SPACE_TO_DEPTH:
                stride //= 2
            self.strides.append((stride, stride))
        self.conv_w = [torch.empty(0)] * len(cfg.conv_layers)
        self.conv_b = [torch.empty(0)] * len(cfg.conv_layers)
        quant = {n: _leaf_to(v, self.device) for n, v in quant.items()}
        for i in range(len(cfg.conv_layers)):
            wq = self._conv_weight(i, quant)
            self.conv_w[i] = torch.empty(wq.shape, dtype=self.dtype,
                                         device=self.device)
            self.conv_b[i] = torch.empty(
                quant[f"torso.convs.{i}.bias"].shape, dtype=self.dtype,
                device=self.device)
        self.dense = {name: _QLinear(quant[f"{name}.weight"],
                                     quant.get(f"{name}.bias"), self.dtype,
                                     self.device, transpose=False)
                      for name in _DENSE if f"{name}.weight" in quant}
        self.recurrent = _QLinear(quant["lstm.recurrent_kernel"], None,
                                  torch.float32, self.device, transpose=True)
        self.lstm_bias = torch.empty(quant["lstm.bias"].shape,
                                     dtype=torch.float32, device=self.device)
        self.load_(quant)

    def _conv_weight(self, i: int, quant: Mapping) -> torch.Tensor:
        weight = dequantize_leaf(quant[f"torso.convs.{i}.weight"], self.dtype)
        if (i == 0 and self.input_layout == SPACE_TO_DEPTH
                and not self._s2d_params):
            weight = conv_weight_space_to_depth(weight)
        return weight

    def load_(self, quant: Mapping) -> None:
        """Adopt a twin: copy it into this object's storage."""
        quant = {n: _leaf_to(v, self.device) for n, v in quant.items()}
        with torch.no_grad():
            for i in range(len(self.conv_w)):
                self.conv_w[i].copy_(self._conv_weight(i, quant))
                self.conv_b[i].copy_(dequantize_leaf(
                    quant[f"torso.convs.{i}.bias"], self.dtype))
            for name, layer in self.dense.items():
                layer.load_(quant[f"{name}.weight"], quant.get(f"{name}.bias"))
            self.recurrent.load_(quant["lstm.recurrent_kernel"], None)
            self.lstm_bias.copy_(dequantize_leaf(quant["lstm.bias"],
                                                 torch.float32))

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor the forward reads (their addresses must not move
        under a captured graph)."""
        out = self.conv_w + self.conv_b + [self.lstm_bias]
        for layer in list(self.dense.values()) + [self.recurrent]:
            out += layer.tensors()
        return out

    def __call__(self, obs_seq: torch.Tensor, last_action_seq: torch.Tensor,
                 hidden: torch.Tensor, layout: str = STANDARD):
        return quantized_inference_apply(self.net, self, obs_seq,
                                         last_action_seq, hidden,
                                         layout=layout)


def _leaf_to(leaf, device):
    if is_quant_leaf(leaf):
        return {"q": leaf["q"].to(device), "scale": leaf["scale"].to(device)}
    return leaf.to(device)


def quantized_inference_apply(net: "NetworkApply", qparams, obs_seq,
                              last_action_seq, hidden,
                              compute_dtype: Optional[torch.dtype] = None,
                              layout: str = STANDARD):
    """The quantized twin of ``R2D2Network.forward``: same inputs and
    outputs, the weights from the twin (``qparams``: a ``QuantInference``,
    or the raw twin, prepared here on obs_seq's device). The LSTM carry,
    the cell and the recurrent product stay f32 (quantization error stays
    per step instead of compounding in the recurrent state); the torso,
    the hoisted input projection and the head run in the compute dtype
    (bf16 on CUDA, f32 on the CPU); Q comes back in f32."""
    if not isinstance(qparams, QuantInference):
        qparams = QuantInference(net, qparams, obs_seq.device, compute_dtype)
    qi = qparams
    dtype = qi.dtype
    cfg = net.config
    batch, seq = obs_seq.shape[:2]
    x = obs_seq.reshape(batch * seq, *obs_seq.shape[2:])
    s2d = qi.input_layout == SPACE_TO_DEPTH
    if layout == SPACE_TO_DEPTH and not s2d:
        raise ValueError("this torso's first conv takes the standard layout")
    with scopes.scope("torso"):
        if s2d and layout == STANDARD:
            x = space_to_depth_2x2(x)
        x = x.permute(0, 3, 1, 2)
        for w, b, stride in zip(qi.conv_w, qi.conv_b, qi.strides):
            x = F.relu(F.conv2d(x.to(dtype), w, b, stride))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)       # (h, w, c)
        latent = qi.dense["torso.dense"](x.contiguous())
    with scopes.scope("lstm"):
        rnn_in = torch.cat([latent.reshape(batch, seq, cfg.cnn_out_dim),
                            last_action_seq.to(dtype)], dim=-1)
        xp = qi.dense["lstm.input_proj"](
            rnn_in.reshape(batch * seq, -1)).float().reshape(batch, seq, -1)
        c, h = unpack_hidden(hidden.float())
        outputs = []
        for t in range(seq):
            gates = xp[:, t] + qi.recurrent(h, torch.float32) + qi.lstm_bias
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outputs.append(h)
        hs = torch.stack(outputs, dim=1).reshape(batch * seq, -1).to(dtype)
    dense = qi.dense
    with scopes.scope("head"):
        adv = dense["head.adv_out"](F.relu(dense["head.adv_hidden"](hs)))
        if cfg.use_dueling:
            val = dense["head.val_out"](F.relu(dense["head.val_hidden"](hs)))
            q = (val + adv - adv.mean(dim=-1, keepdim=True)).float()
        else:
            q = adv.float()
    return q.reshape(batch, seq, -1), pack_hidden((c, h)).float()
