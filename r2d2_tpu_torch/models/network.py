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
"""

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r2d2_tpu_torch.config import (NetworkConfig, check_network,
                                   resolve_bf16, resolve_pallas_lstm,
                                   resolve_space_to_depth)
from r2d2_tpu_torch.ops.indexing import space_to_depth_2x2
from r2d2_tpu_torch.ops.lstm_kernels import lstm_scan

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
            x = F.relu(F.conv2d(x.to(dtype), weight.to(dtype),
                                conv.bias.to(dtype), stride))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        return _linear(x, self.dense, dtype)


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

    def __init__(self, input_dim: int, features: int, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.input_proj = nn.Linear(input_dim, 4 * features, bias=False)
        self.recurrent_kernel = nn.Parameter(torch.empty(features, 4 * features))
        self.bias = nn.Parameter(torch.zeros(4 * features))

    def forward(self, carry, xs: torch.Tensor, dtype: torch.dtype):
        x_proj = _linear(xs, self.input_proj, dtype)          # (B, T, 4H)
        w_rec = self.recurrent_kernel.to(dtype)
        bias = self.bias.to(dtype)
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

    def __init__(self, hidden_dim: int, action_dim: int, use_dueling: bool):
        super().__init__()
        self.use_dueling = use_dueling
        self.adv_hidden = nn.Linear(hidden_dim, hidden_dim)
        self.adv_out = nn.Linear(hidden_dim, action_dim)
        if use_dueling:
            self.val_hidden = nn.Linear(hidden_dim, hidden_dim)
            self.val_out = nn.Linear(hidden_dim, 1)

    def forward(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        adv = _linear(F.relu(_linear(h, self.adv_hidden, dtype)),
                      self.adv_out, dtype)
        if not self.use_dueling:
            return adv.float()
        val = _linear(F.relu(_linear(h, self.val_hidden, dtype)),
                      self.val_out, dtype)
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
        latent = self.torso(obs_seq.reshape(batch * seq, *obs_seq.shape[2:]),
                            dtype, layout).reshape(batch, seq, -1)
        rnn_in = torch.cat([latent, last_action_seq.to(dtype)], dim=-1)
        carry, outputs = self.lstm(unpack_hidden(hidden.to(dtype)), rnn_in,
                                   dtype)
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
