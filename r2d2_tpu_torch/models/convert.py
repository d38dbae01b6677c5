"""Carry weights, quantized twins and replay state over from the JAX
package.

Inputs are plain numpy: a flax param tree as ``jax.tree.map(np.asarray,
params)`` and a ``ReplayState`` whose leaves were turned into numpy the
same way. Nothing here imports JAX.

Layout changes: conv kernels HWIO -> OIHW; Dense kernels (in, out) ->
(out, in); the LSTM's ``recurrent_kernel`` (H, 4H) and ``bias`` (4H,) keep
their layout and gate order i, f, g, o. Under ``network.space_to_depth=
"on"`` the first conv's flax kernel is (k, k, 4C, O) with input channel
(dh*2 + dw)*C + c, the port's order too, so it converts the same way. The torso Dense rows stay in flax's
(h, w, c) flatten order, because the port flattens the last conv output
from its NHWC view (models/network.py ConvTorso).
"""

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


# each leaf's layout change, by the kind of tensor it is
_LAYOUT = {"conv": lambda t: t.permute(3, 2, 0, 1).contiguous(),
           "dense": lambda t: t.T.contiguous(),
           "plain": lambda t: t}


def leaf_kind(name: str) -> str:
    """The layout change (``_LAYOUT``'s key) between port parameter
    ``name`` and its flax leaf."""
    if name.endswith(".bias") or name == "lstm.recurrent_kernel":
        return "plain"
    return "conv" if name.startswith("torso.convs.") else "dense"


# the port dim that holds a flax leaf's trailing (output-feature) axis,
# by kind: O of OIHW, out of (out, in), the last of a plain leaf
OUT_DIM = {"conv": 0, "dense": 0, "plain": -1}


def flax_shape(name: str, shape) -> tuple:
    """The shape of port parameter ``name``'s flax leaf: HWIO for a conv
    kernel, (in, out) for a Dense kernel, the same for a plain leaf."""
    kind, shape = leaf_kind(name), tuple(shape)
    if kind == "conv":
        return (shape[2], shape[3], shape[1], shape[0])
    if kind == "dense":
        return (shape[1], shape[0])
    return shape


def _walk(params: Mapping, leaf) -> Dict[str, torch.Tensor]:
    """The flax tree's leaves by the port's names, ``leaf(x, kind)``
    converting each."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def dense(prefix: str, sub: Mapping) -> None:
        out[f"{prefix}.weight"] = leaf(sub["kernel"], "dense")
        if "bias" in sub:
            out[f"{prefix}.bias"] = leaf(sub["bias"], "plain")

    torso = p["torso"]
    conv_names = sorted((k for k in torso if k.startswith("Conv_")),
                        key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(conv_names):
        out[f"torso.convs.{i}.weight"] = leaf(torso[name]["kernel"], "conv")
        out[f"torso.convs.{i}.bias"] = leaf(torso[name]["bias"], "plain")
    dense("torso.dense", torso["Dense_0"])
    lstm = p["lstm"]
    dense("lstm.input_proj", lstm["input_proj"])
    out["lstm.recurrent_kernel"] = leaf(lstm["recurrent_kernel"], "plain")
    out["lstm.bias"] = leaf(lstm["bias"], "plain")
    for name, sub in p["head"].items():
        dense(f"head.{name}", sub)
    return out


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax R2D2Network param tree -> the port's ``state_dict``."""
    return _walk(params, lambda x, kind: _LAYOUT[kind](_t(x)))


def quant_params_from_flax(qparams: Mapping) -> Dict[str, object]:
    """The quantized twin of a JAX inference bundle (``bundle["quant"]``,
    numpy leaves) -> the port's twin (models/network.py quantize_params):
    each {"q", "scale"} pair laid out as its weight (the scale's size-1
    axes move with it), int8 q; other leaves f32, or bf16 where the JAX
    leaf is bf16 (the "bf16" twin; its values cross exactly through
    f32)."""

    def leaf(x, kind):
        if isinstance(x, Mapping):
            return {"q": _LAYOUT[kind](torch.from_numpy(
                        np.array(x["q"], dtype=np.int8, copy=True))),
                    "scale": _LAYOUT[kind](_t(x["scale"]))}
        t = _LAYOUT[kind](_t(x))
        if np.asarray(x).dtype.name == "bfloat16":
            t = t.to(torch.bfloat16)
        return t

    return _walk(qparams, leaf)


def replay_state_from_jax(state, spec, device) -> "ReplayState":
    """A JAX ``ReplayState`` with numpy leaves -> the port's ReplayState
    on ``device``. ``spec`` is the port's ReplaySpec; its storage layout
    (padded or not) must match the JAX state's."""
    from r2d2_tpu_torch.replay.structs import DIAG_LEAVES, ReplayState

    def t(x):       # a copy: the port updates its state in place
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    obs = t(state.obs)
    expected = (spec.stored_frame_height, spec.stored_frame_width)
    if tuple(obs.shape[2:]) != expected:
        raise ValueError(f"JAX obs ring frames are {tuple(obs.shape[2:])}, "
                         f"the port's spec stores {expected}")
    lane = getattr(state, "lane", None)
    # the replay diagnostics' leaves, where the JAX state has them
    diag = {name: t(getattr(state, name)) for name in DIAG_LEAVES
            if getattr(state, name, None) is not None}
    return ReplayState(
        tree=t(state.tree), obs=obs, last_action=t(state.last_action),
        hidden=t(state.hidden), action=t(state.action),
        reward=t(state.reward), gamma=t(state.gamma),
        burn_in_steps=t(state.burn_in_steps),
        learning_steps=t(state.learning_steps),
        forward_steps=t(state.forward_steps), seq_start=t(state.seq_start),
        weight_version=t(state.weight_version),
        block_ptr=int(np.asarray(state.block_ptr)),
        lane=(t(lane) if lane is not None
              else torch.full((spec.num_blocks,), -1, dtype=torch.int32,
                              device=device)),
        **diag)
