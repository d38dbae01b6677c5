"""Time the first Nature conv (32 filters, 8x8, stride 4) on the card in the
input layouts it could take, as the learner runs it: the forward plus the
weight and bias gradients (the decoded input needs none), bf16 and f32,
with TF32 off as in training (``utils/device.configure_numerics``).

    python -m r2d2_tpu_torch.tools.conv_layouts [--frames=7040]

Layouts of the same N x 84 x 84 x 4 frames:
  channels_last_4     today's decode output viewed as NCHW channels_last
  planar_4            NCHW contiguous (the JAX "planar" decode layout)
  channels_last_pad8  channels zero-padded to 8, input and weight
  space_to_depth_16   (N, 42, 42, 16) channels_last, a 4x4/stride-2 conv on
                      the re-indexed weight (models/network.py)

Default N = 7040 = B x T = 128 x 55, the reference learner's frames. Prints
one line per (layout, dtype): the median ms of CUDA-event runs and the
device kernels ``torch.profiler`` sees in one call (cuDNN's names show a
layout conversion or an f32 fallback); the last line is all of it as JSON.
Needs a CUDA device.
"""

import json
import statistics
import sys

import torch
import torch.nn.functional as F

from r2d2_tpu_torch.models.network import conv_weight_space_to_depth
from r2d2_tpu_torch.ops.indexing import space_to_depth_2x2
from r2d2_tpu_torch.utils.device import configure_numerics

LAYOUTS = ("channels_last_4", "planar_4", "channels_last_pad8",
           "space_to_depth_16")
FILTERS, KERNEL, STRIDE, FRAME, STACK = 32, 8, 4, 84, 4


def _operands(layout: str, frames: torch.Tensor, weight: torch.Tensor):
    """(input, weight function, stride) of the first conv in ``layout``;
    ``frames`` (N, H, W, K). The weight function runs inside autograd, as
    the torso's re-indexing does."""
    if layout == "channels_last_4":
        return frames.permute(0, 3, 1, 2), lambda: weight, STRIDE
    if layout == "planar_4":
        return frames.permute(0, 3, 1, 2).contiguous(), lambda: weight, STRIDE
    if layout == "channels_last_pad8":
        padded = F.pad(frames, (0, 8 - STACK))
        return (padded.permute(0, 3, 1, 2),
                lambda: F.pad(weight, (0, 0, 0, 0, 0, 8 - STACK)), STRIDE)
    if layout == "space_to_depth_16":
        return (space_to_depth_2x2(frames).permute(0, 3, 1, 2),
                lambda: conv_weight_space_to_depth(weight), STRIDE // 2)
    raise ValueError(f"unknown layout {layout!r}")


def _timed(fn, runs: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernels(fn, calls: int = 3):
    """[(device kernel name, ms per call)] of ``fn``, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / calls / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def check_layouts_agree(device, frames: int = 16) -> float:
    """The four layouts compute the same f32 conv (TF32 off): the largest
    difference of each from channels_last_4, raising past 1e-4."""
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.rand((frames, FRAME, FRAME, STACK), generator=gen,
                   device=device)
    w = torch.randn((FILTERS, STACK, KERNEL, KERNEL), generator=gen,
                    device=device) / KERNEL
    outs = []
    for layout in LAYOUTS:
        inp, weight, stride = _operands(layout, x, w)
        outs.append(F.conv2d(inp, weight(), None, stride))
    err = max((o - outs[0]).abs().max().item() for o in outs[1:])
    if not err <= 1e-4:
        raise RuntimeError(f"conv layouts disagree by {err:.3e}")
    return err


def measure(device, frames: int = 128 * 55, runs: int = 10):
    """One dict per (layout, dtype): ms, the kernels and their ms (under
    the caller's TF32 setting: ``configure_numerics`` for training's)."""
    gen = torch.Generator(device=device).manual_seed(0)
    obs = torch.randint(0, 256, (frames, FRAME, FRAME, STACK), generator=gen,
                        device=device, dtype=torch.uint8)
    weight = (torch.randn((FILTERS, STACK, KERNEL, KERNEL), generator=gen,
                          device=device) / KERNEL).requires_grad_(True)
    bias = torch.zeros(FILTERS, device=device, requires_grad=True)
    out_hw = (FRAME - KERNEL) // STRIDE + 1
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        grad_out = torch.randn((frames, FILTERS, out_hw, out_hw),
                               generator=gen, device=device).to(dtype)
        for layout in LAYOUTS:
            x, weight_fn, stride = _operands(
                layout, obs.to(dtype) * (1.0 / 255.0), weight)
            # the gradient arrives in the output's memory format, as from
            # the relu after the conv in training
            fmt = (torch.contiguous_format if layout == "planar_4"
                   else torch.channels_last)
            grad = grad_out.contiguous(memory_format=fmt)

            def step():
                out = F.conv2d(x, weight_fn().to(dtype), bias.to(dtype),
                               stride)
                weight.grad = bias.grad = None
                out.backward(grad)

            ms = _timed(step, runs)
            kernels = _kernels(step)
            results.append(dict(layout=layout,
                                dtype=str(dtype).removeprefix("torch."),
                                ms=ms, kernels=kernels))
            del x, grad
        del grad_out
    return results


def print_results(results) -> None:
    for r in results:
        names = "; ".join(f"{name[:100]} {ms:.3f}"
                          for name, ms in r["kernels"][:6])
        print(f"conv layout {r['layout']} {r['dtype']}: {r['ms']:.4f} ms | "
              f"{names}", flush=True)


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    frames = 128 * 55
    for arg in argv:
        name, _, value = arg.partition("=")
        if name != "--frames":
            raise SystemExit(f"unknown argument {arg!r}")
        frames = int(value)
    if not torch.cuda.is_available():
        raise SystemExit("conv_layouts needs a CUDA device")
    configure_numerics()
    device = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}: first conv "
          f"{FILTERS}x{KERNEL}x{KERNEL}/{STRIDE} on {frames} frames of "
          f"{FRAME}x{FRAME}x{STACK}, forward + weight gradient; layouts "
          f"agree to {check_layouts_agree(device):.3e} (f32)", flush=True)
    results = measure(device, frames)
    print_results(results)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
