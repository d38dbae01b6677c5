"""The port's trace attribution (r2d2_tpu_torch/telemetry/traceparse.py)
and component scopes (telemetry/scopes.py) on the CPU: JAX's component
tokens and their mapping of the same names; a hand-built torch.profiler
trace whose kernels reach their components through a scope, an
``External id``, a runtime call's ``correlation``, a backward range's
sequence number, a scope around a launch with no operator (a hand
kernel through ctypes), and a graph replay through an eager map, with the
rest
reported as unattributed; >= 80% of an eager CPU-profiled port step
attributed; the scopes a no-op without a profiler."""

import json

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.telemetry import scopes, traceparse

pytestmark = pytest.mark.torch_port

NAMES = ["torso", "jvp(torso)/conv", "lstm", "head", "sum_tree_update",
         "sum_tree_sample", "emit_blocks", "env_step", "env_reset",
         "obs_decode", "stack_frames_kernel", "replay_sample", "replay_add",
         "optimizer", "loss", "act_forward", "loss/torso", "act_forward/head",
         "aten::mm", "", "optimizer/lstm", "replay_sample/sum_tree_sample"]


def test_component_tokens_and_mapping_match_jax():
    from r2d2_tpu.telemetry import traceparse as jt
    assert traceparse.COMPONENT_TOKENS == jt.COMPONENT_TOKENS
    assert traceparse.UNATTRIBUTED == jt.UNATTRIBUTED
    for name in NAMES:
        assert traceparse.component_of(name) == jt.component_of(name), name


def _x(name, cat, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _trace():
    """A step: a torso scope with a conv op (its kernel by External id), an
    lstm scope whose kernel comes back through its runtime call's
    correlation, a backward range on autograd's thread (sequence number 7,
    the conv's), a graph replay's kernels (no op), and an unscoped
    kernel."""
    return [
        _x("torso", "user_annotation", 0, 100, **{"External id": 1}),
        _x("aten::conv2d", "cpu_op", 10, 50, **{"External id": 2,
                                                  "Sequence number": 7}),
        _x("lstm", "user_annotation", 200, 100),
        _x("aten::mm", "cpu_op", 210, 30, **{"External id": 3}),
        _x("cudaLaunchKernel", "cuda_runtime", 215, 5, correlation=90),
        _x("autograd::engine::evaluate_function: ConvolutionBackward0",
           "cpu_op", 400, 80, tid=2, **{"Sequence number": 7,
                                        "External id": 4}),
        _x("aten::convolution_backward", "cpu_op", 410, 60, tid=2,
           **{"External id": 5}),
        _x("cudaGraphLaunch", "cuda_runtime", 600, 5, correlation=95),
        # a hand kernel launched through ctypes inside a scope, no
        # operator around it: by the scope's External id, and by its
        # runtime call's place in the scope
        _x("obs_decode", "user_annotation", 800, 50, **{"External id": 9}),
        _x("cudaLaunchKernel", "cuda_runtime", 810, 5, correlation=97),
        _x("cudaLaunchKernel", "cuda_runtime", 820, 5, correlation=98),
        # device events
        _x("conv_fprop", "kernel", 20, 40, pid=0, tid=7,
           **{"External id": 2, "correlation": 80}),
        _x("gemm", "kernel", 220, 20, pid=0, tid=7, correlation=90),
        _x("conv_wgrad", "kernel", 420, 50, pid=0, tid=7,
           **{"External id": 5, "correlation": 85}),
        _x("conv_fprop", "kernel", 610, 40, pid=0, tid=7, correlation=95),
        _x("gemm", "kernel", 650, 10, pid=0, tid=7, correlation=95),
        _x("elementwise", "kernel", 700, 30, pid=0, tid=7, correlation=99),
        _x("Memcpy HtoD", "gpu_memcpy", 740, 10, pid=0, tid=8),
        _x("stack_frames_kernel", "kernel", 815, 7, pid=0, tid=7,
           **{"External id": 9, "correlation": 97}),
        _x("stack_frames_kernel", "kernel", 830, 3, pid=0, tid=7,
           correlation=98),
    ]


def test_attribution_reaches_each_kernel_like_the_scopes_say(tmp_path):
    events = _trace()
    plain = traceparse.attribute_trace(events)
    comps = plain["components"]
    assert plain["total_us"] == 210.0 and not plain["host_fallback"]
    assert comps["torso"]["time_us"] == 40 + 50       # fprop, wgrad
    assert comps["lstm"]["time_us"] == 20
    assert comps["obs_decode"]["time_us"] == 7 + 3
    assert comps["unattributed"]["time_us"] == 40 + 10 + 30 + 10
    assert plain["attributed_frac"] == round(120 / 210, 6)
    # the eager map attributes the graph replay's kernels by name
    kmap = traceparse.kernel_components(events)
    assert kmap == {"conv_fprop": {"torso": 40.0},
                    "conv_wgrad": {"torso": 50.0}, "gemm": {"lstm": 20.0},
                    "stack_frames_kernel": {"obs_decode": 10.0}}
    mapped = traceparse.attribute_trace(events, kernel_map=kmap)
    assert mapped["mapped_us"] == 50.0
    assert mapped["components"]["torso"]["time_us"] == 130
    assert mapped["components"]["lstm"]["time_us"] == 30
    assert mapped["components"]["unattributed"]["time_us"] == 40
    # a file round-trips, and a directory reads its newest trace
    path = tmp_path / "a.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert traceparse.attribute_trace(str(tmp_path)) == plain
    assert "attributed" in traceparse.format_attribution(plain)


def test_scope_is_a_range_only_under_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert scopes.scope("torso") is scopes.scope("lstm")      # the no-op
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with scopes.scope("torso"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "torso" in names


def test_eager_cpu_step_is_attributed(tmp_path):
    """One eager learner step of the gate configuration under the CPU
    profiler: >= 80% of the top-level host operators' time attributed,
    each network component, the decode, the loss, the optimizer, the sum
    tree and the sample seen; the CLI prints and writes the summary."""
    from r2d2_tpu_torch.telemetry.costmodel import gate_config
    from r2d2_tpu_torch.tools import bench
    cfg = gate_config()
    dev = torch.device("cpu")
    spec, rs = bench.filled_replay(cfg, dev, bench.synthetic_blocks(cfg, 8))
    ts, step = bench.build_learner_step(cfg, dev, spec, 1, eager=True)
    step(ts, rs)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(ts, rs)
    path = str(tmp_path / "step.pt.trace.json")
    prof.export_chrome_trace(path)
    summary = traceparse.attribute_trace(path)
    assert summary["host_fallback"]
    assert summary["attributed_frac"] >= 0.8, summary
    assert {"torso", "lstm", "head", "obs_decode", "loss", "optimizer",
            "sum_tree", "replay"} <= set(summary["components"])
    shares = [row["share"] for row in summary["components"].values()]
    assert np.isclose(sum(shares), 1.0, atol=1e-4)
    out = tmp_path / "summary.json"
    assert traceparse.main(["--trace", path, "--out", str(out)]) == 0
    assert json.loads(out.read_text())["total_us"] == summary["total_us"]
