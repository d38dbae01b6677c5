"""The port's roofline (r2d2_tpu_torch/tools/roofline.py) and the cost
model's measured half (telemetry/costmodel.py ``program_cost``,
``collect_cost_table``) on the CPU: the report's analytic component rows
equal the JAX package's ``build_report`` (rtol 1e-12) under the same
peak and step time; the learner step's counted FLOPs within 5% of
``model_flops_per_step``; each hand kernel's registered formula equals
what the flop counter counts for its plain version; the formulas reach an
open ``counted_flops`` record only where a kernel launches; the CLI on
the CPU. Inputs come from numpy seeds."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from r2d2_tpu_torch.ops import launch_counts, lstm_kernels, quant_kernels
from r2d2_tpu_torch.telemetry.costmodel import (GATE_VARIANTS,
                                                collect_cost_table,
                                                gate_config,
                                                model_flops_per_step,
                                                program_cost)
from r2d2_tpu_torch.tools import roofline

pytestmark = pytest.mark.torch_port

PEAK = {"device_kind": "test", "flops_bf16": 100e12, "flops_f32": 20e12,
        "hbm_gbps": 1000.0, "nominal": False}
ROW_KEYS = ("flops", "bytes", "arithmetic_intensity", "bound",
            "share_of_flops", "time_at_peak_ms", "pct_of_peak")


@pytest.fixture(scope="module")
def gate_costs():
    return collect_cost_table(gate_config(),
                              variants=roofline.ROOFLINE_VARIANTS,
                              device="cpu")


@pytest.mark.parametrize("step_ms", [None, 3.5])
def test_analytic_rows_equal_jaxs_build_report(monkeypatch, gate_costs,
                                               step_ms):
    """JAX's report with its XLA table stubbed out (the analytic side is
    the comparison) against the port's at the gate configuration."""
    import r2d2_tpu.tools.roofline as jroof
    from r2d2_tpu.telemetry.costmodel import gate_config as j_gate
    monkeypatch.setattr(jroof, "collect_cost_table", lambda *a, **k: {
        "programs": {}, "backend": "cpu", "shape": {}})
    theirs = jroof.build_report(j_gate(), "gate", step_ms, dict(PEAK))
    ours = roofline.build_report(gate_config(), "gate", step_ms, dict(PEAK),
                                 costs=gate_costs, device="cpu")
    assert ours["compute_dtype"] == theirs["compute_dtype"]
    assert ours["ridge_flops_per_byte"] == theirs["ridge_flops_per_byte"]
    want = theirs["learner_step"]["components"]
    got = ours["learner_step"]["components"]
    assert list(got) == list(want)
    for name in want:
        for key in ROW_KEYS:
            if key not in want[name]:
                assert key not in got[name]
                continue
            a, b = got[name][key], want[name][key]
            if isinstance(b, str):
                assert a == b, (name, key)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-12,
                                           err_msg=f"{name}.{key}")
    for key in ("total_flops_analytic", "pct_of_peak_total"):
        assert ours["learner_step"][key] == theirs["learner_step"][key]
    for key in ("iterations", "flops", "floor_at_peak_ms"):
        assert (ours["learner_step"]["serial_chain"][key]
                == theirs["learner_step"]["serial_chain"][key])
    assert ours["parity"]["model_flops_per_step"] \
        == theirs["parity"]["model_flops_per_step"]


def test_counted_flops_within_5pct_of_the_model(gate_costs):
    cfg = gate_config()
    counted = gate_costs["programs"]["learner_step"]["flops"]
    model = model_flops_per_step(cfg, gate_costs["action_dim"],
                                 cfg.network.use_double)
    assert abs(counted / model - 1.0) <= 0.05
    assert gate_costs["programs"]["anakin_act"]["flops"] > 0
    assert gate_costs["programs"]["replay_sample"]["flops"] == 0.0


def test_every_port_variant_is_counted():
    table = collect_cost_table(gate_config(), device="cpu")
    assert set(table["programs"]) == set(GATE_VARIANTS)
    progs = table["programs"]
    assert (progs["learner_step_multi"]["flops"]
            == progs["learner_step_multi"]["steps_per_dispatch"]
            * progs["learner_step"]["flops"])
    assert progs["serve_forward"]["flops"] > 0
    assert progs["quant_forward"]["flops"] > 0
    with pytest.raises(ValueError, match="unknown cost variants"):
        collect_cost_table(gate_config(), variants=("learner_step_tp",),
                           device="cpu")


def _counted(fn, *args):
    with FlopCounterMode(display=False) as mode:
        fn(*args)
    return mode.get_total_flops()


@pytest.mark.parametrize("shape", [(3, 4, 8), (5, 2, 16), (1, 7, 5)])
def test_lstm_formulas_equal_the_plain_versions_count(shape):
    steps, batch, hidden = shape
    rng = np.random.default_rng(sum(shape))

    def t(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))
    xpb, wh = t(steps, batch, 4 * hidden), t(hidden, 4 * hidden)
    c0, h0 = t(batch, hidden), t(batch, hidden)
    hseq, cseq, acts = lstm_kernels.lstm_fwd_plain(xpb, wh, c0, h0)
    assert _counted(lstm_kernels.lstm_fwd_plain, xpb, wh, c0, h0) \
        == lstm_kernels.lstm_fwd_flops(steps, batch, hidden)
    assert _counted(lstm_kernels.lstm_fwd_plain, xpb, wh, c0, h0, False) \
        == lstm_kernels.lstm_fwd_flops(steps, batch, hidden)
    assert _counted(lstm_kernels.lstm_bwd_plain, wh, c0, h0, hseq, cseq,
                    acts, t(steps, batch, hidden), t(batch, hidden),
                    t(batch, hidden)) \
        == lstm_kernels.lstm_bwd_flops(steps, batch, hidden)


@pytest.mark.parametrize("m, n, k", [(1, 16, 7), (5, 32, 30), (64, 48, 33)])
def test_int8_formula_equals_the_plain_versions_count(m, n, k):
    rng = np.random.default_rng(m + n + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    q = quant_kernels.pad_int8_weight(q)
    scale = torch.ones(n)
    assert _counted(quant_kernels.int8_linear_plain, x, q, scale) \
        == quant_kernels.int8_linear_flops(m, n, k)


def test_copy_kernels_count_no_flops_and_records_nest():
    """The gather and the decode are a copy and an elementwise cast: the
    counter sees none in their plain versions. A launch's FLOPs reach every
    open record and nothing once they close."""
    from r2d2_tpu_torch.ops import replay_kernels
    ring = torch.randint(0, 255, (4, 30, 8, 8), dtype=torch.uint8)
    idx = torch.tensor([0, 2], dtype=torch.int32)
    start = torch.tensor([1, 3], dtype=torch.int32)
    assert _counted(replay_kernels.gather_windows_plain, ring, idx, start,
                    10) == 0
    obs = replay_kernels.gather_windows_plain(ring, idx, start, 10)
    assert _counted(replay_kernels.stack_frames_plain, obs, 8, 3) == 0
    table = {"k": 0}
    with launch_counts.counted_flops() as outer:
        launch_counts.count_launch(table, "k", torch.device("cpu"), 5.0)
        with launch_counts.counted_flops() as inner:
            launch_counts.count_launch(table, "k", torch.device("cpu"), 2.0)
    launch_counts.count_launch(table, "k", torch.device("cpu"), 1.0)
    assert (outer, inner, table) == ({"k": 7.0}, {"k": 2.0}, {"k": 3})


def test_program_cost_adds_the_kernel_formulas():
    def fn():
        launch_counts.count_launch({"lstm_fwd": 0}, "lstm_fwd",
                                   torch.device("cpu"), 100.0)
        torch.ones(2, 3) @ torch.ones(3, 4)
    cost = program_cost(fn)
    assert cost == {"flops": 148.0, "aten_flops": 48.0,
                    "kernel_flops": {"lstm_fwd": 100.0}}


def test_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "roofline.json"
    assert roofline.main(["--device=cpu", "--preset", "gate",
                          "--step-time-ms", "2.0", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    text = capsys.readouterr().out
    assert "NOMINAL" in text and "parity" in text
    assert report["parity"]["within"] is True
    assert report["learner_step"]["measured_ms"] == 2.0
    assert set(report["learner_step"]["components"]) == {
        "torso", "lstm", "head", "sum_tree", "replay"}
