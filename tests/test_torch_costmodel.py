"""The port's analytic cost model (r2d2_tpu_torch/telemetry/costmodel.py)
against the JAX package's ``telemetry/costmodel.py`` on the CPU: the
per-component FLOPs and bytes, the serial chain and the model FLOPs a
step, exactly, over configurations (the reference shape, double DQN, the
fused dual unroll, space-to-depth, activation bytes 2 and 4, no dueling,
other widths), and the model FLOPs reconciled with
``torch.utils.flop_counter.FlopCounterMode``'s count of one eager learner
step of the port, as the JAX package reconciles them with XLA's; the
peak table's rows."""

import numpy as np
import pytest

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.telemetry import costmodel

pytestmark = pytest.mark.torch_port

SMALL = {"env.frame_height": 36, "env.frame_width": 36,
         "env.frame_stack": 2, "network.hidden_dim": 32,
         "network.cnn_out_dim": 64,
         "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
         "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
         "sequence.forward_steps": 3, "replay.capacity": 800,
         "replay.block_length": 20, "replay.batch_size": 8}
# (overrides, act_bytes): the configurations both packages are held to
CASES = {
    "reference": ({}, None),
    "double": ({"network.use_double": True}, None),
    "double_fused_dual": ({"network.use_double": True,
                           "optim.fused_double_unroll": "on"}, None),
    "space_to_depth": ({"network.space_to_depth": "on"}, None),
    "act_bytes_2": ({}, 2),
    "act_bytes_4": ({"network.use_double": True}, 4),
    "no_dueling": ({"network.use_dueling": False}, None),
    "bf16_on_small": ({**SMALL, "network.bf16": "on"}, None),
    "small_batch_capacity": ({"replay.batch_size": 32,
                              "replay.capacity": 120_000}, 2),
}


def _both(overrides):
    from r2d2_tpu.config import Config as JConfig
    return Config().replace(**overrides), JConfig().replace(**overrides)


@pytest.mark.parametrize("case", sorted(CASES))
def test_analytic_component_costs_equal_jaxs(case):
    from r2d2_tpu.telemetry import costmodel as jcost
    overrides, act_bytes = CASES[case]
    ours, theirs = _both(overrides)
    for action_dim in (6, 18):
        got = costmodel.analytic_component_costs(ours, action_dim,
                                                 act_bytes=act_bytes)
        want = jcost.analytic_component_costs(theirs, action_dim,
                                              act_bytes=act_bytes)
        assert got == want
        assert set(got["components"]) == set(costmodel.COMPONENTS)
        assert costmodel.model_flops_per_step(
            ours, action_dim, ours.network.use_double) \
            == jcost.model_flops_per_step(theirs, action_dim,
                                          theirs.network.use_double)


def test_costs_block_is_the_jax_learners():
    """The record's block: the JAX Learner's keys from the same costs."""
    from r2d2_tpu.telemetry import costmodel as jcost
    ours, theirs = _both({})
    block = costmodel.costs_block(ours, 18, act_bytes=4)
    full = jcost.analytic_component_costs(theirs, 18, act_bytes=4)
    assert block == {
        "model_flops_per_step": full["model_flops_per_step"],
        "tokens_per_step": full["tokens_per_step"],
        "components": {n: {"flops": c["flops"], "bytes": c["bytes"]}
                       for n, c in full["components"].items()},
        "serial_chain": full["serial_chain"]}
    assert block["model_flops_per_step"] == pytest.approx(5.73e11,
                                                          rel=1e-3)


def test_fused_dual_auto_resolves_for_the_device():
    """"auto" is CUDA_AUTO's choice on CUDA (off) and off on the CPU: the
    serial chain walks three times under double DQN either way."""
    cfg = Config().replace(**{"network.use_double": True,
                              "optim.fused_double_unroll": "auto"})
    for device in (None, "cpu", "cuda"):
        chain = costmodel.analytic_component_costs(
            cfg, 18, device=device)["serial_chain"]
        assert chain["iterations"] == 3 * cfg.sequence.seq_len


@pytest.mark.parametrize("use_double", [False, True],
                         ids=["single", "double"])
def test_model_flops_reconcile_with_flop_counter(use_double):
    """One eager learner step of the port at a small config on the CPU
    under FlopCounterMode (convolutions, their backward, matmuls): the
    analytic model FLOPs lie within 5% of its count."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from r2d2_tpu_torch.tools import bench
    cfg = Config().replace(**{**SMALL, "network.use_double": use_double})
    dev = torch.device("cpu")
    spec, rs = bench.filled_replay(cfg, dev, bench.synthetic_blocks(
        cfg, 8, seed=int(use_double)))
    ts, step = bench.build_learner_step(cfg, dev, spec, 1)
    step(ts, rs)
    with FlopCounterMode(display=False) as counter:
        step(ts, rs)
    counted = counter.get_total_flops()
    model = costmodel.model_flops_per_step(cfg, bench.ACTION_DIM,
                                           use_double)
    assert counted > 0
    assert abs(model - counted) / counted < 0.05, (model, counted)


def test_peak_spec_rows():
    h100 = costmodel.peak_spec("NVIDIA H100 80GB HBM3")
    assert (h100["flops_bf16"], h100["hbm_gbps"], h100["power_limit_w"],
            h100["nominal"]) == (989.4e12, 3350.0, 700.0, False)
    assert costmodel.peak_spec("NVIDIA H100 PCIe")["flops_bf16"] == 756e12
    assert costmodel.peak_spec("NVIDIA H100 NVL")["hbm_gbps"] == 3900.0
    assert costmodel.peak_spec("NVIDIA A100-SXM4-80GB")["flops_bf16"] \
        == 312e12
    cpu = costmodel.peak_spec("cpu")
    assert cpu["nominal"] is True and cpu["device_kind"] == "cpu"
    # no TPU row: a TPU kind is an unknown card here
    assert costmodel.peak_spec("TPU v5 lite")["nominal"] is True
    assert not any("v5" in marker or "tpu" in marker
                   for marker, _ in costmodel.PEAK_SPECS)
    rates = np.array([spec["flops_bf16"] for _, spec in
                      costmodel.PEAK_SPECS])
    assert np.all(rates > 0)
