"""r2d2_tpu_torch/tools/update_order.py on the CPU: the unsharded external
step on one thread against several gives every leaf's update and gradient
distance; the gradients agree to rounding, and both runs start from the
same weights (ROADMAP C.5's yardstick for 13a's ``update_rel``)."""

import json

import pytest

from r2d2_tpu_torch.tools import update_order

pytestmark = pytest.mark.torch_port


def test_update_order_reports_every_leaf(capsys):
    assert update_order.main(["--hidden", "16", "--batch", "8",
                              "--steps", "2", "--threads", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    leaves = out["leaves"]
    assert "lstm.recurrent_kernel" in leaves
    assert out["worst_update_leaf"] in leaves
    assert all(0.0 <= row["grad_rel"] < 1e-4 for row in leaves.values())
    assert all(row["update_rel"] >= 0.0 for row in leaves.values())
