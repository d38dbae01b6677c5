"""The port's pipelined sequence-parallel LSTM
(r2d2_tpu_torch/parallel/sequence_parallel.py) against the JAX package's
``make_sp_lstm`` on conftest's fake CPU devices: four stages as gloo ranks
(``run_ranks``), four microbatches, T=12, B=8, the ranks running
``tools/dp_check.py``'s ``rank_sp_lstm``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from r2d2_tpu.parallel.sequence_parallel import make_sp_lstm as j_sp_lstm
from r2d2_tpu_torch.ops.lstm_kernels import lstm_fwd_plain
from r2d2_tpu_torch.parallel.mesh import run_ranks
from r2d2_tpu_torch.tools import dp_check

pytestmark = pytest.mark.torch_port

S, M, B, T, H = 4, 4, 8, 12, 8


def _inputs():
    rng = np.random.default_rng(11)
    return {"w_rec": (rng.normal(size=(H, 4 * H)) / np.sqrt(H))
            .astype(np.float32),
            "bias": rng.normal(size=(4 * H,)).astype(np.float32),
            "x_proj": rng.normal(size=(B, T, 4 * H)).astype(np.float32),
            "carry0": rng.normal(size=(2, B, H)).astype(np.float32)}


def test_sp_lstm_matches_jax_and_the_unsharded_scan(tmp_path):
    """S=4 stages x M=4 microbatches over T=12, B=8, f32: outputs and the
    final carry within atol 2e-6 of JAX's make_sp_lstm (the f32 bound
    for the fused scan's arithmetic against JAX's cell), bit-equal to the
    port's unsharded plain lean scan, the same on every stage; a window
    or batch that does not divide raises "not divisible" on every
    stage."""
    inputs = _inputs()
    jrun = j_sp_lstm(JMesh(np.array(jax.devices()[:S]), ("sp",)),
                     microbatches=M)
    j_out, j_final = jrun(*(jnp.asarray(inputs[k]) for k in
                            ("w_rec", "bias", "x_proj", "carry0")))
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    hseq, c_fin = lstm_fwd_plain(
        (t["x_proj"] + t["bias"]).transpose(0, 1).contiguous(), t["w_rec"],
        t["carry0"][0], t["carry0"][1], save_residuals=False)
    plain_out = hseq.transpose(0, 1).numpy()
    plain_final = torch.stack([c_fin, hseq[-1]]).numpy()
    out = run_ranks(dp_check.rank_sp_lstm, S,
                    {"inputs": inputs, "microbatches": M},
                    rendezvous_dir=str(tmp_path))
    for got, final, errors, _, launches in out:
        np.testing.assert_allclose(got, np.asarray(j_out), atol=2e-6, rtol=0)
        np.testing.assert_allclose(final, np.asarray(j_final), atol=2e-6,
                                   rtol=0)
        assert np.array_equal(got, plain_out)
        assert np.array_equal(final, plain_final)
        assert len(errors) == 2 and all("not divisible" in e
                                        for e in errors)
        assert "T=11 not divisible by sp=4" in errors[0]
        assert "B=7 not divisible by microbatches=4" in errors[1]
        assert not any(launches.values())
