"""The fused LSTM scan of the port (``ops/lstm_kernels.py``): its plain
versions and ``LSTMScan`` against the JAX package's Pallas kernels
(``ops/pallas_lstm.py``) run in interpret mode, ``HoistedLSTM``'s fused
path against the JAX ``HoistedLSTM(use_pallas=True)``, and the dispatch.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
against these plain versions there."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.models.network import HoistedLSTM as JHoistedLSTM
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.ops.pallas_lstm import _fwd_call, lstm_scan_pallas
from r2d2_tpu.ops.pallas_lstm import lstm_scan_reference as j_scan_reference
from r2d2_tpu_torch.config import Config, NetworkConfig, parse_overrides
from r2d2_tpu_torch.models import network as port_network
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import HoistedLSTM, NetworkApply
from r2d2_tpu_torch.ops import lstm_kernels as lk

pytestmark = pytest.mark.torch_port

T, B, H = 12, 8, 16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the two sides sum the recurrent product in other orders (as
# tests/test_pallas.py allows the kernel against the scan). bf16: both
# follow the kernel's arithmetic (f32 sums and carries, outputs rounded once),
# so they differ only where an f32 difference of that size flips a rounding:
# two bf16 ulps.
TOL = {"float32": dict(atol=2e-6, rtol=2e-6),
       "bfloat16": dict(atol=2.0 ** -7, rtol=2.0 ** -7)}


def _inputs(rng, dtype, steps=T):
    jdt, tdt = DTYPES[dtype]
    arrays = [rng.standard_normal((steps, B, 4 * H)),
              rng.standard_normal((H, 4 * H)) * 0.3,
              rng.standard_normal((B, H)), rng.standard_normal((B, H))]
    arrays = [a.astype(np.float32) for a in arrays]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_forward_matches_pallas(rng, dtype):
    """Residual forward: hseq, cseq and the post-activation gates against
    the Pallas forward kernel, in its storage type."""
    jargs, targs = _inputs(rng, dtype)
    want = _fwd_call(*jargs, True, 1)
    got = lk.lstm_fwd_plain(*targs, save_residuals=True)
    for name, g, w in zip(("hseq", "cseq", "acts"), got, want):
        assert g.dtype == targs[0].dtype and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name,
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_lean_forward_matches_pallas(rng, dtype):
    """Lean forward (hseq + c_fin) against the Pallas lean kernel, and equal
    to the residual forward's hseq and last c exactly."""
    jargs, targs = _inputs(rng, dtype)
    want_h, want_c = _fwd_call(*jargs, True, 1, save_residuals=False)
    hseq, c_fin = lk.lstm_fwd_plain(*targs, save_residuals=False)
    np.testing.assert_allclose(_np(hseq), _np(want_h), **TOL[dtype])
    np.testing.assert_allclose(_np(c_fin), _np(want_c), **TOL[dtype])
    full_h, full_c, _ = lk.lstm_fwd_plain(*targs, save_residuals=True)
    assert torch.equal(hseq, full_h) and torch.equal(c_fin, full_c[-1])


@pytest.mark.parametrize("carry_used", [True, False],
                         ids=["carry_cotangents", "carry_ignored"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scan_grads_match_pallas(rng, dtype, carry_used):
    """LSTMScan's backward (the plain version on the CPU) against jax.grad
    through the Pallas custom_vjp: dxpb, dWh, dc0, dh0, with the final
    carries read by the loss (nonzero dc_fin/dh_fin) or ignored (zero)."""
    jargs, targs = _inputs(rng, dtype)
    w = rng.standard_normal((T, B, H)).astype(np.float32)
    carry_w = (1.3, 0.7) if carry_used else (0.0, 0.0)

    def jloss(args):
        hs, (c, h) = lstm_scan_pallas(*args, interpret=True)
        f32 = jnp.float32
        loss = jnp.sum(hs.astype(f32) * w)
        if carry_used:
            loss += (jnp.sum(c.astype(f32) * carry_w[0])
                     + jnp.sum(h.astype(f32) * carry_w[1]))
        return loss

    want = jax.grad(jloss)(jargs)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    hs, (c, h) = lk.lstm_scan(*leaves)
    loss = (hs.float() * torch.from_numpy(w)).sum()
    if carry_used:
        loss = loss + (c.float() * carry_w[0]).sum() + \
            (h.float() * carry_w[1]).sum()
    loss.backward()
    for name, t, wnt in zip(("dxpb", "dwh", "dc0", "dh0"), leaves, want):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(_np(t.grad), _np(wnt), err_msg=name,
                                   **TOL[dtype])


def test_f32_plain_equals_scan_reference(rng):
    """In f32 nothing is rounded, so the kernel arithmetic is the scan's:
    the port's plain forward against both scan twins (port and JAX)."""
    jargs, targs = _inputs(rng, "float32")
    hseq, c_fin = lk.lstm_fwd_plain(*targs, save_residuals=False)
    ref_h, (ref_c, ref_hf) = lk.lstm_scan_reference(*targs)
    j_h, (j_c, _) = j_scan_reference(*jargs)
    np.testing.assert_allclose(hseq.numpy(), ref_h.numpy(), atol=2e-6)
    np.testing.assert_allclose(c_fin.numpy(), ref_c.numpy(), atol=2e-6)
    assert torch.equal(ref_hf, ref_h[-1])
    np.testing.assert_allclose(ref_h.numpy(), _np(j_h), atol=2e-6)
    np.testing.assert_allclose(ref_c.numpy(), _np(j_c), atol=2e-6)


def _hoisted_pair(rng, dim=24):
    """JAX HoistedLSTM params with a nonzero bias, copied into the port's."""
    xs = rng.standard_normal((B, T, dim)).astype(np.float32)
    carry = tuple(rng.standard_normal((B, H)).astype(np.float32)
                  for _ in range(2))
    jcell = JHoistedLSTM(features=H, use_pallas=True, pallas_interpret=True)
    params = jcell.init(jax.random.PRNGKey(0), carry, jnp.asarray(xs))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["bias"] = (rng.standard_normal(4 * H) * 0.3
                                ).astype(np.float32)
    cell = HoistedLSTM(dim, H, fused=True)
    p = params["params"]
    cell.load_state_dict({
        "input_proj.weight": torch.from_numpy(p["input_proj"]["kernel"].T
                                              .copy()),
        "recurrent_kernel": torch.from_numpy(p["recurrent_kernel"].copy()),
        "bias": torch.from_numpy(p["bias"].copy())})
    return jcell, params, cell, xs, carry


def test_hoisted_lstm_fused_matches_jax_pallas(rng):
    """The port's fused HoistedLSTM (bias fold, axis swaps, carry order)
    against the JAX HoistedLSTM on its Pallas path (interpret mode), f32:
    outputs, final carry, and the grads of every parameter and of the
    input. Tolerance atol 1e-5, rtol 1e-5, as the JAX package's own
    pallas-vs-scan HoistedLSTM test: the input projection and its grads add
    matmuls over D summed in other orders to the kernels' 2e-6."""
    jcell, params, cell, xs, carry = _hoisted_pair(rng)
    w = rng.standard_normal((B, T, H)).astype(np.float32)

    def jloss(params, xs):
        (c, h), out = jcell.apply(params, tuple(map(jnp.asarray, carry)), xs)
        return jnp.sum(out * w) + jnp.sum(c * 1.3) + jnp.sum(h * 0.7), (
            c, h, out)

    (_, (jc, jh, jout)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(xs))
    txs = torch.from_numpy(xs).requires_grad_(True)
    (c, h), out = cell(tuple(map(torch.from_numpy, carry)), txs,
                       torch.float32)
    ((out * torch.from_numpy(w)).sum() + (c * 1.3).sum()
     + (h * 0.7).sum()).backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    for got, want in ((out, jout), (c, jc), (h, jh), (txs.grad, jgx)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    g = jgp["params"]
    np.testing.assert_allclose(_np(cell.input_proj.weight.grad),
                               _np(g["input_proj"]["kernel"]).T, **tol)
    np.testing.assert_allclose(_np(cell.recurrent_kernel.grad),
                               _np(g["recurrent_kernel"]), **tol)
    np.testing.assert_allclose(_np(cell.bias.grad), _np(g["bias"]), **tol)


def test_network_fused_path_matches_jax_pallas(rng):
    """Whole network, pallas_lstm "on" on both sides (JAX in interpret
    mode), weights converted by models/convert.py unchanged: the fused path
    keeps the parameter layout. Q and packed hidden atol 1e-5, as the
    default-path network test."""
    tiny = dict(hidden_dim=H, cnn_out_dim=32,
                conv_layers=((8, 4, 2), (16, 3, 1)), bf16="off")
    actions, stack, hw = 6, 2, 24
    jnet = JNetworkApply(actions, JNetworkConfig(
        pallas_lstm="on", pallas_lstm_interpret=True, **tiny),
        stack, hw, hw)
    params = jnet.init(jax.random.PRNGKey(1))
    net = NetworkApply(actions, NetworkConfig(pallas_lstm="on", **tiny),
                       stack, hw, hw, "cpu")
    module = net.build()
    assert module.lstm.fused
    default = NetworkApply(actions, NetworkConfig(**tiny), stack, hw, hw,
                           "cpu").build()
    assert module.state_dict().keys() == default.state_dict().keys()
    module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    obs = rng.uniform(size=(B, T, hw, hw, stack)).astype(np.float32)
    la = np.eye(actions, dtype=np.float32)[rng.integers(0, actions, (B, T))]
    hidden = rng.normal(size=(B, 2, H)).astype(np.float32)
    want_q, want_h = jnet.apply(params, jnp.asarray(obs), jnp.asarray(la),
                                jnp.asarray(hidden))
    with torch.no_grad():
        got_q, got_h = module(torch.from_numpy(obs), torch.from_numpy(la),
                              torch.from_numpy(hidden))
    np.testing.assert_allclose(got_q.numpy(), _np(want_q), atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), atol=1e-5)


def test_single_step_stays_on_the_loop(rng, monkeypatch):
    """T=1 (the actor's step) runs the Python loop even when fused; T=2
    takes the fused scan."""
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return lk.lstm_scan(*args)

    monkeypatch.setattr(port_network, "lstm_scan", spy)
    cell = HoistedLSTM(8, H, fused=True)
    torch.nn.init.normal_(cell.recurrent_kernel, std=0.1)
    carry = (torch.zeros(B, H), torch.zeros(B, H))
    for steps in (1, 2):
        xs = torch.from_numpy(rng.standard_normal((B, steps, 8))
                              .astype(np.float32))
        (_, _), out = cell(carry, xs, torch.float32)
        assert out.shape == (B, steps, H)
    assert calls == [torch.Size([2, B, 4 * H])]


def test_dispatch_takes_lean_forward_without_autograd(rng, monkeypatch):
    """Under autograd the residual forward (LSTMScan); under no_grad, or
    when no input requires grad, the lean forward, as the JAX custom_vjp's
    primal does for the target unroll."""
    taken = []

    def spy(xpb, wh, c0, h0, save_residuals=True):
        taken.append(save_residuals)
        return lk.lstm_fwd_plain(xpb, wh, c0, h0, save_residuals)

    monkeypatch.setattr(lk, "lstm_fwd", spy)
    _, targs = _inputs(rng, "float32", steps=3)
    wh = targs[1].clone().requires_grad_(True)
    hs, (c, h) = lk.lstm_scan(targs[0], wh, targs[2], targs[3])
    assert hs.requires_grad and c.requires_grad and h.requires_grad
    with torch.no_grad():
        lean_hs, (lean_c, lean_h) = lk.lstm_scan(targs[0], wh, targs[2],
                                                 targs[3])
    lk.lstm_scan(*targs)
    assert taken == [True, False, False]
    assert torch.equal(lean_hs, hs.detach()) and torch.equal(lean_h, h)
    assert torch.equal(lean_c, c.detach())


def test_cpu_dispatch_launches_nothing(rng):
    """CPU tensors take the plain versions; the CUDA wrappers refuse them."""
    lk.reset_launch_counts()
    _, targs = _inputs(rng, "bfloat16", steps=3)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    hs, _ = lk.lstm_scan(*leaves)
    hs.float().sum().backward()
    with pytest.raises(ValueError):
        lk.lstm_fwd_cuda(*targs)
    with pytest.raises(ValueError):
        lk.lstm_bwd_cuda(targs[1], targs[2], targs[3], hs, hs, targs[0], hs,
                         targs[2], targs[3])
    assert lk.LAUNCHES == {"lstm_fwd": 0, "lstm_fwd_lean": 0, "lstm_bwd": 0}


def test_pallas_lstm_setting():
    """"on" builds the fused path, "off" and "auto" the loop; the TPU grid
    and debug knobs of the JAX config are refused as unknown fields."""
    for setting, fused in (("on", True), ("off", False), ("auto", False)):
        net = NetworkApply(4, NetworkConfig(pallas_lstm=setting, hidden_dim=H,
                                            cnn_out_dim=32, bf16="off"),
                           4, 84, 84, "cpu")
        assert net.config.pallas_lstm is fused
        assert net.build().lstm.fused is fused
    with pytest.raises(ValueError):
        NetworkApply(4, NetworkConfig(pallas_lstm="sometimes"), 4, 84, 84,
                     "cpu")
    cfg = parse_overrides(Config(), ["--network.pallas_lstm=on"])
    assert cfg.network.pallas_lstm == "on"
    for knob in ("--network.pallas_lstm_block=5",
                 "--network.pallas_lstm_interpret=true"):
        with pytest.raises(SystemExit, match="unknown field"):
            parse_overrides(Config(), [knob])


def test_phase_probe_instruments_the_kernel_source():
    """tools/lstm_phases.py puts its clocks at anchors of
    csrc/lstm_kernels.cu: every anchor is found once (the forward's 4
    spans: the wait at the slot's barrier, the staging of h_{t-1} rows, the
    product, and the gate math + stores + arrive; the backward's 3 per step,
    the grid barrier before dWh and the dWh tail; a start and one store per
    kernel; 1 + 5 + 6 anchors in all), and a source without one raises
    instead of timing the wrong span."""
    from r2d2_tpu_torch.tools.lstm_phases import EDITS, instrumented_source
    source = (Path(lk.__file__).resolve().parent.parent / "csrc"
              / "lstm_kernels.cu").read_text()
    out = instrumented_source(source)
    assert len(EDITS) == 1 + 5 + 6
    assert out.count("ph[") - out.count("ph[4]") == 4 + 5 + 2
    assert out.count("tp = now_ns();") == 2
    assert out.count("g_phase[blockIdx.x][i] = ph[i]") == 2
    assert "read_phases" in out
    for anchor, _ in EDITS[1:6]:
        with pytest.raises(ValueError, match="anchor"):
            instrumented_source(source.replace(anchor, ""))
    with pytest.raises(ValueError, match="anchor"):
        instrumented_source(source.replace(EDITS[-1][0], ""))


def test_chip_smoke_lstm_bounds():
    """chip_smoke.py's bound for each LSTM kernel at the reference shape:
    bf16 forward bytes-bound (xpb and acts 28.8 MB each, hseq and cseq 7.2
    MB each), the lean forward and the backward bound by their 14.8 and
    29.5 GFLOP over 989 TFLOP/s; f32 by operations over 67 TFLOP/s."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bf16 = smoke.lstm_bounds((55, 128, 512), "bfloat16")
    assert bf16["lstm_fwd"][1] == "bytes"
    assert bf16["lstm_fwd"][0] == pytest.approx(
        (2 * 55 * 128 * 2048 + 512 * 2048 + 2 * 128 * 512
         + 2 * 55 * 128 * 512) * 2 / 3.35e12 * 1e3)
    flops = 2 * 55 * 128 * 512 * 2048
    assert bf16["lstm_fwd_lean"] == pytest.approx((flops / 989e12 * 1e3,
                                                   "operations"))
    assert bf16["lstm_bwd"] == pytest.approx((2 * flops / 989e12 * 1e3,
                                              "operations"))
    f32 = smoke.lstm_bounds((55, 128, 512), "float32")
    assert f32["lstm_bwd"] == pytest.approx((2 * flops / 67e12 * 1e3,
                                             "operations"))
