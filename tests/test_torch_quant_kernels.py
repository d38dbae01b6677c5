"""``int8_linear`` (ops/quant_kernels.py): its plain version against the
dequantize-then-matmul formula on the CPU, and on a card the kernel
against its plain version (marked ``cuda``: it skips without a card). No
JAX here, so the file runs on the card's machine too:
``python -m pytest tests/test_torch_quant_kernels.py -m cuda``."""

import pytest
import torch

from r2d2_tpu_torch.models.network import quantize_leaf_int8
from r2d2_tpu_torch.ops.quant_kernels import (LAUNCHES, int8_linear,
                                              int8_linear_plain,
                                              pad_int8_weight)

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("m", [1, 3, 32, 64, 70])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_int8_linear_plain_matches_dequant_formula(m, x_dtype):
    """The plain version (the kernel's arithmetic: x . q summed in f32, the
    scale and bias after) against x @ (q * scale)^T + b: f32 within a
    K-scaled 1e-6 relative; the pad columns never reach the sum; a CPU
    tensor launches nothing."""
    g = torch.Generator().manual_seed(m)
    k, n = 1030, 48
    w = torch.randn(n, k, generator=g)
    leaf = quantize_leaf_int8(w, axis=0)
    q, scale = leaf["q"], leaf["scale"].reshape(-1)
    bias = torch.randn(n, generator=g)
    x = torch.randn(m, k, generator=g).to(x_dtype)
    padded = pad_int8_weight(q)
    assert padded.shape == (n, 1040) and padded[:, k:].abs().sum() == 0
    padded[:, k:] = 99                    # not in the sum: x stops at k
    launches = LAUNCHES["int8_linear"]
    got = int8_linear(x, padded, scale, bias, torch.float32)
    assert LAUNCHES["int8_linear"] == launches
    want = x.float() @ (q.float() * scale[:, None]).t() + bias
    tol = 1e-6 * k ** 0.5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    assert int8_linear_plain(x, q, scale).dtype == x_dtype


@pytest.mark.cuda
def test_int8_linear_kernel_matches_plain():
    """On a card: the kernel against its plain version at the quantized
    forward's shapes (f32 sums in another order: rtol 1e-5 scaled by
    sqrt(K); bf16 output within one bf16 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU route")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for k, n in ((3136, 1024), (1030, 2048), (512, 2048), (512, 6)):
        leaf = quantize_leaf_int8(torch.randn(n, k, generator=g), axis=0)
        q = pad_int8_weight(leaf["q"]).to(dev)
        scale = leaf["scale"].reshape(-1).to(dev)
        bias = torch.randn(n, generator=g).to(dev)
        for m in (1, 3, 32, 64):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(m, k, generator=g).to(dev, dt)
                got = int8_linear(x, q, scale, bias, dt).float()
                want = int8_linear_plain(x, q, scale, bias, dt).float()
                if dt == torch.float32:
                    tol = 1e-5 * k ** 0.5 * want.abs().max().item()
                    assert (got - want).abs().max().item() <= tol
                else:
                    ulp = want.abs().clamp_min(1e-30) * 2.0 ** -7
                    assert bool(((got - want).abs() <= ulp + 1e-6).all())


def test_captured_launches_count_their_stream(monkeypatch):
    """A graph capture reads its own launches: ``captured_launches`` counts
    the launches made on the capture's stream, from any thread (a captured
    backward runs in autograd's thread), and not those another thread makes
    on its own stream meanwhile (the policy server's beside the learner's
    capture); every launch still reaches the global count."""
    import threading
    from types import SimpleNamespace

    from r2d2_tpu_torch.ops import launch_counts as lc
    current = threading.local()
    monkeypatch.setattr(lc, "stream_handle",
                        lambda device: getattr(current, "stream", 0))
    table = {"k": 0}

    def launch(stream: int, n: int) -> None:
        current.stream = stream
        for _ in range(n):
            lc.count_launch(table, "k", None)

    lc.count_launch(table, "k", None)                # no capture open
    with lc.captured_launches(SimpleNamespace(cuda_stream=7)) as counted:
        launch(7, 2)
        threads = [threading.Thread(target=launch, args=(7, 3)),
                   threading.Thread(target=launch, args=(9, 5))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5.0)
        assert not any(t.is_alive() for t in threads)
    launch(7, 1)
    assert counted == {"k": 5} and table["k"] == 12
