"""``int8_linear`` (ops/quant_kernels.py): its plain version against the
dequantize-then-matmul formula on the CPU; the kernel's launch plan, its
f32 split and a model of its tensor-core fragments on the CPU; and on a
card the kernel against its plain version (marked ``cuda``: it skips
without a card). No JAX here, so the file runs on the card's machine too:
``python -m pytest tests/test_torch_quant_kernels.py -m cuda``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.models.network import quantize_leaf_int8
from r2d2_tpu_torch.ops import quant_kernels as qk
from r2d2_tpu_torch.ops.quant_kernels import (LAUNCHES, int8_linear,
                                              int8_linear_plain,
                                              int8_linear_plan,
                                              pad_int8_weight, split_bf16x3)

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


# the quantized forward's dense layers at the reference widths (K, N), as
# chip_smoke.py's QUANT_SHAPES
QUANT_SHAPES = ((3136, 1024), (1030, 2048), (512, 2048), (512, 512),
                (512, 6), (512, 1))
PLAN_ROWS = (1, 3, 8, 9, 32, 64)
H100_SMS = 132


def _cover(plan, n, k):
    """How often the kernel's lanes read each (channel, k) weight under
    ``plan`` (the kernel's index math, csrc/quant_kernels.cu): block (s,
    b), warp w, lane (g, t) reads rows 16 (b x warps + w) + g and + 8 at k
    [16t, 16t + 16) of each chunk of each round of its slice."""
    split, blocks = plan.grid
    rows = np.array([16 * (b * plan.warps + w) + g + 8 * h
                     for b in range(blocks) for w in range(plan.warps)
                     for g in range(8) for h in range(2)])
    rows = rows[rows < n]
    counts = np.zeros((n, k), np.int64)
    for s in range(split):
        lo, hi = plan.slice_chunks(s, k)
        for c0 in range(lo, hi, plan.chunks):
            for c in range(c0, min(c0 + plan.chunks, hi)):
                for t in range(4):
                    k0 = c * qk.CHUNK + 16 * t
                    if k0 < k:
                        counts[np.ix_(rows, np.arange(k0, min(k0 + 16, k)))
                               ] += 1
    return counts


@pytest.mark.parametrize("m", PLAN_ROWS)
@pytest.mark.parametrize("k,n", QUANT_SHAPES + ((1030, 1), (40, 300)))
def test_int8_linear_plan_covers_each_weight_once(m, k, n):
    """The launch plan at every dense shape of the quantized forward, N=1
    at K=1030 and a K shorter than one chunk (40): the blocks' slices,
    rounds and lanes read each (channel, k) weight exactly once, for bf16
    and f32 x; the geometry is one the kernel takes (rows the n8 tiles of
    M, at most MAX_SPLIT slices, a round within MAX_CHUNKS and MAX_SMEM),
    and the plan is cached."""
    for x_f32 in (False, True):
        plan = int8_linear_plan(m, n, k, H100_SMS, x_f32)
        assert (_cover(plan, n, k) == 1).all()
        assert plan.rows in (8, 16, 32, 64) and plan.rows // 2 < max(m, 8) \
            <= plan.rows
        assert 1 <= plan.split <= qk.MAX_SPLIT
        assert plan.warps in (1, 2, 4)
        assert 1 <= plan.chunks <= qk.MAX_CHUNKS
        assert plan.smem <= qk.MAX_SMEM
        assert plan.grid[1] * plan.warps * 16 >= n
        assert int8_linear_plan(m, n, k, H100_SMS, x_f32) is plan
    if (k, n) in QUANT_SHAPES[:4]:
        # the wide layers fill at least 120 of the card's SMs
        assert plan.grid[0] * plan.grid[1] >= 120


@pytest.mark.parametrize("lo,hi", [(-110, -60), (-60, 0), (0, 60),
                                   (60, 127)])
def test_split_bf16x3_sums_back_exactly(lo, hi):
    """The f32 route's split: hi + mid + lo gives x back bit for bit over
    normal f32 values with exponents in [lo, hi), both signs, and zeros;
    each term is a bf16 value and hi is x rounded to bf16."""
    rng = np.random.default_rng(lo + 200)
    n = 20000
    bits = ((rng.integers(lo + 127, hi + 127, n, dtype=np.uint32) << 23)
            | rng.integers(0, 1 << 23, n, dtype=np.uint32)
            | (rng.integers(0, 2, n, dtype=np.uint32) << 31))
    x = torch.from_numpy(bits.view(np.float32).copy())
    x[:16] = 0.0
    x[16:32] = -0.0
    assert torch.isfinite(x).all()
    t_hi, t_mid, t_lo = split_bf16x3(x)
    assert all(t.dtype == torch.bfloat16 for t in (t_hi, t_mid, t_lo))
    back = (t_hi.float() + t_mid.float()) + t_lo.float()
    assert torch.equal(back.abs().view(torch.int32),
                       x.abs().view(torch.int32))
    assert torch.equal(t_hi, x.to(torch.bfloat16))


def _mma_m16n8k16(a_regs, b_regs, c_regs):
    """PTX's mma.m16n8k16 .row.col over a warp's fragments, rebuilt from
    the ISA's fragment layouts (groupID g = lane / 4, t = lane % 4):
    a_regs[lane] a0..a7, b_regs[lane] b0..b3, c_regs[lane] c0..c3 (c_i at
    row g + 8 (i / 2), column 2t + i % 2) -> the D fragments of A . B + C."""
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(8):
            a[g + 8 * ((i // 2) % 2), 2 * t + (i % 2) + 8 * (i // 4)] = \
                a_regs[lane][i]
        for i in range(4):
            b[2 * t + (i % 2) + 8 * (i // 2), g] = b_regs[lane][i]
    d = a @ b
    return [[d[lane // 4 + 8 * (i // 2), 2 * (lane % 4) + i % 2]
             + c_regs[lane][i] for i in range(4)] for lane in range(32)]


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_linear_fragment_model(seed):
    """A model of one warp's work on one 64-k chunk, written from the
    kernel's index math: lane (g, t) widens the 16 weights at k [16t, 16t
    + 16) of rows g and g + 8 into its A fragments (step st: bytes 4st,
    4st + 1 as a0 a1 / a2 a3, 4st + 2, 4st + 3 as a4 a5 / a6 a7) and
    takes the same k of x row g as B (b0 b1, b2 b3); four mmas through
    PTX's layouts leave in accumulator e of the lane q . x^T at channel g
    + 8 (e / 2), x row 2t + e % 2 (the kernel's epilogue indices)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (16, 64))
    x = rng.standard_normal((8, 64))
    acc = [[0.0] * 4 for _ in range(32)]
    for st in range(4):
        a_regs, b_regs = [], []
        for lane in range(32):
            g, t = lane // 4, lane % 4
            k = 16 * t + 4 * st
            a_regs.append([q[g, k], q[g, k + 1], q[g + 8, k], q[g + 8, k + 1],
                           q[g, k + 2], q[g, k + 3], q[g + 8, k + 2],
                           q[g + 8, k + 3]])
            b_regs.append([x[g, k], x[g, k + 1], x[g, k + 2], x[g, k + 3]])
        acc = _mma_m16n8k16(a_regs, b_regs, acc)
    want = q @ x.T
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for e in range(4):
            assert abs(acc[lane][e] - want[g + 8 * (e // 2), 2 * t + e % 2]) \
                <= 1e-9


def _sum_floor(x, q, scale, k):
    """The rounding an f32 sum of K terms may carry in any order, at the
    random walk's size: 2^-24 sqrt(K) times the sum of the terms'
    magnitudes, times the channel's scale, per output."""
    mag = x.float().abs() @ q[:, :k].float().abs().t()
    return 2.0 ** -24 * k ** 0.5 * mag * scale.float()


def _bf16_rule(got, want, floor):
    """bf16 outputs within one bf16 ulp of the plain version's, or
    ``floor``."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs()
                 <= want.abs().clamp_min(1e-30) * 2.0 ** -7 + floor).all())


def _truncating_sum(x, q, k, split):
    """x . q^T as the kernel orders it, with each mma's sum truncated to
    f32 (toward zero, as a tensor core may): the 16 exact products of a
    k16 step joined to the chunk's sum, the 64-k chunks' sums added in
    f32, the ``split`` K slices added in rank order."""
    total = -(-k // qk.CHUNK)
    xd, qd = x.double(), q[:, :k].double()

    def trunc(v):
        f = v.float()
        return torch.where(f.double().abs() > v.abs(),
                           torch.nextafter(f, torch.zeros_like(f)), f)

    out = None
    for s in range(split):
        part = torch.zeros(x.shape[0], q.shape[0])
        for c in range(s * total // split, (s + 1) * total // split):
            d = torch.zeros_like(part)
            for k0 in range(c * qk.CHUNK, min((c + 1) * qk.CHUNK, k), 16):
                d = trunc(d.double() + xd[:, k0:k0 + 16]
                          @ qd[:, k0:k0 + 16].t())
            part = part + d
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("k,n", [(3136, 1024), (512, 2048)])
def test_bf16_floor_admits_the_sum_order_and_catches_a_lost_chunk(k, n):
    """The card test's floor for bf16 outputs at N(0, 1) weights
    (``_sum_floor``): it admits the kernel's order of summation modelled
    with truncating mma sums, it refuses the same sum with one 64-k chunk
    lost, and it passes one bf16 ulp only near zero (for < 2% of the
    outputs)."""
    g = torch.Generator().manual_seed(k)
    leaf = quantize_leaf_int8(torch.randn(n, k, generator=g), axis=0)
    q, scale = pad_int8_weight(leaf["q"]), leaf["scale"].reshape(-1)
    bias = torch.randn(n, generator=g)
    x = torch.randn(64, k, generator=g).to(torch.bfloat16)
    plan = int8_linear_plan(64, n, k, H100_SMS)
    want = int8_linear_plain(x, q, scale, bias, torch.bfloat16)
    floor = _sum_floor(x, q, scale, k)
    acc = _truncating_sum(x, q, k, plan.split)
    got = (acc * scale + bias).to(torch.bfloat16)
    assert _bf16_rule(got, want, floor)
    lost = acc - x[:, :qk.CHUNK].float() @ q[:, :qk.CHUNK].float().t()
    assert not _bf16_rule((lost * scale + bias).to(torch.bfloat16), want,
                          floor)
    assert (floor >= want.float().abs() * 2.0 ** -7).float().mean() < 0.02


@pytest.mark.cuda
def test_int8_linear_kernel_matches_plain():
    """On a card: the kernel against its plain version at the quantized
    forward's shapes (f32 sums in another order: rtol 1e-5 scaled by
    sqrt(K); bf16 output within one bf16 ulp, or 1e-6), and two launches
    on the same inputs bit-equal (no atomics: the K slices add in rank
    order). First the four layers at N(0, 1) weights, M 1, 3, 32, 64;
    then every QUANT_SHAPES layer, M across the n8 tiles and past one
    launch, q's pad filled: at a trained layer's scale (weights ~ N(0,
    1/K), biases ~ N(0, 0.01), as chip_smoke.py 9a makes them), and at
    N(0, 1) weights, where outputs near zero are the difference of sums
    of ~200 and a bf16 output's floor is the f32 sum's own rounding
    (``_sum_floor``) instead of 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU route")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def check(x, q, scale, bias, dt, k, sum_floor=False):
        got = int8_linear(x, q, scale, bias, dt)
        again = int8_linear(x, q, scale, bias, dt)
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), again.view(bits))
        got = got.float()
        want = int8_linear_plain(x, q, scale, bias, dt).float()
        if dt == torch.float32:
            tol = 1e-5 * k ** 0.5 * want.abs().max().item()
            assert (got - want).abs().max().item() <= tol
        else:
            floor = _sum_floor(x, q, scale, k) if sum_floor else 1e-6
            assert _bf16_rule(got, want, floor)

    for k, n in ((3136, 1024), (1030, 2048), (512, 2048), (512, 6)):
        leaf = quantize_leaf_int8(torch.randn(n, k, generator=g), axis=0)
        q = pad_int8_weight(leaf["q"]).to(dev)
        scale = leaf["scale"].reshape(-1).to(dev)
        bias = torch.randn(n, generator=g).to(dev)
        for m in (1, 3, 32, 64):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(m, k, generator=g).to(dev, dt)
                check(x, q, scale, bias, dt, k)
    for unit in (False, True):
        for k, n in QUANT_SHAPES:
            w = torch.randn(n, k, generator=g)
            leaf = quantize_leaf_int8(w if unit else w / k ** 0.5, axis=0)
            q = pad_int8_weight(leaf["q"]).to(dev)
            q[:, k:] = 99                   # the pad never reaches a sum
            scale = leaf["scale"].reshape(-1).to(dev)
            bias = (torch.randn(n, generator=g) * (1.0 if unit else 0.1)
                    ).to(dev)
            for m in PLAN_ROWS + (16, 70):
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn(m, k, generator=g).to(dev, dt)
                    check(x, q, scale, bias, dt, k, sum_floor=unit)


def test_int8_ablation_edits_the_kernel_source():
    """tools/int8_ablation.py's copies of csrc/quant_kernels.cu: every
    edit's anchor is found once and each copy's edits apply (no x staging,
    no tensor-core product, 8-tile blocks, clusters of 16 with the
    non-portable size allowed); a source without an anchor raises instead
    of timing the wrong kernel."""
    from r2d2_tpu_torch.tools.int8_ablation import (COPIES, EDITS,
                                                    edited_source)
    source = (Path(qk.__file__).resolve().parent.parent / "csrc"
              / "quant_kernels.cu").read_text()
    for anchor, _ in EDITS.values():
        assert source.count(anchor) == 1
    copies = {name: edited_source(source, edits)
              for name, (edits, _) in COPIES.items()}
    assert copies["kernel"] == source
    assert "stage_rows<2, 16>" not in copies["no_stage"]
    assert "mma.sync.aligned" not in copies["no_stage_no_mma"]
    assert "kMaxWarps = 8;" in copies["w8s16"]
    assert "NonPortableClusterSizeAllowed" in copies["w4s16"]
    for anchor, _ in EDITS.values():
        with pytest.raises(ValueError, match="anchor"):
            edited_source(source.replace(anchor, ""), EDITS)


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
