"""The port's compile telemetry (r2d2_tpu_torch/telemetry/compile.py)
against the JAX package's on the CPU: one seeded sequence of capture
events (a name and a shape signature each, with a wall time) through
both monitors gives the same interval blocks and totals (retraces after
``mark_warm``, late first captures, the newest retrace), apart from the
wall-clock stamp of that retrace; the pre-capture coverage report; the
``compile_event`` context and the one-active-monitor rule; the policy
server's bucket coverage on the CPU."""

import numpy as np
import pytest

from r2d2_tpu_torch.telemetry.compile import (CompileMonitor, active_monitor,
                                              aot_coverage, compile_event)

pytestmark = pytest.mark.torch_port


def _events(seed: int, n: int = 60):
    """(name, signature, seconds, warm_after): a few names, each seen at a
    few signatures, durations log-uniform; warm-up ends a third in."""
    rng = np.random.default_rng(seed)
    names = [f"fn{i}" for i in range(4)]
    out = []
    for i in range(n):
        name = names[int(rng.integers(0, 3 if i < n // 3 else 4))]
        sig = f"[f32[{int(rng.integers(1, 4))},8]]"
        out.append((name, sig, float(10 ** rng.uniform(-3, 0)),
                    i == n // 3))
    return out


def _strip(block: dict) -> dict:
    out = dict(block)
    if "last_retrace" in out:
        out["last_retrace"] = {k: v for k, v in out["last_retrace"].items()
                               if k != "t"}
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_retrace_and_late_compile_accounting_matches_jax(seed):
    from r2d2_tpu.telemetry.compile import CompileMonitor as JMonitor
    ours, theirs = CompileMonitor(), JMonitor()
    blocks = []
    for i, (name, sig, seconds, warm) in enumerate(_events(seed)):
        if warm:
            ours.mark_warm()
            theirs.mark_warm()
        ours.on_compile(name, sig, seconds)
        theirs._on_backend_compile(seconds)
        theirs._on_compile(name, sig)
        if i % 7 == 6:
            a, b = ours.interval_summary(), theirs.interval_summary()
            assert _strip(a) == _strip(b)
            blocks.append(a)
    assert _strip(ours.totals()) == _strip(theirs.totals())
    assert ours.functions_seen() == theirs.functions_seen()
    assert sum(b["retraces_interval"] for b in blocks) > 0
    assert ours.totals()["late_compiles"] == theirs.totals()["late_compiles"]


@pytest.mark.parametrize("expected, compiled", [
    ([1, 2, 4, 8], [1, 2, 4, 8]), ([1, 2, 4, 8], [1, 4]),
    ([1, 2], [1, 2, 3]), ([], [5])])
def test_aot_coverage_matches_jax(expected, compiled):
    from r2d2_tpu.telemetry.compile import aot_coverage as j_cov
    assert aot_coverage(expected, compiled) == j_cov(expected, compiled)


def test_compile_event_reports_to_the_active_monitor_only():
    assert active_monitor() is None
    with compile_event("x", "s"):
        pass                            # no monitor: nothing to count
    first = CompileMonitor().install()
    second = CompileMonitor()
    try:
        with compile_event("graph", "a"):
            pass
        with pytest.raises(RuntimeError):
            with compile_event("graph", "b"):
                raise RuntimeError("a failed capture is not counted")
        assert first.totals()["compiles_total"] == 1
        second.install()                # displaces the first
        assert active_monitor() is second
        first.uninstall()               # not active: a no-op
        assert active_monitor() is second
        first.mark_warm()
        second.mark_warm()
        with compile_event("graph", "a"):
            pass
        with compile_event("graph", "c"):
            pass
        with compile_event("other", "a"):
            pass
        block = second.interval_summary()
        assert (block["compiles"], block["retraces_interval"],
                block["late_compiles_interval"]) == (3, 1, 2)
        assert first.totals()["compiles_total"] == 1
    finally:
        second.uninstall()
    assert active_monitor() is None


def test_policy_server_reports_its_bucket_coverage_on_the_cpu():
    """The buckets run at start are the pre-capture coverage: none
    missing after warm-up, all of them missing without it."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.serve import InprocEndpoint, PolicyServer
    cfg = Config().replace(**{
        "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
        "network.hidden_dim": 16, "network.cnn_out_dim": 32,
        "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
        "serve.max_batch": 8})
    net = NetworkApply(6, cfg.network, 2, 24, 24, "cpu")
    for warmup in (True, False):
        server = PolicyServer(cfg, net, net.init(0),
                              endpoint=InprocEndpoint(), warmup=warmup)
        cov = server.aot_coverage()
        assert cov["expected"] == server.buckets
        assert cov["missing"] == ([] if warmup else server.buckets)


def test_a_library_load_is_one_compile_event(monkeypatch):
    """ops/_build.py: a host library's first load in a process counts once,
    named by its source; a cached one counts nothing."""
    from r2d2_tpu_torch.native import __file__ as native_init
    from r2d2_tpu_torch.ops import _build
    from pathlib import Path
    monkeypatch.setattr(_build, "_loaded", {})
    mon = CompileMonitor().install()
    try:
        source = Path(native_init).parent / "sum_tree.cc"
        _build.load_host(source)
        _build.load_host(source)
    finally:
        mon.uninstall()
    assert mon.functions_seen() == {"kernel/sum_tree": 1}
    assert mon.totals()["compiles_total"] == 1
