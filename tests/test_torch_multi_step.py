"""The port's K-step dispatch against the JAX package's
``make_multi_learner_step`` (f32, on the CPU, where the dispatch is K eager
steps), the ``runtime.steps_per_dispatch`` and ``optim.fused_double_unroll``
settings, the learner and trainer in K-step dispatches, ``dual_sequence_q``
and the dual-unroll loss against the JAX package's, the CUDA graph
wrapper's static-address guard, and the bench's choices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.config import OptimConfig as JOptimConfig
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.learner.train_step import make_loss_fn as j_loss_fn
from r2d2_tpu.learner.train_step import make_multi_learner_step as j_multi
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.models.network import dual_sequence_q as j_dual
from r2d2_tpu.replay import device_replay as jdr
from r2d2_tpu_torch.tools import sync_train
from r2d2_tpu_torch.config import (CUDA_AUTO, Config, NetworkConfig,
                                   OptimConfig, RuntimeConfig,
                                   parse_overrides,
                                   resolve_fused_double_unroll,
                                   resolve_pallas_lstm)
from r2d2_tpu_torch.learner.train_step import (METRICS, GraphedSteps,
                                               TrainState, _state_tensors,
                                               create_train_state,
                                               make_learner_step,
                                               make_loss_fn,
                                               make_multi_learner_step,
                                               make_optimizer)
from r2d2_tpu_torch.models.convert import replay_state_from_jax
from r2d2_tpu_torch.models.network import (SPACE_TO_DEPTH, NetworkApply,
                                           dual_sequence_q)
from r2d2_tpu_torch.ops.indexing import space_to_depth_2x2
from r2d2_tpu_torch.replay.structs import SampleBatch
from r2d2_tpu_torch.runtime.learner_loop import Learner
from tests.test_torch_replay import (jax_filled, specs, synthetic_blocks,
                                     to_numpy_state)
from tests.test_torch_train import TINY_ARGS
from tests.test_torch_train_step import A, OPTIM, TINY, _flat

pytestmark = pytest.mark.torch_port

K = 3             # steps per dispatch; target syncs at steps 2, 4, 6
DISPATCHES = 2


def _jax_multi_run(use_double, pallas_lstm):
    """DISPATCHES JAX dispatches of K steps; per dispatch: the (K, B)
    jitter of its steps (the step's key chain, as the single step splits
    it), the stacked losses and grad norms, and the params, target and
    tree after it."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    jstate = jax_filled(jspec, synthetic_blocks(spec, 10, seed=5))
    start = to_numpy_state(jstate)
    jnet = JNetworkApply(A, JNetworkConfig(
        use_double=use_double, pallas_lstm=pallas_lstm,
        pallas_lstm_interpret=pallas_lstm == "on", **TINY),
        spec.frame_stack, spec.frame_height, spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init_params = _flat(ts.params)
    multi = j_multi(jnet, jspec, optim, use_double, K)
    trace = []
    for _ in range(DISPATCHES):
        key, jitter = ts.key, []
        for _ in range(K):
            key, base = jax.random.split(key)
            jitter.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(base, 0), (spec.batch_size,),
                jnp.float32)))
        ts, jstate, m = multi(ts, jstate)
        trace.append(dict(jitter=np.stack(jitter),
                          loss=np.asarray(m["loss"]),
                          grad_norm=np.asarray(m["grad_norm"]),
                          params=_flat(ts.params),
                          target=_flat(ts.target_params),
                          tree=np.asarray(jstate.tree)))
    return spec, start, init_params, trace


def _port_state(spec, start, init_params, use_double, pallas_lstm="off",
                fused_double_unroll="off"):
    net = NetworkApply(A, NetworkConfig(use_double=use_double,
                                        pallas_lstm=pallas_lstm, **TINY),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       "cpu")
    optim = OptimConfig(fused_double_unroll=fused_double_unroll, **OPTIM)
    online = net.build()
    online.load_state_dict(init_params)
    target = online
    if use_double:
        target = net.build()
        target.load_state_dict(init_params)
    ts = TrainState(params=online, target_params=target,
                    opt=make_optimizer(optim, online), step=0,
                    generator=torch.Generator().manual_seed(11))
    return net, optim, ts, replay_state_from_jax(start, spec, "cpu")


@pytest.mark.parametrize("pallas_lstm", ["off", "on"])
@pytest.mark.parametrize("use_double", [False, True])
def test_multi_step_matches_jax(use_double, pallas_lstm):
    """K=3 steps a dispatch, two dispatches, a target sync inside each
    (interval 2), per dispatch: the stacked losses rtol 1e-5, grad norms
    rtol 1e-4, params and target atol 1e-5 (the single step's
    tolerances), and the tree rtol 1e-5 after the first dispatch (3 steps,
    the single-step test's horizon). After the second (6 steps) the tree
    is held to rtol 1e-4: observed 1.45e-5 with double DQN, the priorities
    |td|^0.9 of the smallest TD errors drifting as the weights drift in
    the two frameworks' sum orders (losses stay within 2.4e-6).
    pallas_lstm="on": the port's fused scan (plain versions on the CPU)
    against the JAX step through the Pallas LSTM kernels in interpret
    mode."""
    spec, start, init_params, trace = _jax_multi_run(use_double, pallas_lstm)
    net, optim, ts, rs = _port_state(spec, start, init_params, use_double,
                                     pallas_lstm)
    multi = make_multi_learner_step(net, spec, optim, use_double, K)
    for d, want in enumerate(trace):
        ts, rs, m = multi(ts, rs, torch.from_numpy(want["jitter"].copy()))
        np.testing.assert_allclose(m["loss"].numpy(), want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].numpy(),
                                   want["grad_norm"], rtol=1e-4)
        for name, value in ts.params.state_dict().items():
            np.testing.assert_allclose(value.numpy(),
                                       want["params"][name].numpy(),
                                       atol=1e-5, err_msg=name)
        if use_double:
            for name, value in ts.target_params.state_dict().items():
                np.testing.assert_allclose(value.numpy(),
                                           want["target"][name].numpy(),
                                           atol=1e-5, err_msg=name)
        np.testing.assert_allclose(rs.tree.numpy(), want["tree"],
                                   rtol=1e-5 if d == 0 else 1e-4, atol=1e-7)
    assert ts.step == K * DISPATCHES
    assert int(ts.step_count) == K * DISPATCHES


@pytest.mark.parametrize("use_double", [False, True])
def test_dispatch_equals_single_steps_exactly(use_double):
    """One K-step dispatch drawing its jitter from the generator is K
    single steps, bit for bit: losses, every metric, params, target (a
    sync falls inside) and tree; every metric stacked to (K,)."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    start = to_numpy_state(jax_filled(jspec,
                                      synthetic_blocks(spec, 10, seed=5)))
    net = NetworkApply(A, NetworkConfig(use_double=use_double, **TINY),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       "cpu")
    optim = OptimConfig(**OPTIM)
    runs = []
    for k in (K, 1):
        ts = create_train_state(net, optim, seed=4, use_double=use_double)
        rs = replay_state_from_jax(start, spec, "cpu")
        if k == K:
            ts, rs, m = make_multi_learner_step(net, spec, optim,
                                                use_double, K)(ts, rs)
            assert set(m) == set(METRICS)
            assert all(v.shape == (K,) for v in m.values())
        else:
            step = make_learner_step(net, spec, optim, use_double)
            per_step = [step(ts, rs)[2] for _ in range(K)]
            m = {n: torch.stack([s[n] for s in per_step]) for n in METRICS}
        runs.append((ts, rs, m))
    (ts_a, rs_a, m_a), (ts_b, rs_b, m_b) = runs
    for name in METRICS:
        assert torch.equal(m_a[name], m_b[name]), name
    for a, b in ((ts_a.params, ts_b.params),
                 (ts_a.target_params, ts_b.target_params)):
        for (name, x), y in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert torch.equal(x, y), name
    assert torch.equal(rs_a.tree, rs_b.tree)
    assert ts_a.step == ts_b.step == K


@pytest.mark.parametrize("telemetry", [False, True])
def test_learner_dispatch_at_k1_is_the_single_step_exactly(telemetry):
    """The Learner's one factory (``make_dispatch_step``) at K = 1 keeps
    the single step's contract and values: from the same seed and blocks,
    a Learner's dispatches equal ``make_learner_step``'s steps bit for bit
    (losses, every metric and its shape, params, tree), with and without
    the diagnostics' interval steps; the K = 1 dispatch is held as
    ``multi``, and at K > 1 the factory returns that dispatch itself. The
    bench builds the same dispatch, or the eager single step on request."""
    from r2d2_tpu_torch.learner.train_step import make_dispatch_step
    from r2d2_tpu_torch.telemetry.learning import LearningDiag
    from r2d2_tpu_torch.telemetry.replaydiag import ReplayDiag
    from r2d2_tpu_torch.tools import bench
    cfg = parse_overrides(Config(), TINY_ARGS + [
        "--runtime.steps_per_dispatch=1",
        f"--telemetry.enabled={str(telemetry).lower()}",
        "--telemetry.learning_interval=3",
        "--telemetry.replay_diag_interval=2"])
    net = NetworkApply(6, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    dispatched, single = Learner(cfg, net), Learner(cfg, net)
    assert callable(dispatched._step_fn.multi)
    single._step_fn = make_learner_step(
        net, single.spec, cfg.optim, cfg.network.use_double,
        diag=LearningDiag.from_config(cfg), rdiag=ReplayDiag.from_config(cfg))
    for block in synthetic_blocks(dispatched.spec, 6, seed=1):
        block.last_action_row = block.last_action_row % 6
        block.action = block.action % 6
        dispatched.ingest(block)
        single.ingest(block)
    for i in range(6):
        uniform = (torch.rand(cfg.replay.batch_size,
                              generator=torch.Generator().manual_seed(i))
                   if i % 2 else None)
        got, want = dispatched.step(uniform), single.step(uniform)
        assert set(got) == set(want)
        for name in want:
            assert got[name].shape == want[name].shape, name
            assert torch.equal(got[name], want[name]) or (
                torch.isnan(want[name]).all()
                and torch.isnan(got[name]).all()), name
    for x, y in zip(dispatched.train_state.params.state_dict().values(),
                    single.train_state.params.state_dict().values()):
        assert torch.equal(x, y)
    assert torch.equal(dispatched.replay_state.tree, single.replay_state.tree)
    assert dispatched.training_steps == single.training_steps == 6
    spec = dispatched.spec
    multi = make_dispatch_step(net, spec, cfg.optim, False, 4)
    assert not hasattr(multi, "multi")
    _, step = bench.build_learner_step(cfg, "cpu", spec)
    _, eager = bench.build_learner_step(cfg, "cpu", spec, eager=True)
    assert callable(step.multi) and not hasattr(eager, "multi")


def test_runtime_and_unroll_settings():
    """--runtime.steps_per_dispatch parses; -1 resolves to 1 on the CPU and
    to the bench's winner on CUDA; prefetch_batches,
    runtime.snapshot_interval and replay.ingest_batch_blocks parse.
    pallas_lstm and fused_double_unroll "auto": off on the CPU,
    CUDA_AUTO's choice on CUDA."""
    cfg = parse_overrides(Config(), ["--runtime.steps_per_dispatch=4",
                                     "--optim.fused_double_unroll=on"])
    assert cfg.runtime.steps_per_dispatch == 4
    assert cfg.optim.fused_double_unroll == "on"
    assert Config().runtime.steps_per_dispatch == -1
    assert Config().optim.fused_double_unroll == "off"
    auto = RuntimeConfig()
    assert auto.resolved_steps_per_dispatch(torch.device("cpu")) == 1
    assert auto.resolved_steps_per_dispatch("cuda:0") == \
        CUDA_AUTO["runtime.steps_per_dispatch"]
    assert RuntimeConfig(steps_per_dispatch=8).resolved_steps_per_dispatch(
        "cpu") == 8
    assert parse_overrides(Config(), ["--runtime.prefetch_batches=2"]
                           ).runtime.prefetch_batches == 2
    knobs = parse_overrides(Config(), ["--runtime.snapshot_interval=5",
                                       "--replay.ingest_batch_blocks=8"])
    assert knobs.runtime.snapshot_interval == 5
    assert knobs.replay.ingest_batch_blocks == 8
    for resolve, name in ((resolve_pallas_lstm, "network.pallas_lstm"),
                          (resolve_fused_double_unroll,
                           "optim.fused_double_unroll")):
        assert resolve("auto", torch.device("cpu")) is False
        assert resolve("auto") is False
        assert resolve("auto", torch.device("cuda")) is CUDA_AUTO[name]
        assert resolve("on", "cpu") is True and resolve("off", "cuda") is False
        with pytest.raises(ValueError, match=name):
            resolve("sometimes", "cpu")


def test_learner_and_cli_train_in_k_step_dispatches():
    """steps_per_dispatch=4 on the CPU: the learner takes 4 steps a call,
    a (4,) loss tensor per dispatch, and reports every step's loss once
    flushed; the synchronous trainer (tools.sync_train, where the loop
    moved from cli.train) stops at the first multiple of 4 at or past
    --max-steps and reports every step's loss (the JAX package's
    test_multi_step_dispatch_end_to_end)."""
    cfg = parse_overrides(Config(), TINY_ARGS
                          + ["--runtime.steps_per_dispatch=4"])
    net = NetworkApply(6, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    learner = Learner(cfg, net)
    assert learner.steps_per_dispatch == 4
    spec = learner.spec
    for block in synthetic_blocks(spec, 6, seed=1):
        block.last_action_row = block.last_action_row % 6
        block.action = block.action % 6
        learner.ingest(block)
    m = learner.step()
    assert learner.training_steps == 4 and m["loss"].shape == (4,)
    learner.step(torch.rand((4, spec.batch_size)))
    assert learner.training_steps == 8
    losses = learner.losses
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert losses[:4] == m["loss"].tolist()

    summary = sync_train.main(TINY_ARGS + ["--device=cpu", "--max-steps=6",
                                           "--runtime.steps_per_dispatch=4"])
    assert summary["steps"] == 8 and len(summary["losses"]) == 8
    assert np.all(np.isfinite(summary["losses"]))


@pytest.fixture(scope="module")
def dual_setup():
    """A tiny JAX network with two distinct parameter sets and the same
    parameters in the port."""
    jspec, spec = specs()
    jnet = JNetworkApply(A, JNetworkConfig(use_double=True, **TINY),
                         spec.frame_stack, spec.frame_height,
                         spec.frame_width)
    params_a = jnet.init(jax.random.PRNGKey(1))
    params_b = jnet.init(jax.random.PRNGKey(9))
    net = NetworkApply(A, NetworkConfig(use_double=True, **TINY),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       "cpu")
    online, target = net.build(), net.build()
    online.load_state_dict(_flat(params_a))
    target.load_state_dict(_flat(params_b))
    return jspec, spec, jnet, params_a, params_b, net, online, target


def test_dual_sequence_q_matches_jax(dual_setup):
    """The port's dual_sequence_q against the JAX package's on the same
    inputs and weights (atol 1e-5, f32; the port's from the 2x2
    space-to-depth layout the learner's decode emits, the JAX package's
    from the standard one), and equal bit for bit to the two networks' own
    unrolls (the JAX test's identity)."""
    _, spec, jnet, params_a, params_b, net, online, target = dual_setup
    assert net.input_layout == SPACE_TO_DEPTH
    rng = np.random.default_rng(3)
    b, t, h, w, k = 3, 7, spec.frame_height, spec.frame_width, \
        spec.frame_stack
    obs = rng.uniform(size=(b, t, h, w, k)).astype(np.float32)
    la = np.eye(A, dtype=np.float32)[rng.integers(0, A, (b, t))]
    hid_a = rng.normal(size=(b, 2, spec.hidden_dim)).astype(np.float32)
    hid_b = rng.normal(size=(b, 2, spec.hidden_dim)).astype(np.float32)
    want_a, want_b = j_dual(jnet, params_a, params_b, jnp.asarray(obs),
                            jnp.asarray(la), jnp.asarray(hid_a),
                            jnp.asarray(hid_b))
    x = space_to_depth_2x2(torch.from_numpy(obs).flatten(0, 1)).unflatten(
        0, (b, t))
    args = (torch.from_numpy(la), torch.from_numpy(hid_a),
            torch.from_numpy(hid_b))
    q_a, q_b = dual_sequence_q(net, online, target, x, *args)
    np.testing.assert_allclose(q_a.detach().numpy(), np.asarray(want_a),
                               atol=1e-5)
    np.testing.assert_allclose(q_b.numpy(), np.asarray(want_b), atol=1e-5)
    assert q_a.requires_grad and not q_b.requires_grad
    own_a, _ = online(x, args[0], args[1], SPACE_TO_DEPTH)
    own_b, _ = target(x, args[0], args[2], SPACE_TO_DEPTH)
    assert torch.equal(q_a, own_a) and torch.equal(q_b, own_b)


def _batches(jspec, spec):
    """One JAX sample and the same batch as the port's SampleBatch."""
    jstate = jax_filled(jspec, synthetic_blocks(spec, 8, seed=2))
    jbatch = jdr.replay_sample(jspec, jstate, jax.random.PRNGKey(5))
    batch = SampleBatch(**{
        f.name: torch.from_numpy(np.asarray(getattr(jbatch, f.name)).copy())
        for f in dataclasses.fields(SampleBatch)})
    return jbatch, batch


@pytest.mark.parametrize("fused", ["off", "on"])
def test_dual_unroll_loss_matches_jax(dual_setup, fused):
    """The double-DQN loss with optim.fused_double_unroll off and on
    against the JAX package's loss with the same setting, on one batch with
    distinct online and target weights: loss rtol 1e-5, priorities rtol
    1e-5 atol 1e-6. In the port "on" gives the same loss, priorities and
    gradients as "off", bit for bit (the JAX test_train_step.py identity)."""
    jspec, spec, jnet, params_a, params_b, net, online, target = dual_setup
    jbatch, batch = _batches(jspec, spec)
    joptim = JOptimConfig(pallas_obs_decode="off", fused_double_unroll=fused,
                          **OPTIM)
    jloss, jaux = j_loss_fn(jnet, jspec, joptim, True)(params_a, params_b,
                                                        jbatch)
    results = {}
    for setting in ("off", "on"):
        online.zero_grad(set_to_none=True)
        loss_fn = make_loss_fn(net, spec, OptimConfig(
            fused_double_unroll=setting, **OPTIM), True)
        loss, aux = loss_fn(online, target, batch)
        loss.backward()
        results[setting] = (loss.detach(), aux["priorities"],
                            [p.grad.clone() for p in online.parameters()])
    loss, prios, _ = results[fused]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(prios.numpy(), np.asarray(jaux["priorities"]),
                               rtol=1e-5, atol=1e-6)
    (l_off, p_off, g_off), (l_on, p_on, g_on) = results["off"], results["on"]
    assert torch.equal(l_off, l_on) and torch.equal(p_off, p_on)
    assert all(torch.equal(a, b) for a, b in zip(g_off, g_on))


def test_graph_refuses_moved_state():
    """The CUDA graph wrapper records the address of every tensor of both
    states (params, grads, target, Adam's state, the step counter, the
    replay's rings and tree) and raises, naming it, if one has moved
    before a replay."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    start = to_numpy_state(jax_filled(jspec,
                                      synthetic_blocks(spec, 10, seed=5)))
    net, optim, ts, rs = _port_state(spec, start, _flat(j_create(
        jax.random.PRNGKey(0), JNetworkApply(A, JNetworkConfig(**TINY),
                                             spec.frame_stack,
                                             spec.frame_height,
                                             spec.frame_width),
        JOptimConfig(**OPTIM)).params), use_double=True)
    make_learner_step(net, spec, optim, True)(ts, rs)   # grads, Adam state
    names = {name for name, _ in _state_tensors(ts, rs)}
    assert {"step_count", "replay.tree", "replay.obs",
            "params.lstm.recurrent_kernel",
            "params.lstm.recurrent_kernel.grad",
            "target_params.head.adv_out.bias",
            "opt.state[0].exp_avg"} <= names
    graph = GraphedSteps(body=None, steps=K, batch_size=spec.batch_size)
    graph.addresses = {n: t.data_ptr() for n, t in _state_tensors(ts, rs)}
    graph._check_addresses(ts, rs)
    rs.tree = rs.tree.clone()
    with pytest.raises(RuntimeError, match="replay.tree"):
        graph._check_addresses(ts, rs)


def test_bench_choices_follow_its_pairs():
    """tools/bench.py's choices for "auto" on CUDA: the fewest steps a
    dispatch within 1% of the best mean speed-up over K=1, the fused scan
    iff it beats the loop (single DQN) at that K; the config holds the
    fused scan the committed bench run chose, K=4 (which that run ties
    with K=1: config.py's CUDA_AUTO says why it stays) and
    fused_double_unroll off. The host path (K = 1 only) takes no part,
    however fast."""
    from r2d2_tpu_torch.tools import bench
    assert set(bench.PATHS) == {"default", "double", "fused_double",
                                "fused", "host"}
    assert bench.path_ks("host") == (1,)
    assert bench.path_ks("fused") == bench.KS
    base = {"default": 100.0, "double": 80.0, "fused_double": 120.0,
            "fused": 160.0}
    scale = {1: 1.0, 4: 3.0, 16: 3.02}

    def cells():
        out = {(p, k): {"median_seq_updates_per_s": r * scale[k]}
               for p, r in base.items() for k in bench.KS}
        out["host", 1] = {"median_seq_updates_per_s": 1e6}
        return out

    auto = bench.choose_autos(cells())
    assert auto["runtime.steps_per_dispatch"]["value"] == 4
    assert auto["network.pallas_lstm"] == {
        "value": True, "fused": 160.0 * 3, "default": 100.0 * 3}
    assert set(auto) == {"runtime.steps_per_dispatch",
                         "network.pallas_lstm"}
    scale[16] = 3.1                       # 16 past the 1% margin
    base["fused"] = 90.0                  # the loop wins
    auto = bench.choose_autos(cells())
    assert auto["runtime.steps_per_dispatch"]["value"] == 16
    assert auto["network.pallas_lstm"]["value"] is False
    assert CUDA_AUTO == {"network.pallas_lstm": True,
                         "optim.fused_double_unroll": False,
                         "runtime.steps_per_dispatch": 4,
                         "replay.ingest_batch_blocks": 1}


def test_device_union_counts_overlap_once():
    """The bench's device time with overlapping events counted once: the
    union of [0, 4), [2, 5), [5, 6), [8, 9) us is 7 us, their sum 9."""
    from types import SimpleNamespace
    from r2d2_tpu_torch.tools import bench

    def event(start, end):
        return SimpleNamespace(
            device_type=torch.autograd.DeviceType.CUDA,
            is_user_annotation=False,
            time_range=SimpleNamespace(start=start, end=end,
                                       elapsed_us=lambda: end - start))

    prof = SimpleNamespace(events=lambda: [event(8, 9), event(2, 5),
                                           event(0, 4), event(5, 6)])
    assert bench.device_busy_ms(prof) == pytest.approx(9e-3)
    assert bench.device_union_ms(prof) == pytest.approx(7e-3)
