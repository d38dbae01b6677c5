"""The port's quantized inference plane against the JAX package's on the
CPU: the per-channel int8 and bf16 twins (q exactly equal, scales bit for
bit after models/convert.py's transposes), the quantized forward at T=1
and T=5 (Q and h' within atol 1e-5), the accuracy probe (|dQ| within 1e-5,
agreement exactly equal), int8 policies acting like JAX's over 50 steps
with the same draws, the bundle through the weight service (exact), the
publish-time snapshot's stamp, QuantStats, and the config's settings and
refusals. ``int8_linear`` is tested in test_torch_quant_kernels.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.actor.policy import ActorPolicy as JActorPolicy
from r2d2_tpu.actor.policy import BatchedActorPolicy as JBatchedActorPolicy
from r2d2_tpu.actor.policy import make_forward_fn as j_make_forward_fn
from r2d2_tpu.config import Config as JConfig
from r2d2_tpu.envs.fake import FakeR2D2Env as JFakeEnv
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.models.network import make_inference_bundle as j_bundle
from r2d2_tpu.models.network import param_tree_bytes as j_param_tree_bytes
from r2d2_tpu.models.network import \
    quantized_inference_apply as j_quantized_apply
from r2d2_tpu.telemetry.quant import QuantStats as JQuantStats
from r2d2_tpu_torch.actor.policy import (ActorPolicy, BatchedActorPolicy,
                                         InferenceTwin, as_bundle,
                                         make_forward_fn)
from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.models.convert import (params_from_flax,
                                           quant_params_from_flax)
from r2d2_tpu_torch.models.network import (NetworkApply, bundle_from_flat,
                                           bundle_size, bundle_to_flat,
                                           dequantize_leaf,
                                           make_inference_bundle,
                                           param_tree_bytes,
                                           quant_compute_dtype,
                                           quantize_leaf_int8,
                                           quantize_params,
                                           quantized_inference_apply)
from r2d2_tpu_torch.runtime.weights import (InProcWeightStore,
                                            SnapshotPublisher,
                                            WeightPublisher,
                                            WeightSubscriber,
                                            make_publish_preparer,
                                            wrap_publish)
from r2d2_tpu_torch.telemetry.quant import QuantStats

pytestmark = pytest.mark.torch_port

A = 6
SMALL = {"env.game_name": "Fake", "env.frame_height": 24,
         "env.frame_width": 24, "env.frame_stack": 2,
         "network.hidden_dim": 16, "network.cnn_out_dim": 32,
         "network.conv_layers": ((8, 4, 2), (16, 3, 1))}
GAP = 1e-5


def nets(mode: str, seed: int = 0, **extra):
    """(JAX net, JAX params, port net, port state dict) with the same
    weights, at inference dtype ``mode``."""
    over = {**SMALL, "network.inference_dtype": mode, **extra}
    jnet = JNetworkApply(A, JConfig().replace(**over).network, 2, 24, 24)
    jparams = jnet.init(jax.random.PRNGKey(seed))
    net = NetworkApply(A, Config().replace(**over).network, 2, 24, 24, "cpu")
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    return jnet, jparams, net, sd


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def inputs(rng, n: int, t: int = 1):
    obs = rng.uniform(size=(n, t, 24, 24, 2)).astype(np.float32)
    la = np.eye(A, dtype=np.float32)[rng.integers(0, A, (n, t))]
    hidden = (rng.normal(size=(n, 2, 16)) * 0.5).astype(np.float32)
    return obs, la, hidden


@pytest.mark.parametrize("mode,s2d", [("int8", "off"), ("bf16", "off"),
                                      ("int8", "on")])
def test_twin_matches_jax(mode, s2d):
    """q exactly equal and scales bit for bit after convert's transposes
    (the space-to-depth first conv too), bf16 leaves equal; round half to
    even and clip as JAX; the bytes a forward streams equal JAX's."""
    jnet, jparams, net, sd = nets(mode, **{"network.space_to_depth": s2d})
    jb = np_tree(j_bundle(jnet, jparams, 3))
    ours = quantize_params(sd, mode)
    theirs = quant_params_from_flax(jb["quant"])
    assert ours.keys() == theirs.keys()
    for name, leaf in ours.items():
        other = theirs[name]
        if isinstance(leaf, dict):
            assert leaf["q"].dtype == torch.int8
            assert torch.equal(leaf["q"], other["q"]), name
            assert torch.equal(leaf["scale"], other["scale"]), name
        else:
            assert leaf.dtype == other.dtype and torch.equal(leaf, other), \
                name
    assert param_tree_bytes(ours) == j_param_tree_bytes(jb["quant"])
    assert param_tree_bytes(sd) == j_param_tree_bytes(jparams)


def test_int8_leaf_rounding_and_bounds():
    """Half-way values round to even, the extremes clip to +-127, an
    all-zero channel keeps the 1e-12 floor, and the round trip is within
    scale/2."""
    w = torch.tensor([[127.0, 0.5, 1.5, -2.5], [0.0, 0.0, 0.0, 0.0]])
    leaf = quantize_leaf_int8(w, axis=0)
    assert leaf["q"].tolist() == [[127, 0, 2, -2], [0, 0, 0, 0]]
    assert leaf["scale"][1, 0].item() == pytest.approx(1e-12)
    x = torch.randn(32, 40, generator=torch.Generator().manual_seed(0))
    lx = quantize_leaf_int8(x, axis=0)
    err = (dequantize_leaf(lx, torch.float32) - x).abs()
    assert bool((err <= lx["scale"] / 2 + 1e-7).all())


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("t", [1, 5])
def test_quantized_inference_apply_matches_jax(rng, mode, t):
    """The quantized forward on the same twin and inputs: Q and the packed
    hidden within atol 1e-5 of JAX's, Q and h' in f32."""
    jnet, jparams, net, sd = nets(mode)
    jb = np_tree(j_bundle(jnet, jparams, 1))
    obs, la, hidden = inputs(rng, 3, t)
    jq, jh = j_quantized_apply(jnet, jb["quant"], jnp.asarray(obs),
                               jnp.asarray(la), jnp.asarray(hidden))
    assert quant_compute_dtype("cpu") == torch.float32
    q, h = quantized_inference_apply(
        net, quant_params_from_flax(jb["quant"]), torch.from_numpy(obs),
        torch.from_numpy(la), torch.from_numpy(hidden))
    assert q.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)


@pytest.mark.parametrize("live", [5, 3])
def test_probe_matches_jax(rng, live):
    """The forward's probe on a probe tick: max |dQ| over the live rows
    within 1e-5 of JAX's, the agreement fraction exactly JAX's, probed=1;
    off the interval (0, 0, 0) and the f32 twin does not run."""
    jnet, jparams, net, sd = nets("int8")
    jb = j_bundle(jnet, jparams, 1)
    obs, la, hidden = inputs(rng, 5)
    la_idx = rng.integers(-1, A, 5).astype(np.int32)
    jfwd = j_make_forward_fn(jnet, probe_interval=2)
    fwd = make_forward_fn(net, probe_interval=2)
    twin = InferenceTwin(net, make_inference_bundle(net, sd, 1), "cpu")
    ja, jq, jh, jprobe = jfwd(jb, obs[:, 0], la_idx, hidden, np.int32(0),
                              np.int32(live))
    ta, tq, th, probe = fwd(twin, obs[:, 0], la_idx, hidden, 0, live)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    assert abs(float(probe[0]) - float(jprobe[0])) <= 1e-5
    assert float(probe[1]) == float(jprobe[1])
    assert float(probe[2]) == float(jprobe[2]) == 1.0
    calls = []
    twin.f32.register_forward_hook(lambda *a: calls.append(1))
    _, _, _, off = fwd(twin, obs[:, 0], la_idx, hidden, 1, live)
    assert [float(x) for x in off] == [0.0, 0.0, 0.0] and not calls


def _assert_greedy_equal(got, want, q):
    top2 = np.sort(np.asarray(q), axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > GAP
    np.testing.assert_array_equal(np.asarray(got)[clear],
                                  np.asarray(want)[clear])


@pytest.mark.parametrize("batched", [False, True])
def test_int8_policies_act_like_jax(batched):
    """int8 policies over 50 steps of Fake envs with the same numpy draws:
    Q and hidden within 1e-5 of JAX's, the same actions where the greedy
    choice is clear; the probe fires on the same ticks with the same
    agreement; the envs step on JAX's actions."""
    jnet, jparams, net, sd = nets("int8")
    jstats, stats = JQuantStats("int8", 4), QuantStats("int8", 4)
    lanes = 3 if batched else 1
    if batched:
        eps, seeds = [0.3, 0.05, 0.6], [1, 2, 3]
        jpol = JBatchedActorPolicy(jnet, jparams, eps, seeds,
                                   quant_stats=jstats, quant_probe_interval=4)
        pol = BatchedActorPolicy(net, sd, eps, seeds, quant_stats=stats,
                                 quant_probe_interval=4)
        for p in (jpol, pol):
            for i in range(lanes):
                p.observe_reset_lane(i, JFakeEnv(height=24, width=24,
                                                 seed=5 + i).reset())
    else:
        jpol = JActorPolicy(jnet, jparams, 0.3, seed=4, quant_stats=jstats,
                            quant_probe_interval=4)
        pol = ActorPolicy(net, sd, 0.3, seed=4, quant_stats=stats,
                          quant_probe_interval=4)
        for p in (jpol, pol):
            p.observe_reset(JFakeEnv(height=24, width=24, seed=5).reset())
    envs = [JFakeEnv(height=24, width=24, seed=5 + i) for i in range(lanes)]
    for env in envs:
        env.reset()
    for _ in range(50):
        ja, jq, jh = jpol.act()
        ta, tq, th = pol.act()
        np.testing.assert_allclose(tq, np.asarray(jq), atol=1e-5)
        np.testing.assert_allclose(th, np.asarray(jh), atol=1e-5)
        _assert_greedy_equal(np.atleast_1d(ta), np.atleast_1d(ja),
                             np.atleast_2d(jq))
        if batched:
            obs = np.stack([e.step(int(a))[0] for e, a in zip(envs, ja)])
        else:
            obs = envs[0].step(int(ja))[0]
        for p in (jpol, pol):
            p.observe(obs, ja)
    np.testing.assert_allclose(pol.bootstrap_q(), np.asarray(
        jpol.bootstrap_q()), atol=1e-5)
    ours, theirs = stats.interval_block(), jstats.interval_block()
    assert ours["probes"] == theirs["probes"] > 0
    assert ours["lanes_probed"] == theirs["lanes_probed"]
    assert ours["agree_frac"] == theirs["agree_frac"]
    assert abs(ours["dq_max"] - theirs["dq_max"]) <= 1e-5


def test_bundle_flat_payload_is_exact():
    """The bundle as the flat f32 payload and back: int8 values and bf16
    values exact in f32, the stamp kept; the JAX bundle's twin crosses
    equally; a payload of the wrong length is refused."""
    jnet, jparams, net, sd = nets("int8")
    bundle = make_inference_bundle(net, sd, 7)
    flat = bundle_to_flat(net, bundle)
    assert flat.dtype == torch.float32 and flat.numel() == bundle_size(net)
    back = bundle_from_flat(net, flat)
    assert back["stamp"] == 7
    for name, leaf in bundle["quant"].items():
        got = back["quant"][name]
        if isinstance(leaf, dict):
            assert torch.equal(leaf["q"], got["q"])
            assert torch.equal(leaf["scale"].reshape(-1),
                               got["scale"].reshape(-1))
        else:
            assert torch.equal(leaf, got)
    for name, t in sd.items():
        assert torch.equal(t, back["f32"][name])
    jq = quant_params_from_flax(np_tree(j_bundle(jnet, jparams, 7))["quant"])
    theirs = bundle_to_flat(net, {"f32": sd, "quant": jq, "stamp": 7})
    assert torch.equal(flat, theirs)
    _, _, bnet, bsd = nets("bf16")
    b16 = bundle_from_flat(bnet, bundle_to_flat(
        bnet, make_inference_bundle(bnet, bsd, 2)))
    assert all(v.dtype == torch.bfloat16 for v in b16["quant"].values())
    with pytest.raises(ValueError, match="payload"):
        bundle_from_flat(net, flat[:-1])


@pytest.mark.parametrize("service", ["inproc", "shm"])
def test_bundle_through_the_weight_service(service):
    """The preparer's payload through InProcWeightStore and the shm
    WeightPublisher: read back bit for bit, the stamp publish_count + 1
    through wrap_publish; a policy adopts it and reports the stamp."""
    _, _, net, sd = nets("int8")
    prepare = make_publish_preparer(net)
    assert make_publish_preparer(nets("f32")[2]) is None
    first = prepare(sd, 1)
    if service == "inproc":
        store = InProcWeightStore(first)
        read = lambda: store.poll(0)                       # noqa: E731
        count = lambda: store.publish_count                # noqa: E731
        publish, closers = store.publish, []
    else:
        pub = WeightPublisher(first)
        sub = WeightSubscriber(pub.name, bundle_size(net))
        read, count, publish = sub.poll, (lambda: pub.publish_count), \
            pub.publish
        closers = [sub.close, pub.close]
    try:
        got = read()
        assert np.array_equal(got, first.numpy())
        stats = QuantStats("int8")
        pol = ActorPolicy(net, got, 0.0, quant_stats=stats)
        moved = {n: t + 0.25 for n, t in sd.items()}
        wrap_publish(publish, prepare, count)(moved)
        got = read()
        want = prepare(moved, 2).numpy()
        assert np.array_equal(got, want)
        decoded = bundle_from_flat(net, got)
        assert decoded["stamp"] == 2
        pol.update_params(got)
        assert stats.publish_stamp == 2 and pol.twin.stamp == 2
    finally:
        for close in closers:
            close()


def test_snapshot_publisher_quantizes_the_snapshot():
    """The learner's publish hook at int8: each publication is the bundle
    of the module's weights at the snapshot, stamped publish_count + 1."""
    _, _, net, sd = nets("int8")
    module = net.build()
    module.load_state_dict(sd)
    store = InProcWeightStore(make_publish_preparer(net)(module, 1))
    snap = SnapshotPublisher(store.publish, module, net=net,
                             publish_count=lambda: store.publish_count)
    try:
        for k in range(2):
            with torch.no_grad():
                module.torso.dense.weight.mul_(1.5)
            snap(module)
            snap.flush()
            got = store.poll(0)
            want = make_publish_preparer(net)(module, 2 + k).numpy()
            assert np.array_equal(got, want)
    finally:
        snap.close()
    assert snap.publishes == 2


def test_as_bundle_accepts_every_form():
    """A module, plain weights, the flat f32 weights and the flat payload
    all become the same bundle (stamp 0 where built here)."""
    _, _, net, sd = nets("int8")
    module = net.build()
    module.load_state_dict(sd)
    flat_w = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    payload = bundle_to_flat(net, make_inference_bundle(net, sd, 5))
    forms = [as_bundle(net, x) for x in (module, sd, flat_w, payload)]
    assert [b["stamp"] for b in forms] == [0, 0, 0, 5]
    for b in forms[1:]:
        for name, leaf in forms[0]["quant"].items():
            other = b["quant"][name]
            if isinstance(leaf, dict):
                assert torch.equal(leaf["q"], other["q"])
            else:
                assert torch.equal(leaf, other)


def test_quant_stats_matches_jax():
    """The same probe and stamp events give JAX's block, and the interval
    is consumed."""
    ours, theirs = QuantStats("int8", 8), JQuantStats("int8", 8)
    for stats in (ours, theirs):
        stats.on_probe(0.01, 1.0, lanes=4)
        stats.on_probe(0.03, 0.75, lanes=1)
        stats.on_stamp(5)
        stats.on_stamp(3)
    assert ours.interval_block() == theirs.interval_block()
    assert ours.interval_block() == theirs.interval_block()


def test_config_inference_settings():
    """inference_dtype, actor.inference, the serve section and
    telemetry.quant_probe_interval parse and round-trip; a config written
    before them loads with JAX's defaults; bad values and what the port
    does not have are refused naming the item."""
    cfg = parse_overrides(Config(), [
        "--network.inference_dtype=int8", "--actor.inference=server",
        "--serve.max_batch=16", "--serve.transport=socket",
        "--telemetry.quant_probe_interval=8", "--serve.deadline_ms=2.5"])
    assert Config.from_json(cfg.to_json()) == cfg
    jdef = JConfig()
    d = Config().to_dict()
    for f in dataclasses.fields(Config().serve):
        assert getattr(Config().serve, f.name) == getattr(jdef.serve, f.name)
    assert Config().network.inference_dtype == jdef.network.inference_dtype
    assert Config().actor.inference == jdef.actor.inference
    assert (Config().telemetry.quant_probe_interval
            == jdef.telemetry.quant_probe_interval)
    for key in ("serve", "telemetry"):
        d.pop(key)
    d["network"].pop("inference_dtype")
    d["actor"].pop("inference")
    assert Config.from_dict(d) == Config()
    for bad, match in ((("network.inference_dtype", "fp8"), "inference_dtype"),
                       (("actor.inference", "remote"), "actor.inference"),
                       (("serve.servers", 2), "A.6"),
                       (("serve.max_servers", 4), "router"),
                       (("serve.state_slots", 10), "divisible"),
                       (("serve.transport", "udp"), "transport"),
                       (("telemetry.quant_probe_interval", -1), "probe")):
        with pytest.raises(ValueError, match=match):
            Config().replace(**{bad[0]: bad[1]})
    with pytest.raises(ValueError, match="state_slots"):
        Config().replace(**{"actor.inference": "server",
                            "actor.num_actors": 8,
                            "actor.envs_per_actor": 2,
                            "serve.state_slots": 8, "serve.state_shards": 4})
    with pytest.raises(ValueError, match="on_device"):
        Config().replace(**{"actor.inference": "server",
                            "actor.on_device": True,
                            "replay.block_length": 120,
                            "replay.capacity": 120_000})
