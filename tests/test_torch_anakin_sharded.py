"""The port's data-parallel on-device acting against the JAX package's
``make_sharded_anakin_act`` (tests/test_anakin_sharded.py's counterpart):
each rank's segment plus its ring write equals JAX's shard at dp=2 with
JAX's draws injected; the global epsilon ladder's layout; the config's
lane/shard rules; and ``cli.train --mesh.dp=2 --actor.on_device=true`` on
two CPU ranks, which emits the per-shard ``anakin`` block."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.envs.factory import create_jax_env
from r2d2_tpu.parallel import (init_sharded_act_carry as j_init_carry,
                               make_mesh as j_make_mesh,
                               make_sharded_anakin_act as j_sharded_act,
                               sharded_replay_init as j_sharded_init)
from r2d2_tpu.replay.structs import ReplaySpec as JReplaySpec
from r2d2_tpu_torch.config import Config, apex_epsilon
from r2d2_tpu_torch.envs.factory import create_device_env
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.parallel.sharded import (init_sharded_act_carry,
                                             make_sharded_anakin_act,
                                             sharded_replay_init)
from r2d2_tpu_torch.replay import device_replay as tdr
from r2d2_tpu_torch.replay.structs import ReplaySpec
from r2d2_tpu_torch.tools.dp_check import REPLAY_FIELDS
from tests.test_torch_anakin import (_jax_net, _jax_reset_draws,
                                     _jax_segment_draws, _module_from,
                                     _port_net, jax_cfg, small_cfg)

pytestmark = pytest.mark.torch_port

DP = 2
LANES = 4                   # two a shard
SHARDED = {"actor.anakin_lanes": LANES, "mesh.dp": DP}
INT_STATE = ("obs", "last_action", "action", "burn_in_steps",
             "learning_steps", "forward_steps", "seq_start",
             "weight_version", "lane")


def _rank_mesh(rank: int) -> Mesh:
    """Rank ``rank``'s view of a dp=2 world: the acting path issues no
    collective, so no process group is needed to drive one rank."""
    return Mesh(dp=DP, rank=rank, device=torch.device("cpu"),
                backend="gloo")


@pytest.mark.parametrize("priority", [1.0, "td"])
def test_sharded_segment_matches_jax_with_injected_draws(priority):
    """Three segments (an episode of two segments ends inside) of JAX's
    one sharded dispatch against each port rank's segment + ring write
    into its own shard, with the draws of that shard's key chain
    (fold_in(key, s)) injected: every replay field of every shard (ints
    and frames exact, hidden atol 1e-5, reward atol 2e-5, gamma atol
    2e-6, the tree rtol 1e-5) and the per-shard stats (episodes, reports,
    return sums, env steps)."""
    over = {**SHARDED, "actor.anakin_priority": priority}
    cfg, jcfg = small_cfg(**over), jax_cfg(**over)
    jenv = create_jax_env(jcfg.env)
    env = create_device_env(cfg.env, "cpu")
    spec = ReplaySpec.from_config(cfg, "cpu")
    jspec = JReplaySpec.from_config(jcfg)
    jnet, net = _jax_net(jcfg, env.action_dim), _port_net(cfg,
                                                          env.action_dim)
    jparams = jnet.init(jax.random.PRNGKey(0))
    module = _module_from(net, jparams)
    eps = [apex_epsilon(i, LANES, cfg.actor.base_eps, cfg.actor.eps_alpha)
           for i in range(LANES)]
    kw = dict(num_lanes=LANES, epsilons=eps, gamma=cfg.optim.gamma,
              priority=priority, near_greedy_eps=cfg.actor.near_greedy_eps)
    jmesh = j_make_mesh(jcfg.mesh)
    jact = j_sharded_act(jenv, jnet, jspec, mesh=jmesh, **kw)
    key = jax.random.PRNGKey(1)
    jcarry = j_init_carry(jenv, jspec, LANES, jmesh, key)
    jreplay = j_sharded_init(jspec, jmesh)

    lps = LANES // DP
    ranks = []
    for s in range(DP):
        mesh = _rank_mesh(s)
        k_env, _ = jax.random.split(jax.random.fold_in(key, s))
        ranks.append(dict(
            act=make_sharded_anakin_act(env, net, spec, mesh=mesh,
                                        quant_probe_on=False, **kw),
            carry=init_sharded_act_carry(
                env, spec, LANES, mesh, reset_draws=_jax_reset_draws(
                    jenv, jax.random.split(k_env, lps))),
            replay=sharded_replay_init(spec, mesh)))
    for seg in range(3):
        wv = seg + 1
        draws = [_jax_segment_draws(jenv, jcarry.key[s], lps,
                                    spec.block_length, env.action_dim)[0]
                 for s in range(DP)]
        jcarry, jreplay, jstats = jact(jparams, jcarry, jreplay,
                                       np.int32(wv))
        jstats = jax.device_get(jstats)
        for s, r in enumerate(ranks):
            r["carry"], blocks, stats = r["act"](
                module, r["carry"], torch.tensor(wv, dtype=torch.int32),
                draws=draws[s])
            tdr.replay_add_many(spec, r["replay"], blocks)
            for name in ("episodes", "reported_episodes"):
                assert int(stats[name]) == int(jstats[name][s]), name
            np.testing.assert_allclose(float(stats["reported_return_sum"]),
                                       float(jstats["reported_return_sum"]
                                             [s]), rtol=1e-6)
            assert int(blocks.learning_steps.sum()) == \
                int(jstats["env_steps"][s])
    for s, r in enumerate(ranks):
        assert r["replay"].block_ptr == int(np.asarray(jreplay.block_ptr)[s])
        for name in REPLAY_FIELDS:
            got = getattr(r["replay"], name).numpy()
            want = np.asarray(getattr(jreplay, name))[s]
            if name in INT_STATE:
                np.testing.assert_array_equal(got, want, err_msg=name)
            elif name == "hidden":
                np.testing.assert_allclose(got, want, atol=1e-5)
            elif name == "reward":
                np.testing.assert_allclose(got, want, atol=2e-5)
            elif name == "gamma":
                np.testing.assert_allclose(got, want, atol=2e-6)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                           err_msg=name)


def test_epsilon_ladder_spans_global_lanes():
    """Each rank acts its contiguous slice of the global ladder and stamps
    global lane indices; with 4 lanes over 2 shards both near-greedy
    (reporting) lanes are rank 1's, as in JAX's layout."""
    cfg = small_cfg(**SHARDED)
    env = create_device_env(cfg.env, "cpu")
    net = _port_net(cfg, env.action_dim)
    spec = ReplaySpec.from_config(cfg, "cpu")
    eps = [apex_epsilon(i, LANES, cfg.actor.base_eps, cfg.actor.eps_alpha)
           for i in range(LANES)]
    acts = [make_sharded_anakin_act(
        env, net, spec, mesh=_rank_mesh(s), num_lanes=LANES, epsilons=eps,
        gamma=0.997, priority=1.0, near_greedy_eps=cfg.actor.near_greedy_eps)
        for s in range(DP)]
    assert torch.cat([a.eps for a in acts]).tolist() == \
        torch.tensor(eps).tolist()
    assert torch.cat([a.lanes for a in acts]).tolist() == list(range(LANES))
    assert [a.report.tolist() for a in acts] == [[False, False],
                                                 [True, True]]
    with pytest.raises(ValueError, match="one epsilon per GLOBAL lane"):
        make_sharded_anakin_act(env, net, spec, mesh=_rank_mesh(0),
                                num_lanes=LANES, epsilons=eps[:3],
                                gamma=0.997, priority=1.0,
                                near_greedy_eps=0.02)
    with pytest.raises(ValueError, match="divide evenly"):
        make_sharded_anakin_act(env, net, spec, mesh=_rank_mesh(0),
                                num_lanes=3, epsilons=eps[:3], gamma=0.997,
                                priority=1.0, near_greedy_eps=0.02)


def test_config_validates_lane_shard_rules():
    """JAX's rules, in both packages: lanes % dp == 0, each shard's lane
    group <= num_blocks (80 lanes / dp 2 = 40 = num_blocks passes, 82
    does not), and model parallelism with on-device acting refused; the
    knobs round-trip."""
    for make in (small_cfg, jax_cfg):
        with pytest.raises(ValueError, match="divisible by mesh.dp"):
            make(**{**SHARDED, "actor.anakin_lanes": 5})
        ok = make(**{**SHARDED, "actor.anakin_lanes": 80})
        assert ok.actor.anakin_lanes // ok.mesh.dp == ok.num_blocks
        with pytest.raises(ValueError, match="num_blocks"):
            make(**{**SHARDED, "actor.anakin_lanes": 82})
        with pytest.raises(ValueError, match="on_device composes with "
                                             "data-parallel meshes only"):
            make(**{"mesh.mp": 2, "mesh.dp": 1})
    cfg = small_cfg(**SHARDED)
    again = Config.from_dict(json.loads(cfg.to_json()))
    assert again.mesh.dp == DP and again.actor.anakin_lanes == LANES


def test_cli_train_dp2_on_device_emits_the_shard_block(tmp_path):
    """python -m r2d2_tpu_torch.cli.train --mesh.dp=2 --actor.on_device
    on two CPU ranks: the record's anakin block has dp 2, two lanes a
    shard, equal env steps a shard (imbalance 1.0) and per-shard lists;
    both ranks stop at the same step with the same train state, each
    shard holding its own lanes' blocks; no rank outlives the command."""
    from tests.test_torch_train import TINY_ARGS
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.cli.train", *TINY_ARGS,
         "--device=cpu", "--max-steps=6", "--mesh.dp=2",
         "--actor.on_device=true", f"--actor.anakin_lanes={LANES}",
         "--env.episode_len=40", "--runtime.log_interval=0",
         f"--runtime.save_dir={tmp_path}"],
        capture_output=True, text=True, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    shards = summary["shards"]
    assert {s["steps"] for s in shards} == {summary["steps"]} == {6}
    assert len({s["state_sha256"] for s in shards}) == 1
    assert shards[0]["shard_blocks"] == shards[1]["shard_blocks"] > 0
    records = [json.loads(line) for line in
               open(os.path.join(tmp_path, "metrics_player0.jsonl"))]
    blocks = [r["anakin"] for r in records if r.get("anakin")]
    assert blocks, "no anakin block in the records"
    for an in blocks:
        assert an["dp"] == 2 and an["lanes_per_shard"] == 2
        assert len(an["shard_env_steps"]) == len(an["shard_episodes"]) == 2
        assert an["shard_env_steps"][0] == an["shard_env_steps"][1] > 0
        assert an["shard_imbalance"] == 1.0
