"""System-level learnability of the port, the twin of the JAX package's
tests/test_learnability.py: its configuration, budget and thresholds
through the deterministic synchronous loop (tools/sync_train.py). The Fake
env shows the target action in every frame, so the oracle return is
episode_len = 120 and a uniform-random policy expects episode_len /
action_dim = 20; the greedy policy must land every evaluation seed at 2x
random and the mean at 3x.

    python -m r2d2_tpu_torch.tools.learnability SAVE_DIR [--device=cpu]

prints ``{"training_steps": N, "returns": [...]}`` and exits nonzero if a
threshold is missed. ``tests/test_torch_learnability.py`` runs it on the
CPU, ``chip_smoke.py`` with the learner on the card.

The gridworld under the fused on-device loop (``grid_config``,
``grid_train``, ``check_grid_returns``) is the twin of the JAX package's
tests/test_anakin.py learnability: the Grid env needs navigation, and the
near-greedy lanes' return must grow several-fold from the episodes before
training to those of the last quarter of it (tests/test_torch_anakin.py
on the CPU, ``chip_smoke.py`` on the card).
"""

import json
import sys

RANDOM_EXPECTATION = 120 / 6      # episode_len / action_dim
ORACLE = 120.0
TRAIN_STEPS = 4000
COLLECT_EPS = 0.4
EVAL_SEEDS = (123, 456, 789)


def learn_config(save_dir: str, **overrides):
    from r2d2_tpu_torch.config import Config
    return Config().replace(**{
        "env.game_name": "Fake",
        "env.frame_height": 32, "env.frame_width": 32, "env.frame_stack": 2,
        "network.hidden_dim": 32, "network.cnn_out_dim": 32,
        "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
        "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
        "sequence.forward_steps": 3,
        "replay.capacity": 4000, "replay.block_length": 20,
        "replay.batch_size": 16, "replay.learning_starts": 500,
        "replay.max_env_steps_per_train_step": 2.0,
        "actor.num_actors": 2, "actor.actor_update_interval": 50,
        "optim.lr": 1e-3, "optim.gamma": 0.99,
        "runtime.save_dir": save_dir, "runtime.save_interval": 0,
        "runtime.weight_publish_interval": 5,
        "runtime.log_interval": 30.0, **overrides,
    })


def train_and_eval(cfg, device=None) -> dict:
    """sync_train ``cfg`` for TRAIN_STEPS, then one greedy episode per
    evaluation seed."""
    from r2d2_tpu_torch.tools.sync_train import greedy_return, sync_train
    net, learner = sync_train(cfg, TRAIN_STEPS, COLLECT_EPS, seed=0,
                              device=device)
    returns = [greedy_return(net, learner.train_state.params, cfg.env, seed)
               for seed in EVAL_SEEDS]
    return {"training_steps": int(learner.training_steps),
            "returns": returns}


def check_returns(returns) -> None:
    """The JAX test's thresholds: every seed >= 2x random, mean >= 3x."""
    mean = sum(returns) / len(returns)
    if min(returns) < 2.0 * RANDOM_EXPECTATION:
        raise AssertionError(f"a seed below 2x random: {returns}")
    if not 3.0 * RANDOM_EXPECTATION <= mean <= ORACLE:
        raise AssertionError(f"mean outside [3x random, oracle]: {returns}")


GRID_TRAIN_STEPS = 2000


def grid_config(save_dir: str, **overrides):
    """tests/test_anakin.py's gridworld configuration of the fused loop,
    logged at every loop turn (``runtime.log_interval`` 0; the JAX test's
    8 s), so that the records split the run by learner steps on any
    device (check_grid_returns)."""
    from r2d2_tpu_torch.config import Config
    return Config().replace(**{
        "env.game_name": "Grid", "env.grid_size": 5,
        "env.frame_height": 20, "env.frame_width": 20,
        "env.frame_stack": 2, "env.episode_len": 40,
        "network.hidden_dim": 32, "network.cnn_out_dim": 64,
        "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
        "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
        "sequence.forward_steps": 3,
        "replay.capacity": 32_000, "replay.block_length": 40,
        "replay.batch_size": 16, "replay.learning_starts": 2_000,
        "replay.max_env_steps_per_train_step": 16.0,
        "actor.on_device": True, "actor.anakin_lanes": 32,
        "optim.lr": 1e-3, "optim.gamma": 0.99,
        "runtime.save_interval": 0, "runtime.log_interval": 0.0,
        "runtime.save_dir": save_dir, **overrides,
    })


def grid_train(cfg, device=None) -> dict:
    """The fused loop on ``cfg`` for GRID_TRAIN_STEPS learner steps; per
    record that acted, (learner steps, env steps, near-greedy episodes,
    their return sum), from the record's anakin block."""
    from r2d2_tpu_torch.runtime.anakin_loop import run_anakin_train
    records = []
    stack = run_anakin_train(cfg, max_training_steps=GRID_TRAIN_STEPS,
                             max_seconds=600, device=device,
                             log_fn=records.append)
    return {"training_steps": int(stack.learner.training_steps),
            "intervals": [(r["training_steps"],
                           r["anakin"]["shard_env_steps"][0],
                           r["anakin"]["shard_reported_episodes"][0],
                           r["anakin"]["shard_return_sum"][0])
                          for r in records if "anakin" in r]}


def check_grid_returns(intervals, learning_starts: int) -> dict:
    """The JAX test's threshold, late >= max(3x early, early + 0.3), on
    the near-greedy lanes' mean episode return: early over the segments
    acted before the replay held ``learning_starts`` steps, so before any
    learner step (what the JAX test's first 8 s record holds on the CPU),
    late over those of the last quarter of GRID_TRAIN_STEPS.
    ``intervals``: (learner steps, env steps, episodes, return sum) per
    record. A segment (1,280 env steps) comes every 80 learner steps
    under the rate limiter, 17 of its 32 lanes reporting, so one record
    alone swings by a factor of ten."""
    def mean(rows):
        episodes = sum(r[2] for r in rows)
        if not episodes:
            raise AssertionError(f"no episodes to judge: {intervals}")
        return sum(r[3] for r in rows) / episodes

    acted, early_rows = 0, []
    for row in intervals:
        if acted < learning_starts:
            early_rows.append(row)
        acted += row[1]
    early = mean(early_rows)
    late = mean([r for r in intervals if r[0] >= 0.75 * GRID_TRAIN_STEPS])
    if late < max(3.0 * early, early + 0.3):
        raise AssertionError(f"the gridworld did not learn: early {early}, "
                             f"late {late}, records {intervals}")
    return {"early": early, "late": late}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    for arg in [a for a in argv if a.startswith("--device=")]:
        device = arg.partition("=")[2]
        argv.remove(arg)
    result = train_and_eval(learn_config(argv[0]), device)
    print(json.dumps(result), flush=True)
    if result["training_steps"] < TRAIN_STEPS:
        raise AssertionError(f"trained {result['training_steps']} steps")
    check_returns(result["returns"])
    return result


if __name__ == "__main__":
    main()
