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
