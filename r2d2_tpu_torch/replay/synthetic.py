"""Reference-shaped synthetic block: a full block of S sequences with a
carried burn-in prefix, random frames/actions/rewards, and the last
sequence's forward horizon cut to 1 as at an episode end."""

import numpy as np

from r2d2_tpu_torch.replay.structs import Block


def make_synthetic_block(spec, rng: np.random.Generator) -> Block:
    S, L = spec.seqs_per_block, spec.learning
    burn = np.minimum(np.arange(S) * L, spec.burn_in).astype(np.int32)
    return Block(
        obs_row=rng.integers(0, 255, (spec.obs_row_len, spec.frame_height,
                                      spec.frame_width)).astype(np.uint8),
        last_action_row=rng.integers(
            0, 18, (spec.la_row_len,)).astype(np.int32),
        hidden=rng.normal(size=(S, 2, spec.hidden_dim)).astype(np.float32),
        action=rng.integers(0, 18, (S, L)).astype(np.int32),
        reward=rng.normal(size=(S, L)).astype(np.float32),
        gamma=np.full((S, L), 0.997**spec.forward, np.float32),
        priority=rng.uniform(0.1, 2.0, (S,)).astype(np.float32),
        burn_in_steps=burn,
        learning_steps=np.full((S,), L, np.int32),
        forward_steps=np.concatenate(
            [np.full((S - 1,), spec.forward), [1]]).astype(np.int32),
        seq_start=(burn[0] + L * np.arange(S)).astype(np.int32),
        num_sequences=np.asarray(S, np.int32),
        sum_reward=np.asarray(np.nan, np.float32),
    )
