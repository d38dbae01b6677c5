"""Data parallelism on one host: one process and one GPU a rank in a
``torch.distributed`` process group (``mesh.py``), the dp-sharded learner
step, replay and on-device acting (``sharded.py``), with the JAX package's
``r2d2_tpu/parallel`` names."""

from r2d2_tpu_torch.parallel.mesh import Mesh, make_mesh
from r2d2_tpu_torch.parallel.sharded import (init_sharded_act_carry,
                                             make_sharded_anakin_act,
                                             make_sharded_learner_step,
                                             make_sharded_replay_add,
                                             make_sharded_replay_add_many,
                                             sharded_buffer_steps,
                                             sharded_replay_init)

__all__ = ["Mesh", "make_mesh", "init_sharded_act_carry",
           "make_sharded_anakin_act", "make_sharded_learner_step",
           "make_sharded_replay_add", "make_sharded_replay_add_many",
           "sharded_buffer_steps", "sharded_replay_init"]
