"""Parallelism on one host and across hosts: one process and one GPU a rank
in a ``torch.distributed`` process group laid out as a dp x mp grid
(``mesh.py``); the dp-sharded learner step, replay and on-device acting
(``sharded.py``); tensor parallelism over mp (``tensor_parallel.py``); the
pipelined sequence-parallel LSTM (``sequence_parallel.py``), with the JAX
package's ``r2d2_tpu/parallel`` names."""

from r2d2_tpu_torch.parallel.mesh import Mesh, make_mesh
from r2d2_tpu_torch.parallel.sharded import (init_sharded_act_carry,
                                             make_sharded_anakin_act,
                                             make_sharded_learner_step,
                                             make_sharded_replay_add,
                                             make_sharded_replay_add_many,
                                             sharded_buffer_steps,
                                             sharded_replay_init)
from r2d2_tpu_torch.parallel.tensor_parallel import (
    make_tp_external_batch_step, state_shardings)

__all__ = ["Mesh", "make_mesh", "init_sharded_act_carry",
           "make_sharded_anakin_act", "make_sharded_learner_step",
           "make_sharded_replay_add", "make_sharded_replay_add_many",
           "sharded_buffer_steps", "sharded_replay_init",
           "make_tp_external_batch_step", "state_shardings", "make_sp_lstm"]


def __getattr__(name):
    # lazy, as in the JAX package: the sequence-parallel unroll is a
    # capability no trainer path imports
    if name == "make_sp_lstm":
        from r2d2_tpu_torch.parallel.sequence_parallel import make_sp_lstm
        return make_sp_lstm
    raise AttributeError(name)
