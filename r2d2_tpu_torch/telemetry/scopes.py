"""Component scopes, the port's counterpart of the JAX package's
``jax.named_scope`` annotations: ``scope(name)`` opens a
``torch.profiler.record_function`` range named by one of
``telemetry/traceparse.py``'s ``COMPONENT_TOKENS`` (torso, lstm, head,
sum_tree_*, replay_sample, replay_add, obs_decode, loss, optimizer,
act_forward, env_step, env_reset, emit_blocks), so a profiler capture's
operators and kernels map to the component that launched them.

A range costs a dispatcher call (~15 us on a CPU core) even with no
profiler running, so ``scope`` opens one only while a profiler is
recording and is otherwise one check of the profiler's state. Inside a
CUDA-graph capture no range is recorded: a replay's kernels are
attributed by ``traceparse.kernel_components`` from an eager profile of
the same step.
"""

import contextlib

import torch

_NULL = contextlib.nullcontext()


def scope(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
