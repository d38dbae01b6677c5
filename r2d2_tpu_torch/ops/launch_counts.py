"""Every kernel wrapper's launch count, across ``ops/replay_kernels.py`` and
``ops/lstm_kernels.py``: each wrapper adds one to its ``LAUNCHES`` entry
where it launches its kernel. A CUDA graph replay calls no wrapper, so the
graph of K learner steps adds the counts of its capture once per replay
(``add_launch_counts``)."""

from typing import Dict

from r2d2_tpu_torch.ops import lstm_kernels, replay_kernels

_TABLES = (replay_kernels.LAUNCHES, lstm_kernels.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Launches so far, by kernel."""
    return {name: n for table in _TABLES for name, n in table.items()}


def add_launch_counts(counts: Dict[str, int]) -> None:
    for table in _TABLES:
        for name in table:
            table[name] += counts.get(name, 0)


def reset_launch_counts() -> None:
    for table in _TABLES:
        for name in table:
            table[name] = 0
