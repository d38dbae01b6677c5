"""Every kernel wrapper's launch count, across ``ops/replay_kernels.py``,
``ops/lstm_kernels.py`` and ``ops/quant_kernels.py``: each wrapper counts
one launch (``count_launch``) where it launches its kernel. A CUDA graph
replay calls no wrapper, so the graph of K learner steps, like the policy
server's graph of a dispatch bucket, adds the counts of its capture once
per replay (``add_launch_counts``). A capture reads its own launches with
``captured_launches``, by the stream it captures on: other threads (the
policy server beside the learner) may launch kernels on their streams
meanwhile, and a captured backward runs in autograd's own thread, on the
capture stream.

A launch also carries its FLOPs, from the wrapper's formula over the
launch's shapes (``torch.utils.flop_counter`` does not see a kernel
launched through ctypes): ``counted_flops`` collects them, by kernel, for
``telemetry/costmodel.py program_cost``. Each formula counts what
``FlopCounterMode`` counts for the kernel's plain version (its matrix
products; copies and elementwise work count 0)."""

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List

from r2d2_tpu_torch.utils.device import stream_handle

_lock = threading.Lock()
_captures: Dict[int, Dict[str, int]] = {}    # capture stream -> launches
_flop_sinks: List[Dict[str, float]] = []      # open counted_flops records


def count_launch(table: Dict[str, int], name: str, device,
                 flops: float = 0.0) -> None:
    """One launch of kernel ``name`` on ``device``'s current stream: into
    its module's table and, when that stream is capturing under
    ``captured_launches``, into the capture's record; its ``flops`` into
    every open ``counted_flops`` record."""
    table[name] += 1
    if _flop_sinks:
        with _lock:
            for sink in _flop_sinks:
                sink[name] = sink.get(name, 0.0) + float(flops)
    if _captures:
        record = _captures.get(stream_handle(device))
        if record is not None:
            with _lock:
                record[name] = record.get(name, 0) + 1


@contextmanager
def captured_launches(stream) -> Iterator[Dict[str, int]]:
    """The launches made on ``stream`` (a ``torch.cuda.Stream``) inside
    the block, by kernel, whichever thread makes them."""
    record: Dict[str, int] = {}
    key = stream.cuda_stream
    with _lock:
        _captures[key] = record
    try:
        yield record
    finally:
        with _lock:
            del _captures[key]


@contextmanager
def counted_flops() -> Iterator[Dict[str, float]]:
    """The FLOPs of the kernel launches inside the block, by kernel."""
    record: Dict[str, float] = {}
    with _lock:
        _flop_sinks.append(record)
    try:
        yield record
    finally:
        with _lock:
            _flop_sinks.remove(record)


def _tables():
    from r2d2_tpu_torch.ops import lstm_kernels, quant_kernels, replay_kernels
    return (replay_kernels.LAUNCHES, lstm_kernels.LAUNCHES,
            quant_kernels.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Launches so far, by kernel."""
    return {name: n for table in _tables() for name, n in table.items()}


def add_launch_counts(counts: Dict[str, int]) -> None:
    for table in _tables():
        for name in table:
            table[name] += counts.get(name, 0)


def reset_launch_counts() -> None:
    for table in _tables():
        for name in table:
            table[name] = 0
