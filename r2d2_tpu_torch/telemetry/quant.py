"""Quantized-inference accuracy aggregation, the JAX package's
``telemetry/quant.py``.

The quantized acting forward (``actor/policy.py make_forward_fn`` at
``network.inference_dtype`` "bf16" or "int8") runs, on every
``telemetry.quant_probe_interval``-th tick, the f32 twin on the same live
rows and reports max |Q_f32 - Q_quant| and the greedy-action agreement.
``QuantStats`` gathers those probes, from thread actors and the policy
server alike, into the periodic record's ``quant`` block. Thread-safe;
``interval_block`` consumes the interval.
"""

import threading
from typing import Optional


class QuantStats:
    """Per-interval accumulator: probes weigh by lanes, ``dq_max`` is the
    interval's max, ``agree_min`` the worst probe. ``publish_stamp`` is
    the newest adopted bundle stamp (``make_inference_bundle``): the
    publication the acting twin was quantized at."""

    def __init__(self, dtype: str, probe_interval: int = 0):
        self.dtype = str(dtype)
        self.probe_interval = int(probe_interval)
        self._lock = threading.Lock()
        self._probes = 0
        self._lanes = 0
        self._agree_sum = 0.0
        self._agree_min: Optional[float] = None
        self._dq_max: Optional[float] = None
        self.publish_stamp = 0

    def on_probe(self, dq_max: float, agree_frac: float,
                 lanes: int = 1) -> None:
        with self._lock:
            self._probes += 1
            self._lanes += int(lanes)
            self._agree_sum += float(agree_frac) * int(lanes)
            self._agree_min = (float(agree_frac) if self._agree_min is None
                               else min(self._agree_min, float(agree_frac)))
            self._dq_max = (float(dq_max) if self._dq_max is None
                            else max(self._dq_max, float(dq_max)))

    def on_stamp(self, stamp: int) -> None:
        with self._lock:
            self.publish_stamp = max(self.publish_stamp, int(stamp))

    def interval_block(self) -> dict:
        """The record's ``quant`` block; consumes the interval."""
        with self._lock:
            block = {
                "dtype": self.dtype,
                "probe_interval": self.probe_interval,
                "probes": self._probes,
                "lanes_probed": self._lanes,
                "dq_max": (round(self._dq_max, 6)
                           if self._dq_max is not None else None),
                "agree_frac": (round(self._agree_sum / self._lanes, 6)
                               if self._lanes else None),
                "agree_min": (round(self._agree_min, 6)
                              if self._agree_min is not None else None),
                "publish_stamp": self.publish_stamp,
            }
            self._probes = 0
            self._lanes = 0
            self._agree_sum = 0.0
            self._agree_min = None
            self._dq_max = None
        return block
