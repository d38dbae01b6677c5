"""One owner for ``torch.profiler`` captures, the JAX package's
``telemetry/profiler.py`` with ``torch.profiler`` in place of
``jax.profiler``.

``ProfilerCapture`` makes start and stop idempotent and gives a run loop
one ``poll(now)`` that ends a bounded capture; a stopped capture is
written as a Chrome trace (``*.pt.trace.json``, what TensorBoard's and
Perfetto's viewers read, and ``tools/profile_step.py summarize_trace``).
``CaptureTriggers`` holds the three mid-run triggers around one capture,
shared by the orchestrator's loop and the on-device acting loop:

  * the first interval, when ``runtime.profile_dir`` is set;
  * ``runtime.profile_at_step`` (one shot): armed until a capture really
    starts, so a trigger refused while another capture runs fires once
    that one ends instead of being lost;
  * SIGUSR2 on demand: the handler only sets a flag (the profiler is not
    async-signal-safe) and the loop starts the capture at its next poll;
    the previous handler is restored exactly at ``uninstall``. Only the
    main thread can install a handler, and only one ``CaptureTriggers`` a
    process holds it (a second install, as a nested loop would make, is a
    no-op), so thread actors and controllers never install it twice.

Captures go to ``runtime.profile_dir`` or ``{save_dir}/profile``. A start
while another ``torch.profiler`` is active in the process is refused with
a warning (starting a second one would end the first silently): the
capture that ``chip_smoke.py`` counts launches with is never cut short.
"""

import logging
import os
import signal
import threading
import time
from contextlib import contextmanager
from typing import Optional

_UNSET = object()   # a previous handler can be None
_INSTALLED = {"owner": None}    # the CaptureTriggers holding SIGUSR2


def profiler_active() -> bool:
    """Whether a ``torch.profiler``/autograd profiler runs in this
    process."""
    import torch
    return bool(torch._C._autograd._profiler_enabled())


class ProfilerCapture:
    def __init__(self):
        self.active = False
        self.captures = 0
        self.refused = 0
        self.out_dir: Optional[str] = None
        self.last_trace: Optional[str] = None
        self._until: Optional[float] = None
        self._prof = None

    def start(self, out_dir: str, duration_s: Optional[float] = None) -> bool:
        """Begin a capture into ``out_dir``; False (and nothing changes)
        when one is running here or another profiler is active in the
        process. ``duration_s`` arms the stop at poll()."""
        if self.active:
            return False
        if profiler_active():
            self.refused += 1
            logging.getLogger(__name__).warning(
                "profiler capture refused: another torch.profiler is "
                "active in this process")
            return False
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.start()
        self.active = True
        self.out_dir = out_dir
        self._until = (time.time() + duration_s
                       if duration_s is not None else None)
        return True

    def poll(self, now: Optional[float] = None) -> bool:
        """Stop a bounded capture whose window has passed; True if one
        stopped."""
        if not self.active or self._until is None:
            return False
        if (time.time() if now is None else now) < self._until:
            return False
        self.stop()
        return True

    def stop(self) -> Optional[str]:
        """Stop and write the trace; a no-op without a running capture.
        Returns the trace's path."""
        if not self.active:
            return None
        prof, self._prof = self._prof, None
        self.active = False        # first: the stop or the write may raise
        self._until = None
        prof.stop()
        self.captures += 1
        path = os.path.join(self.out_dir, f"capture_{os.getpid()}_"
                            f"{self.captures}_{int(time.time())}"
                            ".pt.trace.json")
        prof.export_chrome_trace(path)
        self.last_trace = path
        return path


class CaptureTriggers:
    """The mid-run triggers (module docstring) around one
    ``ProfilerCapture``; ``runtime_cfg`` is a RuntimeConfig."""

    def __init__(self, runtime_cfg):
        self.prof = ProfilerCapture()
        self.out_dir = runtime_cfg.profile_dir or os.path.join(
            runtime_cfg.save_dir or ".", "profile")
        self.window = min(runtime_cfg.log_interval, 30.0)
        self._first_interval_dir = runtime_cfg.profile_dir
        self._at_step = runtime_cfg.profile_at_step
        self._armed = self._at_step > 0
        self._request = threading.Event()
        self._prev_usr2 = _UNSET

    def install(self) -> "CaptureTriggers":
        """The SIGUSR2 flag handler, from the main thread and if no other
        CaptureTriggers holds it; a no-op otherwise. Returns self."""
        if (threading.current_thread() is not threading.main_thread()
                or _INSTALLED["owner"] is not None):
            return self

        def _on_usr2(signum, frame):
            self._request.set()
        try:
            self._prev_usr2 = signal.signal(signal.SIGUSR2, _on_usr2)
        except (ValueError, OSError, AttributeError):
            self._prev_usr2 = _UNSET
            return self
        _INSTALLED["owner"] = self
        return self

    def start_first_interval(self) -> None:
        """The ``runtime.profile_dir`` capture of the first interval."""
        if self._first_interval_dir:
            self.prof.start(self._first_interval_dir, self.window)

    def poll(self, now: float, training_steps: int) -> None:
        """Once a loop turn: end a window that has passed, fire the
        one-shot step trigger, serve a pending SIGUSR2."""
        self.prof.poll(now)
        if self._armed and training_steps >= self._at_step:
            if self.prof.start(self.out_dir, self.window):
                self._armed = False
        if self._request.is_set():
            if self.prof.start(self.out_dir, self.window):
                self._request.clear()

    def uninstall(self) -> None:
        """Stop a running capture and restore the previous SIGUSR2
        handler."""
        self.prof.stop()
        if self._prev_usr2 is not _UNSET:
            try:
                signal.signal(signal.SIGUSR2,
                              self._prev_usr2 or signal.SIG_DFL)
            except (ValueError, OSError, TypeError):
                pass
            self._prev_usr2 = _UNSET
        if _INSTALLED["owner"] is self:
            _INSTALLED["owner"] = None


@contextmanager
def trace(out_dir: str):
    """A capture for tools: it stops exactly once, raise or return. A
    start that is refused raises."""
    cap = ProfilerCapture()
    if not cap.start(out_dir):
        raise RuntimeError("profiler capture refused: another "
                           "torch.profiler is active in this process")
    try:
        yield cap
    finally:
        cap.stop()
