"""The port's telemetry: the shared log histogram (host and device), the
stage timers and their publication (``core``, ``spans``, ``board``),
``torch.profiler`` captures (``profiler``), the component scopes and the
attribution of a capture to them (``scopes``, ``traceparse``), the cost
model (``costmodel``), the learning and replay diagnostics (``learning``,
``replaydiag``), the resource, compile and alert planes (``resources``,
``compile``, ``alerts``), cross-plane tracing (``tracing``) and the
quantized inference probe's aggregator."""

from r2d2_tpu_torch.telemetry.quant import QuantStats

__all__ = ["QuantStats"]
