"""Observability of the port: the metrics registry, JSONL sink and
TensorBoard event writer (metrics), the step records (telemetry), host
spans and the steps' phase ranges (spans, trace), torch.profiler windows
(profiler), and the diagnostics (flight, watchdog, numerics, tickprof)."""
