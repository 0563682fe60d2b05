"""Host-side utilities: structured logs, timers, the profiler hook."""
