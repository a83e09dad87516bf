"""Runtime: the fused-VO chunk driver, the per-frame front end, the
named-span profiler, the leveled logger and checkpoint/resume."""
