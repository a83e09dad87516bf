"""Runtime: the fused-VO chunk driver, the per-frame front end and the
named-span profiler."""
