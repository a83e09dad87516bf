"""Runtime: the fused-VO chunk driver, the per-frame front end, the
named-span profiler, the leveled logger, checkpoint/resume, the per-frame
stage dumps and the frame-timing twin."""
