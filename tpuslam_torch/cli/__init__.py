"""Command-line entry points: the batch SLAM app (slam_batch)."""
