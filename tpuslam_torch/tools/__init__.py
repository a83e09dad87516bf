"""Tools of the port that no path runs: `probe_bm_parts`, the phase harness
of kernel K1 (StereoBM) on the card; the block-shape sweeps, the timing
helpers and the ingest turns; `dist_worker`, one rank of a multi-process
run of the multi-device layer."""
