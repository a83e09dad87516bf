"""Tools of the port that no path runs: `probe_bm_parts`, the phase harness
of kernel K1 (StereoBM) on the card."""
