"""Keyframe memory, visual-word dictionary, loop closure, pose-graph data
and bundle-adjustment windows: counterpart of tpuslam/mapping/.  Graph
bookkeeping is host Python; the dictionary search and the loop-closure
registration run on a torch device."""
