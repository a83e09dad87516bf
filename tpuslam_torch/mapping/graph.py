"""Pose-graph data structures: Node, Link, multimap helpers.

Behavioral twins of the reference's src/slam/src/core/{Node,Link}.cpp and
the graph utilities in Graph.cpp / Mapper.cpp (findLink,
getConnectedGraph).  The C++ std::multimap (sorted keys, insertion order
within a key) is modeled by `MultiMap`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geometry import transform as T

# Link types (include/core/Link.h:12-16)
NEIGHBOR = 0
LOOP_CLOSURE = 1
UNDEFINED = 2


@dataclass
class Link:
    from_id: int
    to_id: int
    type: int
    transform: np.ndarray
    info: np.ndarray = field(
        default_factory=lambda: np.eye(6, dtype=np.float64))

    def inverse(self) -> "Link":
        return Link(self.to_id, self.from_id, self.type,
                    T.inverse(self.transform), self.info.copy())


class Node:
    """Graph node (include/core/Node.h:16-60)."""

    def __init__(self, node_id: int, map_id: int, weight: int,
                 pose: np.ndarray, frame):
        self.id = node_id
        self.map_id = map_id
        self.weight = weight           # -1 == intermediate
        self.pose = pose
        self.frame = frame             # SensorData twin
        self.links: "MultiMap" = MultiMap()   # keyed by other node id
        self.words: list[tuple[int, int]] = []  # (word_id, kpt index) sorted
        self.velocity = None
        self.stamp = frame.stamp if frame is not None else 0.0

    def add_link(self, link: Link):
        self.links.insert(link.to_id, link)

    def has_link(self, id_to: int) -> bool:
        return len(self.links.get(id_to)) > 0


class MultiMap:
    """std::multimap twin: sorted keys, insertion order within a key."""

    def __init__(self, items=None):
        self._d: dict[int, list] = {}
        if items:
            for k, v in items:
                self.insert(k, v)

    def insert(self, key: int, value):
        self._d.setdefault(key, []).append(value)

    def get(self, key: int) -> list:
        return self._d.get(key, [])

    def keys(self):
        return sorted(self._d.keys())

    def items(self):
        for k in sorted(self._d.keys()):
            for v in self._d[k]:
                yield k, v

    def values(self):
        for _, v in self.items():
            yield v

    def remove(self, key: int, pred):
        """Remove entries under `key` satisfying pred(value)."""
        if key in self._d:
            self._d[key] = [v for v in self._d[key] if not pred(v)]
            if not self._d[key]:
                del self._d[key]

    def copy(self) -> "MultiMap":
        m = MultiMap()
        for k, vs in self._d.items():
            m._d[k] = list(vs)
        return m

    def __len__(self):
        return sum(len(v) for v in self._d.values())

    def __contains__(self, key):
        return key in self._d


def find_link(links: MultiMap, from_id: int, to_id: int):
    """Bidirectional link search (Graph.cpp:8-30).  Returns Link or None."""
    for link in links.get(from_id):
        if link.to_id == to_id:
            return link
    for link in links.get(to_id):
        if link.to_id == from_id:
            return link
    return None


def get_connected_graph(from_id: int, poses_in: dict,
                        links_in: MultiMap):
    """Shortest-path reconnect with pose recomputation along links
    (Mapper.cpp getConnectedGraph:195-255).

    Traversal order mirrors the reference exactly: the frontier is a set
    popped from the largest id; neighbor order follows link insertion
    order per node.  Returns (poses_out dict, links_out MultiMap).
    """
    poses_out: dict[int, np.ndarray] = {}
    links_out = MultiMap()

    bi_links = MultiMap()
    for _, link in links_in.items():
        bi_links.insert(link.from_id, link.to_id)
        bi_links.insert(link.to_id, link.from_id)

    next_poses = {from_id}
    while next_poses:
        current = max(next_poses)
        next_poses.discard(current)

        if not poses_out:
            poses_out[current] = poses_in[current]

        for to_id in bi_links.get(current):
            link = find_link(links_in, current, to_id)
            if to_id not in next_poses:
                if to_id not in poses_out:
                    if link.from_id == current:
                        t = T.compose(poses_out[current], link.transform)
                    else:
                        t = T.compose(poses_out[current],
                                      T.inverse(link.transform))
                    poses_out[to_id] = t
                    next_poses.add(to_id)
                if find_link(links_out, current, to_id) is None:
                    links_out.insert(current, link)

    return poses_out, links_out
