"""OctoMap-compatible occupancy octree with `.bt` binary serialization.

Reimplements (from behavior, not code) the *used surface* of the vendored
OctoMap library — OcTree(res), coordToKey, updateNode(key, true),
writeBinary("slam.bt") — as consumed by the reference's occupancy-map
builder (/root/reference/src/slam/src/core/main.cpp:495-561).

Because the SLAM app only ever inserts occupied hits (updateNode(key,
true)) and writeBinary() first converts the tree to max-likelihood and
prunes it, the on-disk tree is fully determined by the *set* of occupied
voxel keys.  We therefore keep the map as a flat array of unique packed
keys (a TPU/NumPy-friendly representation — no pointer tree in the hot
path) and materialize the pruned octree only at serialization time.

File format (reference src/slam/src/octomap/AbstractOccupancyOcTree.cpp
writeBinaryConst + OccupancyOcTreeBase.hxx writeBinaryNode):

    # Octomap OcTree binary file
    # (feel free to add / change comments, ...)
    #
    id OcTree
    size <node count after prune>
    res <resolution>
    data
    <preorder nodes, 2 bytes each: 2 bits per child>
      bits (LSB-first, child i uses bits 2i, 2i+1):
        00 = no child, 01 (bit 2i+1) = occupied leaf,
        10 (bit 2i)   = free leaf,   11 = inner node (recurse)

Key convention (OcTreeBaseImpl.h:357-358): key = floor(coord/res) + 32768,
tree depth 16; child index at depth d takes bit (15-d) of each key
component, x -> bit0, y -> bit1, z -> bit2.
"""

from __future__ import annotations

import numpy as np

TREE_DEPTH = 16
TREE_MAX_VAL = 32768  # 2^15

_HEADER = (b"# Octomap OcTree binary file\n"
           b"# (feel free to add / change comments, but leave the first "
           b"line as it is!)\n#\n")


def coords_to_keys(points: np.ndarray, resolution: float) -> np.ndarray:
    """World coordinates (N,3) float -> voxel keys (N,3) uint16.

    OcTreeBaseImpl.h:357: key = (int)floor(res_factor * coord) + 32768.
    """
    k = np.floor(np.asarray(points, np.float64) / resolution).astype(
        np.int64) + TREE_MAX_VAL
    if k.size and (k.min() < 0 or k.max() > 65535):
        k = np.clip(k, 0, 65535)
    return k.astype(np.uint16)


def keys_to_coords(keys: np.ndarray, resolution: float) -> np.ndarray:
    """Voxel-center coordinates (OcTreeBaseImpl.h:485)."""
    return ((keys.astype(np.float64) - TREE_MAX_VAL) + 0.5) * resolution


def pack_keys(keys: np.ndarray) -> np.ndarray:
    """(N,3) uint16 -> (N,) uint64 packed key (x | y<<16 | z<<32)."""
    k = keys.astype(np.uint64)
    return k[:, 0] | (k[:, 1] << np.uint64(16)) | (k[:, 2] << np.uint64(32))


def unpack_keys(packed: np.ndarray) -> np.ndarray:
    p = packed.astype(np.uint64)
    m = np.uint64(0xFFFF)
    return np.stack([p & m, (p >> np.uint64(16)) & m,
                     (p >> np.uint64(32)) & m], axis=1).astype(np.uint16)


def _child_indices(keys: np.ndarray, depth: int) -> np.ndarray:
    """OcTreeKey computeChildIdx: bit (15-depth) of x,y,z -> 0..7."""
    bit = TREE_DEPTH - 1 - depth
    return (((keys[:, 0] >> bit) & 1)
            | (((keys[:, 1] >> bit) & 1) << 1)
            | (((keys[:, 2] >> bit) & 1) << 2)).astype(np.int64)


def _serialize(keys: np.ndarray) -> tuple[bytes, int]:
    """Preorder-serialize the pruned max-likelihood octree of an occupied
    voxel set.  Returns (data bytes, node count incl. root).

    A child whose subtree is *complete* (covers all 8^(15-depth) voxels)
    is what OctoMap's prune() collapses into a single occupied leaf.
    """
    out = bytearray()
    # iterative preorder with an explicit stack of (keys, depth)
    n_nodes = 1  # root
    stack = [(keys, 0)]
    while stack:
        node_keys, depth = stack.pop()
        full = 1 << (3 * (TREE_DEPTH - 1 - depth))  # voxels of a full child
        idx = _child_indices(node_keys, depth)
        order = np.argsort(idx, kind="stable")
        sidx = idx[order]
        skeys = node_keys[order]
        bounds = np.searchsorted(sidx, np.arange(9))
        b1to4 = 0
        b5to8 = 0
        children = []  # collect, then push reversed for preorder
        for i in range(8):
            lo, hi = bounds[i], bounds[i + 1]
            cnt = hi - lo
            if cnt == 0:
                continue
            n_nodes += 1
            if cnt >= full:
                code = 2  # occupied leaf: bit 2i+1
            else:
                code = 3  # inner node: both bits
                children.append((skeys[lo:hi], depth + 1))
            if i < 4:
                b1to4 |= code << (2 * i)
            else:
                b5to8 |= code << (2 * (i - 4))
        out.append(b1to4)
        out.append(b5to8)
        for child in reversed(children):
            stack.append(child)
    return bytes(out), n_nodes


def write_bt(path: str, keys: np.ndarray, resolution: float) -> int:
    """Write occupied voxel keys (N,3) uint16 as an OctoMap .bt file.

    Returns the serialized node count (the header `size` field).
    """
    keys = np.asarray(keys, np.uint16).reshape(-1, 3)
    keys = unpack_keys(np.unique(pack_keys(keys)))
    if len(keys) == 0:
        data, n_nodes = b"", 0
    else:
        data, n_nodes = _serialize(keys)
    res_str = np.format_float_positional(
        resolution, trim="-")  # matches std::ostream double formatting
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(b"id OcTree\n")
        f.write(b"size %d\n" % n_nodes)
        f.write(b"res %s\n" % res_str.encode())
        f.write(b"data\n")
        f.write(data)
    return n_nodes


def read_bt(path: str, max_voxels: int = 10_000_000):
    """Parse a .bt file back into (keys (N,3) uint16, resolution).

    Pruned occupied leaves are expanded to voxel level (capped at
    `max_voxels`).  Used for round-trip tests and map reloading.
    """
    with open(path, "rb") as f:
        blob = f.read()
    pos = blob.index(b"data\n") + 5
    header = blob[:pos].decode()
    if not header.startswith("# Octomap OcTree binary file"):
        raise ValueError("not an OctoMap .bt file")
    res = None
    size = None
    for line in header.splitlines():
        if line.startswith("res "):
            res = float(line[4:])
        elif line.startswith("size "):
            size = int(line[5:])
    if res is None or size is None:
        raise ValueError("missing res/size in .bt header")
    data = blob[pos:]
    voxels: list[np.ndarray] = []
    total = 0

    def expand(prefix, depth):
        """All voxel keys under an occupied leaf at (prefix, depth)."""
        nonlocal total
        bits = TREE_DEPTH - depth
        n = 1 << (3 * bits)
        total += n
        if total > max_voxels:
            raise ValueError("bt expansion exceeds max_voxels")
        r = np.arange(1 << bits, dtype=np.uint16)
        xs, ys, zs = np.meshgrid(r, r, r, indexing="ij")
        base = np.array(prefix, np.uint16) << bits
        return np.stack([base[0] + xs.ravel(), base[1] + ys.ravel(),
                         base[2] + zs.ravel()], axis=1)

    cursor = [0]

    def read_node(prefix, depth):
        """Recursive descent (max depth 16) mirroring writeBinaryNode."""
        b1to4 = data[cursor[0]]
        b5to8 = data[cursor[0] + 1]
        cursor[0] += 2
        word = b1to4 | (b5to8 << 8)
        inner = []
        for i in range(8):
            code = (word >> (2 * i)) & 3
            if code == 0 or code == 1:  # absent / free leaf: no voxels
                continue
            child_prefix = (prefix[0] * 2 + (i & 1),
                            prefix[1] * 2 + ((i >> 1) & 1),
                            prefix[2] * 2 + ((i >> 2) & 1))
            if code == 2:  # occupied (pruned) leaf
                voxels.append(expand(child_prefix, depth + 1))
            else:  # 3: inner node — recurse in file order
                inner.append((child_prefix, depth + 1))
        for child_prefix, d in inner:
            read_node(child_prefix, d)

    if size > 0:
        read_node((0, 0, 0), 0)
    keys = (unpack_keys(np.unique(pack_keys(np.concatenate(voxels))))
            if voxels else np.zeros((0, 3), np.uint16))
    return keys, res
