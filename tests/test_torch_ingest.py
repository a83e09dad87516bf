"""tpuslam_torch's ingest against tpuslam's and Pillow.

- The native decoder (io/native_loader.py over csrc/loader.cpp, a copy of
  tpuslam/native/loader.cpp built into build/tpuslam_torch/): Pillow's
  pixels on Pillow-written gray files, tpuslam's native decode_image on
  RGB, RGBA, gray+alpha and PGM files (its own luma), the ring's order and
  wrap-around, and the errors; modelled on tests/test_native_loader.py.
- `load_gray` equals tpuslam's (Pillow's convert("L"), and its bilinear
  resize to 640x480) on every kind tpuslam reads; `resize_bilinear` equals
  Pillow at the shape pairs that matter and at random small ones.
- `FastSlamPipeline.run_ingest` over a written 8-frame 320x240 directory
  in chunks of 3 (two whole chunks, the buffers' rotation back to the
  first, a partial last chunk) equals `run_staged` on the same frames
  exactly: poses, inliers, lost flags and the Mapper's graph
  (tests/test_run_ingest.py does the same for tpuslam).  The run_ingest
  runs with the span recorder (runtime/perf.py) on and run_staged with it
  off, so the equality also holds the recorder to changing nothing; its
  spans nest as dispatch, the VO step and the consumer run.
All exact: the decoders and the resize are integer arithmetic, and both
runs compute the same frames in the same order with the same draws.
"""

import os
import threading
import time

import numpy as np
import pytest
from PIL import Image

from tpuslam_torch.io import native_loader as NL
from tpuslam_torch.io.resize import resize_bilinear


# colour PNGs by Pillow mode, and the PGM
KINDS = {"gray": ("L", (23, 31)), "rgb": ("RGB", (23, 31, 3)),
         "rgba": ("RGBA", (23, 31, 4)), "gray_alpha": ("LA", (23, 31, 2)),
         "pgm": (None, (20, 30))}


def _write(path, kind, seed):
    """An image of `kind` written to `path` (Pillow for PNGs; a P5 file
    with a comment for the PGM); returns the path."""
    mode, shape = KINDS[kind]
    img = np.random.default_rng(seed).integers(0, 256, shape) \
        .astype(np.uint8)
    if mode is None:
        with open(path, "wb") as f:
            f.write(f"P5\n# comment\n{shape[1]} {shape[0]}\n255\n".encode())
            f.write(img.tobytes())
    else:
        Image.fromarray(img, mode).save(path)
    return path


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """Nine Pillow-written gray PNGs of growing height, and their pixels."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths, imgs = [], []
    for i in range(9):
        img = rng.integers(0, 256, (48 + i, 64), dtype=np.uint8)
        p = str(d / f"{i:06d}.png")
        Image.fromarray(img).save(p)
        paths.append(p)
        imgs.append(img)
    return paths, imgs


@pytest.fixture(scope="module")
def reference_decode(tmp_path_factory):
    """tpuslam's native decode_image, its library built from its own
    source by its own build into a directory of this module, so that no
    other test process sees a half-written tpuslam/native library."""
    from tpuslam.io import native_loader as J
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_SO", str(tmp_path_factory.mktemp("jlib") /
                                 "_native_loader.so"))
        mp.setattr(J, "_lib", None)
        J.get_lib()
        yield J.decode_image


def test_builds_into_the_build_tree():
    lib = NL.get_lib()
    assert lib is not None and NL.lib_path().exists()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(NL.lib_path()).startswith(
        os.path.join(root, "build", "tpuslam_torch") + os.sep)


def test_build_failure_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    """A source g++ refuses raises NativeLoaderUnavailable with g++'s
    message; nothing falls back to another decoder."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(NL, "SRC", bad)
    monkeypatch.setattr(NL, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(NL.NativeLoaderUnavailable, match="error"):
        NL.build()
    assert not any((tmp_path / "build").rglob("*.so"))


def test_decode_gray_png_matches_pil(png_dir):
    for p, img in zip(*png_dir):
        np.testing.assert_array_equal(NL.decode_image(p), img)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray_alpha", "pgm"])
def test_decode_matches_reference(tmp_path, reference_decode, kind):
    """The port's copy of loader.cpp decodes colour PNGs (its own luma)
    and PGMs to what tpuslam's native decoder gives."""
    p = _write(str(tmp_path / f"x.{'pgm' if kind == 'pgm' else 'png'}"),
               kind, 1)
    got = NL.decode_image(p)
    assert got.dtype == np.uint8 and got.shape == KINDS[kind][1][:2]
    np.testing.assert_array_equal(got, reference_decode(p))


def test_prefetch_order_and_wraparound(png_dir):
    """9 frames through a 3-bank ring arrive in order, pixel-exact."""
    paths, imgs = png_dir
    loader = NL.NativeStereoLoader(paths, paths, n_banks=3, n_threads=2)
    assert len(loader) == 9
    seen = 0
    for idx, left, right in loader:
        assert idx == seen
        np.testing.assert_array_equal(left, imgs[idx])
        np.testing.assert_array_equal(right, imgs[idx])
        seen += 1
    assert seen == 9
    loader.close()


def test_decode_failure_raises(tmp_path, png_dir):
    paths, _ = png_dir
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png at all")
    loader = NL.NativeStereoLoader([paths[0], bad], [paths[0], bad],
                                   n_banks=2)
    it = iter(loader)
    next(it)
    with pytest.raises(IOError):
        next(it)
    loader.close()
    with pytest.raises(IOError):
        NL.decode_image(bad)


def test_missing_file_raises(tmp_path):
    nope = str(tmp_path / "nope.png")
    loader = NL.NativeStereoLoader([nope], [nope])
    with pytest.raises(IOError):
        next(iter(loader))
    loader.close()
    with pytest.raises(IOError):
        NL.decode_image(nope)


@pytest.mark.parametrize("do_resize", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_load_gray_matches_reference(tmp_path, kind, do_resize):
    """load_gray equals tpuslam's (Pillow's convert("L"), then its
    bilinear resize to 640x480) on each kind tpuslam reads."""
    from tpuslam.io.dataset import load_gray as J
    from tpuslam_torch.io.dataset import load_gray as T
    p = _write(str(tmp_path / f"x.{'pgm' if kind == 'pgm' else 'png'}"),
               kind, 2)
    got = T(p, do_resize)
    assert got.dtype == np.uint8
    assert got.shape == ((480, 640) if do_resize else KINDS[kind][1][:2])
    np.testing.assert_array_equal(got, J(p, do_resize))


def test_prefetch_iter_reads_colour_as_the_native_decoder(
        tmp_path, reference_decode):
    """prefetch_iter (the sequence reader) decodes colour PNGs as
    tpuslam's prefetch_iter does, through loader.cpp's luma."""
    from tpuslam_torch.io.dataset import StereoImageDataset
    for sub in ("l", "r"):
        os.makedirs(tmp_path / sub)
        for i, kind in enumerate(("rgb", "rgba", "gray_alpha")):
            _write(str(tmp_path / sub / f"{i:06d}.png"), kind,
                   10 * i + (sub == "r"))
    ds = StereoImageDataset(left_dir=str(tmp_path / "l"),
                            right_dir=str(tmp_path / "r"))
    got = list(ds.prefetch_iter(0, 3, n_banks=2, n_threads=2))
    assert [g["id"] for g in got] == [1, 2, 3]
    for i, g in enumerate(got):
        for sub, key in (("l", "left"), ("r", "right")):
            np.testing.assert_array_equal(
                g[key], reference_decode(str(tmp_path / sub /
                                             f"{i:06d}.png")))


def _resize_cases():
    """(name, (H, W) in, (width, height) out): the bench's KITTI frames to
    tpuslam's 640x480, a shrink and stretch, the identity, a small
    shrink; then random sizes of 1..64 in both directions."""
    cases = [("kitti", (376, 1241), (640, 480)),
             ("shrink_stretch", (100, 77), (50, 200)),
             ("same", (480, 640), (640, 480)),
             ("small", (33, 33), (7, 5))]
    rng = np.random.default_rng(5)
    for k in range(6):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 65, 4))
        cases.append((f"random{k}", (h, w), (ow, oh)))
    return cases


@pytest.mark.parametrize("name, shape, size",
                         _resize_cases(),
                         ids=[c[0] for c in _resize_cases()])
def test_resize_matches_pillow(stereo_pair, name, shape, size):
    """resize_bilinear equals Pillow's resize(size, BILINEAR) bit for bit
    (the KITTI-sized case is the fixture photograph, the rest random)."""
    if name == "kitti":
        img = np.asarray(Image.fromarray(stereo_pair[0])
                         .resize(shape[::-1], Image.BILINEAR))
    else:
        img = np.random.default_rng(shape[0] * 100 + shape[1]) \
            .integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, size), want)


INGEST = dict(width=320, height=240, f=250.0, baseline=0.54, seed=3)
N_INGEST, CHUNK_INGEST = 8, 3


@pytest.fixture(scope="module")
def ingest_runs(tmp_path_factory):
    """The port's run_staged and run_ingest (after reset()) over the same
    written 8-frame sequence, each with its own Mapper, chunk 3 (map_update
    3, so the chunk stays 3); run_ingest with the span recorder on, its
    spans and counters and its perf_counter_ns bounds in `traced`."""
    from tpuslam_torch.config import MapperConfig, SlamConfig
    from tpuslam_torch.io.dataset import StereoImageDataset
    from tpuslam_torch.io.synthetic import sequence_camera, write_sequence
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.runtime import perf
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    seq = str(tmp_path_factory.mktemp("ingestseq"))
    write_sequence(seq, n_frames=N_INGEST, speed=0.4, yaw_rate=0.002,
                   device="cpu", **INGEST)
    ds = StereoImageDataset(left_dir=os.path.join(seq, "image_0"),
                            right_dir=os.path.join(seq, "image_1"),
                            times_path=os.path.join(seq, "times.txt"))
    items = [ds[i] for i in range(len(ds))]
    cam = sequence_camera(INGEST["width"], INGEST["height"], INGEST["f"],
                          INGEST["baseline"])
    cfg = SlamConfig().replace(mapper=MapperConfig(map_update=3))
    pipe = FastSlamPipeline(cam, cfg, chunk=CHUNK_INGEST, capacity=384,
                            device="cpu")
    assert pipe.chunk == CHUNK_INGEST

    def mapper():
        return Mapper(cam, cfg.mapper, cfg.matching, cfg.pnp, device="cpu")

    m_staged = mapper()
    staged = pipe.run_staged(pipe.stage_chunks(items), items,
                             mapper=m_staged, mapper_async=True)
    paths = [[os.path.join(d, n) for n in names]
             for d, names in ((ds.left_dir, ds._left),
                              (ds.right_dir, ds._right))]
    pipe.reset()
    m_ingest = mapper()
    perf.drain()
    perf.enable()
    try:
        t0 = time.perf_counter_ns()
        ingest = pipe.run_ingest(*paths, [it["stamp"] for it in items],
                                 mapper=m_ingest)
        t1 = time.perf_counter_ns()
    finally:
        perf.disable()
    events, counters = perf.drain()
    traced = dict(events=events, counters=counters, t0=t0, t1=t1,
                  producer=threading.get_native_id())
    return staged, ingest, m_staged, m_ingest, traced


def test_run_ingest_matches_staged(ingest_runs):
    staged, ingest, _, _, _ = ingest_runs
    assert len(staged) == len(ingest) == N_INGEST
    assert not any(i.lost for i in staged[1:])
    for a, b in zip(staged, ingest):
        np.testing.assert_array_equal(a.pose, b.pose)
        assert a.num_inliers == b.num_inliers and a.lost == b.lost
        assert a.stamp == b.stamp


def test_run_ingest_builds_the_same_graph(ingest_runs):
    _, _, m_staged, m_ingest, _ = ingest_runs
    pa, la = m_staged.get_graph()
    pb, lb = m_ingest.get_graph()
    assert sorted(pa) == sorted(pb) and len(pa) == N_INGEST
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
    assert [(k, l.from_id, l.to_id, l.type) for k, l in la.items()] == \
        [(k, l.from_id, l.to_id, l.type) for k, l in lb.items()]
    for (_, a), (_, b) in zip(la.items(), lb.items()):
        np.testing.assert_array_equal(a.transform, b.transform)
    assert m_staged.vwd._count == m_ingest.vwd._count > 0


def _children(events, parent):
    return [e for e in events if e.parent == parent.id]


def test_traced_run_ingest_nests_the_dispatch_spans(ingest_runs):
    """Each pipe.dispatch holds one front end (its four stages) and a VO
    step a frame (match, RANSAC, refine, pose), then the chunk's
    dictionary update and the fetch."""
    *_, traced = ingest_runs
    ev = traced["events"]
    dispatches = [e for e in ev if e.name == "pipe.dispatch"]
    assert [e.chunk for e in dispatches] == [(1, 0), (1, 3), (1, 6)]
    assert [e.frames for e in dispatches] == [3, 3, 2]
    for d in dispatches:
        kids = _children(ev, d)
        assert [k.name for k in kids] == ["vo.frontend"] + ["vo.step"] * 3 \
            + ["dict.dispatch", "pipe.fetch"]
        assert all(k.chunk == d.chunk and k.thread == d.thread
                   for k in kids)
        assert [k.name for k in _children(ev, kids[0])] == \
            ["fe.disparity", "fe.gftt", "fe.orb", "fe.lift"]
        for step in kids[1:4]:
            assert [k.name for k in _children(ev, step)] == \
                ["vo.match", "vo.ransac", "vo.refine", "vo.pose"]
        # pipe.dispatch's own time: no more than a tenth here
        own = (d.end_ns - d.start_ns) - sum(k.end_ns - k.start_ns
                                            for k in kids)
        assert 0 <= own < 0.1 * (d.end_ns - d.start_ns)
    assert traced["counters"] == {"ingest.frames": 8, "pipe.chunks": 3,
                                  "pipe.frames": 8, "dict.nodes": 3}


def test_traced_run_ingest_consumes_each_chunk_under_its_id(ingest_runs):
    """Each pipe.consume, on the consumer thread, carries its dispatch's
    chunk id and frames; its children wait, fetch, unpack and feed the
    Mapper a frame at a time."""
    *_, traced = ingest_runs
    ev = traced["events"]
    dispatches = [e for e in ev if e.name == "pipe.dispatch"]
    consumes = [e for e in ev if e.name == "pipe.consume"]
    assert [(c.chunk, c.frames) for c in consumes] == \
        [(d.chunk, d.frames) for d in dispatches]
    for c, d in zip(consumes, dispatches):
        assert c.thread != d.thread and c.start_ns >= d.end_ns
        names = [k.name for k in _children(ev, c)]
        assert names == ["dict.fetch", "consume.unpack"] + \
            ["mapper.process"] * c.frames
    # the Mapper's dictionary and loop-closure step, at each full node
    assert sum(e.name == "lc.search" for e in ev) == 2


def test_traced_run_ingest_producer_spans_cover_the_run(ingest_runs):
    """The producer's spans lie inside the run and cover it but for the
    loop's own bookkeeping."""
    *_, traced = ingest_runs
    t0, t1 = traced["t0"], traced["t1"]
    ev = traced["events"]
    assert all(t0 <= e.start_ns <= e.end_ns <= t1 for e in ev)
    top = [e for e in ev if e.thread == traced["producer"] and not e.parent]
    assert {e.name for e in top} == {
        "pipe.open", "ingest.open", "ingest.next", "ingest.copy",
        "ingest.upload", "pipe.dispatch", "pipe.handoff", "pipe.drain",
        "ingest.close"}
    assert sum(e.end_ns - e.start_ns for e in top) > 0.95 * (t1 - t0)


def test_run_ingest_refuses_other_image_sizes(png_dir):
    """Files whose size is not the camera's are refused by name."""
    from tpuslam_torch.config import SlamConfig
    from tpuslam_torch.io.synthetic import sequence_camera
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    paths, _ = png_dir
    pipe = FastSlamPipeline(sequence_camera(64, 48, 50.0, 0.5),
                            SlamConfig(), chunk=5, capacity=64,
                            device="cpu")
    with pytest.raises(ValueError, match="frame 1"):
        pipe.run_ingest(paths[:2], paths[:2], [0.0, 0.1])
