"""tpuslam_torch's PNG codec, KITTI-layout dataset, sequence writer and
occupancy export against Pillow and tpuslam.

The PNG decoder must read what libpng and Pillow write (any of the five
row filters per row) exactly; the dataset must give the images, stamps
and ground truth tpuslam's gives; `write_sequence` must write what
tpuslam's make_sequence writes, byte for byte in its text files; the
occupancy grid's voxel keys and .bt bytes must equal tpuslam's.  The
reprojection is f32 in both packages and held to 1e-5 relative.
"""

import dataclasses
import io
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpuslam_torch.io import png


def _filter_rows(img: np.ndarray, kind: int) -> bytes:
    """PNG filter `kind` (0-4) applied to every row of an 8-bit
    grayscale image, as an encoder writes it (PNG spec 9.2)."""
    h, w = img.shape
    x = img.astype(np.int64)
    out = bytearray()
    for y in range(h):
        prior = x[y - 1] if y else np.zeros(w, np.int64)
        row = []
        for i in range(w):
            a = x[y, i - 1] if i else 0
            b = prior[i]
            c = prior[i - 1] if i else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                        else c)
            row.append((x[y, i] - pred) & 255)
        out += bytes([kind] + row)
    return bytes(out)


def _png_bytes(w: int, h: int, rows: bytes) -> bytes:
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload +
                struct.pack(">I", zlib.crc32(kind + payload)))
    return (png.SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("width", [1, 2, 1241])
@pytest.mark.parametrize("kind", range(5))
@pytest.mark.parametrize("decoder", ["python", "native"])
def test_png_decode_each_filter(tmp_path, decoder, kind, width):
    """Hand-built files, every row with filter `kind`, decode to what
    Pillow decodes (and to the image that was filtered), through io/png.py
    and through the native decoder (csrc/loader.cpp)."""
    from tpuslam_torch.io.native_loader import decode_image
    img = np.random.default_rng(kind * 7 + width).integers(
        0, 256, (4, width)).astype(np.uint8)
    img[2] = img[1]                      # equal rows: Up residuals of 0
    data = _png_bytes(width, 4, _filter_rows(img, kind))
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil, img)
    if decoder == "python":
        got = png.decode(data)
    else:
        (tmp_path / "x.png").write_bytes(data)
        got = decode_image(str(tmp_path / "x.png"))
    np.testing.assert_array_equal(got, pil)


def test_png_decode_pillow_written(stereo_pair):
    """A Pillow-written photograph (Pillow picks a filter per row, mostly
    Paeth) decodes exactly; its size is read from the header."""
    img = stereo_pair[0][:64]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode(buf.getvalue()), img)
    assert png._header(buf.getvalue()) == (640, 64)


def test_png_encode_filters_like_pillow(stereo_pair):
    """The encoder picks a filter per row as Pillow does (least sum of
    absolute values as signed bytes): on a photograph mostly Paeth, the
    same filter as Pillow on at least 95 % of rows, and the file reads
    back through Pillow and the port unchanged."""
    img = stereo_pair[0]
    data = png.encode(img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    ours, pillow = png.row_filters(data), png.row_filters(buf.getvalue())
    assert (ours == 4).mean() > 0.9
    assert (ours == pillow).mean() >= 0.95
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("kind", range(5))
def test_png_encode_one_filter(kind):
    """With `row_filter` every row takes that filter, and the file reads
    back through Pillow and the port unchanged."""
    img = np.random.default_rng(kind).integers(0, 256, (5, 7)) \
        .astype(np.uint8)
    data = png.encode(img, row_filter=kind)
    assert (png.row_filters(data) == kind).all()
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (37, 1241)])
def test_png_encode_read_by_pillow(tmp_path, shape):
    """The port's written PNGs read back through Pillow unchanged."""
    img = np.random.default_rng(shape[1]).integers(
        0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(path), img)
    assert png.image_size(path) == (shape[1], shape[0])


# Pillow mode and shape of each 8-bit colour type that Pillow writes
COLOUR_KINDS = {"rgb": ("RGB", (5, 7, 3)), "rgba": ("RGBA", (5, 7, 4)),
                "gray_alpha": ("LA", (5, 7, 2))}


def _filter_bytes(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Filter each (stride,) byte row of `rows` as an encoder does, row y
    under filter (first + y) % 5, `bpp` bytes to the left pixel."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = (first + y) % 5
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        b = prior
        if kind == 4:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        else:
            pred = [0 * a, a, b, (a + b) // 2][kind]
        out += bytes([kind]) + ((row - pred) & 255).astype(np.uint8) \
            .tobytes()
        prior = row
    return bytes(out)


def _pack(s: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) bytes at `depth` bits."""
    h = s.shape[0]
    flat = s.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = -(-flat.shape[1] // per) * per
    flat = np.pad(flat, ((0, 0), (0, n - flat.shape[1])))
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _png_kind(s, depth, colour, interlace=False, plte=None, trns=None):
    """A PNG file of samples s (h, w, ch) at `depth` bits and colour type
    `colour`, its rows under all five filters, Adam7-interlaced if asked
    (Pillow writes no interlaced PNG)."""
    h, w, ch = s.shape
    bpp = max(1, ch * depth // 8)
    passes = png.ADAM7 if interlace else ((0, 0, 1, 1),)
    body = b""
    for i, (x0, y0, dx, dy) in enumerate(passes):
        sub = s[y0::dy, x0::dx]
        if sub.size:
            body += _filter_bytes(_pack(sub, depth), bpp, i)
    data = png.SIGNATURE + png._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    if plte is not None:
        data += png._chunk(b"PLTE", plte)
    if trns is not None:
        data += png._chunk(b"tRNS", trns)
    return (data + png._chunk(b"IDAT", zlib.compress(body)) +
            png._chunk(b"IEND", b""))


def _made_kind(case):
    """(file bytes, samples) of a hand-made case: name = kind, bit depth
    and options, e.g. gray2, rgb16, palette4_trns, adam7_rgba8_13x11."""
    rng = np.random.default_rng(sum(map(ord, case)))
    parts = case.split("_")
    interlace = parts[0] == "adam7"
    if interlace:
        parts = parts[1:]
    h, w = (5, 7)
    if "x" in parts[-1]:
        w, h = map(int, parts.pop().split("x"))
    trns = parts[-1] == "trns"
    name = parts[0].rstrip("0123456789")
    depth = int(parts[0][len(name):])
    colour = {"gray": 0, "rgb": 2, "palette": 3, "grayalpha": 4,
              "rgba": 6}[name]
    s = rng.integers(0, 1 << depth, (h, w, png.CHANNELS[colour]))
    if depth == 16:         # values below 256 too, where 16 -> 8 bits differ
        s[::2] >>= 8
    plte = t = None
    if colour == 3:         # fewer entries than indices: the rest black
        n = max(1, (1 << depth) - 1)
        plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        if trns:
            t = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    elif trns:
        t = struct.pack(">" + "H" * (3 if colour == 2 else 1),
                        *s[0, 0, :3 if colour == 2 else 1].tolist())
    return _png_kind(s, depth, colour, interlace, plte, t), s


MADE_KINDS = ["gray1", "gray2", "gray4", "gray8_trns", "gray16_trns",
              "rgb16", "rgb8_trns", "rgb16_trns", "grayalpha16", "rgba16",
              "palette1", "palette2", "palette4", "palette8_trns",
              "adam7_gray8_13x11", "adam7_gray1_1x1", "adam7_rgb16_3x2",
              "adam7_palette2_9x10", "adam7_rgba8_5x5",
              "adam7_grayalpha8_8x8", "adam7_gray16_trns_6x1"]


@pytest.mark.parametrize("case", ["rgb", "rgba", "gray_alpha", "16bit",
                                  "interlaced", "palette", *MADE_KINDS])
def test_png_refuses_other_kinds(tmp_path, case):
    """Every PNG kind (bit depths 1-16, gray, RGB, palette with and
    without tRNS, gray+alpha, RGBA, Adam7) reads as Pillow reads it:
    `gray` and load_gray equal Pillow's convert("L") and tpuslam's
    load_gray; `decode` gives the samples (Pillow's channels for the 8-bit
    colour types it writes).  These kinds were once refused."""
    from tpuslam.io.dataset import load_gray as ref_load_gray
    from tpuslam_torch.io.dataset import load_gray
    buf = io.BytesIO()
    if case in COLOUR_KINDS:
        mode, shape = COLOUR_KINDS[case]
        img = np.random.default_rng(len(shape) * shape[-1]).integers(
            0, 256, shape).astype(np.uint8)
        Image.fromarray(img, mode).save(buf, format="PNG")
        data = buf.getvalue()
        np.testing.assert_array_equal(png.decode(data), img)
        np.testing.assert_array_equal(png.luma(png.decode(data)),
                                      png.gray(data))
        assert png._header(data) == (7, 5)
    elif case == "16bit":
        img = np.random.default_rng(16).integers(0, 1 << 16, (6, 9)) \
            .astype(np.uint16)
        img[::2] >>= 8
        Image.fromarray(img).save(buf, format="PNG")
        data = buf.getvalue()
        assert Image.open(io.BytesIO(data)).mode == "I;16"
        np.testing.assert_array_equal(png.decode(data), img)
    elif case == "palette":
        rgb = np.random.default_rng(3).integers(0, 256, (6, 9, 3)) \
            .astype(np.uint8)
        Image.fromarray(rgb).convert("P").save(buf, format="PNG")
        data = buf.getvalue()
        assert Image.open(io.BytesIO(data)).mode == "P"
        np.testing.assert_array_equal(
            png.decode(data), np.asarray(Image.open(io.BytesIO(data))))
    elif case == "interlaced":      # Pillow writes no interlaced PNG
        img = np.random.default_rng(7).integers(0, 256, (11, 13, 1))
        data = _png_kind(img, 8, 0, interlace=True)
        np.testing.assert_array_equal(png.decode(data), img[..., 0])
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))), img[..., 0])
    else:
        data, s = _made_kind(case)
        got = png.decode(data)
        np.testing.assert_array_equal(got, s[..., 0] if s.shape[2] == 1
                                      else s)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    np.testing.assert_array_equal(png.gray(data), want)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    got = load_gray(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref_load_gray(path))
    np.testing.assert_array_equal(got, want)


POSES_KW = dict(width=160, height=120, f=150.0, baseline=0.54, seed=5)


def _poses():
    from tpuslam_torch.io.synthetic import out_and_back_trajectory
    return out_and_back_trajectory(1, 0.45)          # 3 frames


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The same 3-frame 160x120 sequence written by tpuslam and by the
    port."""
    from tpuslam.io.synthetic import make_sequence
    from tpuslam_torch.io.synthetic import write_sequence
    j = str(tmp_path_factory.mktemp("jax_seq"))
    t = str(tmp_path_factory.mktemp("port_seq"))
    make_sequence(j, poses=_poses(), **POSES_KW)
    write_sequence(t, poses=_poses(), device="cpu", **POSES_KW)
    return j, t


def _datasets(seq):
    from tpuslam.io.dataset import StereoImageDataset as JD
    from tpuslam_torch.io.dataset import StereoImageDataset as TD
    kw = dict(left_dir=os.path.join(seq, "image_0"),
              right_dir=os.path.join(seq, "image_1"),
              times_path=os.path.join(seq, "times.txt"),
              gt_path=os.path.join(seq, "poses.txt"))
    return JD(**kw), TD(**kw)


def _assert_same_items(a, b):
    assert a.keys() == b.keys()
    for k in ("left", "right"):
        assert b[k].dtype == np.uint8
        np.testing.assert_array_equal(a[k], b[k])
    assert a["id"] == b["id"] and a["stamp"] == b["stamp"]
    np.testing.assert_array_equal(a["ground_truth"], b["ground_truth"])


def test_dataset_reads_reference_sequence(sequences):
    """The port's dataset reads a tpuslam-written sequence (Pillow PNGs)
    to tpuslam's images, stamps and ground truth; prefetch_iter yields
    the same items in order."""
    jd, td = _datasets(sequences[0])
    assert len(jd) == len(td) == 3
    assert td._left == jd._left
    for i in range(3):
        _assert_same_items(jd[i], td[i])
    got = list(td.prefetch_iter(1))
    assert [g["id"] for g in got] == [2, 3]
    for g in got:
        _assert_same_items(jd[g["id"] - 1], g)


def test_reference_reads_written_sequence(sequences):
    """tpuslam's dataset reads the port's write_sequence output to the
    port's own in-memory frames, stamps and ground truth, exactly."""
    from tpuslam_torch.io.synthetic import make_sequence
    jd, _ = _datasets(sequences[1])
    left, right, stamps, gt = make_sequence(poses=_poses(), device="cpu",
                                            **POSES_KW)
    for i in range(3):
        item = jd[i]
        np.testing.assert_array_equal(item["left"], left[i].numpy())
        np.testing.assert_array_equal(item["right"], right[i].numpy())
        assert item["stamp"] == stamps[i]
        np.testing.assert_array_equal(item["ground_truth"], gt[i])


@pytest.mark.parametrize("name", ["calib.txt", "times.txt", "poses.txt"])
def test_text_files_match_reference(sequences, name):
    j, t = sequences
    assert open(os.path.join(t, name), "rb").read() == \
        open(os.path.join(j, name), "rb").read()


def test_out_and_back_and_poses_option():
    """The copied trajectory, and make_sequence's `poses` (its frame
    count is theirs)."""
    from tpuslam.io.synthetic import out_and_back_trajectory as J
    from tpuslam_torch.io.synthetic import make_sequence, \
        out_and_back_trajectory as T
    for a, b in zip(T(4, 0.45), J(4, 0.45)):
        np.testing.assert_array_equal(a, b)
    assert len(T(30, 0.45)) == 61
    left, _, stamps, gt = make_sequence(n_frames=9, width=32, height=24,
                                        poses=_poses(), device="cpu")
    assert left.shape == (3, 24, 32) and len(stamps) == 3 and len(gt) == 3


def _graph():
    from tpuslam_torch.mapping.graph import Link
    rng = np.random.default_rng(2)
    from tpuslam_torch.geometry import transform as T
    poses = {i: T.from_rpy_xyz(*rng.normal(0, 1, 6)) for i in (1, 2, 5)}
    links = [Link(1, 2, 0, T.from_rpy_xyz(*rng.normal(0, 1, 6)),
                  np.diag(rng.uniform(1, 9, 6))),
             Link(5, 1, 1, T.from_rpy_xyz(*rng.normal(0, 1, 6)),
                  rng.normal(0, 3, (6, 6)))]
    return poses, links


def test_poses_and_links_round_trip(tmp_path):
    """save_*/load_* in tpuslam's format: the port writes what tpuslam
    writes, and each reads the other's files to the same values."""
    from tpuslam.io import dataset as J
    from tpuslam_torch.io import dataset as T
    poses, links = _graph()
    for mod, tag in ((J, "j"), (T, "t")):
        mod.save_poses(str(tmp_path / f"p{tag}.csv"), poses)
        mod.save_links(str(tmp_path / f"l{tag}.csv"), links)
    for kind in "pl":
        assert (tmp_path / f"{kind}j.csv").read_bytes() == \
            (tmp_path / f"{kind}t.csv").read_bytes()
    for reader in (J, T):
        got = reader.load_poses(str(tmp_path / "pt.csv"))
        want = J.load_poses(str(tmp_path / "pj.csv"))
        assert sorted(got) == sorted(want) == [1, 2, 5]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        gl = reader.load_links(str(tmp_path / "lt.csv"))
        wl = J.load_links(str(tmp_path / "lj.csv"))
        assert [(x.from_id, x.to_id, x.type) for x in gl] == \
            [(x.from_id, x.to_id, x.type) for x in wl] == [(1, 2, 0),
                                                            (5, 1, 1)]
        for x, y in zip(gl, wl):
            np.testing.assert_array_equal(x.transform, y.transform)
            np.testing.assert_array_equal(x.info, y.info)


def _camera():
    from tpuslam_torch.io.synthetic import sequence_camera
    return sequence_camera(160, 120, 150.0, 0.54)


def _decimated_map(rng):
    d = rng.integers(-16, 900, (30, 40)).astype(np.int16)
    d[rng.uniform(size=d.shape) < 0.2] = -16
    return d


def test_project_disparity_grid_matches_reference():
    from tpuslam.mapping3d import occupancy as J
    from tpuslam_torch.mapping3d import occupancy as T
    from tpuslam_torch.geometry import transform as TT
    rng = np.random.default_rng(9)
    cam = _camera()
    pose = TT.from_rpy_xyz(0.1, -0.2, 0.05, 1.0, 2.0, -0.5)
    full = TT.compose(pose, cam.local_transform).astype(np.float32)[:3]
    origin = pose[:3, 3].astype(np.float32)
    d = _decimated_map(rng)
    cv = T._cam_vector(cam)
    pj, mj = J._project_disparity_grid(
        jnp.asarray(d), jnp.asarray(full), jnp.asarray(origin),
        jnp.asarray(cv), np.float32(25.0), 4)
    pt, mt = T._project_disparity_grid(
        torch.as_tensor(d), torch.as_tensor(full), torch.as_tensor(origin),
        torch.as_tensor(cv), 25.0, 4)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < int(mt.sum()) < mt.numel()
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)


def test_occupancy_grid_file_matches_reference(tmp_path):
    """build_occupancy_grid_map over a fake mapper (full and intermediate
    nodes): the same voxel keys and the same slam.bt bytes."""
    from tpuslam.mapping3d import build_occupancy_grid_map as J
    from tpuslam_torch.mapping3d import build_occupancy_grid_map as T
    from tpuslam_torch.geometry import transform as TT
    rng = np.random.default_rng(4)

    @dataclasses.dataclass
    class FakeFrame:
        disparity_dec: np.ndarray | None
        disp_scale: int = 4

    @dataclasses.dataclass
    class FakeNode:
        weight: int
        frame: FakeFrame

    class FakeMapper:
        nodes = {i: FakeNode(-1 if i == 2 else 0,
                             FakeFrame(_decimated_map(rng)))
                 for i in (1, 2, 3)}

    poses = {i: TT.from_rpy_xyz(0, 0, 0.1 * i, 0.3 * i, 0, 0)
             for i in (1, 2, 3)}
    gj = J(FakeMapper, poses, _camera(), out_path=str(tmp_path / "j.bt"))
    gt = T(FakeMapper, poses, _camera(), out_path=str(tmp_path / "t.bt"),
           device="cpu")
    assert gt.num_occupied == gj.num_occupied > 0
    np.testing.assert_array_equal(gt.occupied_keys, gj.occupied_keys)
    assert (tmp_path / "t.bt").read_bytes() == (tmp_path / "j.bt").read_bytes()
