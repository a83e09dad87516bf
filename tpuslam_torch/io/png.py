"""8-bit PNG read and 8-bit grayscale PNG write on the standard library's
zlib.

The port reads KITTI-layout sequences without Pillow.  `decode` reads
non-interlaced 8-bit PNGs of colour types 0, 2, 4 and 6 (gray, RGB,
gray+alpha, RGBA) with any of the five row filters (PNG spec section 9.2):
None and Up as whole-row array operations, Sub as a uint8 cumulative sum
along each channel of the row, Average and Paeth pixel by pixel along each
channel, since each byte there depends on the decoded one a pixel to its
left.  `luma` converts a decoded colour image to gray as Pillow's
convert("L") does.  The sequence readers decode through the native loader
(io/native_loader.py); this decoder serves colour files in `load_gray` and
the tests as an independent oracle.

libpng and Pillow choose a filter per row, so a file they wrote mixes all
five, mostly Paeth on a photograph.  `write_png` chooses as they do: per
row the filter whose output bytes, read as signed, have the least sum of
absolute values.  So a written sequence decodes at the cost of a libpng-
or Pillow-written one.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# bytes per pixel of each colour type read: gray, RGB, gray+alpha, RGBA
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of every chunk after the signature."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def layout(data: bytes):
    """(width, height, bytes per pixel) of an 8-bit non-interlaced PNG of
    colour type 0, 2, 4 or 6; raises for any other kind."""
    kind, ihdr = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG without IHDR first")
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or colour not in CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"PNG bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}: only 8-bit, not interlaced, colour types 0, 2, "
            f"4 and 6 are read")
    return w, h, CHANNELS[colour]


def _header(data: bytes):
    """(width, height) of a PNG that `decode` reads; raises for any other
    kind."""
    return layout(data)[:2]


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG file, read from its header."""
    with open(path, "rb") as f:
        return _header(f.read(64))


def _average_row(raw: list, prior: list) -> list:
    out = [0] * len(raw)
    a = 0
    for i, (x, b) in enumerate(zip(raw, prior)):
        a = (x + ((a + b) >> 1)) & 255
        out[i] = a
    return out


def _paeth_row(raw: list, prior: list) -> list:
    out = [0] * len(raw)
    a = c = 0
    for i, (x, b) in enumerate(zip(raw, prior)):
        pa = b - c if b >= c else c - b          # |p - a|, p = a + b - c
        pb = a - c if a >= c else c - a          # |p - b|
        pc = abs(a + b - c - c)                  # |p - c|
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        a = (x + pred) & 255
        out[i] = a
        c = b
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W) uint8 image for gray, (H, W, C) for the
    colour types of C = 3 (RGB), 2 (gray+alpha) and 4 (RGBA) channels."""
    w, h, ch = layout(data)
    stride = w * ch
    idat = b"".join(p for k, p in _chunks(data) if k == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, not "
                         f"{h} rows of 1 + {stride}")
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:                            # None
            out[y] = raw
        elif kind == 1:                          # Sub
            np.cumsum(raw.reshape(w, ch), axis=0, dtype=np.uint8,
                      out=out[y].reshape(w, ch))
        elif kind == 2:                          # Up
            np.add(raw, prior, out=out[y])
        elif kind in (3, 4):                     # Average, Paeth
            # each channel unfilters on its own bytes alone
            unfilter = _average_row if kind == 3 else _paeth_row
            for c in range(ch):
                out[y, c::ch] = unfilter(raw[c::ch].tolist(),
                                         prior[c::ch].tolist())
        else:
            raise ValueError(f"PNG row {y}: unknown filter {kind}")
        prior = out[y]
    return out if ch == 1 else out.reshape(h, w, ch)


def luma(img: np.ndarray) -> np.ndarray:
    """A decoded image as Pillow's convert("L") makes it gray: gray stays,
    gray+alpha keeps its gray byte, RGB and RGBA (alpha ignored) take the
    ITU-R 601-2 luma in Pillow's integer form,
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return img[..., 0].copy()
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16) \
        .astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A PNG file -> its `decode`d image."""
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload +
            struct.pack(">I", zlib.crc32(kind + payload)))


def _filtered(img: np.ndarray) -> np.ndarray:
    """(5, H, W) uint8: every row of an (H, W) uint8 image under each of
    the five filters, None, Sub, Up, Average, Paeth (PNG spec 9.2)."""
    x = img.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return (np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) &
            255).astype(np.uint8)


def encode(img: np.ndarray, level: int = 6,
           row_filter: int | None = None) -> bytes:
    """(H, W) uint8 image -> PNG file bytes, deflated at zlib `level`.
    Each row goes under the filter whose output has the least sum of
    absolute values as signed bytes (libpng's and Pillow's choice), or
    under `row_filter` (0-4) when that is given."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {img.shape}")
    h, w = img.shape
    cand = _filtered(img)
    if row_filter is None:
        kind = np.minimum(cand, 256 - cand.astype(np.int32)).sum(axis=2) \
            .argmin(axis=0)
    else:
        kind = np.full(h, row_filter)
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = cand[kind, np.arange(h)]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) +
            _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) +
            _chunk(b"IEND", b""))


def row_filters(data: bytes) -> np.ndarray:
    """The filter type (0-4) of every row of a PNG file's bytes."""
    w, h, ch = layout(data)
    idat = b"".join(p for k, p in _chunks(data) if k == b"IDAT")
    return np.frombuffer(zlib.decompress(idat),
                         np.uint8)[::w * ch + 1][:h].copy()


def write_png(path: str, img: np.ndarray, level: int = 6,
              row_filter: int | None = None) -> None:
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG file (rows
    filtered as `encode` says)."""
    with open(path, "wb") as f:
        f.write(encode(img, level, row_filter))
