"""PNG read (every kind) and 8-bit grayscale PNG write on the standard
library's zlib.

The port reads KITTI-layout sequences without Pillow.  `decode` reads
PNGs of every bit depth (1, 2, 4, 8, 16) and colour type (gray, RGB,
palette, gray+alpha, RGBA), not interlaced or Adam7-interlaced, with any
of the five row filters (PNG spec section 9.2): None and Up as whole-row
array operations, Sub as a uint8 cumulative sum along each byte of a
pixel, Average and Paeth byte by byte along each byte of a pixel, since
each byte there depends on the decoded one a pixel to its left.  `gray`
converts a file to what Pillow 12's `Image.open(f).convert("L")` gives
(`luma` is its RGB rule).  The sequence readers decode through the native
loader (io/native_loader.py), which reads 8-bit non-interlaced gray; this
decoder serves every other kind in `load_gray` and the tests as an
independent oracle.

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
# samples per pixel of each colour type: gray, RGB, palette index,
# gray+alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths each colour type may have (PNG spec table 11.1)
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7's passes: first column, first row, column step, row step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def header(data: bytes):
    """(width, height, bit depth, colour type, interlace) of a PNG file's
    bytes (the first 33 suffice); raises ValueError for a kind the PNG
    spec does not define."""
    kind, ihdr = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG without IHDR first")
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth not in DEPTHS.get(colour, ()) or interlace not in (0, 1):
        raise ValueError(f"PNG bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}: not a PNG kind")
    return w, h, depth, colour, interlace


def layout(data: bytes):
    """(width, height, bytes per pixel) of an 8-bit non-interlaced PNG of
    colour type 0, 2, 4 or 6, the kinds whose bytes are their samples;
    raises NotImplementedError for any other kind."""
    w, h, depth, colour, interlace = header(data)
    if depth != 8 or colour == 3 or interlace != 0:
        raise NotImplementedError(
            f"PNG bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}: not 8-bit, not interlaced, colour type 0, 2, 4 "
            f"or 6")
    return w, h, CHANNELS[colour]


def _header(data: bytes):
    """(width, height) of a PNG file's bytes."""
    return header(data)[:2]


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


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines -> (h, stride) bytes; `bpp`
    bytes per pixel (at least 1), the distance a filter looks left."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:                            # None
            out[y] = raw
        elif kind == 1:                          # Sub
            np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8,
                      out=out[y].reshape(-1, bpp))
        elif kind == 2:                          # Up
            np.add(raw, prior, out=out[y])
        elif kind in (3, 4):                     # Average, Paeth
            # each byte of a pixel unfilters on its own lane alone
            unfilter = _average_row if kind == 3 else _paeth_row
            for c in range(bpp):
                out[y, c::bpp] = unfilter(raw[c::bpp].tolist(),
                                          prior[c::bpp].tolist())
        else:
            raise ValueError(f"PNG row {y}: unknown filter {kind}")
        prior = out[y]
    return out


def _samples(raw: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, w, ch) samples: uint8 for 1-8
    bits (the values themselves, unscaled), big-endian uint16 for 16."""
    h = raw.shape[0]
    if depth == 16:
        return raw.view(">u2").astype(np.uint16).reshape(h, -1)[
            :, :w * ch].reshape(h, w, ch)
    if depth < 8:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        raw = ((raw[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, raw.shape[1] * per)
    return raw[:, :w * ch].reshape(h, w, ch)


def _read(data: bytes):
    """(header, (H, W, C) samples, PLTE payload) of a PNG file's bytes."""
    w, h, depth, colour, interlace = hdr = header(data)
    ch = CHANNELS[colour]
    bpp = max(1, ch * depth // 8)
    idat = b"".join(p for k, p in _chunks(data) if k == b"IDAT")
    plte = b"".join(p for k, p in _chunks(data) if k == b"PLTE")
    flat = np.frombuffer(zlib.decompress(idat), np.uint8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue                 # an empty pass has no scanlines
        stride = -(-pw * ch * depth // 8)
        n = ph * (stride + 1)
        if flat.size < pos + n:
            raise ValueError(f"PNG data holds {flat.size} bytes, fewer "
                             f"than its scanlines need")
        rows = _unfilter(flat[pos:pos + n].reshape(ph, stride + 1), bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
        pos += n
    if pos != flat.size:
        raise ValueError(f"PNG data holds {flat.size} bytes, not the "
                         f"{pos} of its scanlines")
    return hdr, out, plte


def decode(data: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W) samples for gray and palette indices,
    (H, W, C) for the colour types of C = 3 (RGB), 2 (gray+alpha) and 4
    (RGBA) channels: uint8 at bit depths 1-8 (values unscaled), uint16 at
    16."""
    _, out, _ = _read(data)
    return out[..., 0] if out.shape[2] == 1 else out


def luma(img: np.ndarray) -> np.ndarray:
    """A decoded 8-bit image as Pillow's convert("L") makes it gray: gray
    stays, gray+alpha keeps its gray byte, RGB and RGBA (alpha ignored)
    take the ITU-R 601-2 luma in Pillow's integer form,
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return img[..., 0].copy()
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16) \
        .astype(np.uint8)


def gray(data: bytes) -> np.ndarray:
    """PNG file bytes -> the (H, W) uint8 image that Pillow 12's
    convert("L") gives.  Pillow's rules (tests/test_torch_io.py holds
    them): gray of 1, 2 and 4 bits scaled to 0-255 (x 255, 85, 17); 16-bit
    gray clipped to 255 (mode I;16 to L); the other 16-bit kinds keep the
    high byte of each sample; palette indices look up PLTE (missing
    entries black), then luma; transparency (tRNS) changes no value."""
    (_, _, depth, colour, _), s, plte = _read(data)
    if colour == 0:
        g = s[..., 0]
        if depth == 16:
            return np.minimum(g, 255).astype(np.uint8)
        return (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if colour == 3:
        pal = np.zeros((256, 3), np.uint8)
        n = min(len(plte) // 3, 256)
        pal[:n] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
        return luma(pal[s[..., 0]])
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
    return luma(s)


def read_png(path: str) -> np.ndarray:
    """A PNG file -> its `decode`d image."""
    with open(path, "rb") as f:
        return decode(f.read())


def read_gray(path: str) -> np.ndarray:
    """A PNG file -> its `gray` image."""
    with open(path, "rb") as f:
        return gray(f.read())


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
