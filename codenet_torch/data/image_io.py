"""PNG frames without OpenCV: `read_png` and `write_png`.

The port reads and writes the PNG files it needs (the synthetic sets of
tools_torch/synthetic_data.py, KITTI's frames) with the standard
library's zlib and numpy, so that it needs no image library. `read_png`
gives what ``cv2.imread(path)`` (IMREAD_COLOR) gives: BGR uint8 (H, W, 3),
grey replicated to three channels, alpha and palette transparency
dropped. It reads non-interlaced 8-bit images of colour type 0 (grey), 2
(RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA), each scanline
un-filtered by its own filter type (None, Sub, Up, Average, Paeth), and
raises ValueError naming anything else it meets (Adam7 interlacing, 16-
or sub-byte samples, a broken chunk).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per pixel of each 8-bit colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha",
                 6: "RGBA"}


def _chunks(data, path):
    """(type, payload) of every chunk after the signature, CRC checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError("{}: truncated PNG chunk {!r}".format(
                path, ctype))
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError("{}: bad CRC in PNG chunk {!r}".format(
                path, ctype))
        yield ctype, payload
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError("{}: PNG ends without an IEND chunk".format(path))


def _unfilter_rows(lines, ftypes, bpp):
    """Scanlines with no Average or Paeth row: None, Up and Sub are each
    one vector operation on a whole row."""
    out = np.empty_like(lines)
    up = np.zeros(lines.shape[1], np.uint8)
    for y, ftype in enumerate(ftypes):
        line = lines[y]
        if ftype == 0:
            out[y] = line
        elif ftype == 1:  # Sub: a running sum along each channel, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        else:  # Up
            out[y] = line + up
        up = out[y]
    return out


def _unfilter_wavefront(lines, ftypes, bpp):
    """Scanlines of any filter types, Average and Paeth among them.

    Pixel (r, i) depends on its left (r, i-1), upper (r-1, i) and
    upper-left (r-1, i-1) neighbours once un-filtered, so every pixel of
    one anti-diagonal r + i = d depends only on the diagonals before it.
    Row r is stored shifted right by r pixels (`rec`), which makes each
    diagonal a column: the image is un-filtered in H + W - 1 vector steps
    over the rows, each row by its own filter type, where a loop over
    bytes would take H * W * bpp."""
    height, stride = lines.shape
    width = stride // bpp
    # rec[r + 1, r + i + 2] is pixel (r, i); row 0 and the columns left of
    # each row's first pixel stay 0, the neighbours PNG gives the edges
    rec = np.zeros((height + 1, width + height + 2, bpp), np.int16)
    filt = np.zeros((height, width + height, bpp), np.int16)
    px = lines.reshape(height, width, bpp)
    for r in range(height):
        filt[r, r:r + width] = px[r]
    # None, Sub, Up and Average predict (wa * left + wb * up) >> 1
    ftypes = np.asarray(ftypes).reshape(height, 1)
    wa = np.array([0, 2, 0, 1, 0], np.int16)[ftypes]
    wb = np.array([0, 0, 2, 1, 0], np.int16)[ftypes]
    is_paeth = ftypes == 4
    for d in range(width + height - 1):
        r0, r1 = max(0, d - width + 1), min(height - 1, d) + 1
        a = rec[r0 + 1:r1 + 1, d + 1]  # left
        b = rec[r0:r1, d + 1]          # up
        c = rec[r0:r1, d]              # upper-left
        pred = a * wa[r0:r1]
        pred += b * wb[r0:r1]
        pred >>= 1
        # Paeth: whichever of left, up, upper-left is nearest to
        # left + up - upper-left (ties to left, then up)
        bc, ac = b - c, a - c
        pa, pb = np.abs(bc), np.abs(ac)
        pc = np.abs(bc + ac)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(is_paeth[r0:r1], paeth, pred)
        pred += filt[r0:r1, d]
        pred &= 0xFF
        rec[r0 + 1:r1 + 1, d + 2] = pred
    out = np.empty((height, width, bpp), np.uint8)
    for r in range(height):
        out[r] = rec[r + 1, r + 2:r + 2 + width]
    return out.reshape(height, stride)


def _unfilter(raw, height, stride, bpp, path):
    """(height, stride) uint8 samples of the decompressed scanlines, each
    a filter-type byte and `stride` filtered bytes."""
    if len(raw) != height * (stride + 1):
        raise ValueError("{}: PNG image data holds {} bytes, {} expected"
                         .format(path, len(raw), height * (stride + 1)))
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    ftypes, lines = rows[:, 0], rows[:, 1:]
    bad = np.flatnonzero(ftypes > 4)
    if bad.size:
        raise ValueError("{}: PNG scanline {} has filter type {}, not 0-4"
                         .format(path, bad[0], ftypes[bad[0]]))
    if height and ftypes.max() >= 3:
        return _unfilter_wavefront(lines, ftypes, bpp)
    return _unfilter_rows(lines, ftypes, bpp)


def read_png(path):
    """BGR uint8 (H, W, 3) pixels of the PNG file at `path`, as
    ``cv2.imread(path)`` gives them."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError("{}: not a PNG file".format(path))
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("{}: PNG has no IHDR chunk".format(path))
    width, height, depth, colour, compression, filt, interlace = header
    if interlace != 0:
        raise ValueError("{}: Adam7-interlaced PNG is not supported (only "
                         "non-interlaced)".format(path))
    if colour not in _CHANNELS:
        raise ValueError("{}: PNG colour type {} is not one of {}".format(
            path, colour, sorted(_CHANNELS)))
    if depth != 8:
        raise ValueError("{}: {}-bit {} PNG samples are not supported (only "
                         "8-bit)".format(path, depth, _COLOUR_NAMES[colour]))
    if compression != 0 or filt != 0:
        raise ValueError("{}: PNG compression method {} / filter method {} "
                         "(only 0 / 0)".format(path, compression, filt))
    if colour == 3 and palette is None:
        raise ValueError("{}: palette PNG without a PLTE chunk".format(path))
    bpp = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError("{}: PNG image data: {}".format(path, e)) from e
    px = _unfilter(raw, height, width * bpp, bpp, path).reshape(
        height, width, bpp)
    if colour == 3:
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError("{}: PNG palette index {} past its {} entries"
                             .format(path, int(idx.max()), len(palette)))
        rgb = palette[idx]
    elif colour in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path, bgr):
    """Write BGR uint8 (H, W, 3) pixels to `path` as an 8-bit RGB PNG:
    filter type 0 on every scanline, zlib level 6."""
    bgr = np.asarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError("write_png takes BGR uint8 (H, W, 3) pixels, got "
                         "{} {}".format(bgr.dtype, bgr.shape))
    height, width = bgr.shape[:2]
    rows = np.zeros((height, 1 + 3 * width), np.uint8)
    rows[:, 1:] = bgr[..., ::-1].reshape(height, -1)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
