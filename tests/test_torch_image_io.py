"""The port's PNG reader and writer (codenet_torch/data/image_io.py) and
its synthetic set (tools_torch/synthetic_data.py).

`read_png` is held equal to cv2.imread (IMREAD_COLOR) and to PIL on
files they wrote: grey, RGB, palette, grey + alpha and RGBA, every
scanline filter type, a 1-pixel-wide and a 375x500 frame, and on files
whose rows mix all five filter types; `write_png`
round trips exactly; what the reader does not read raises. The port's
synthetic generator makes the same numpy draws as tests/synthetic.py.
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

from test_torch_common import rng

from codenet_torch.data.image_io import read_png, write_png
from codenet_torch.engine import detector

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools_torch"))
import synthetic  # noqa: E402  (tests/synthetic.py, the JAX package's)
import synthetic_data  # noqa: E402  (the port's copy)


def _frame(h, w, seed):
    """Noise with a flat box and a ramp, so that every filter type has
    something to predict."""
    r = rng(seed)
    img = r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[h // 4:h // 2, :max(1, w // 2)] = (30, 200, 90)
    img[..., 0] = (img[..., 0] // 2 + np.arange(w)[None, :] % 97).astype(
        np.uint8)
    return img


def _header_and_filters(path):
    """IHDR fields and the set of scanline filter types of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif ctype == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    width, height, depth, colour = header[:4]
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    raw = zlib.decompress(idat)
    stride = width * channels * depth // 8
    return header, {raw[y * (stride + 1)] for y in range(height)}


SIZES = [(375, 500), (40, 1), (1, 7), (33, 29)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "{}x{}".format(*s))
@pytest.mark.parametrize("grey", [False, True], ids=["bgr", "grey"])
def test_read_png_equals_cv2_default_filters(tmp_path, size, grey):
    """Frames cv2 wrote with its default settings (colour types 2 and 0):
    read_png equals cv2.imread, and PIL."""
    img = _frame(*size, seed=1)
    if grey:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    path = str(tmp_path / "f.png")
    assert cv2.imwrite(path, img)
    header, _ = _header_and_filters(path)
    assert header[3] == (0 if grey else 2) and header[2] == 8
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == size + (3,)
    np.testing.assert_array_equal(got, cv2.imread(path))
    with Image.open(path) as im:
        np.testing.assert_array_equal(
            got, np.asarray(im.convert("RGB"))[..., ::-1])


FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]


@pytest.mark.parametrize("name", FILTERS)
def test_read_png_unfilters_every_filter_type(tmp_path, name):
    """cv2 told to write every scanline with one filter type (0-4): the
    file holds that type only, and read_png equals cv2.imread and the
    pixels written."""
    img = _frame(375, 500, seed=2)
    path = str(tmp_path / "f.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, getattr(
        cv2, "IMWRITE_PNG_FILTER_" + name)])
    _, filters = _header_and_filters(path)
    assert filters == {FILTERS.index(name)}
    got = read_png(path)
    np.testing.assert_array_equal(got, cv2.imread(path))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode,colour", [("P", 3), ("RGBA", 6), ("L", 0),
                                         ("LA", 4)])
@pytest.mark.parametrize("size", [(375, 500), (40, 1)],
                         ids=lambda s: "{}x{}".format(*s))
def test_read_png_equals_cv2_on_pil_frames(tmp_path, mode, colour, size):
    """PIL's palette (256 colours: 8-bit indices), RGBA, grey and grey +
    alpha frames: read_png equals cv2.imread (alpha dropped, palette
    looked up, grey replicated) and PIL's RGB conversion. PIL filters
    adaptively, so its files mix filter types."""
    img = _frame(*size, seed=3)
    alpha = rng(4).randint(0, 256, size + (1,)).astype(np.uint8)
    im = Image.fromarray(np.concatenate([img[..., ::-1], alpha], axis=2),
                         "RGBA")
    if mode == "P":
        im = im.convert("RGB").convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=256)
    elif mode != "RGBA":
        im = im.convert(mode)
    path = str(tmp_path / "f.png")
    im.save(path)
    header, _ = _header_and_filters(path)
    assert header[2:4] == (8, colour)
    got = read_png(path)
    np.testing.assert_array_equal(got, cv2.imread(path))
    with Image.open(path) as back:
        np.testing.assert_array_equal(
            got, np.asarray(back.convert("RGB"))[..., ::-1])


def _filtered_rows(img, kinds):
    """The scanlines of RGB uint8 `img`, row y filtered with filter type
    kinds[y] (PNG's predictors on the unfiltered neighbours)."""
    h, w, bpp = img.shape
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    k = np.asarray(kinds)
    rows = (x - preds[k, np.arange(h)]) & 0xFF
    return np.concatenate([k[:, None].astype(np.uint8),
                           rows.reshape(h, -1).astype(np.uint8)], axis=1)


@pytest.mark.parametrize("size", SIZES + [(375, 1242)],
                         ids=lambda s: "{}x{}".format(*s))
def test_read_png_unfilters_mixed_filter_rows(tmp_path, size):
    """Every scanline with a filter type of its own, drawn at random, so
    that Average and Paeth rows sit next to rows of each other type:
    read_png gives the pixels filtered, and equals cv2.imread."""
    img = _frame(*size, seed=6)
    h, w = size
    kinds = rng(7).randint(0, 5, h)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        for ctype, payload in ((b"IHDR", ihdr), (b"IDAT", zlib.compress(
                _filtered_rows(img[..., ::-1], kinds).tobytes())),
                               (b"IEND", b"")):
            f.write(struct.pack(">I", len(payload)) + ctype + payload
                    + struct.pack(">I", zlib.crc32(ctype + payload)))
    assert _header_and_filters(path)[1] == set(kinds.tolist())
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, cv2.imread(path))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "{}x{}".format(*s))
def test_write_png_round_trip_is_exact(tmp_path, size):
    """write_png -> read_png gives the pixels back, and cv2 and PIL read
    the same: an 8-bit RGB file, filter 0 on every scanline."""
    img = _frame(*size, seed=5)
    path = str(tmp_path / "f.png")
    write_png(path, img)
    header, filters = _header_and_filters(path)
    assert header[:5] == (size[1], size[0], 8, 2, 0) and filters == {0}
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(cv2.imread(path), img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im)[..., ::-1], img)


def _rewrite_ihdr(src, dst, **fields):
    """A copy of PNG `src` with IHDR fields replaced (CRC recomputed)."""
    with open(src, "rb") as f:
        data = bytearray(f.read())
    names = ("width", "height", "depth", "colour", "compression", "filter",
             "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    values.update(fields)
    data[16:29] = struct.pack(">IIBBBBB", *(values[n] for n in names))
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with open(dst, "wb") as f:
        f.write(bytes(data))


def test_unsupported_pngs_raise(tmp_path):
    """Adam7 interlacing, 16-bit samples (cv2 writes uint16 so), a 4-bit
    palette (PIL writes 16 colours so), a broken CRC and a file that is
    not a PNG each raise ValueError naming what was met."""
    img = _frame(24, 32, seed=6)
    good = str(tmp_path / "good.png")
    write_png(good, img)
    adam7 = str(tmp_path / "adam7.png")
    _rewrite_ihdr(good, adam7, interlace=1)
    with pytest.raises(ValueError, match="Adam7"):
        read_png(adam7)

    deep = str(tmp_path / "deep.png")
    assert cv2.imwrite(deep, img.astype(np.uint16) * 257)
    assert _header_and_filters(deep)[0][2] == 16
    with pytest.raises(ValueError, match="16-bit"):
        read_png(deep)

    small = str(tmp_path / "small.png")
    Image.fromarray(img[..., ::-1]).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=16).save(small)
    assert _header_and_filters(small)[0][2] == 4
    with pytest.raises(ValueError, match="4-bit palette"):
        read_png(small)

    with open(good, "rb") as f:
        data = bytearray(f.read())
    data[45] ^= 0xFF  # inside the IDAT payload
    broken = str(tmp_path / "broken.png")
    with open(broken, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(broken)

    text = str(tmp_path / "text.png")
    with open(text, "w") as f:
        f.write("not an image")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(text)


def test_imread_reads_png_without_cv2(tmp_path, monkeypatch):
    """engine/detector.py::imread reads a PNG with read_png, cv2 importable
    or not; another format still needs cv2 and names the file when it is
    missing."""
    img = _frame(30, 40, seed=7)
    paths = [str(tmp_path / "f.png"), str(tmp_path / "G.PNG")]
    for path in paths:
        write_png(path, img)
    jpg = str(tmp_path / "f.jpg")
    assert cv2.imwrite(jpg, img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for path in paths:
        np.testing.assert_array_equal(detector.imread(path), img)
    with pytest.raises(RuntimeError, match="f.jpg"):
        detector.imread(jpg)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("adversarial", [False, True])
def test_gen_images_equals_tests_synthetic(seed, adversarial):
    """The port's _gen_images makes the draws of tests/synthetic.py's:
    equal pixels and annotations, the images' records equal but for the
    file name's extension (.png)."""
    kw = dict(num_images=6, img_w=160, img_h=120, first_id=3,
              max_objects=5 if adversarial else 3, num_classes=20,
              min_side=8 if adversarial else 16, adversarial=adversarial)
    ref = synthetic._gen_images(np.random.RandomState(seed), **kw)
    out = synthetic_data._gen_images(np.random.RandomState(seed), **kw)
    assert out[1] == ref[1] and len(out[1]) >= 6
    assert [dict(i, file_name=i["file_name"][:-4]) for i in out[0]] == \
        [dict(i, file_name=i["file_name"][:-4]) for i in ref[0]]
    assert all(i["file_name"].endswith(".png") for i in out[0])
    for (name, a), (_, b) in zip(out[2], ref[2]):
        assert name.endswith(".png")
        np.testing.assert_array_equal(a, b)


def test_make_voc_dataset_writes_tests_synthetic_set_as_png(tmp_path):
    """make_voc_dataset with a held-out split: the annotations of
    tests/synthetic.py's set, the json naming .png files whose pixels,
    read back with read_png, are its frames."""
    kw = dict(num_images=4, img_w=160, img_h=120, seed=2, test_images=3,
              num_classes=20, min_side=8, max_objects=5, adversarial=True)
    root = synthetic_data.make_voc_dataset(str(tmp_path), **kw)
    rs, rs_test = np.random.RandomState(2), np.random.RandomState(3)
    common = dict(img_w=160, img_h=120, max_objects=5, num_classes=20,
                  min_side=8, adversarial=True)
    ref = {"trainval0712": synthetic._gen_images(rs, 4, first_id=1,
                                                 **common),
           "test2007": synthetic._gen_images(rs_test, 3, first_id=5,
                                             **common)}
    import json
    for split, (images, anns, pixels) in ref.items():
        with open(os.path.join(root, "annotations",
                               "pascal_{}.json".format(split))) as f:
            db = json.load(f)
        assert db["annotations"] == anns
        assert [i["file_name"] for i in db["images"]] == \
            ["{:06d}.png".format(i["id"]) for i in images]
        for info, (_, img) in zip(db["images"], pixels):
            np.testing.assert_array_equal(read_png(os.path.join(
                root, "images", info["file_name"])), img)
