"""The port's image decoder (``models/image_decode.py``) against Pillow, and
its image embedder against the JAX package's.

The JAX embedder decodes with Pillow: ``Image.open(...).convert("L")
.resize((64, 64), BILINEAR)``.  The port decodes PNG, BMP and baseline
JPEG itself with numpy, zlib and struct; every supported variant must
give Pillow's pixels bit for bit, so both embedders give the same bits.
Images are seeded smooth patterns with noise, 1 x 5 to 256 x 256.
"""

import io
import re
import struct
import sys
import zlib

import numpy as np
import pytest

from super_rag_tpu.models.image_embedder import ImageEmbedder as JImageEmbedder
from super_rag_tpu_torch.models import image_decode as dec
from super_rag_tpu_torch.models.image_embedder import ImageEmbedder

Image = pytest.importorskip("PIL.Image")

SIZES = [(64, 96), (17, 23), (31, 45), (100, 75), (256, 256), (1, 5), (65, 129)]


def smooth_image(h, w, seed=0):
    """[h, w, 3] uint8: seeded sines plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (3 + seed % 7) + c) * 60
                     + np.cos(yy / (5 + c + seed % 3)) * 60 + 128 for c in range(3)], -1)
    base += rng.integers(-30, 30, base.shape)
    return np.clip(base, 0, 255).astype(np.uint8)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_row(ft, row, prior, bpp):
    row = row.astype(np.int64)
    prior = prior.astype(np.int64)
    if ft == 0:
        return row
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if ft == 1:
        return row - left
    if ft == 2:
        return row - prior
    if ft == 3:
        return row - (left + prior) // 2
    p = left + prior - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
    return row - pred


def png_bytes(arr, filters=(0, 1, 2, 3, 4)):
    """An 8-bit RGB (or grey for 2-D ``arr``) PNG written with zlib and
    struct, its rows filtered by the types in ``filters`` in turn."""
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = arr.reshape(h, w * ch)
    raw = bytearray()
    prior = np.zeros(w * ch, np.uint8)
    for y in range(h):
        ft = filters[y % len(filters)]
        raw.append(ft)
        raw += (_filter_row(ft, rows[y], prior, ch) & 0xFF).astype(np.uint8).tobytes()
        prior = rows[y]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(raw), 6)) + _chunk(b"IEND", b""))


def bmp_bytes(arr, bits=24, top_down=False):
    """A BI_RGB BMP of an [h, w, 3] image, 24 or 32 bits a pixel."""
    h, w = arr.shape[:2]
    bpp = bits // 8
    stride = (w * bpp + 3) & ~3
    px = arr[..., ::-1]
    if bpp == 4:
        px = np.concatenate([px, np.full((h, w, 1), 7, np.uint8)], axis=2)
    rows = px if top_down else px[::-1]
    body = b"".join(r.tobytes() + bytes(stride - w * bpp) for r in rows)
    header = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0,
                         len(body), 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 14 + 40 + len(body), 0, 0, 54) + header + body


def pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def pil_gray(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("L"))


def pil_gray64(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("L").resize(
        (64, 64), Image.BILINEAR))


def assert_pillow_pixels(data):
    np.testing.assert_array_equal(dec.decode_gray(data), pil_gray(data))
    np.testing.assert_array_equal(dec.gray64(data), pil_gray64(data))


def _mode_image(arr, mode):
    if mode == "RGBA":
        return Image.fromarray(np.concatenate([arr, arr[..., :1]], -1), "RGBA")
    if mode == "LA":
        return Image.fromarray(np.stack([arr[..., 0], arr[..., 1]], -1), "LA")
    if mode == "P":
        return Image.fromarray(arr).quantize(16)
    return Image.fromarray(arr).convert(mode)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_png_matches_pillow(mode, size):
    assert_pillow_pixels(pil_bytes(_mode_image(smooth_image(*size, seed=3), mode), "PNG"))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("transparency", [False, True])
def test_low_bit_palette_png_matches_pillow(bits, transparency):
    img = Image.fromarray(smooth_image(37, 53, seed=bits)).quantize(2 ** bits)
    kw = {"transparency": 0} if transparency else {}
    assert_pillow_pixels(pil_bytes(img, "PNG", bits=bits, **kw))


@pytest.mark.parametrize("bits", [2, 4])
def test_low_bit_grey_png_matches_pillow(bits):
    arr = (smooth_image(29, 41, seed=bits)[..., 0] >> (8 - bits)).astype(np.uint8)
    rows = np.packbits(np.unpackbits(arr[..., None], axis=2)[..., 8 - bits:]
                       .reshape(29, -1), axis=1)
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 41, 29, bits, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    assert_pillow_pixels(data)


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_filter_types_match_pillow(ft, channels):
    arr = smooth_image(33, 47, seed=ft)
    if channels == 1:
        arr = arr[..., 0]
    elif channels == 2:
        arr = arr[..., :2]
    elif channels == 4:
        arr = np.concatenate([arr, arr[..., :1]], -1)
    assert_pillow_pixels(png_bytes(arr, filters=(ft,)))


@pytest.mark.parametrize("size", SIZES)
def test_bmp_matches_pillow(size):
    arr = smooth_image(*size, seed=5)
    assert_pillow_pixels(pil_bytes(Image.fromarray(arr), "BMP"))
    for bits in (24, 32):
        for top_down in (False, True):
            assert_pillow_pixels(bmp_bytes(arr, bits, top_down))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_matches_pillow(size, quality, subsampling):
    img = Image.fromarray(smooth_image(*size, seed=7))
    assert_pillow_pixels(pil_bytes(img, "JPEG", quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("size", SIZES)
def test_jpeg_variants_match_pillow(size):
    arr = smooth_image(*size, seed=11)
    assert_pillow_pixels(pil_bytes(Image.fromarray(arr[..., 1]), "JPEG", quality=90))
    assert_pillow_pixels(pil_bytes(Image.fromarray(arr), "JPEG", quality=85,
                                   restart_marker_blocks=3))
    assert_pillow_pixels(pil_bytes(Image.fromarray(arr), "JPEG", quality=85,
                                   restart_marker_rows=1, subsampling=2))
    assert_pillow_pixels(pil_bytes(Image.fromarray(arr), "JPEG", quality=80,
                                   optimize=True))


@pytest.mark.parametrize("h,w", [(64, 64), (17, 23), (64, 200), (300, 64), (1, 1),
                                 (255, 3), (128, 96)])
def test_resize_matches_pillow(h, w):
    arr = smooth_image(h, w, seed=h)[..., 2]
    for tw, th in ((64, 64), (33, 80), (w, 17)):
        got = dec.resize_bilinear(arr, tw, th)
        ref = np.asarray(Image.fromarray(arr).resize((tw, th), Image.BILINEAR))
        np.testing.assert_array_equal(got, ref)


def _embed_inputs():
    arr = smooth_image(120, 90, seed=13)
    return [png_bytes(arr), pil_bytes(Image.fromarray(arr), "PNG"),
            bmp_bytes(arr, 32, True),
            pil_bytes(Image.fromarray(arr), "JPEG", quality=90),
            pil_bytes(Image.fromarray(arr), "JPEG", quality=75, subsampling=1),
            pil_bytes(Image.fromarray(arr[..., 0]), "JPEG"),
            b"not an image", b"\x89PNG\r\n\x1a\n" + b"\x00" * 30]


@pytest.mark.parametrize("dim", [16, 256])
def test_image_embedder_matches_jax(dim):
    imgs = _embed_inputs()
    got = ImageEmbedder(dim=dim).embed(imgs)
    np.testing.assert_array_equal(got, JImageEmbedder(dim=dim).embed(imgs))
    assert not got[-2:].any() and got[:-2].any(axis=1).all()


def test_image_embedder_works_without_pillow(monkeypatch):
    imgs = _embed_inputs()
    ref = JImageEmbedder(dim=64).embed(imgs)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    np.testing.assert_array_equal(ImageEmbedder(dim=64).embed(imgs), ref)
    assert not JImageEmbedder(dim=64).embed(imgs).any()  # C6: zeros without Pillow


def _interlaced_png():
    """An Adam7-interlaced 8-bit RGB PNG (every pass unfiltered)."""
    arr = smooth_image(13, 11, seed=1)
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = arr[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + r.tobytes() for r in sub)
    ihdr = struct.pack(">IIBBBBB", 11, 13, 8, 2, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _refused():
    arr = smooth_image(24, 24, seed=2)
    img = Image.fromarray(arr)
    out = {
        "progressive JPEG": pil_bytes(img, "JPEG", progressive=True),
        "GIF": pil_bytes(img.quantize(8), "GIF"),
        "TIFF": pil_bytes(img, "TIFF"),
        "16-bit PNG": pil_bytes(Image.fromarray(arr[..., 0].astype(np.uint16) * 200),
                                "PNG"),
        "interlaced PNG": _interlaced_png(),
        "8-bit BMP": pil_bytes(img.quantize(8), "BMP"),
        "CMYK JPEG": pil_bytes(img.convert("CMYK"), "JPEG"),
    }
    try:
        out["WebP"] = pil_bytes(img, "WEBP")
    except (KeyError, OSError):
        pass
    return out


@pytest.mark.parametrize("name", list(_refused()))
def test_refused_formats_raise(name):
    data = _refused()[name]
    np.asarray(Image.open(io.BytesIO(data)).convert("L"))  # Pillow reads it
    with pytest.raises(dec.UnsupportedImageError):
        dec.decode_gray(data)
    with pytest.raises(dec.UnsupportedImageError):
        ImageEmbedder(dim=16).embed([data])


def test_non_images_embed_to_zeros():
    arr = smooth_image(40, 40, seed=9)
    png = pil_bytes(Image.fromarray(arr), "PNG")
    jpg = pil_bytes(Image.fromarray(arr), "JPEG")
    bmp = bmp_bytes(arr)
    broken = [b"not an image", b"", png[:len(png) // 2], jpg[:len(jpg) // 2],
              bmp[:len(bmp) // 2], png[:40], jpg[:30], b"BM" + bytes(10),
              b"\xff\xd8\xff\xe0" + bytes(60)]
    for data in broken:
        with pytest.raises(dec.ImageDecodeError):
            dec.decode_gray(data)
    got = ImageEmbedder(dim=32).embed(broken)
    assert not got.any()
    np.testing.assert_array_equal(got, JImageEmbedder(dim=32).embed(broken))


# -- corrupt and oversized input ------------------------------------------------------


def _fuzz_bases():
    arr = smooth_image(40, 56, seed=3)
    img = Image.fromarray(arr)
    return {
        "png_rgb": png_bytes(arr), "png_grey": png_bytes(arr[..., 0]),
        "png_palette": pil_bytes(img.quantize(16), "PNG"),
        "bmp24": bmp_bytes(arr), "bmp32": bmp_bytes(arr, bits=32, top_down=True),
        "jpeg420": pil_bytes(img, "JPEG", quality=90),
        "jpeg444": pil_bytes(img, "JPEG", quality=75, subsampling=0),
        "jpeg_grey": pil_bytes(Image.fromarray(arr[..., 1]), "JPEG", quality=80),
        "jpeg_restart": pil_bytes(img, "JPEG", quality=90, restart_marker_blocks=2),
    }


MUTATIONS = ["bit_flips", "truncation", "header_bytes"]


def _mutate(data, kind, rng):
    b = bytearray(data)
    if kind == "bit_flips":
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        return bytes(b)
    if kind == "truncation":
        return bytes(b[:int(rng.integers(0, len(b)))])
    for _ in range(2):  # header fields set to 0xFF
        b[int(rng.integers(0, min(len(b), 64)))] = 0xFF
    return bytes(b)


def _jpeg_scan_runs_to_the_end(data):
    """A JPEG whose entropy-coded data is followed by no marker at all."""
    at = data.find(b"\xff\xda")
    if not data.startswith(b"\xff\xd8\xff") or at < 0 or at + 4 > len(data):
        return False
    start = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    return re.search(rb"\xff+[\x01-\xfe]", data[start:]) is None


@pytest.mark.parametrize("kind", MUTATIONS)
@pytest.mark.parametrize("name", list(_fuzz_bases()))
def test_corrupt_images_embed_as_the_reference(name, kind):
    """Seeded corruptions of every decoded format raise only the decoder's
    two errors, and embed to the JAX embedder's bits: zeros where Pillow
    fails, libjpeg's repaired pixels where it repairs corrupt JPEG data.
    A refused format raises instead; a JPEG whose scan runs to the end of
    the file with no marker after it embeds to zeros (ROADMAP C)."""
    rng = np.random.default_rng([zlib.crc32(name.encode()), MUTATIONS.index(kind)])
    data = _fuzz_bases()[name]
    port, ref = ImageEmbedder(dim=32), JImageEmbedder(dim=32)
    compared = 0
    for _ in range(25):
        bad = _mutate(data, kind, rng)
        try:
            dec.decode_gray(bad)
        except dec.UnsupportedImageError:
            with pytest.raises(dec.UnsupportedImageError):
                port.embed([bad])
            continue
        except dec.ImageDecodeError:
            assert not port.embed([bad]).any()
            if kind != "truncation" and _jpeg_scan_runs_to_the_end(bad):
                continue
        np.testing.assert_array_equal(port.embed([bad]), ref.embed([bad]))
        compared += 1
    assert compared >= 15


def _oversized():
    arr = smooth_image(16, 16, seed=4)
    jpg = bytearray(pil_bytes(Image.fromarray(arr), "JPEG", quality=90))
    sof = jpg.index(b"\xff\xc0")
    jpg[sof + 5:sof + 9] = struct.pack(">HH", 3000, 60000)  # 180M pixels
    ihdr = struct.pack(">IIBBBBB", 70000, 70000, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", zlib.compress(bytes(1000))) + _chunk(b"IEND", b""))
    bmp = bytearray(bmp_bytes(arr))
    bmp[18:26] = struct.pack("<ii", 20000, -20000)
    return {"jpeg": bytes(jpg), "png": png, "bmp": bytes(bmp)}


@pytest.mark.parametrize("name", list(_oversized()))
def test_oversized_headers_are_refused_before_decoding(name):
    """A header that claims more than Pillow's decompression-bomb limit is
    refused from the header alone, as Pillow refuses it: zeros in both."""
    data = _oversized()[name]
    with pytest.raises(dec.ImageDecodeError, match="pixel limit"):
        dec.decode_gray(data)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    got = ImageEmbedder(dim=32).embed([data])
    assert not got.any()
    np.testing.assert_array_equal(got, JImageEmbedder(dim=32).embed([data]))


@pytest.mark.parametrize("band", [50, 333])
def test_banded_decoding_matches_pillow(monkeypatch, band):
    """Whole-image work runs in bands of rows; small bands give the same
    pixels as one band."""
    monkeypatch.setattr(dec, "_BAND_PIXELS", band)
    arr = smooth_image(37, 61, seed=5)
    img = Image.fromarray(arr)
    for data in [pil_bytes(img, "JPEG", quality=90, subsampling=s) for s in (0, 1, 2)] + [
            png_bytes(arr), bmp_bytes(arr), pil_bytes(img.quantize(7), "PNG"),
            pil_bytes(img.convert("1"), "PNG")]:
        np.testing.assert_array_equal(dec.decode_gray(data), pil_gray(data))
        np.testing.assert_array_equal(dec.gray64(data), pil_gray64(data))


@pytest.mark.parametrize("at", [0.3, 0.6])
def test_invalid_huffman_codes_follow_libjpeg(at):
    """A run of one bits is no code in any table: libjpeg reads it as the
    symbol 0 after 17 bits and decodes on; the pixels match Pillow's."""
    arr = smooth_image(48, 64, seed=6)
    data = pil_bytes(Image.fromarray(arr), "JPEG", quality=90)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    cut = start + int((len(data) - 2 - start) * at)
    while data[cut - 1] == 0xFF:
        cut += 1
    bad = data[:cut] + b"\xff\x00" * 6 + data[cut:]
    np.testing.assert_array_equal(dec.decode_gray(bad), pil_gray(bad))
    np.testing.assert_array_equal(ImageEmbedder(dim=32).embed([bad]),
                                  JImageEmbedder(dim=32).embed([bad]))
