"""Image decoding for the image embedder, with numpy, zlib and struct only.

``gray64(data)`` returns the 64 x 64 8-bit grayscale pixels that Pillow
gives for ``Image.open(...).convert("L").resize((64, 64), Image.BILINEAR)``,
bit for bit, for the formats decoded here:

- PNG: colour types 0, 2, 3, 4 and 6; bit depth 8, and palette / grey at
  1, 2 and 4 bits; all five filter types; not interlaced.
- BMP: 24- and 32-bit ``BI_RGB``, bottom-up and top-down.
- Baseline (and extended sequential) Huffman JPEG, 8-bit: grey and
  YCbCr at 4:4:4, 4:2:2, 4:4:0 and 4:2:0, restart markers, any size.
  The arithmetic follows libjpeg (Pillow's libjpeg-turbo): ``jidctint.c``
  ISLOW integer IDCT with the 16-bit lanes of its SIMD version,
  ``jdsample.c`` fancy upsampling and ``jdcolor.c`` fixed-point
  YCbCr -> RGB tables.

Grey follows Pillow's ``convert("L")`` (``(R*19595 + G*38470 + B*7471 +
0x8000) >> 16``, alpha ignored, palette through its RGB entries) and the
resize Pillow's ``Resample.c`` (a bilinear filter whose support grows
with the reduction, coefficients in double then fixed point with 22
fraction bits, a horizontal pass then a vertical one, 8-bit clipping in
between; a pass whose size does not change is skipped).

Bytes that are an image in a format Pillow reads and this module does
not (progressive or arithmetic JPEG, CMYK JPEG, GIF, TIFF, WebP,
interlaced or 16-bit PNG, BMP below 24 bits or compressed) raise
``UnsupportedImageError``.  Bytes that are no image at all, or a stream
that Pillow fails on, raise ``ImageDecodeError``: the headers are read
as Pillow's plugins read them (PNG checksums, BMP header sizes, JPEG
markers), and a size above Pillow's decompression-bomb limit is refused
before anything of that size is allocated.  Corrupt JPEG entropy data
is repaired as libjpeg repairs it (zero bits at a marker, restart
resynchronisation), so such an image decodes to Pillow's pixels.
Whole-image work runs in bands of rows, so memory stays near the size
of the decoded planes.
"""

from __future__ import annotations

import array
import math
import re
import struct
import zlib

import numpy as np


class ImageDecodeError(ValueError):
    """The bytes are not a decodable image (unknown or corrupt data)."""


class UnsupportedImageError(ValueError):
    """The bytes are an image in a format this decoder does not decode."""


# Pillow refuses an image of more than twice ``Image.MAX_IMAGE_PIXELS``
# pixels as a decompression bomb; the header's size is checked against
# the same limit before anything of that size is allocated.
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _check_size(width: int, height: int) -> None:
    if width * height > MAX_PIXELS:
        raise ImageDecodeError(
            f"image of {width} x {height} pixels exceeds the {MAX_PIXELS}-pixel limit")


# --------------------------------------------------------------------------
# grey conversion and resampling (Pillow's Convert.c / Resample.c)


# Whole-image work runs in bands of about this many pixels, so that its
# wide temporaries stay small next to the image itself.
_BAND_PIXELS = 1 << 20


def _bands(height: int, width: int, align: int = 1):
    """Row ranges ``[y0, y1)`` of about ``_BAND_PIXELS`` pixels each."""
    step = max(align, _BAND_PIXELS // max(width, 1) // align * align)
    for y0 in range(0, height, step):
        yield y0, min(height, y0 + step)


def rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """Pillow's L24: ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``."""
    out = np.empty(rgb.shape[:-1], np.uint8)
    rows = rgb.reshape(-1, *rgb.shape[-2:]) if rgb.ndim > 2 else rgb[None]
    flat = out.reshape(rows.shape[:-1])
    for y0, y1 in _bands(rows.shape[0], rows.shape[1]):
        band = rows[y0:y1].astype(np.int64)
        flat[y0:y1] = (band[..., 0] * 19595 + band[..., 1] * 38470
                       + band[..., 2] * 7471 + 0x8000) >> 16
    return out


_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    if x < 1.0:
        return 1.0 - x
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """Resample.c ``precompute_coeffs`` + ``normalize_coeffs_8bpc``."""
    filterscale = scale = float(in_size) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = []
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        ww = 0.0
        ss = 1.0 / filterscale
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        xmax -= xmin
        k = []
        for x in range(xmax):
            w = _bilinear((x + xmin - center + 0.5) * ss)
            k.append(w)
            ww += w
        for x in range(xmax):
            if ww != 0.0:
                k[x] /= ww
            v = k[x] * (1 << _PRECISION_BITS)
            kk[xx, x] = int(-0.5 + v) if k[x] < 0 else int(0.5 + v)
        bounds.append((xmin, xmax))
    return bounds, kk


def _clip8(ss: np.ndarray) -> np.ndarray:
    return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's ``Image.resize((width, height), BILINEAR)`` of an L image."""
    h, w = img.shape
    if (w, h) == (width, height):
        return img.copy()
    bh, kh = _coeffs(w, width)
    bv, kv = _coeffs(h, height)
    need_h = width != w
    need_v = height != h
    src = img  # uint8; each filter window is widened on its own
    if need_h:
        first = bv[0][0]
        last = bv[-1][0] + bv[-1][1]
        rows = src[first:last]
        out = np.empty((last - first, width), np.int64)
        for xx, (xmin, xmax) in enumerate(bh):
            ss = np.full(rows.shape[0], 1 << (_PRECISION_BITS - 1), np.int64)
            ss += rows[:, xmin:xmin + xmax].astype(np.int64) @ kh[xx, :xmax]
            out[:, xx] = ss
        src = _clip8(out)
        bv = [(ymin - first, ymax) for ymin, ymax in bv]
    if not need_v:
        return src.copy()
    out = np.empty((height, src.shape[1]), np.int64)
    for yy, (ymin, ymax) in enumerate(bv):
        out[yy] = ((1 << (_PRECISION_BITS - 1))
                   + kv[yy, :ymax] @ src[ymin:ymin + ymax].astype(np.int64))
    return _clip8(out)


# --------------------------------------------------------------------------
# format detection


_REFUSED_MAGIC = (
    (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
    (b"\x00\x00\x01\x00", "ICO"), (b"8BPS", "PSD"), (b"qoif", "QOI"),
    (b"DDS ", "DDS"), (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
    (b"\xff\x4f\xff\x51", "JPEG 2000"),
)


def decode_gray(data: bytes) -> np.ndarray:
    """``[H, W]`` uint8: the image as Pillow's ``convert("L")`` gives it."""
    data = bytes(data)
    decode = (_png if data.startswith(b"\x89PNG\r\n\x1a\n") else
              _jpeg if data.startswith(b"\xff\xd8\xff") else
              _bmp if data.startswith(b"BM") else None)
    if decode is not None:
        try:
            return decode(data)
        except (struct.error, IndexError, KeyError, ValueError, OverflowError) as exc:
            if isinstance(exc, (ImageDecodeError, UnsupportedImageError)):
                raise
            # a field that points past its segment, or a value out of range
            raise ImageDecodeError(f"corrupt image data: {exc!r}") from None
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise UnsupportedImageError("WebP images are not decoded")
    for magic, name in _REFUSED_MAGIC:
        if data.startswith(magic):
            raise UnsupportedImageError(f"{name} images are not decoded")
    raise ImageDecodeError("not an image")


def gray64(data: bytes, size: int = 64) -> np.ndarray:
    """``[size, size]`` uint8, Pillow's ``.convert("L").resize(BILINEAR)``."""
    return resize_bilinear(decode_gray(data), size, size)


# --------------------------------------------------------------------------
# PNG

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) < height * (stride + 1):
        raise ImageDecodeError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    fts = rows[:, 0]
    if int(fts.max()) > 4:
        raise ImageDecodeError(f"bad PNG filter type {int(fts.max())}")
    # runs of rows with one filter type: None, Sub and Up run at once
    cuts = np.flatnonzero(np.diff(fts)) + 1
    for y0, y1 in zip([0, *cuts.tolist()], [*cuts.tolist(), height]):
        ft = int(fts[y0])
        lines = rows[y0:y1, 1:]
        prior = out[y0 - 1] if y0 else np.zeros(stride, np.uint8)
        if ft == 0:
            out[y0:y1] = lines
        elif ft == 1:
            pad = (-stride) % bpp
            v = np.concatenate([lines, np.zeros((y1 - y0, pad), np.uint8)], axis=1)
            out[y0:y1] = np.cumsum(v.reshape(y1 - y0, -1, bpp), axis=1,
                                   dtype=np.uint8).reshape(y1 - y0, -1)[:, :stride]
        elif ft == 2:
            out[y0:y1] = np.cumsum(lines, axis=0, dtype=np.uint8) + prior
        else:
            row = _avg_row if ft == 3 else _paeth_row
            for y in range(y0, y1):
                prior = out[y] = row(rows[y, 1:], prior, bpp)
    return out


def _avg_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    f = line.tolist()
    p = prior.tolist()
    out = bytearray(len(f))
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (f[i] + ((a + p[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    f = line.tolist()
    p = prior.tolist()
    out = bytearray(len(f))
    for i in range(len(f)):
        b = p[i]
        if i >= bpp:
            a = out[i - bpp]
            c = p[i - bpp]
        else:
            a = c = 0
        pa = abs(b - c)
        pb = abs(a - c)
        pc = abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pr = a
        elif pb <= pc:
            pr = b
        else:
            pr = c
        out[i] = (f[i] + pr) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Sub-byte samples, most significant first, to one byte each."""
    bits = np.unpackbits(rows, axis=1)
    n = bits.shape[1] // depth
    bits = bits[:, :n * depth].reshape(rows.shape[0], n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width]


_PNG_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3),
              (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)}


def _is_cid(ctype: bytes) -> bool:
    return len(ctype) == 4 and all(c == 95 or chr(c).isalnum() and c < 128
                                   for c in ctype)


def _png_header(data: bytes, pos: int):
    """(length, type) of the chunk at ``pos``, or None where Pillow's
    reader fails on it (too short, or a type that is not 4 word bytes)."""
    if pos + 8 > len(data):
        return None
    length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
    return (length, ctype) if _is_cid(ctype) else None


def _png(data: bytes) -> np.ndarray:
    """Chunks are read as Pillow's PngImagePlugin reads them: up to the
    first IDAT each one whole and checksummed; then the IDAT run, as far
    as the image needs; then the chunks after it up to IEND."""
    pos = 8
    ihdr = None
    palette = None
    while True:
        head = _png_header(data, pos)
        if head is None:
            raise ImageDecodeError("bad or truncated PNG chunk")
        length, ctype = head
        if ctype == b"IDAT":
            break
        if ctype == b"IEND":
            raise ImageDecodeError("PNG has no image data")
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise ImageDecodeError("PNG chunk is truncated")
        if ctype == b"IHDR":
            if length < 13:
                raise ImageDecodeError("bad PNG header")
            ihdr = struct.unpack(">IIBBBBB", body[:13])
            if ihdr[5]:
                raise ImageDecodeError("unknown PNG filter category")
        elif ctype == b"PLTE" and ihdr is not None and ihdr[3] == 3:
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ImageDecodeError("bad PNG chunk checksum")
        pos += 12 + length
    if ihdr is None:
        raise ImageDecodeError("PNG has no header")
    width, height, depth, ctype, _, _, interlace = ihdr
    if width == 0 or height == 0 or (depth, ctype) not in _PNG_MODES:
        raise ImageDecodeError("bad PNG header")
    _check_size(width, height)
    if interlace:
        raise UnsupportedImageError("interlaced PNG images are not decoded")
    if depth == 16:
        raise UnsupportedImageError("16-bit PNG images are not decoded")
    ch = _PNG_CHANNELS[ctype]
    stride = (width * ch * depth + 7) // 8
    raw, pos = _png_idat(data, pos, height * (stride + 1))
    _png_tail(data, pos)
    px = _unfilter(raw, height, stride, max(1, ch * depth // 8))
    del raw
    if ctype == 3:
        if palette is None:
            raise ImageDecodeError("PNG palette image without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        lut = rgb_to_l(pal)
    else:
        lut = (np.arange(256) * {1: 255, 2: 0x55, 4: 0x11, 8: 1}[depth]).astype(np.uint8)
    out = np.empty((height, width), np.uint8)
    for y0, y1 in _bands(height, width):
        band = (_unpack_bits(px[y0:y1], width, depth) if depth != 8
                else px[y0:y1].reshape(y1 - y0, width, ch))
        if ctype in (0, 3):
            out[y0:y1] = lut[band.reshape(y1 - y0, width)]
        elif ctype == 4:
            out[y0:y1] = band[..., 0]
        else:
            out[y0:y1] = rgb_to_l(band)
    return out


def _png_idat(data: bytes, pos: int, need: int):
    """The image's ``need`` filtered bytes, inflated from the IDAT run at
    ``pos``, and the offset just past the chunk in which they were
    complete.  As in Pillow, a chunk may claim more bytes than the file
    holds, IDAT checksums are not read, and nothing past the image's
    last byte is inflated (so neither is the zlib checksum)."""
    inflate = zlib.decompressobj()
    out = []
    got = 0
    while True:
        length, _ = _png_header(data, pos)
        body = data[pos + 8:pos + 8 + length]
        try:
            piece = inflate.decompress(body, need - got)
        except zlib.error as exc:
            raise ImageDecodeError(f"corrupt PNG data: {exc}") from None
        out.append(piece)
        got += len(piece)
        pos += 12 + length
        if got >= need:
            return b"".join(out), pos
        head = _png_header(data, pos)
        if len(body) < length or head is None or head[1] != b"IDAT":
            raise ImageDecodeError("PNG image data is truncated")


def _png_tail(data: bytes, pos: int) -> None:
    """Pillow's ``load_end``: the chunks after the image are read up to
    IEND or a header it cannot read; one that claims more bytes than
    the file holds fails the load."""
    while True:
        head = _png_header(data, pos)
        if head is None or head[1] == b"IEND":
            return
        length = head[0]
        if length and pos + 8 + length > len(data):
            raise ImageDecodeError("PNG chunk is truncated")
        pos += 12 + length


# --------------------------------------------------------------------------
# BMP


def _bmp(data: bytes) -> np.ndarray:
    """The header is read as Pillow's BmpImagePlugin reads it."""
    if len(data) < 18:
        raise ImageDecodeError("BMP header is truncated")
    offset, hsize = struct.unpack("<II", data[10:18])
    if hsize == 12:
        raise UnsupportedImageError("OS/2 BMP images are not decoded")
    if hsize not in (40, 52, 56, 64, 108, 124):
        raise ImageDecodeError(f"unsupported BMP header size {hsize}")
    if len(data) < 14 + hsize:
        raise ImageDecodeError("BMP header is truncated")
    width, height, planes, bits, compression = struct.unpack(
        "<IIHHI", data[18:34])
    # Pillow: a height whose top byte is 0xFF is a top-down image
    height = height - (1 << 32) if data[25] == 0xFF else height
    if bits not in (1, 2, 4, 8, 16, 24, 32) or compression > 3:
        raise ImageDecodeError(
            f"BMP images of {bits} bits, compression {compression} are not read")
    if bits not in (24, 32) or compression != 0:
        raise UnsupportedImageError(
            f"BMP images of {bits} bits, compression {compression} are not decoded")
    if width == 0 or height == 0:
        raise ImageDecodeError("bad BMP size")
    _check_size(width, abs(height))
    offset = offset or 14 + hsize
    rows = abs(height)
    bpp = bits // 8
    stride = (width * bpp + 3) & ~3
    body = data[offset:offset + stride * rows]
    if len(body) < stride * rows:
        raise ImageDecodeError("BMP pixel data is truncated")
    px = np.frombuffer(body, np.uint8).reshape(rows, stride)[:, :width * bpp]
    px = px.reshape(rows, width, bpp)[..., 2::-1]  # BGR(X) -> RGB
    if height > 0:
        px = px[::-1]
    return rgb_to_l(px)


# --------------------------------------------------------------------------
# JPEG (baseline / extended sequential Huffman, 8-bit)

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)


# libjpeg-turbo loads these (ITU T.81 K.3) into table slots 0 and 1 that
# no DHT has filled by the first scan (for Motion-JPEG frames)
_STD_HUFFMAN = {
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
             "2433627282090a161718191a25262728292a3435363738393a43444546474849"
             "4a535455565758595a636465666768696a737475767778797a83848586878889"
             "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
             "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
             "f9fa"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c109233352f0"
             "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
             "494a535455565758595a636465666768696a737475767778797a828384858687"
             "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
             "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
             "f9fa"),
}


def _huff_table(counts: bytes, symbols: bytes, dc: bool):
    """A 16-bit lookup: peeked bits -> (symbol << 5) | code length, -1 where
    no code matches.  Refuses what libjpeg's ``jpeg_make_d_derived_tbl``
    refuses: an all-ones code, a code that does not fit its length, and
    a DC symbol above 15."""
    if dc and any(v > 15 for v in symbols):
        raise ImageDecodeError("bad JPEG Huffman table")
    lut = [-1] * 65536
    code = 0
    k = 0
    last = max((i + 1 for i, c in enumerate(counts) if c), default=0)
    for length in range(1, last + 1):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            span = 1 << (16 - length)
            if code < (1 << length):
                lut[lo:lo + span] = [(symbols[k] << 5) | length] * span
            code += 1
            k += 1
        if code >= (1 << length):
            raise ImageDecodeError("bad JPEG Huffman table")
        code <<= 1
    return lut


class _Bits:
    __slots__ = ("data", "pos", "acc", "n", "end")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0
        self.end = len(data)


_STUFFED = re.compile(rb"\xff+\x00")


def _unstuff(segment: bytes) -> bytes:
    # libjpeg reads 0xFF, any 0xFF fill bytes, then 0x00 as one 0xFF byte
    return _STUFFED.sub(b"\xff", segment)


def _decode_blocks(bits: _Bits, plan, coefs, count: int, preds: list,
                   first: int) -> int:
    """Decode MCUs ``first .. first + count`` of ``plan`` (per block of an
    MCU: component, MCU -> block index, DC and AC lookups) from ``bits``.
    Past the data it reads zero bits, as libjpeg does at a marker; it
    stops after the MCU that needed them and returns how many MCUs it
    decoded (libjpeg leaves the rest of the restart interval zero)."""
    data = bits.data
    end = bits.end
    pos = bits.pos
    acc = bits.acc
    n = bits.n
    zz = _ZIGZAG_LIST
    for m in range(first, first + count):
        for ci, block_at, dc_lut, ac_lut in plan:
            blk = coefs[ci]
            base = block_at(m) * 64
            # DC
            while n < 16:
                acc = (acc << 8) | (data[pos] if pos < end else 0)
                pos += 1
                n += 8
            e = dc_lut[(acc >> (n - 16)) & 0xFFFF]
            if e < 0:  # no code: libjpeg takes 17 bits as the symbol 0
                while n < 17:
                    acc = (acc << 8) | (data[pos] if pos < end else 0)
                    pos += 1
                    n += 8
                e = 17
            n -= e & 31
            s = e >> 5
            if s:
                while n < s:
                    acc = (acc << 8) | (data[pos] if pos < end else 0)
                    pos += 1
                    n += 8
                v = (acc >> (n - s)) & ((1 << s) - 1)
                n -= s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
            else:
                v = 0
            preds[ci] += v
            blk[base] = ((preds[ci] + 32768) & 0xFFFF) - 32768  # JCOEF is 16-bit
            # AC
            k = 1
            while k < 64:
                while n < 16:
                    acc = (acc << 8) | (data[pos] if pos < end else 0)
                    pos += 1
                    n += 8
                e = ac_lut[(acc >> (n - 16)) & 0xFFFF]
                if e < 0:
                    while n < 17:
                        acc = (acc << 8) | (data[pos] if pos < end else 0)
                        pos += 1
                        n += 8
                    e = 17
                n -= e & 31
                rs = e >> 5
                r = rs >> 4
                s = rs & 15
                if s:
                    k += r
                    while n < s:
                        acc = (acc << 8) | (data[pos] if pos < end else 0)
                        pos += 1
                        n += 8
                    v = (acc >> (n - s)) & ((1 << s) - 1)
                    n -= s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    # past the block's end libjpeg's natural order maps to 63
                    blk[base + (zz[k] if k < 64 else 63)] = v
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            acc &= (1 << n) - 1
        if 8 * pos - n > 8 * end:  # this MCU read past the data
            bits.pos, bits.acc, bits.n = pos, acc, n
            return m - first + 1
    bits.pos, bits.acc, bits.n = pos, acc, n
    return count


_ZIGZAG_LIST = _ZIGZAG.tolist()

_FIX_0_298631336 = 2446
_FIX_0_390180644 = 3196
_FIX_0_541196100 = 4433
_FIX_0_765366865 = 6270
_FIX_0_899976223 = 7373
_FIX_1_175875602 = 9633
_FIX_1_501321110 = 12299
_FIX_1_847759065 = 15137
_FIX_1_961570560 = 16069
_FIX_2_053119869 = 16819
_FIX_2_562915447 = 20995
_FIX_3_072711026 = 25172


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7, shift):
    """One pass of jidctint.c's ISLOW butterfly; returns 8 descaled outputs,
    saturated to 16 bits.  The sums that libjpeg-turbo's SIMD version
    forms in 16-bit lanes (``x0 ± x4``, ``x7 + x3``, ``x5 + x1``) wrap as
    they do there; products are exact, as in its 32-bit ``pmaddwd``."""
    z1 = (x2 + x6) * _FIX_0_541196100
    tmp2 = z1 + x6 * (-_FIX_1_847759065)
    tmp3 = z1 + x2 * _FIX_0_765366865
    tmp0 = _wrap16(x0 + x4) << 13
    tmp1 = _wrap16(x0 - x4) << 13
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = _wrap16(t0 + t2)
    z4 = _wrap16(t1 + t3)
    z5 = (z3 + z4) * _FIX_1_175875602
    t0 = t0 * _FIX_0_298631336
    t1 = t1 * _FIX_2_053119869
    t2 = t2 * _FIX_3_072711026
    t3 = t3 * _FIX_1_501321110
    z1 = z1 * (-_FIX_0_899976223)
    z2 = z2 * (-_FIX_2_562915447)
    z3 = z3 * (-_FIX_1_961570560) + z5
    z4 = z4 * (-_FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (shift - 1)
    return tuple(np.clip((v + r) >> shift, -32768, 32767) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3))


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``[N, 64]`` natural-order coefficients -> ``[N, 8, 8]`` uint8 samples."""
    out = np.full((coef.shape[0], 8, 8), 128, np.uint8)  # an all-zero block
    step = max(1, _BAND_PIXELS // 64)
    for b0 in range(0, coef.shape[0], step):
        chunk = coef[b0:b0 + step]
        live = np.flatnonzero(chunk.any(axis=1)) + b0
        if live.size:
            out[live] = _idct_blocks(coef[live].astype(np.int64), quant)
    return out


def _idct_blocks(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    # dequantized in 16-bit lanes, as libjpeg-turbo's SIMD ``pmullw``
    c = _wrap16(coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (rows of the block are k), CONST_BITS - PASS1_BITS
    cols = _idct_1d(*(c[:, k, :] for k in range(8)), shift=13 - 2)
    ws = np.stack(cols, axis=1)  # [N, row, col]
    # the SIMD pass 1 takes a block whose rows 1..7 are zero as its first
    # row shifted left in 16 bits (``psllw``), which wraps where the full
    # pass saturates
    flat = ~coef.reshape(-1, 8, 8)[:, 1:, :].any(axis=(1, 2))
    ws[flat] = _wrap16(c[flat, :1, :] << 2)
    # pass 2: rows, CONST_BITS + PASS1_BITS + 3
    rows = _idct_1d(*(ws[:, :, k] for k in range(8)), shift=13 + 2 + 3)
    out = np.stack(rows, axis=2) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """jdsample.c: fancy upsampling (h2v1, h1v2, h2v2) with edge context
    where libjpeg-turbo takes it, plain replication for the other ratios
    and for h2 planes no more than 2 pixels wide."""
    p = plane.astype(np.int64)
    if (fh, fv) == (1, 1):
        return p
    if (fh, fv) not in ((2, 1), (1, 2), (2, 2)) or (fh == 2 and p.shape[1] <= 2):
        return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)
    if (fh, fv) == (2, 1):
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        return out
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    if (fh, fv) == (1, 2):
        out = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out
    if (fh, fv) == (2, 2):
        out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int64)
        for v, near in ((0, up), (1, down)):
            s = 3 * p + near
            left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
            right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
            out[v::2, 0::2] = (3 * s + left + 8) >> 4
            out[v::2, 1::2] = (3 * s + right + 7) >> 4
        return out


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its fixed-point tables."""
    one_half = 1 << 15

    def fix(x):
        return int(x * (1 << 16) + 0.5)

    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half + (-fix(0.71414)) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


_RST = range(0xD0, 0xD8)
_SOF = (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)
_NOT_READ_SOF = (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)  # hierarchical: libjpeg refuses
_REFUSED_SOF = {0xC2: "progressive", 0xC3: "lossless", 0xC9: "arithmetic",
                0xCA: "arithmetic", 0xCB: "arithmetic"}


def _next_marker(data: bytes, pos: int):
    """(offset, code) of the first marker at or after ``pos``, skipping
    bytes that are not one (libjpeg's ``next_marker``), or None at the end."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        while 0 <= pos and pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1
        if pos < 0 or pos + 1 >= n:
            return None
        if data[pos + 1] != 0x00:
            return pos, data[pos + 1]
        pos += 2


class _Frame:
    __slots__ = ("h", "w", "comps", "coefs", "single", "scans")

    def __init__(self, h: int, w: int, comps: list):
        self.h, self.w, self.comps = h, w, comps
        self.scans = 0
        self.single = True
        hmax = max(c["h"] for c in comps)
        vmax = max(c["v"] for c in comps)
        mcux = -(-w // (8 * hmax))
        mcuy = -(-h // (8 * vmax))
        self.coefs = []
        for c in comps:
            c["bw"] = mcux * c["h"]
            c["bh"] = mcuy * c["v"]
            c["dw"] = -(-w * c["h"] // hmax)
            c["dh"] = -(-h * c["v"] // vmax)
            c["q"] = None
            # 16-bit coefficients, flat, 64 per block (libjpeg's JCOEF)
            self.coefs.append(array.array("h", bytes(2 * 64 * c["bh"] * c["bw"])))


def _jpeg(data: bytes) -> np.ndarray:
    """Markers are read as Pillow's JpegImagePlugin and then libjpeg read
    them; the entropy-coded data as libjpeg decodes it, with its repairs
    of corrupt data (see ``_scan``)."""
    n = len(data)
    pos = 2
    qt = {}
    tables = {}  # (class, slot) -> (counts, symbols)
    frame = None
    restart = 0
    adobe = None
    jfif = False
    while True:
        at = _next_marker(data, pos)
        if at is None:
            if frame is not None and frame.scans and frame.single:
                break  # libjpeg's reading past the one scan stops at the end
            raise ImageDecodeError("JPEG stream is truncated")
        pos, marker = at
        if marker == 0xD9:  # EOI
            break
        if marker in _RST or (marker == 0x01 and frame is not None and frame.scans):
            pos += 2
            continue
        if marker < 0xC0 or marker in (0xC8, 0xD8, 0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
            raise ImageDecodeError(f"bad JPEG marker 0x{marker:02X}")
        # what libjpeg refuses before it reads the segment's length
        if marker in _SOF and frame is not None:
            raise ImageDecodeError("JPEG has two frame headers")
        if marker in _NOT_READ_SOF:
            raise ImageDecodeError("hierarchical JPEG images are not read")
        if marker in _REFUSED_SOF:
            raise UnsupportedImageError(
                f"{_REFUSED_SOF[marker]} JPEG images are not decoded")
        if marker == 0xDA and frame is None:
            raise ImageDecodeError("JPEG scan before frame")
        ln = struct.unpack(">H", data[pos + 2:pos + 4])[0] if pos + 4 <= n else 0
        if ln < 2 or pos + 2 + ln > n:
            if frame is not None and frame.scans and frame.single:
                break  # libjpeg stops at the end once its one scan is read
            raise ImageDecodeError("JPEG segment is truncated")
        body = data[pos + 4:pos + 2 + ln]
        nxt = pos + 2 + ln
        if marker in (0xC0, 0xC1):
            frame = _sof(body)
        elif marker == 0xC4:
            p = 0
            while p < len(body):
                if p + 17 > len(body):
                    raise ImageDecodeError("bad JPEG Huffman table")
                tc_th = body[p]
                counts = body[p + 1:p + 17]
                total = sum(counts)
                if tc_th >> 4 > 1 or tc_th & 15 > 3 or total > 256 \
                        or p + 17 + total > len(body):
                    raise ImageDecodeError("bad JPEG Huffman table")
                tables[(tc_th >> 4, tc_th & 15)] = (counts, body[p + 17:p + 17 + total])
                p += 17 + total
        elif marker == 0xDB:
            p = 0
            while p < len(body):
                pq_tq = body[p]
                size = 129 if pq_tq >> 4 else 65
                if p + size > len(body) or pq_tq & 15 > 3:
                    raise ImageDecodeError("bad JPEG quantization table")
                fmt = ">64H" if pq_tq >> 4 else "64B"
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = struct.unpack(fmt, body[p + 1:p + size])
                qt[pq_tq & 15] = q
                p += size
        elif marker == 0xDD:
            if len(body) != 2:
                raise ImageDecodeError("bad JPEG restart interval")
            (restart,) = struct.unpack(">H", body)
        elif 0xE0 <= marker <= 0xEF and (frame is None or not frame.scans):
            # what Pillow's header reader parses, and fails on when short
            if (marker == 0xE0 and body[:4] == b"JFIF" and len(body) < 7) \
                    or (marker == 0xEE and body[:5] == b"Adobe" and len(body) < 7) \
                    or (marker == 0xE2 and body[:12] == b"ICC_PROFILE\x00"
                        and len(body) < 14):
                raise ImageDecodeError("bad JPEG application segment")
            if marker == 0xE0 and len(body) >= 14 and body.startswith(b"JFIF\x00"):
                jfif = True
            if marker == 0xEE and len(body) >= 12 and body.startswith(b"Adobe"):
                adobe = body[11]
        elif marker == 0xDA:
            if frame.scans and frame.single:
                raise ImageDecodeError("JPEG has a scan after its only one")
            if not frame.scans:  # libjpeg's Motion-JPEG default tables
                for key, (counts, syms) in _STD_HUFFMAN.items():
                    tables.setdefault(key, (bytes.fromhex(counts), bytes.fromhex(syms)))
            sel = _sos(body, frame, tables, qt)
            pos = _scan(data, nxt, frame, sel, restart)
            continue
        pos = nxt
    if frame is None or not frame.scans:
        raise ImageDecodeError("JPEG has no image data")
    return _jpeg_pixels(frame, jfif, adobe)


def _sof(body: bytes) -> _Frame:
    if len(body) < 6:
        raise ImageDecodeError("bad JPEG frame header")
    prec, h, w, nc = struct.unpack(">BHHB", body[:6])
    if prec != 8 or nc not in (1, 3, 4) or len(body) != 6 + 3 * nc:
        raise ImageDecodeError("bad JPEG frame header")
    if not (0 < h <= 65500 and 0 < w <= 65500):
        raise ImageDecodeError("bad JPEG image size")
    comps = []
    for i in range(nc):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        hs, vs = hv >> 4, hv & 15
        if not (1 <= hs <= 4 and 1 <= vs <= 4):
            raise ImageDecodeError("bad JPEG sampling factors")
        comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
    if nc == 4:
        raise UnsupportedImageError("JPEG images of 4 components are not decoded")
    _check_size(w, h)
    return _Frame(h, w, comps)


def _sos(body: bytes, frame: _Frame, tables: dict, qt: dict) -> list:
    """The scan's components with their lookups, checked as libjpeg's
    ``get_sos``, ``start_pass_huff_decoder`` and ``latch_quant_tables`` do."""
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 2 * ns + 4:
        raise ImageDecodeError("bad JPEG scan header")
    sel = []
    for i in range(ns):
        cid, tt = body[1 + 2 * i:3 + 2 * i]
        idx = [j for j, c in enumerate(frame.comps) if c["id"] == cid]
        if not idx or any(idx[0] == s[0] for s in sel):
            raise ImageDecodeError("JPEG scan names a bad component")
        sel.append((idx[0], tt >> 4, tt & 15))
    if ns > 1 and sum(frame.comps[ci]["h"] * frame.comps[ci]["v"] for ci, _, _ in sel) > 10:
        raise ImageDecodeError("JPEG MCU has more than 10 blocks")
    if not frame.scans:
        frame.single = ns == len(frame.comps)
    out = []
    for ci, td, ta in sel:
        if (0, td) not in tables or (1, ta) not in tables:
            raise ImageDecodeError("JPEG scan names a missing Huffman table")
        c = frame.comps[ci]
        if c["q"] is None:
            if c["tq"] not in qt:
                raise ImageDecodeError("JPEG names a missing quantization table")
            c["q"] = qt[c["tq"]].copy()
        out.append((ci, _huff_table(*tables[(0, td)], dc=True),
                    _huff_table(*tables[(1, ta)], dc=False)))
    frame.scans += 1
    return out


def _jpeg_pixels(frame: _Frame, jfif: bool, adobe) -> np.ndarray:
    h, w, comps = frame.h, frame.w, frame.comps
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for ci, c in enumerate(comps):
        if hmax % c["h"] or vmax % c["v"]:
            raise ImageDecodeError("JPEG sampling ratio is not an integer")
        q = c["q"] if c["q"] is not None else np.ones(64, np.int64)  # never scanned: zeros
        blocks = idct_islow(np.frombuffer(frame.coefs[ci], np.int16).reshape(-1, 64), q)
        frame.coefs[ci] = None
        planes.append(blocks.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
            c["bh"] * 8, c["bw"] * 8)[:c["dh"], :c["dw"]])
    # libjpeg's default_decompress_parms: JFIF, then Adobe, then the ids
    if jfif:
        rgb_space = False
    elif adobe is not None:
        rgb_space = adobe == 0
    else:
        rgb_space = tuple(c["id"] for c in comps) == (ord("R"), ord("G"), ord("B"))
    out = np.empty((h, w), np.uint8)
    for y0, y1 in _bands(h, w):
        band = []
        for c, plane in zip(comps, planes):
            fh, fv = hmax // c["h"], vmax // c["v"]
            # the band's rows of this plane, with a row of context each side
            lo = max(y0 // fv - 1, 0)
            hi = min(-(-y1 // fv) + 1, plane.shape[0])
            up = _upsample(plane[lo:hi], fh, fv)
            band.append(up[y0 - lo * fv:y1 - lo * fv, :w])
        if len(band) == 1:
            out[y0:y1] = band[0]
        elif rgb_space:
            out[y0:y1] = rgb_to_l(np.stack(band, axis=-1).astype(np.uint8))
        else:
            out[y0:y1] = rgb_to_l(_ycc_to_rgb(*band))
    return out


def _scan(data: bytes, pos: int, frame: _Frame, sel, restart: int) -> int:
    """Decode one scan's entropy-coded data from ``pos``; returns the
    offset at which the marker reader goes on.

    Corrupt data is repaired as libjpeg repairs it: where a restart
    interval's data ends at a marker before its MCUs do, the MCU being
    decoded takes zero bits and the rest of the interval is left zero;
    a restart marker out of sequence is resolved by libjpeg's
    ``jpeg_resync_to_restart``.  Data that ends at the end of the file
    instead fails, as Pillow fails on a truncated file."""
    comps = frame.comps
    coefs = frame.coefs
    if len(sel) == 1:
        ci, dc, ac = sel[0]
        c = comps[ci]
        bw = -(-c["dw"] // 8)
        bh = -(-c["dh"] // 8)
        stride = c["bw"]
        plan = [(ci, lambda m, bw=bw, s=stride: (m // bw) * s + m % bw, dc, ac)]
        total = bw * bh
    else:
        plan = []
        hmax = max(c["h"] for c in comps)
        vmax = max(c["v"] for c in comps)
        mcux = -(-frame.w // (8 * hmax))
        mcuy = -(-frame.h // (8 * vmax))
        for ci, dc, ac in sel:
            c = comps[ci]
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    plan.append((ci, lambda m, by=by, bx=bx, c=c, mx=mcux:
                                 ((m // mx) * c["v"] + by) * c["bw"] + (m % mx) * c["h"] + bx,
                                 dc, ac))
        total = mcux * mcuy
    per = restart if restart else total
    done = 0
    want = 0  # the restart marker libjpeg expects next
    starved = False  # libjpeg's insufficient_data: the interval stays zero
    while True:
        at = _next_marker(data, pos)
        count = min(per, total - done)
        if not starved:
            if at is None:  # libjpeg asks for more data: Pillow calls it truncated
                raise ImageDecodeError("JPEG scan data is truncated")
            got = _decode_blocks(_Bits(_unstuff(data[pos:at[0]])), plan, coefs,
                                 count, [0] * len(comps), done)
            starved = got < count
        done += count
        if done >= total:
            return at[0]
        # process_restart -> read_restart_marker / jpeg_resync_to_restart
        pos, marker = at
        while marker != 0xD0 + want:
            if marker < 0xC0 or (marker in _RST
                                 and marker - 0xD0 in ((want - 1) & 7, (want - 2) & 7)):
                at = _next_marker(data, pos + 2)  # skip it, decide on the next
                if at is None:
                    raise ImageDecodeError("JPEG scan data is truncated")
                pos, marker = at
                continue
            if marker not in _RST or marker - 0xD0 in ((want + 1) & 7, (want + 2) & 7):
                break  # left unread: the next interval is read as empty
            marker = 0xD0 + want  # too far off: discarded, as if it were expected
        if marker == 0xD0 + want:
            pos += 2
            starved = False
        want = (want + 1) & 7
