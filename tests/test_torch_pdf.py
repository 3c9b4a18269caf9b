"""The port's PDF parser (super_rag_tpu_torch/fileparser/pdf.py) against
the JAX package's on the CPU: every fixture of tests/test_pdf.py gives
the same ``extract_pdf_text`` string (or the same error), DCT and JPX
images the same bytes and asset ids, FlateDecode bitmaps PNG files with
the same pixels (the port writes its PNG with zlib and struct, the JAX
package with Pillow, so their bytes and asset ids differ: a kept
difference), bad input the same exception, and seeded bit flips and cuts
of the fixtures the same parts or the same error."""

import hashlib
import io
import zlib

import numpy as np
import pytest
from PIL import Image

from super_rag_tpu.fileparser import ocr as jocr
from super_rag_tpu.fileparser import pdf as jpdf
from super_rag_tpu.fileparser.parser import DocParser as JDocParser
from super_rag_tpu_torch.fileparser import ocr as tocr
from super_rag_tpu_torch.fileparser import pdf as tpdf
from super_rag_tpu_torch.fileparser.parser import DocParser as TDocParser
from super_rag_tpu_torch.models.image_decode import decode_gray


@pytest.fixture(autouse=True)
def no_ocr(monkeypatch):
    """Neither package's OCR runs: the outcome must not depend on which
    engines this machine has."""
    monkeypatch.setattr(jocr, "default_ocr", lambda: None)
    monkeypatch.setattr(tocr, "default_ocr", lambda: None)


# -- fixture builders (tests/test_pdf.py make_pdf, make_cid_pdf) ----------------


def make_pdf(content_stream: bytes, compress: bool = False, extra=()) -> bytes:
    """Minimal single-page PDF with one content stream."""
    if compress:
        filt = b"/Filter /FlateDecode "
        data = zlib.compress(content_stream)
    else:
        filt = b""
        data = content_stream
    objs = [
        b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj",
        b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj",
        b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R >> endobj",
        b"4 0 obj << " + filt + b"/Length " + str(len(data)).encode()
        + b" >>\nstream\n" + data + b"\nendstream\nendobj",
        *extra,
    ]
    return b"%PDF-1.4\n" + b"\n".join(objs) + b"\ntrailer\n%%EOF"


def make_cid_pdf(codes_hex: bytes, cmap_stream: bytes,
                 in_objstm: bool = False) -> bytes:
    """Single-page PDF whose text uses a Type0 (CID) font with a
    /ToUnicode CMap."""
    content = b"BT /F1 12 Tf 72 700 Td <" + codes_hex + b"> Tj ET"
    font = (b"<< /Type /Font /Subtype /Type0 /BaseFont /Subset+Fake "
            b"/ToUnicode 6 0 R >>")
    page = (b"<< /Type /Page /Parent 2 0 R /Contents 4 0 R "
            b"/Resources << /Font << /F1 5 0 R >> >> >>")
    objs = [
        b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj",
        b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj",
    ]
    if in_objstm:
        inner = [(3, page), (5, font)]
        payload = b""
        header = b""
        for num, body in inner:
            header += str(num).encode() + b" " + str(len(payload)).encode() + b" "
            payload += body + b" "
        first = len(header)
        stm = zlib.compress(header + payload)
        objs.append(
            b"7 0 obj << /Type /ObjStm /N 2 /First " + str(first).encode()
            + b" /Filter /FlateDecode /Length " + str(len(stm)).encode()
            + b" >>\nstream\n" + stm + b"\nendstream\nendobj"
        )
    else:
        objs.append(b"3 0 obj " + page + b" endobj")
        objs.append(b"5 0 obj " + font + b" endobj")
    objs.append(
        b"4 0 obj << /Length " + str(len(content)).encode()
        + b" >>\nstream\n" + content + b"\nendstream\nendobj"
    )
    objs.append(
        b"6 0 obj << /Length " + str(len(cmap_stream)).encode()
        + b" >>\nstream\n" + cmap_stream + b"\nendstream\nendobj"
    )
    return b"%PDF-1.5\n" + b"\n".join(objs) + b"\ntrailer\n%%EOF"


CMAP = b"""/CIDInit /ProcSet findresource begin
begincmap
1 begincodespacerange
<0000> <FFFF>
endcodespacerange
2 beginbfchar
<0001> <0048>
<0002> <0069>
endbfchar
1 beginbfrange
<0010> <0012> <0061>
endbfrange
endcmap
end
"""
CONTENT = (b"BT /F1 12 Tf 72 700 Td (Hello PDF world.) Tj T* "
           b"[(Seg) -120 (mented) -90 ( text!)] TJ ET")
JPEG = b"\xff\xd8\xff\xe0" + b"J" * 64 + b"\xff\xd9"
JP2 = b"\x00\x00\x00\x0cjP  \r\n\x87\n" + b"K" * 64


def _tm(cells) -> bytes:
    return b" ".join(f"BT 1 0 0 1 {x} {y} Tm ({t}) Tj ET".encode() for x, y, t in cells)


def image_obj(num: int, w: int, h: int, channels: int, pixels: bytes,
              flate: bool = True) -> bytes:
    space = b"/DeviceRGB" if channels == 3 else b"/DeviceGray"
    data = zlib.compress(pixels) if flate else pixels
    filt = b" /Filter /FlateDecode" if flate else b""
    return (str(num).encode() + b" 0 obj << /Type /XObject /Subtype /Image /Width "
            + str(w).encode() + b" /Height " + str(h).encode() + b" /ColorSpace "
            + space + b" /BitsPerComponent 8" + filt + b" /Length "
            + str(len(data)).encode() + b" >>\nstream\n" + data + b"\nendstream\nendobj")


def _pixels(seed: int, w: int, h: int, channels: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, (h, w, channels), np.uint8).tobytes()


def image_pdf(text: bytes = CONTENT) -> bytes:
    """A text page with one FlateDecode RGB and one grey bitmap, a DCT and
    a JPX image."""
    return make_pdf(text, True, extra=(
        image_obj(5, 7, 5, 3, _pixels(1, 7, 5, 3)),
        image_obj(6, 3, 9, 1, _pixels(2, 3, 9, 1)),
        b"8 0 obj << /Subtype /Image /Width 4 /Height 4 /Filter /DCTDecode /Length "
        + str(len(JPEG)).encode() + b" >>\nstream\n" + JPEG + b"\nendstream\nendobj",
        b"9 0 obj << /Subtype /Image /Width 4 /Height 4 /Filter /JPXDecode /Length "
        + str(len(JP2)).encode() + b" >>\nstream\n" + JP2 + b"\nendstream\nendobj",
    ))


FIXTURES = {
    "plain": make_pdf(CONTENT),
    "flate": make_pdf(CONTENT, compress=True),
    "escapes": make_pdf(rb"BT (paren \( inside \) and \134 backslash) Tj "
                        b"<48656C6C6F> Tj ET"),
    "scanned": make_pdf(b"q 1 0 0 1 0 0 cm /Im0 Do Q"),
    "cid": make_cid_pdf(b"00010002001000110012", CMAP),
    "cid_array": make_cid_pdf(b"00050006", b"begincmap\n1 begincodespacerange\n<0000> <FFFF>\n"
                              b"endcodespacerange\n1 beginbfrange\n"
                              b"<0005> <0006> [<0058> <0059>]\nendbfrange\nendcmap\n"),
    "cid_objstm": make_cid_pdf(b"00010002", CMAP, in_objstm=True),
    "cid_nomap": (b"%PDF-1.5\n1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n"
                  b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj\n"
                  b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R "
                  b"/Resources << /Font << /F1 5 0 R >> >> >> endobj\n"
                  b"5 0 obj << /Type /Font /Subtype /Type0 /BaseFont /NoMap >> endobj\n"
                  b"4 0 obj << /Length 30 >>\nstream\nBT /F1 12 Tf <00410042> Tj ET"
                  b"\nendstream\nendobj\ntrailer\n%%EOF"),
    "two_column": make_pdf(_tm([(72, 700, "Left one."), (320, 700, "Right one."),
                                (72, 685, "Left two."), (320, 685, "Right two."),
                                (72, 670, "Left three."), (320, 670, "Right three.")])),
    "same_line": make_pdf(b"BT 1 0 0 1 300 700 Tm (world) Tj ET "
                          b"BT 1 0 0 1 72 700 Tm (Hello) Tj ET"),
    "grid": make_pdf(b"BT 1 0 0 1 72 730 Tm (Team roster:) Tj ET " + _tm(
        [(72, 700, "Name"), (220, 700, "Role"), (400, 700, "Team"),
         (72, 685, "Alice"), (220, 685, "Engineer"), (400, 685, "Ops|Infra"),
         (72, 670, "Bob"), (220, 670, "Manager"), (400, 670, "Infra")])
        + b" BT 1 0 0 1 72 640 Tm (End of roster.) Tj ET"),
    "lone_multi": make_pdf(b"BT 1 0 0 1 72 700 Tm (Hello) Tj ET "
                           b"BT 1 0 0 1 200 700 Tm (world) Tj ET "
                           b"BT 1 0 0 1 72 685 Tm (Just a paragraph line.) Tj ET"),
    "narrow_table": make_pdf(_tm([(72, 700, "Key"), (180, 700, "Value"),
                                  (72, 685, "qps"), (180, 685, "21000"),
                                  (72, 670, "recall"), (180, 670, "0.95")])),
    "leading": make_pdf(b"BT /F9 10 Tf 14 TL 72 700 Td (One) Tj T* (Two) ' "
                        b"1 2 (Three) \" 0 -20 TD (Four) Tj ET"),
    "images": image_pdf(),
    "image_only": make_pdf(b"q 1 0 0 1 0 0 cm /Im0 Do Q", extra=(
        image_obj(5, 16, 16, 1, _pixels(3, 16, 16, 1)),)),
    "encrypted": make_pdf(CONTENT, extra=(b"7 0 obj << /Encrypt 8 0 R >> endobj",)),
    "not_pdf": b"PK\x03\x04 not a pdf at all",
    "truncated": make_pdf(CONTENT, compress=True)[:60],
    "empty": b"",
}


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("error", type(e).__name__, str(e))


def _png_pixels(blob: bytes):
    im = Image.open(io.BytesIO(blob))
    im.load()
    return im.mode, im.size, im.tobytes()


def _norm_parts(parts):
    """Parts as comparable tuples; a PNG asset is its decoded pixels, and
    PNG asset ids (which hash the bytes) become their order."""
    png_ids = {}
    for p in parts:
        if type(p).__name__ == "AssetBinPart" and p.mime_type == "image/png":
            png_ids[p.asset_id] = f"png#{len(png_ids)}"
    out = []
    for p in parts:
        kind = type(p).__name__
        aid = getattr(p, "asset_id", None)
        url = getattr(p, "url", None)
        if url and url.startswith("asset://") and url[8:] in png_ids:
            url = "asset://" + png_ids[url[8:]]
        data = getattr(p, "data", None)
        if kind == "AssetBinPart" and p.mime_type == "image/png":
            data = _png_pixels(data)
        out.append((kind, p.content, getattr(p, "mime_type", None),
                    png_ids.get(aid, aid), url, data))
    return out


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_text_matches(name):
    data = FIXTURES[name]
    assert _outcome(tpdf.extract_pdf_text, data) == _outcome(jpdf.extract_pdf_text, data)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_parts_match(name):
    data = FIXTURES[name]
    want = _outcome(jpdf.PdfParser().parse_file, "x.pdf", data)
    got = _outcome(tpdf.PdfParser().parse_file, "x.pdf", data)
    if want[0] == "ok" and got[0] == "ok":
        assert _norm_parts(got[1]) == _norm_parts(want[1])
    else:
        assert got == want
    want = _outcome(JDocParser().parse_file, "x.pdf", data)
    got = _outcome(TDocParser().parse_file, "x.pdf", data)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert _norm_parts(got[1]) == _norm_parts(want[1])
    else:
        assert got == want


def test_dct_and_jpx_images_keep_bytes_and_asset_ids():
    data = FIXTURES["images"]
    want = [(m, b) for m, b in jpdf.extract_pdf_images(data) if m != "image/png"]
    got = [(m, b) for m, b in tpdf.extract_pdf_images(data) if m != "image/png"]
    assert got == want and sorted(m for m, _ in got) == ["image/jp2", "image/jpeg"]
    jparts = jpdf.PdfParser().parse_file("x.pdf", data)
    tparts = tpdf.PdfParser().parse_file("x.pdf", data)
    ids = {p.asset_id for p in tparts if getattr(p, "mime_type", "") in ("image/jpeg", "image/jp2")}
    assert ids == {p.asset_id for p in jparts
                   if getattr(p, "mime_type", "") in ("image/jpeg", "image/jp2")}
    assert ids == {hashlib.sha256(b).hexdigest()[:16] for _, b in got}


@pytest.mark.parametrize("w,h,channels", [(7, 5, 3), (3, 9, 1), (1, 1, 3), (64, 33, 1),
                                          (40, 40, 3)])
def test_flate_bitmaps_give_the_same_pixels(w, h, channels):
    """The port's PNG decodes (by Pillow and by the port's own decoder) to
    the pixels of the JAX package's Pillow-written PNG; extra pixel bytes
    past w x h are dropped alike.  The PNG bytes, and so the asset ids,
    differ: the kept difference."""
    pixels = _pixels(w * 31 + h, w, h, channels) + b"\x07" * 5
    data = make_pdf(CONTENT, extra=(image_obj(5, w, h, channels, pixels),))
    (jm, jblob), = jpdf.extract_pdf_images(data)
    (tm, tblob), = tpdf.extract_pdf_images(data)
    assert jm == tm == "image/png"
    assert tblob.startswith(b"\x89PNG\r\n\x1a\n")
    assert _png_pixels(tblob) == _png_pixels(jblob)
    assert _png_pixels(tblob)[2] == pixels[: w * h * channels]
    want_l = np.asarray(Image.open(io.BytesIO(jblob)).convert("L"))
    np.testing.assert_array_equal(decode_gray(tblob), want_l)
    if tblob != jblob:  # the kept difference: ids hash the bytes
        jid = {p.asset_id for p in jpdf.PdfParser().parse_file("x.pdf", data)
               if getattr(p, "asset_id", "")}
        tid = {p.asset_id for p in tpdf.PdfParser().parse_file("x.pdf", data)
               if getattr(p, "asset_id", "")}
        assert jid != tid and tid == {hashlib.sha256(tblob).hexdigest()[:16]}


def test_png_writer_refuses_an_empty_image_as_pillow_does():
    zero = make_pdf(CONTENT, extra=(image_obj(5, 0, 4, 3, b""),
                                    image_obj(6, 4, 0, 1, b"")))
    assert jpdf.extract_pdf_images(zero) == tpdf.extract_pdf_images(zero) == []
    short = make_pdf(CONTENT, extra=(image_obj(5, 4, 4, 3, b"\x00" * 47),))
    assert jpdf.extract_pdf_images(short) == tpdf.extract_pdf_images(short) == []
    with pytest.raises(ValueError):
        tpdf.png_bytes(b"", 0, 3, 3)


def test_keeps_flate_images_where_pillow_is_missing(monkeypatch):
    """Without Pillow the JAX package drops FlateDecode bitmaps; the port
    never imports it and keeps them."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    data = FIXTURES["images"]
    assert sorted(m for m, _ in jpdf.extract_pdf_images(data)) == ["image/jp2", "image/jpeg"]
    assert sorted(m for m, _ in tpdf.extract_pdf_images(data)) == [
        "image/jp2", "image/jpeg", "image/png", "image/png"]


def _mutants(seed: int, data: bytes):
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    kind = seed % 3
    if kind == 0:  # bit flips
        for _ in range(int(rng.integers(1, 6))):
            i = int(rng.integers(len(b)))
            b[i] ^= 1 << int(rng.integers(8))
        return bytes(b)
    if kind == 1:  # a cut
        return bytes(b[: int(rng.integers(8, len(b)))])
    i, j = sorted(int(x) for x in rng.integers(0, len(b), 2))  # a hole
    return bytes(b[:i] + b[j:])


@pytest.mark.parametrize("seed", range(30))
def test_corrupt_fixtures_match(seed):
    names = ["images", "flate", "cid", "cid_objstm", "grid", "image_only", "leading"]
    data = _mutants(seed, FIXTURES[names[seed % len(names)]])
    want = _outcome(jpdf.PdfParser().parse_file, "x.pdf", data)
    got = _outcome(tpdf.PdfParser().parse_file, "x.pdf", data)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert _norm_parts(got[1]) == _norm_parts(want[1])
    else:
        assert got == want
