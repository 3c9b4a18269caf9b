"""Best-effort pure-Python PDF text extraction (port of the JAX package's
fileparser/pdf.py).

It walks the object graph (including compressed /ObjStm object streams),
inflates FlateDecode streams, resolves per-page font resources, decodes
CID/Type0 text through /ToUnicode CMaps (bfchar/bfrange), and interprets
the text operators (Tf/Tj/TJ/'/") of content streams, inserting line
breaks on text positioning (Td/TD/T*).

Embedded images come back as parts: DCTDecode and JPXDecode streams as
they are, FlateDecode bitmaps (8-bit grey or RGB) as PNG files that
``png_bytes`` writes with zlib and struct.  The JAX package writes those
PNGs with Pillow, and drops them where Pillow is missing; the port's
have the same pixels, but not the same bytes, so their asset ids differ.

No encrypted files; subset fonts without a ToUnicode map decode
approximately; a scanned PDF goes to OCR (``fileparser/ocr.py``) and to
the vision index through its page images.
"""

from __future__ import annotations

import hashlib
import re
import struct
import zlib
from typing import Optional

from super_rag_tpu_torch.fileparser import ocr
from super_rag_tpu_torch.fileparser.base import (
    AssetBinPart, BaseParser, ImagePart, Part, TextPart)

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
_OBJ_RE = re.compile(rb"(\d+)\s+\d+\s+obj(.*?)endobj", re.S)
# text-showing operators inside BT..ET blocks, WITH the positioning
# operators' operands captured: text runs carry (x, y) so lines and
# columns reassemble in reading order (a two-column page interleaves
# its columns under naive stream order)
_BT_RE = re.compile(rb"BT(.*?)ET", re.S)
_NUM = rb"[-+]?[0-9.]+"
_OP_RE = re.compile(
    rb"\((?P<lit>(?:\\.|[^\\()])*)\)\s*(?P<litop>Tj|'|\")"
    rb"|<(?P<hex>[0-9A-Fa-f\s]+)>\s*Tj"  # <hex> Tj
    rb"|\[(?P<arr>(?:\\.|[^\]])*)\]\s*TJ"  # [(a) -120 (b)] TJ
    rb"|/(?P<font>[^\s/<>()\[\]]+)\s+" + _NUM + rb"\s+Tf"  # font select
    rb"|(?P<tm>(?:" + _NUM + rb"\s+){6})Tm"
    rb"|(?P<tdx>" + _NUM + rb")\s+(?P<tdy>" + _NUM + rb")\s+(?P<tdop>TD|Td)"
    rb"|(?P<tl>" + _NUM + rb")\s+TL"
    rb"|(?P<tstar>T\*)"
)
_ARR_STR_RE = re.compile(rb"\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]+>")

_ESCAPES = {
    b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
    b"(": b"(", b")": b")", b"\\": b"\\",
}


def _unescape_literal(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if nxt.isdigit():  # octal escape \ddd
                j = i + 1
                while j < min(i + 4, len(raw)) and raw[j : j + 1].isdigit():
                    j += 1
                try:
                    out.append(int(raw[i + 1 : j], 8) & 0xFF)
                except ValueError:
                    pass
                i = j
                continue
            i += 2
            continue
        out += c
        i += 1
    return bytes(out)


def _hex_bytes(raw: bytes) -> bytes:
    clean = re.sub(rb"\s", b"", raw)
    if len(clean) % 2:
        clean += b"0"
    try:
        return bytes.fromhex(clean.decode("ascii"))
    except ValueError:
        return b""


def _guess_decode(data: bytes) -> str:
    """No font information: UTF-16BE CID text (2-byte codes) decodes
    readably for Latin ranges; otherwise latin-1."""
    if len(data) >= 2 and data[0] == 0 and len(data) % 2 == 0:
        try:
            return data.decode("utf-16-be", errors="replace")
        except UnicodeDecodeError:
            pass
    return data.decode("latin-1", errors="replace")


# -- fonts / ToUnicode CMaps ---------------------------------------------------

_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.S)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.S)
_HEX_TOKEN_RE = re.compile(rb"<([0-9A-Fa-f]+)>")
_CODESPACE_RE = re.compile(
    rb"begincodespacerange\s*<([0-9A-Fa-f]+)>", re.S
)


def _utf16(dst_hex: bytes) -> str:
    b = _hex_bytes(dst_hex)
    if len(b) % 2:
        b = b"\x00" + b
    try:
        return b.decode("utf-16-be", errors="ignore")
    except UnicodeDecodeError:
        return ""


def parse_tounicode(stream: bytes) -> tuple[dict[int, str], int]:
    """Parse a /ToUnicode CMap into {code: unicode} + code byte width.

    Handles beginbfchar pairs and beginbfrange in both the incrementing
    (<lo> <hi> <dst>) and array (<lo> <hi> [<d0> <d1> ...]) forms, the
    decode path of subset fonts."""
    cmap: dict[int, str] = {}
    width = 2
    m = _CODESPACE_RE.search(stream)
    if m:
        width = max(1, len(m.group(1)) // 2)
    for block in _BFCHAR_RE.findall(stream):
        toks = _HEX_TOKEN_RE.findall(block)
        for src, dst in zip(toks[0::2], toks[1::2]):
            cmap[int(src, 16)] = _utf16(dst)
    for block in _BFRANGE_RE.findall(stream):
        # array form: <lo> <hi> [<d0> <d1> ...]
        pos = 0
        while True:
            m3 = re.search(
                rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*"
                rb"(\[(?:\s*<[0-9A-Fa-f]+>\s*)+\]|<[0-9A-Fa-f]+>)",
                block[pos:],
            )
            if not m3:
                break
            lo, hi = int(m3.group(1), 16), int(m3.group(2), 16)
            dst = m3.group(3)
            if dst.startswith(b"["):
                dsts = _HEX_TOKEN_RE.findall(dst)
                for off, d in enumerate(dsts):
                    if lo + off <= hi:
                        cmap[lo + off] = _utf16(d)
            else:
                base = _utf16(dst[1:-1])
                if base:
                    first = ord(base[-1])
                    prefix = base[:-1]
                    for code in range(lo, min(hi, lo + 65535) + 1):
                        cmap[code] = prefix + chr(first + code - lo)
            pos += m3.end()
    return cmap, width


class _Font:
    """Per-font string decoder: ToUnicode CMap when present, heuristic
    otherwise."""

    def __init__(self, cmap: Optional[dict[int, str]] = None,
                 width: int = 1):
        self.cmap = cmap
        self.width = width

    def decode(self, data: bytes) -> str:
        if not self.cmap:
            return _guess_decode(data)
        w = self.width
        out: list[str] = []
        for i in range(0, len(data) - w + 1, w):
            code = int.from_bytes(data[i : i + w], "big")
            ch = self.cmap.get(code)
            if ch is not None:
                out.append(ch)
            elif w == 1 and 32 <= code < 127:
                out.append(chr(code))  # partial map: ASCII passthrough
        return "".join(out)


_DEFAULT_FONT = _Font()


# -- object graph --------------------------------------------------------------


def _stream_of(body: bytes) -> Optional[bytes]:
    m = _STREAM_RE.search(body)
    if not m:
        return None
    raw = m.group(1)
    if b"/FlateDecode" in body[: m.start()]:
        try:
            return zlib.decompress(raw)
        except zlib.error:
            return None
    return raw


def collect_objects(data: bytes) -> dict[int, bytes]:
    """All numbered objects, including those packed in /ObjStm object
    streams (PDF 1.5+ compressed xref files put font dicts and page
    nodes there)."""
    objs: dict[int, bytes] = {}
    for num, body in _OBJ_RE.findall(data):
        objs[int(num)] = body
    for body in list(objs.values()):
        if b"/ObjStm" not in body:
            continue
        stream = _stream_of(body)
        if stream is None:
            continue
        mf = re.search(rb"/First\s+(\d+)", body)
        mn = re.search(rb"/N\s+(\d+)", body)
        if not (mf and mn):
            continue
        first = int(mf.group(1))
        header = stream[:first].split()
        pairs = [
            (int(header[i]), int(header[i + 1]))
            for i in range(0, 2 * int(mn.group(1)) - 1, 2)
            if i + 1 < len(header)
        ]
        for j, (num, off) in enumerate(pairs):
            end = pairs[j + 1][1] if j + 1 < len(pairs) else len(stream)
            objs.setdefault(num, stream[first + off : first + end])
    return objs


_REF_RE_T = rb"/%s\s+(\d+)\s+\d+\s+R"


def _ref(body: bytes, key: bytes) -> Optional[int]:
    m = re.search(_REF_RE_T % re.escape(key), body)
    return int(m.group(1)) if m else None


def _dict_slice(body: bytes, key: bytes) -> Optional[bytes]:
    """The balanced << ... >> dict value following /key, if inline."""
    m = re.search(rb"/" + re.escape(key) + rb"\s*<<", body)
    if not m:
        return None
    start = m.end() - 2
    depth = 0
    i = start
    while i < len(body) - 1:
        if body[i : i + 2] == b"<<":
            depth += 1
            i += 2
        elif body[i : i + 2] == b">>":
            depth -= 1
            i += 2
            if depth == 0:
                return body[start:i]
        else:
            i += 1
    return None


def _page_fonts(page: bytes, objs: dict[int, bytes]) -> dict[bytes, _Font]:
    """Resolve the page's /Resources /Font name->decoder map."""
    res = _dict_slice(page, b"Resources")
    if res is None:
        rnum = _ref(page, b"Resources")
        res = objs.get(rnum, b"") if rnum is not None else b""
    fdict = _dict_slice(res, b"Font")
    if fdict is None:
        fnum = _ref(res, b"Font")
        fdict = objs.get(fnum, b"") if fnum is not None else b""
    fonts: dict[bytes, _Font] = {}
    for m in re.finditer(rb"/([^\s/<>()\[\]]+)\s+(\d+)\s+\d+\s+R", fdict):
        name, fnum = m.group(1), int(m.group(2))
        fbody = objs.get(fnum)
        if fbody is None:
            continue
        cmap, width = None, 1
        tu = _ref(fbody, b"ToUnicode")
        if tu is not None and tu in objs:
            s = _stream_of(objs[tu])
            if s:
                cmap, width = parse_tounicode(s)
        if cmap is None and b"/Type0" in fbody:
            width = 2  # CID font without ToUnicode: 2-byte codes
        fonts[name] = _Font(cmap, width)
    return fonts


def _collect_runs(content: bytes,
                  fonts: Optional[dict[bytes, _Font]] = None
                  ) -> list[tuple[float, float, int, str]]:
    """Decode every text run with its (x, y) line position.

    Tracks the line matrix through Tm/Td/TD/TL/T* (and the implicit T*
    of ' / ") so runs can be reassembled in reading order instead of
    stream order."""
    fonts = fonts or {}
    font = _DEFAULT_FONT
    runs: list[tuple[float, float, int, str]] = []
    seq = 0
    for block in _BT_RE.findall(content):
        lx = ly = 0.0
        leading = 0.0

        def emit(txt: str) -> None:
            nonlocal seq
            if txt:
                runs.append((ly, lx, seq, txt))
                seq += 1

        for m in _OP_RE.finditer(block):
            if m.group("font") is not None:
                font = fonts.get(m.group("font"), _DEFAULT_FONT)
            elif m.group("lit") is not None:
                if m.group("litop") in (b"'", b'"'):  # implicit T*
                    ly -= leading if leading > 0 else 12.0
                emit(font.decode(_unescape_literal(m.group("lit"))))
            elif m.group("hex") is not None:
                emit(font.decode(_hex_bytes(m.group("hex"))))
            elif m.group("arr") is not None:
                parts = []
                for s in _ARR_STR_RE.findall(m.group("arr")):
                    if s.startswith(b"("):
                        parts.append(font.decode(_unescape_literal(s[1:-1])))
                    else:
                        parts.append(font.decode(_hex_bytes(s[1:-1])))
                emit("".join(parts))
            elif m.group("tm") is not None:
                nums = m.group("tm").split()
                try:
                    lx, ly = float(nums[4]), float(nums[5])
                except (ValueError, IndexError):
                    pass
            elif m.group("tdop") is not None:
                try:
                    dx, dy = float(m.group("tdx")), float(m.group("tdy"))
                except ValueError:
                    dx = dy = 0.0
                lx += dx
                ly += dy
                if m.group("tdop") == b"TD":
                    leading = -dy
            elif m.group("tl") is not None:
                try:
                    leading = float(m.group("tl"))
                except ValueError:
                    pass
            elif m.group("tstar") is not None:
                ly -= leading if leading > 0 else 12.0
    return runs


def _lines_struct(runs: list[tuple[float, float, int, str]],
                  y_tol: float = 2.0) -> list[list[tuple[float, str]]]:
    """Group runs into lines by y (top first); each line keeps its runs
    as (x, text) in x-then-stream order."""
    runs = sorted(runs, key=lambda r: (-r[0], r[1], r[2]))
    lines: list[list[tuple[float, str]]] = []
    last_y: Optional[float] = None
    for y, x, _seq, txt in runs:
        if last_y is not None and abs(last_y - y) <= y_tol:
            lines[-1].append((x, txt))
        else:
            lines.append([(x, txt)])
            last_y = y
    return lines


def _shared_cols(a: list[tuple[float, str]], b: list[tuple[float, str]],
                 x_tol: float) -> int:
    return sum(1 for xa, _ in a
               if any(abs(xa - xb) <= x_tol for xb, _ in b))


def _render_lines(lines: list[list[tuple[float, str]]],
                  x_tol: float = 4.0) -> list[str]:
    """Emit lines as text, detecting grid-aligned blocks as markdown
    tables: >=2 consecutive lines whose runs start at >=2 shared x
    positions are a table (the layout signal MinerU reads from cell
    boxes; reference mineru_parser.py renders tables to markdown the
    same way).  Inline font-change runs don't trigger it — accidental
    x agreement across consecutive lines at >=2 positions is what a
    ruled grid produces, not prose."""
    out: list[str] = []
    block: list[list[tuple[float, str]]] = []

    def flush() -> None:
        if not block:
            return
        if len(block) >= 2:
            # cluster x starts into columns
            cols: list[float] = []
            for ln in block:
                for x, _ in ln:
                    if not any(abs(x - c) <= x_tol for c in cols):
                        cols.append(x)
            cols.sort()
            rows = []
            for ln in block:
                cells = [""] * len(cols)
                for x, txt in ln:
                    ci = min(range(len(cols)), key=lambda i: abs(cols[i] - x))
                    cells[ci] = (cells[ci] + " " + txt).strip()
                rows.append([c.replace("|", "\\|") for c in cells])
            out.append("")
            out.append("| " + " | ".join(rows[0]) + " |")
            out.append("|" + "|".join([" --- "] * len(cols)) + "|")
            for r in rows[1:]:
                out.append("| " + " | ".join(r) + " |")
            out.append("")
        else:
            for ln in block:
                out.append(" ".join(t for _x, t in ln if t).strip())
        block.clear()

    for ln in lines:
        multi = len(ln) >= 2
        if multi and block and _shared_cols(block[-1], ln, x_tol) >= 2:
            block.append(ln)
        elif multi:
            flush()
            block.append(ln)
        else:
            flush()  # a single-run line ends any pending grid
            out.append(" ".join(t for _x, t in ln if t).strip())
    flush()
    return out


def _lines_text(runs: list[tuple[float, float, int, str]],
                y_tol: float = 2.0) -> list[str]:
    """Reading-order lines with grid-aligned blocks as markdown tables."""
    return _render_lines(_lines_struct(runs, y_tol))


def _assemble_runs(runs: list[tuple[float, float, int, str]],
                   y_tol: float = 2.0) -> str:
    """Reading order from positions: detect a two-column layout from a
    persistent gap in run x positions, then emit each column's lines
    top-to-bottom (the layout a naive stream-order walk scrambles;
    the reference gets it from MinerU/Docling)."""
    if not runs:
        return ""
    xs = sorted({round(x, 1) for _y, x, _s, _t in runs})
    # a >=3-column grid (consecutive lines sharing >=3 run x-positions)
    # is a TABLE spanning the page, not a two-column layout — the
    # column-split heuristic would cleave its rightmost column off
    struct = _lines_struct(runs)
    grid3 = any(
        len(a) >= 3 and len(b) >= 3 and _shared_cols(a, b, 4.0) >= 3
        for a, b in zip(struct, struct[1:])
    )
    column_split = None
    if not grid3 and len(runs) >= 6 and len(xs) >= 2:
        gaps = [(xs[i + 1] - xs[i], (xs[i] + xs[i + 1]) / 2)
                for i in range(len(xs) - 1)]
        gap, mid = max(gaps)
        left = [r for r in runs if r[1] < mid]
        right = [r for r in runs if r[1] >= mid]
        span = xs[-1] - xs[0]
        if gap > max(120.0, 0.3 * span) and len(left) >= 3 \
                and len(right) >= 3:
            # true columns coexist vertically: their y-ranges overlap
            ly = [r[0] for r in left]
            ry = [r[0] for r in right]
            lo, hi = max(min(ly), min(ry)), min(max(ly), max(ry))
            smaller = max(1e-6, min(max(ly) - min(ly), max(ry) - min(ry)))
            if (hi - lo) / smaller > 0.5:
                column_split = mid
    if column_split is not None:
        out_lines = (_lines_text([r for r in runs if r[1] < column_split],
                                 y_tol)
                     + _lines_text([r for r in runs if r[1] >= column_split],
                                   y_tol))
    else:
        out_lines = _lines_text(runs, y_tol)
    text = "\n".join(ln for ln in out_lines if ln)
    text = re.sub(r"[ \t]+", " ", text)
    return re.sub(r"\n{3,}", "\n\n", text).strip()


def _text_from_content(content: bytes,
                       fonts: Optional[dict[bytes, _Font]] = None) -> str:
    return _assemble_runs(_collect_runs(content, fonts))


def _is_textual(body: bytes) -> bool:
    return b"BT" in body and (b"Tj" in body or b"TJ" in body or b"'" in body)


def extract_pdf_text(data: bytes) -> str:
    if b"/Encrypt" in data[:4096] or b"/Encrypt" in data[-4096:]:
        raise ValueError("encrypted PDFs are not supported")
    objs = collect_objects(data)
    chunks: list[str] = []
    seen: set[int] = set()

    # page-structured pass: resolve each page's fonts, then decode its
    # content streams through them (CID/ToUnicode-aware)
    for num, body in objs.items():
        if b"/Type" not in body or b"/Page" not in body or b"/Pages" in body:
            continue
        fonts = _page_fonts(body, objs)
        content_nums: list[int] = []
        carr = re.search(rb"/Contents\s*\[(.*?)\]", body, re.S)
        if carr:
            content_nums = [int(x) for x in
                            re.findall(rb"(\d+)\s+\d+\s+R", carr.group(1))]
        else:
            c = _ref(body, b"Contents")
            if c is not None:
                content_nums = [c]
        for cn in content_nums:
            cbody = objs.get(cn)
            if cbody is None:
                continue
            stream = _stream_of(cbody)
            if stream is None or not _is_textual(stream):
                continue
            seen.add(cn)
            t = _text_from_content(stream, fonts)
            if t:
                chunks.append(t)

    # fallback pass: any remaining textual stream (files whose page tree
    # the regex walk could not resolve)
    for num, body in objs.items():
        if num in seen:
            continue
        stream = _stream_of(body)
        if stream is not None and _is_textual(stream):
            t = _text_from_content(stream)
            if t:
                chunks.append(t)
        elif stream is None and _is_textual(body):
            t = _text_from_content(body)
            if t:
                chunks.append(t)
    text = "\n\n".join(chunks).strip()
    if not text:
        raise ValueError(
            "no extractable text (scanned or custom-encoded PDF)"
        )
    return text


_IMG_DICT_RE = re.compile(rb"/Subtype\s*/Image")
_WH_RE = re.compile(rb"/Width\s+(\d+).*?/Height\s+(\d+)", re.S)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def png_bytes(pixels: bytes, width: int, height: int, channels: int) -> bytes:
    """An 8-bit grey (``channels`` 1) or RGB (3) PNG file of ``width`` x
    ``height`` row-major ``pixels``: signature, IHDR, one IDAT of rows that
    each start with filter type 0 (none), IEND."""
    if width <= 0 or height <= 0:
        raise ValueError("a PNG needs a width and a height")
    stride = width * channels
    raw = b"".join(b"\x00" + pixels[y * stride:(y + 1) * stride]
                   for y in range(height))
    ihdr = struct.pack(">IIBBBBB", width, height, 8,
                       {1: 0, 3: 2}[channels], 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def extract_pdf_images(data: bytes) -> list[tuple[str, bytes]]:
    """Embedded image XObjects as (mime_type, bytes).

    Scanned PDFs are usually one full-page image per page: DCTDecode
    streams ARE JPEG files and JPXDecode streams ARE JPEG-2000 files
    (returned verbatim); FlateDecode raw bitmaps become PNG files
    (``png_bytes``) when the dict gives a decodable geometry.
    """
    images: list[tuple[str, bytes]] = []
    for body in collect_objects(data).values():
        if not _IMG_DICT_RE.search(body):
            continue
        m = _STREAM_RE.search(body)
        if not m:
            continue
        raw = m.group(1)
        if b"/DCTDecode" in body:
            images.append(("image/jpeg", raw))
            continue
        if b"/JPXDecode" in body:
            images.append(("image/jp2", raw))
            continue
        if b"/FlateDecode" in body:
            try:
                pixels = zlib.decompress(raw)
            except zlib.error:
                continue
            wh = _WH_RE.search(body)
            if not wh:
                continue
            w, h = int(wh.group(1)), int(wh.group(2))
            channels = None
            if b"/DeviceRGB" in body and len(pixels) >= w * h * 3:
                channels = 3
            elif b"/DeviceGray" in body and len(pixels) >= w * h:
                channels = 1
            if channels is None or w <= 0 or h <= 0:
                continue  # no geometry to write
            images.append(("image/png", png_bytes(
                pixels[: w * h * channels], w, h, channels)))
    return images


class PdfParser(BaseParser):
    supported_extensions = (".pdf",)

    def parse_file(self, path: str, data: bytes | None = None) -> list[Part]:
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        if not data.startswith(b"%PDF"):
            raise ValueError("not a PDF file")
        parts: list[Part] = []
        images = extract_pdf_images(data)
        try:
            parts.append(TextPart(content=extract_pdf_text(data)))
        except ValueError:
            # image-only (scanned) PDF: OCR the page images where the
            # tesseract binary is installed; without it the vision index
            # still indexes the pages by caption (index/vision.py)
            if images and ocr.default_ocr() is not None:
                page_texts = [t for t in ocr.ocr_images(images) if t]
                if page_texts:
                    parts.append(TextPart(content="\n\n".join(page_texts)))
        for j, (mime, blob) in enumerate(images):
            asset_id = hashlib.sha256(blob).hexdigest()[:16]
            parts.append(AssetBinPart(data=blob, mime_type=mime,
                                      asset_id=asset_id))
            parts.append(ImagePart(content=f"page image {j + 1}",
                                   url=f"asset://{asset_id}"))
        if not parts:
            raise ValueError(
                "no extractable text or images (encrypted or unsupported "
                "encoding)"
            )
        return parts
