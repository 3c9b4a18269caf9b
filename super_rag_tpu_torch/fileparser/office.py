"""Office Open XML parsers: docx / xlsx / pptx with zipfile and
xml.etree (port of the JAX package's fileparser/office.py).

OOXML files are zip archives of XML; the text lives in well-known parts:

  docx  word/document.xml          <w:t> runs, <w:p> paragraphs,
                                   heading styles -> TitlePart levels,
                                   tables -> markdown grids
  xlsx  xl/sharedStrings.xml +     cell values placed by reference, one
        xl/worksheets/sheetN.xml   markdown grid per sheet
  pptx  ppt/slides/slideN.xml      <a:t> runs per slide
"""

from __future__ import annotations

import io
import re
import zipfile
from xml.etree import ElementTree

from super_rag_tpu_torch.fileparser.base import BaseParser, Part, TextPart, TitlePart

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
_S = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"

_HEADING_RE = re.compile(r"Heading(\d)|heading\s*(\d)", re.I)


def _open_zip(path: str, data: bytes | None) -> zipfile.ZipFile:
    if data is None:
        return zipfile.ZipFile(path)
    return zipfile.ZipFile(io.BytesIO(data))


def _col_index(ref: str) -> int | None:
    """'BC23' -> 54 (0-based column); None when the ref has no letters."""
    n = 0
    for ch in ref:
        if ch.isalpha():
            n = n * 26 + (ord(ch.upper()) - 64)
        else:
            break
    return n - 1 if n else None


def _md_table(rows: list[list[str]]) -> str:
    """Rows -> a markdown grid (the shape the reference's Docling path
    produces for tables; ragged rows pad to the widest)."""
    width = max(len(r) for r in rows)
    cells = [[c.replace("|", "\\|") for c in r] + [""] * (width - len(r))
             for r in rows]
    out = ["| " + " | ".join(cells[0]) + " |",
           "|" + "|".join([" --- "] * width) + "|"]
    out += ["| " + " | ".join(r) + " |" for r in cells[1:]]
    return "\n".join(out)


def _iter_blocks(el):
    """Yield w:p / w:tbl descendants in document order, recursing through
    container elements (w:sdt content controls, mc:AlternateContent, text
    boxes) WITHOUT descending into the blocks themselves — a w:tbl's cell
    paragraphs belong to the table, not the body stream."""
    for child in el:
        if child.tag in (f"{_W}p", f"{_W}tbl"):
            yield child
        else:
            yield from _iter_blocks(child)


class DocxParser(BaseParser):
    supported_extensions = (".docx",)

    def parse_file(self, path: str, data: bytes | None = None) -> list[Part]:
        with _open_zip(path, data) as z:
            xml = z.read("word/document.xml")
        root = ElementTree.fromstring(xml)
        body = root.find(f"{_W}body")
        parts: list[Part] = []
        # walk block items IN ORDER: a w:tbl keeps its row structure
        # (markdown grid) instead of flattening cell paragraphs into
        # free-floating text
        for el in _iter_blocks(body if body is not None else root):
            if el.tag == f"{_W}tbl":
                rows = []
                for tr in el.iter(f"{_W}tr"):
                    row = []
                    for tc in tr.iter(f"{_W}tc"):
                        row.append(" ".join(
                            t.text or "" for t in tc.iter(f"{_W}t")
                        ).strip())
                    if any(row):
                        rows.append(row)
                if rows:
                    parts.append(TextPart(content=_md_table(rows)))
                continue
            if el.tag != f"{_W}p":
                continue
            text = "".join(t.text or "" for t in el.iter(f"{_W}t")).strip()
            if not text:
                continue
            style = el.find(f"{_W}pPr/{_W}pStyle")
            level = None
            if style is not None:
                m = _HEADING_RE.search(style.get(f"{_W}val", ""))
                if m:
                    level = int(m.group(1) or m.group(2))
            if level:
                parts.append(TitlePart(content=text, level=min(level, 6)))
            else:
                parts.append(TextPart(content=text))
        if not parts:
            raise ValueError("docx contains no extractable text")
        return parts


class XlsxParser(BaseParser):
    supported_extensions = (".xlsx",)

    def parse_file(self, path: str, data: bytes | None = None) -> list[Part]:
        with _open_zip(path, data) as z:
            shared: list[str] = []
            if "xl/sharedStrings.xml" in z.namelist():
                sroot = ElementTree.fromstring(z.read("xl/sharedStrings.xml"))
                for si in sroot.iter(f"{_S}si"):
                    shared.append("".join(t.text or "" for t in si.iter(f"{_S}t")))
            parts: list[Part] = []
            sheets = sorted(
                n for n in z.namelist()
                if re.match(r"xl/worksheets/sheet\d+\.xml$", n)
            )
            for idx, name in enumerate(sheets, 1):
                root = ElementTree.fromstring(z.read(name))
                rows: list[list[str]] = []
                for row in root.iter(f"{_S}row"):
                    cells: list[str] = []
                    last = -1
                    for c in row.iter(f"{_S}c"):
                        # place by the r="B2" cell reference: sparse rows
                        # omit empty cells, so document order alone shifts
                        # values into the wrong columns
                        ref = c.get("r", "")
                        col = _col_index(ref)
                        if col is None:
                            col = last + 1
                        last = col
                        if c.get("t") == "inlineStr":
                            val = "".join(
                                t.text or "" for t in c.iter(f"{_S}t"))
                        else:
                            v = c.find(f"{_S}v")
                            if v is None or v.text is None:
                                continue
                            if c.get("t") == "s":
                                i = int(v.text)
                                val = shared[i] if i < len(shared) else ""
                            else:
                                val = v.text
                        while len(cells) <= col:
                            cells.append("")
                        cells[col] = val
                    if any(c != "" for c in cells):
                        rows.append(cells)
                if rows:
                    parts.append(TitlePart(content=f"Sheet {idx}", level=2))
                    # a sheet IS a table: keep the grid (markdown), the
                    # shape tab-joined lines lose
                    parts.append(TextPart(content=_md_table(rows)))
        if not parts:
            raise ValueError("xlsx contains no extractable text")
        return parts


class PptxParser(BaseParser):
    supported_extensions = (".pptx",)

    def parse_file(self, path: str, data: bytes | None = None) -> list[Part]:
        with _open_zip(path, data) as z:
            slides = sorted(
                (n for n in z.namelist()
                 if re.match(r"ppt/slides/slide\d+\.xml$", n)),
                key=lambda n: int(re.search(r"(\d+)", n).group(1)),
            )
            parts: list[Part] = []
            for i, name in enumerate(slides, 1):
                root = ElementTree.fromstring(z.read(name))
                texts = [t.text for t in root.iter(f"{_A}t") if t.text]
                if texts:
                    parts.append(TitlePart(content=f"Slide {i}: {texts[0]}",
                                           level=2))
                    body = "\n".join(texts[1:]).strip()
                    if body:
                        parts.append(TextPart(content=body))
        if not parts:
            raise ValueError("pptx contains no extractable text")
        return parts
