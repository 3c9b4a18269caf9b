"""The port's office parsers (super_rag_tpu_torch/fileparser/office.py and
olebinary.py) against the JAX package's on the CPU: docx, xlsx and pptx
fixtures built with the builders of tests/test_office.py, doc and ppt
fixtures built with make_doc / make_ppt of tests/test_olebinary.py, each
through the parser and through DocParser; corrupt zips and broken OLE
sector chains give the same outcome in both."""

import struct

import numpy as np
import pytest

from super_rag_tpu.fileparser import office as joffice
from super_rag_tpu.fileparser import olebinary as jole
from super_rag_tpu.fileparser.parser import DocParser as JDocParser
from super_rag_tpu_torch.fileparser import office as toffice
from super_rag_tpu_torch.fileparser import olebinary as tole
from super_rag_tpu_torch.fileparser.parser import DocParser as TDocParser

from test_office import A, S, W, zip_bytes
from test_olebinary import make_doc, make_ppt, write_cfb

DOCX = {
    "headings": f"""<?xml version="1.0"?>
<w:document xmlns:w="{W}"><w:body>
  <w:p><w:pPr><w:pStyle w:val="Heading1"/></w:pPr><w:r><w:t>Quarterly Report</w:t></w:r></w:p>
  <w:p><w:pPr><w:pStyle w:val="heading 7"/></w:pPr><w:r><w:t>Deep</w:t></w:r></w:p>
  <w:p><w:pPr><w:pStyle w:val="Title"/></w:pPr><w:r><w:t>Styled</w:t></w:r></w:p>
  <w:p><w:r><w:t>Revenue grew by </w:t></w:r><w:r><w:t>12 percent.</w:t></w:r></w:p>
  <w:p><w:r><w:t>   </w:t></w:r></w:p>
</w:body></w:document>""",
    "table": f"""<?xml version="1.0"?>
<w:document xmlns:w="{W}"><w:body>
  <w:p><w:r><w:t>Before table.</w:t></w:r></w:p>
  <w:tbl>
    <w:tr><w:tc><w:p><w:r><w:t>Name</w:t></w:r></w:p></w:tc>
          <w:tc><w:p><w:r><w:t>Role</w:t></w:r></w:p></w:tc></w:tr>
    <w:tr><w:tc><w:p><w:r><w:t>Alice</w:t></w:r></w:p></w:tc>
          <w:tc><w:p><w:r><w:t>Eng|ineer</w:t></w:r></w:p></w:tc>
          <w:tc><w:p><w:r><w:t>extra</w:t></w:r></w:p></w:tc></w:tr>
    <w:tr><w:tc><w:p/></w:tc></w:tr>
  </w:tbl>
  <w:p><w:r><w:t>After table.</w:t></w:r></w:p>
</w:body></w:document>""",
    "sdt": f"""<?xml version="1.0"?>
<w:document xmlns:w="{W}"><w:body>
  <w:p><w:r><w:t>plain paragraph</w:t></w:r></w:p>
  <w:sdt><w:sdtContent>
    <w:p><w:r><w:t>inside content control</w:t></w:r></w:p>
    <w:tbl><w:tr><w:tc><w:p><w:r><w:t>CellA</w:t></w:r></w:p></w:tc>
                 <w:tc><w:p><w:r><w:t>CellB</w:t></w:r></w:p></w:tc></w:tr></w:tbl>
  </w:sdtContent></w:sdt>
  <w:p><w:r><w:t>after control</w:t></w:r></w:p>
</w:body></w:document>""",
    "no_body": f"""<?xml version="1.0"?>
<w:document xmlns:w="{W}"><w:p><w:r><w:t>bodiless</w:t></w:r></w:p></w:document>""",
    "empty": f"""<?xml version="1.0"?><w:document xmlns:w="{W}"><w:body/></w:document>""",
}

SHEET_SPARSE = f"""<?xml version="1.0"?>
<worksheet xmlns="{S}"><sheetData>
  <row r="1"><c r="A1" t="inlineStr"><is><t>Name</t></is></c>
             <c r="B1" t="inlineStr"><is><t>Qty</t></is></c></row>
  <row r="2"><c r="B2"><v>5</v></c></row>
  <row r="3"><c r="A3" t="inlineStr"><is><t>bolt</t></is></c><c r="C3"><v>7</v></c></row>
  <row r="4"><c><v>no ref</v></c><c t="s"><v>9</v></c><c r="AA4"><v>far</v></c></row>
  <row r="5"><c r="A5"/></row>
</sheetData></worksheet>"""
XLSX = {
    "shared": {"xl/sharedStrings.xml": f"""<?xml version="1.0"?>
<sst xmlns="{S}"><si><t>alpha</t></si><si><r><t>be</t></r><r><t>ta|</t></r></si></sst>""",
               "xl/worksheets/sheet1.xml": f"""<?xml version="1.0"?>
<worksheet xmlns="{S}"><sheetData>
  <row><c t="s"><v>0</v></c><c><v>42</v></c></row>
  <row><c t="s"><v>1</v></c></row>
</sheetData></worksheet>"""},
    "sparse": {"xl/worksheets/sheet1.xml": SHEET_SPARSE,
               "xl/worksheets/sheet2.xml": SHEET_SPARSE.replace("bolt", "nut"),
               "xl/worksheets/sheet10.xml": SHEET_SPARSE.replace("Qty", "Count")},
    "empty": {"xl/worksheets/sheet1.xml": f"<worksheet xmlns=\"{S}\"/>"},
}

SLIDE = f"""<?xml version="1.0"?>
<p:sld xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main"
       xmlns:a="{A}"><p:cSld>{{}}</p:cSld></p:sld>"""
PPTX = {
    "deck": {f"ppt/slides/slide{i}.xml": SLIDE.format(
        "".join(f"<a:t>{t}</a:t>" for t in texts))
        for i, texts in ((1, ["Launch Plan", "Ship in Q3", "Hire two"]), (2, ["Only title"]),
                         (10, ["Tenth", "after the ninth"]), (9, []), (3, ["", "x"]))},
    "empty": {"ppt/slides/slide1.xml": SLIDE.format("")},
}


def _parts(parts):
    return [(type(p).__name__, p.content, getattr(p, "level", None)) for p in parts]


def _outcome(fn, *args):
    try:
        return ("ok", _parts(fn(*args)))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("error", type(e).__name__, str(e))


def _both(name: str, data: bytes, jparser, tparser):
    got = _outcome(tparser.parse_file, name, data)
    assert got == _outcome(jparser.parse_file, name, data)
    assert _outcome(TDocParser().parse_file, name, data) == \
        _outcome(JDocParser().parse_file, name, data)
    return got


@pytest.mark.parametrize("case", sorted(DOCX))
def test_docx_matches(case):
    data = zip_bytes({"word/document.xml": DOCX[case]})
    got = _both("r.docx", data, joffice.DocxParser(), toffice.DocxParser())
    assert got[0] == ("error" if case == "empty" else "ok")


@pytest.mark.parametrize("case", sorted(XLSX))
def test_xlsx_matches(case):
    _both("t.xlsx", zip_bytes(XLSX[case]), joffice.XlsxParser(), toffice.XlsxParser())


@pytest.mark.parametrize("case", sorted(PPTX))
def test_pptx_matches(case):
    _both("d.pptx", zip_bytes(PPTX[case]), joffice.PptxParser(), toffice.PptxParser())


DOCS = {
    "mixed": (["Hello from Word 97.", "Second 8-bit paragraph.", "café crème"],
              ["Unicode 中文 paragraph.", "Ελληνικά"]),
    "fields": (["Before \x13 PAGE \x14 7\x15 after.", "tab\there\x07cell", "\x0c"],
               ["nb space \x1ehyphen\x1f."]),
    "empty": ([""], [""]),
}


@pytest.mark.parametrize("case", sorted(DOCS))
def test_doc_matches(case):
    data = make_doc(*DOCS[case])
    assert tole.extract_doc_text(data) == jole.extract_doc_text(data)
    _both("a.doc", data, jole.LegacyDocParser(), tole.LegacyDocParser())


@pytest.mark.parametrize("texts", [["Slide one title", "Body text line\rnext", "Third\x0b"],
                                   ["\x00\x00", "   "], ["x" * 5000, "y" * 3]])
def test_ppt_matches(texts):
    data = make_ppt(texts)
    assert tole.extract_ppt_text(data) == jole.extract_ppt_text(data)
    _both("b.ppt", data, jole.LegacyPptParser(), tole.LegacyPptParser())


def test_compound_file_streams_match():
    streams = {"Big": bytes(range(256)) * 40, "Small": b"mini" * 100, "Tiny": b"t"}
    data = write_cfb(streams)
    j, t = jole.CompoundFile(data), tole.CompoundFile(data)
    assert t.stream_names() == j.stream_names()
    for name in list(streams) + ["missing", "big"]:
        assert t.stream(name) == j.stream(name)
    assert t.entries == j.entries


def test_doc_fallbacks_match():
    """A WordDocument stream without the Word 97 magic, one without a
    table stream, and a piece table without a Pcdt take the printable-run
    scan in both."""
    word = bytearray(2048)
    word[100:140] = b"Printable run of a Word 6 file here.\r ok"
    cases = [write_cfb({"WordDocument": bytes(word)})]
    struct.pack_into("<H", word, 0, 0xA5EC)
    struct.pack_into("<I", word, 0x01A6, 10)
    cases.append(write_cfb({"WordDocument": bytes(word)}))
    cases.append(write_cfb({"WordDocument": bytes(word), "0Table": b"\x01\x00\x00" * 30}))
    cases.append(write_cfb({"Other": b"x" * 600}))
    for data in cases:
        assert _outcome(tole.LegacyDocParser().parse_file, "a.doc", data) == \
            _outcome(jole.LegacyDocParser().parse_file, "a.doc", data)


def _mutate(seed: int, data: bytes) -> bytes:
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    if seed % 3 == 0:
        for _ in range(int(rng.integers(1, 8))):
            i = int(rng.integers(len(b)))
            b[i] ^= 1 << int(rng.integers(8))
        return bytes(b)
    if seed % 3 == 1:
        return bytes(b[: int(rng.integers(4, len(b)))])
    # an OLE chain pointed at itself, past the end, or at a free sector
    i = 512 + 4 * int(rng.integers(0, 64))
    if i + 4 <= len(b):
        struct.pack_into("<I", b, i, int(rng.choice([0, 1, 0xFFFFFFFF, 0xFFFFFFFE, 10 ** 6])))
    struct.pack_into("<I", b, 0x30, int(rng.choice([0, 3, 10 ** 6])))
    return bytes(b)


@pytest.mark.parametrize("seed", range(24))
def test_corrupt_zips_and_ole_chains_match(seed):
    docs = [("a.docx", zip_bytes({"word/document.xml": DOCX["table"]})),
            ("b.xlsx", zip_bytes(XLSX["sparse"])), ("c.pptx", zip_bytes(PPTX["deck"])),
            ("d.doc", make_doc(*DOCS["mixed"])), ("e.ppt", make_ppt(["Alpha", "Beta"]))]
    name, data = docs[seed % len(docs)]
    bad = _mutate(seed, data)
    assert _outcome(TDocParser().parse_file, name, bad) == \
        _outcome(JDocParser().parse_file, name, bad)
