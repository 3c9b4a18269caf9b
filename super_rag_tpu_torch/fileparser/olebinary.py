"""Legacy binary Office parsing: OLE2/CFB container + .doc/.ppt text
(port of the JAX package's fileparser/olebinary.py).

A pure-Python Compound File Binary reader ([MS-CFB]), the Word 97+ piece
table ([MS-DOC] Clx/PlcPcd, which handles mixed cp1252 / UTF-16 text
runs), and PowerPoint text atoms ([MS-PPT] TextCharsAtom / TextBytesAtom).
No third-party dependency, no subprocess.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

CFB_MAGIC = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
FREESECT = 0xFFFFFFFF
ENDOFCHAIN = 0xFFFFFFFE
NOSTREAM = 0xFFFFFFFF


def _u16(b: bytes, off: int) -> int:
    return struct.unpack_from("<H", b, off)[0]


def _u32(b: bytes, off: int) -> int:
    return struct.unpack_from("<I", b, off)[0]


class CompoundFile:
    """Minimal [MS-CFB] reader: header, (DI)FAT, directory, mini stream."""

    def __init__(self, data: bytes):
        if data[:8] != CFB_MAGIC:
            raise ValueError("not an OLE2 compound file")
        self.data = data
        self.sector_size = 1 << _u16(data, 0x1E)
        self.mini_size = 1 << _u16(data, 0x20)
        self.mini_cutoff = _u32(data, 0x38)
        n_fat = _u32(data, 0x2C)
        first_dir = _u32(data, 0x30)
        first_minifat = _u32(data, 0x3C)
        n_minifat = _u32(data, 0x40)
        first_difat = _u32(data, 0x44)
        n_difat = _u32(data, 0x48)

        # DIFAT: 109 header entries + chained DIFAT sectors
        difat = list(struct.unpack_from("<109I", data, 0x4C))
        sec = first_difat
        per = self.sector_size // 4 - 1
        for _ in range(n_difat):
            raw = self._sector(sec)
            entries = struct.unpack_from(f"<{per + 1}I", raw, 0)
            difat.extend(entries[:per])
            sec = entries[per]
            if sec in (ENDOFCHAIN, FREESECT):
                break
        fat_secs = [s for s in difat[: max(n_fat, 0) + len(difat)]
                    if s not in (FREESECT, ENDOFCHAIN)][:n_fat]
        fat = bytearray()
        for s in fat_secs:
            fat.extend(self._sector(s))
        self.fat = struct.unpack(f"<{len(fat) // 4}I", bytes(fat))

        # directory entries (walked linearly: every 128-byte entry)
        dir_bytes = self._read_chain(first_dir)
        self.entries = []
        for off in range(0, len(dir_bytes) - 127, 128):
            raw = dir_bytes[off : off + 128]
            name_len = _u16(raw, 0x40)
            etype = raw[0x42]
            if etype == 0 or name_len < 2:
                continue
            name = raw[: max(name_len - 2, 0)].decode(
                "utf-16-le", errors="replace"
            )
            self.entries.append({
                "name": name,
                "type": etype,
                "start": _u32(raw, 0x74),
                "size": struct.unpack_from("<Q", raw, 0x78)[0]
                & 0xFFFFFFFF,
            })

        root = next(e for e in self.entries if e["type"] == 5)
        self._mini_stream = (
            self._read_chain(root["start"])[: root["size"]]
            if root["start"] not in (ENDOFCHAIN, FREESECT) and root["size"]
            else b""
        )
        minifat = bytearray()
        sec = first_minifat
        for _ in range(n_minifat):
            if sec in (ENDOFCHAIN, FREESECT):
                break
            minifat.extend(self._sector(sec))
            sec = self.fat[sec]
        self.minifat = struct.unpack(f"<{len(minifat) // 4}I", bytes(minifat))

    def _sector(self, sid: int) -> bytes:
        # sector 0 starts right after the 512-byte header for v3 files
        # AND at offset 4096 for v4 (4096-byte sectors): both are
        # (sid + 1) * sector_size — the header occupies sector "-1"
        off = (sid + 1) * self.sector_size
        return self.data[off : off + self.sector_size]

    def _read_chain(self, start: int, limit: int = 1 << 26) -> bytes:
        out = bytearray()
        sec = start
        seen = set()
        while sec not in (ENDOFCHAIN, FREESECT) and sec not in seen:
            seen.add(sec)
            out.extend(self._sector(sec))
            if sec >= len(self.fat) or len(out) > limit:
                break
            sec = self.fat[sec]
        return bytes(out)

    def _read_mini_chain(self, start: int) -> bytes:
        out = bytearray()
        sec = start
        seen = set()
        while sec not in (ENDOFCHAIN, FREESECT) and sec not in seen:
            seen.add(sec)
            out.extend(
                self._mini_stream[sec * self.mini_size
                                  : (sec + 1) * self.mini_size]
            )
            if sec >= len(self.minifat):
                break
            sec = self.minifat[sec]
        return bytes(out)

    def stream_names(self) -> list[str]:
        return [e["name"] for e in self.entries if e["type"] == 2]

    def stream(self, name: str) -> Optional[bytes]:
        for e in self.entries:
            if e["type"] == 2 and e["name"].lower() == name.lower():
                if e["size"] < self.mini_cutoff:
                    return self._read_mini_chain(e["start"])[: e["size"]]
                return self._read_chain(e["start"])[: e["size"]]
        return None


# -- Word (.doc) -------------------------------------------------------------

_DOC_CONTROL = {
    0x0D: "\n",  # paragraph end
    0x0B: "\n",  # line break
    0x07: "\n",  # cell / row mark
    0x0C: "\n",  # page break
    0x1E: "-",  # non-breaking hyphen
    0x1F: "",  # optional hyphen
    0xA0: " ",  # nbsp
}


def _clean_doc_text(raw: str) -> str:
    out = []
    skip_field = 0
    for ch in raw:
        o = ord(ch)
        if o == 0x13:  # field begin: skip the instruction up to 0x14
            skip_field = 1
            continue
        if o == 0x14:
            skip_field = 0
            continue
        if o == 0x15:  # field end
            continue
        if skip_field:
            continue
        if o in _DOC_CONTROL:
            out.append(_DOC_CONTROL[o])
        elif o >= 0x20 or ch in "\t\n":
            out.append(ch)
    return "".join(out)


def extract_doc_text(data: bytes) -> str:
    """Main-document text of a Word 97-2003 binary .doc.

    Reads the FIB for the active Table stream and Clx location
    ([MS-DOC] 2.5.1), then decodes every piece descriptor run —
    fCompressed pieces are cp1252 at fc/2, others UTF-16LE at fc.
    Falls back to a printable-run scan for pre-97 or damaged files.
    """
    cf = CompoundFile(data)
    word = cf.stream("WordDocument")
    if word is None or len(word) < 0x200:
        raise ValueError("no WordDocument stream")
    if _u16(word, 0) != 0xA5EC:
        return _scan_text_fallback(word)
    try:
        flags = _u16(word, 0x0A)
        table_name = f"{(flags >> 9) & 1}Table"
        table = cf.stream(table_name) or cf.stream("0Table") or cf.stream(
            "1Table"
        )
        fc_clx = _u32(word, 0x01A2)
        lcb_clx = _u32(word, 0x01A6)
        ccp_text = _u32(word, 0x004C)
        if table is None or lcb_clx == 0:
            return _scan_text_fallback(word)
        clx = table[fc_clx : fc_clx + lcb_clx]
        # skip Prc blocks (clxt=1) to the Pcdt (clxt=2)
        pos = 0
        while pos < len(clx) and clx[pos] == 1:
            cb = _u16(clx, pos + 1)
            pos += 3 + cb
        if pos >= len(clx) or clx[pos] != 2:
            return _scan_text_fallback(word)
        lcb = _u32(clx, pos + 1)
        plc = clx[pos + 5 : pos + 5 + lcb]
        n = (len(plc) - 4) // 12
        cps = struct.unpack_from(f"<{n + 1}I", plc, 0)
        chunks = []
        total = 0
        for i in range(n):
            pcd = plc[4 * (n + 1) + 8 * i : 4 * (n + 1) + 8 * i + 8]
            fc_raw = _u32(pcd, 2)
            compressed = (fc_raw >> 30) & 1
            fc = fc_raw & 0x3FFFFFFF
            cp_len = cps[i + 1] - cps[i]
            if compressed:
                piece = word[fc // 2 : fc // 2 + cp_len].decode(
                    "cp1252", errors="replace"
                )
            else:
                piece = word[fc : fc + 2 * cp_len].decode(
                    "utf-16-le", errors="replace"
                )
            chunks.append(piece)
            total += cp_len
        text = "".join(chunks)
        if ccp_text:
            text = text[:ccp_text]  # main document only (no headers/notes)
        return _clean_doc_text(text)
    except (struct.error, IndexError, ValueError):
        return _scan_text_fallback(word)


def _scan_text_fallback(word: bytes) -> str:
    """Heuristic printable-run scan (Word 6/95 or damaged piece tables)."""
    runs = []
    cur = bytearray()
    for byte in word:
        if byte in (0x0D, 0x0B, 0x0C) or 0x20 <= byte < 0x7F or byte >= 0xA0:
            cur.append(byte)
        else:
            if len(cur) >= 16:
                runs.append(cur.decode("cp1252", errors="replace"))
            cur = bytearray()
    if len(cur) >= 16:
        runs.append(cur.decode("cp1252", errors="replace"))
    return _clean_doc_text("\n".join(runs))


# -- PowerPoint (.ppt) --------------------------------------------------------

_PPT_TEXT_CHARS = 0x0FA0  # TextCharsAtom: UTF-16LE
_PPT_TEXT_BYTES = 0x0FA8  # TextBytesAtom: cp1252
_PPT_CSTRING = 0x0FBA  # CString: UTF-16LE


def _walk_ppt_records(data: bytes, pos: int, end: int) -> Iterator[str]:
    while pos + 8 <= end:
        ver_inst = _u16(data, pos)
        rec_len = _u32(data, pos + 4)
        rec_type = _u16(data, pos + 2)
        body_end = min(pos + 8 + rec_len, end)
        if (ver_inst & 0xF) == 0xF:  # container record
            yield from _walk_ppt_records(data, pos + 8, body_end)
        elif rec_type in (_PPT_TEXT_CHARS, _PPT_CSTRING):
            yield data[pos + 8 : body_end].decode(
                "utf-16-le", errors="replace"
            )
        elif rec_type == _PPT_TEXT_BYTES:
            yield data[pos + 8 : body_end].decode(
                "cp1252", errors="replace"
            )
        pos = pos + 8 + rec_len


def extract_ppt_text(data: bytes) -> list[str]:
    """All text atoms of a PowerPoint 97-2003 binary .ppt, in order."""
    cf = CompoundFile(data)
    doc = cf.stream("PowerPoint Document")
    if doc is None:
        raise ValueError("no PowerPoint Document stream")
    out = []
    for text in _walk_ppt_records(doc, 0, len(doc)):
        text = text.replace("\r", "\n").replace("\x0b", "\n").strip("\x00")
        if text.strip():
            out.append(text)
    return out


# -- parser adapters ----------------------------------------------------------

from super_rag_tpu_torch.fileparser.base import BaseParser, Part, TextPart  # noqa: E402


def _read(path: str, data: Optional[bytes]) -> bytes:
    if data is not None:
        return data
    with open(path, "rb") as fh:
        return fh.read()


class LegacyDocParser(BaseParser):
    """Word 97-2003 binary .doc (ref parity: docling_parser.py soffice)."""

    supported_extensions = (".doc",)

    def parse_file(self, path: str, data: Optional[bytes] = None) -> list[Part]:
        text = extract_doc_text(_read(path, data))
        parts: list[Part] = []
        for para in text.split("\n"):
            para = para.strip()
            if para:
                parts.append(TextPart(content=para))
        if not parts:
            raise ValueError("empty .doc text")
        return parts


class LegacyPptParser(BaseParser):
    """PowerPoint 97-2003 binary .ppt."""

    supported_extensions = (".ppt",)

    def parse_file(self, path: str, data: Optional[bytes] = None) -> list[Part]:
        texts = extract_ppt_text(_read(path, data))
        parts: list[Part] = []
        for text in texts:
            for ln in text.split("\n"):
                ln = ln.strip()
                if ln:
                    parts.append(TextPart(content=ln))
        if not parts:
            raise ValueError("empty .ppt text")
        return parts
