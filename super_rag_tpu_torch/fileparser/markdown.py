"""Markdown and plain text -> Parts (port of the JAX package's
fileparser/markdown.py).

The JAX package walks a markdown-it token stream (CommonMark with tables,
HTML off).  The port carries no markdown library, so this module holds a
block parser of its own that yields the same Parts for what that walk
reads: ATX and setext headings become TitlePart(level), fenced code
becomes CodePart, paragraphs (also inside lists and block quotes) become
TextPart with markdown-it's inline text, a table becomes one TextPart of
its cells one per line, and indented code, thematic breaks and fence-less
HTML are dropped or kept as markdown-it keeps them.  Embedded base64
images are extracted to AssetBinPart and replaced by an ImagePart
reference.
"""

from __future__ import annotations

import base64
import hashlib
import re
from typing import Optional

from super_rag_tpu_torch.fileparser.base import (
    AssetBinPart,
    BaseParser,
    CodePart,
    ImagePart,
    Part,
    TextPart,
    TitlePart,
)

_DATA_URI = re.compile(r"data:(image/[\w.+-]+);base64,([A-Za-z0-9+/=\s]+)")

_FENCE = re.compile(r"^( {0,3})(`{3,}|~{3,})(.*)$")
_QUOTE = re.compile(r"^ {0,3}> ?")
_HR = re.compile(r"^ {0,3}(?:(?:\*[ \t]*){3,}|(?:-[ \t]*){3,}|(?:_[ \t]*){3,})$")
_BULLET = re.compile(r"^( {0,3})([-+*])([ \t]+|$)")
_ORDERED = re.compile(r"^( {0,3})(\d{1,9})([.)])([ \t]+|$)")
_ATX = re.compile(r"^ {0,3}(#{1,6})(?=[ \t]|$)(.*)$")
_SETEXT = re.compile(r"^ {0,3}(=+|-+)[ \t]*$")
_TABLE_DELIM = re.compile(r"^:?-+:?$")


def _extract_data_uris(md_text: str) -> tuple[str, list[AssetBinPart]]:
    assets: list[AssetBinPart] = []

    def repl(m: re.Match) -> str:
        mime, b64 = m.group(1), m.group(2)
        try:
            data = base64.b64decode(b64)
        except Exception:
            return m.group(0)
        asset_id = hashlib.sha256(data).hexdigest()[:16]
        assets.append(
            AssetBinPart(data=data, mime_type=mime, asset_id=asset_id)
        )
        return f"asset://{asset_id}"

    return _DATA_URI.sub(repl, md_text), assets


def _indent(line: str) -> int:
    col = 0
    for ch in line:
        if ch == " ":
            col += 1
        elif ch == "\t":
            col += 4 - col % 4
        else:
            break
    return col


def _dedent(line: str, cols: int) -> str:
    """``line`` less up to ``cols`` columns of leading whitespace."""
    i = col = 0
    while i < len(line) and col < cols and line[i] in " \t":
        col += 1 if line[i] == " " else 4 - col % 4
        i += 1
    return line[i:]


def _blank(line: str) -> bool:
    return not line.strip()


def _list_item(line: str) -> Optional[tuple[int, str]]:
    """(content offset, content) of a list item's first line, else None."""
    m = _BULLET.match(line) or _ORDERED.match(line)
    if m is None:
        return None
    end = m.end(m.lastindex - 1)  # column after the marker
    rest = line[end:]
    spaces = _indent(rest)
    if not rest.strip():
        return end + 1, ""
    if spaces > 4:  # content that starts as indented code
        return end + 1, rest[1:]
    return end + spaces, rest[len(rest) - len(rest.lstrip(" \t")):]


def _split_row(line: str) -> list[str]:
    cells, cur, i = [], "", 0
    while i < len(line):
        ch = line[i]
        if ch == "\\" and i + 1 < len(line) and line[i + 1] == "|":
            cur += "|"
            i += 2
            continue
        if ch == "|":
            cells.append(cur)
            cur = ""
        else:
            cur += ch
        i += 1
    cells.append(cur)
    if cells and cells[0].strip() == "":
        cells.pop(0)
    if cells and cells[-1].strip() == "":
        cells.pop()
    return cells


def _table_columns(lines: list[str], i: int) -> int:
    """Columns of a GFM table whose header is ``lines[i]``, else 0."""
    if i + 1 >= len(lines) or _indent(lines[i]) >= 4 or _indent(lines[i + 1]) >= 4:
        return 0
    delim = lines[i + 1].strip()
    if len(delim) < 2 or delim[0] not in "|-:" or delim[1] not in "|-: \t":
        return 0
    if delim[0] == "-" and delim[1] in " \t":
        return 0
    if any(ch not in "|-: \t" for ch in delim):
        return 0
    parts = delim.split("|")
    aligns = 0
    for k, p in enumerate(parts):
        t = p.strip()
        if not t:
            if k in (0, len(parts) - 1):
                continue
            return 0
        if not _TABLE_DELIM.match(t):
            return 0
        aligns += 1
    header = lines[i].strip()
    if "|" not in header:
        return 0
    cols = len(_split_row(header))
    return cols if cols and cols == aligns else 0


def _fence_opens(line: str) -> bool:
    m = _FENCE.match(line)
    # a backtick fence's info string may hold no backtick
    return m is not None and not (m.group(2)[0] == "`" and "`" in m.group(3))


def _starts_block(lines: list[str], i: int, in_paragraph: bool) -> bool:
    """Whether ``lines[i]`` opens a block that ends a paragraph."""
    line = lines[i]
    if _indent(line) >= 4:
        return False
    if _fence_opens(line):
        return True
    if _QUOTE.match(line) or _HR.match(line) or _ATX.match(line):
        return True
    item = _list_item(line)
    if item is not None:
        if not in_paragraph:
            return True
        m = _ORDERED.match(line)
        return bool(item[1].strip()) and (m is None or m.group(2) == "1")
    return _table_columns(lines, i) > 0


class _Blocks:
    """Block tokens of markdown-it's CommonMark + table grammar, as far as
    MarkdownParser reads them: ("heading", level, text), ("inline", text),
    ("fence", info, content) and ("table", cells)."""

    def __init__(self):
        self.tokens: list[tuple] = []

    def parse(self, lines: list[str], open_end: bool = False) -> None:
        """``open_end``: the last line ends the document without a newline."""
        i, n = 0, len(lines)
        while i < n:
            line = lines[i]
            if _blank(line):
                i += 1
                continue
            cols = _table_columns(lines, i)
            if cols:
                i = self._table(lines, i, cols)
            elif _indent(line) >= 4:  # indented code: markdown-it's code_block
                i += 1
                while i < n and (_blank(lines[i]) or _indent(lines[i]) >= 4):
                    i += 1
            elif _fence_opens(line):
                i = self._fence(lines, i, open_end)
            elif _QUOTE.match(line):
                i = self._container(lines, i, open_end, quote=True)
            elif _HR.match(line):
                i += 1
            elif _list_item(line) is not None:
                i = self._container(lines, i, open_end, quote=False)
            elif _ATX.match(line):
                self.tokens.append(("heading", *self._atx(line)))
                i += 1
            else:
                i = self._paragraph(lines, i)

    @staticmethod
    def _atx(line: str) -> tuple[int, str]:
        m = _ATX.match(line)
        rest = m.group(2).rstrip(" \t")
        t = rest.rstrip("#")
        if len(t) < len(rest) and (t == "" or t[-1] in " \t"):
            rest = t
        return len(m.group(1)), rest.strip()

    def _fence(self, lines: list[str], i: int, open_end: bool) -> int:
        m = _FENCE.match(lines[i])
        pad, marker, info = len(m.group(1)), m.group(2), m.group(3)
        close = re.compile(r"^ {0,3}" + re.escape(marker[0]) + "{" + str(len(marker))
                           + r",}[ \t]*$")
        body, j = [], i + 1
        while j < len(lines) and not close.match(lines[j]):
            body.append(_dedent(lines[j], pad))
            j += 1
        content = "".join(b + "\n" for b in body)
        if j >= len(lines) and open_end and content:
            content = content[:-1]
        self.tokens.append(("fence", info.strip(), content))
        return j + 1

    def _paragraph(self, lines: list[str], i: int) -> int:
        body, j = [lines[i]], i + 1
        while j < len(lines) and not _blank(lines[j]):
            line = lines[j]
            if _indent(line) < 4 and _SETEXT.match(line):
                level = 1 if line.strip()[0] == "=" else 2
                self.tokens.append(("heading", level, "\n".join(body).strip()))
                return j + 1
            if _starts_block(lines, j, True):
                break
            body.append(line)
            j += 1
        self.tokens.append(("inline", "\n".join(body).strip()))
        return j

    def _table(self, lines: list[str], i: int, cols: int) -> int:
        cells = [c.strip() for c in _split_row(lines[i].strip())]
        j = i + 2
        while j < len(lines) and not _blank(lines[j]) and _indent(lines[j]) < 4:
            if _starts_block(lines, j, False) and not _table_columns(lines, j):
                break
            row = _split_row(lines[j].strip())
            cells.extend(row[c].strip() if c < len(row) else "" for c in range(cols))
            j += 1
        self.tokens.append(("table", cells))
        return j

    def _container(self, lines: list[str], i: int, open_end: bool, quote: bool) -> int:
        """A block quote, or a list (its items parsed one by one)."""
        n = len(lines)
        while True:
            if quote:
                inner = [lines[i][_QUOTE.match(lines[i]).end():]]
                offset = None
            else:
                offset, first = _list_item(lines[i])
                inner = [first]
            j = i + 1
            while j < n:
                line = lines[j]
                if quote:
                    m = _QUOTE.match(line)
                    if m:
                        inner.append(line[m.end():])
                    elif (_blank(line) or _blank(inner[-1])
                          or _starts_block(lines, j, True)):
                        break
                    else:
                        inner.append(line)  # lazy continuation
                elif _blank(line):
                    inner.append("")
                elif _indent(line) >= offset:
                    inner.append(_dedent(line, offset))
                elif (_blank(inner[-1]) or _starts_block(lines, j, True)
                      or _list_item(line) is not None):
                    break
                else:
                    inner.append(_dedent(line, offset))  # lazy continuation
                j += 1
            self.parse(inner, open_end and j >= n)
            if quote or j >= n or _list_item(lines[j]) is None or _HR.match(lines[j]):
                return j
            i = j  # the next item of the list


class MarkdownParser(BaseParser):
    supported_extensions = (".md", ".markdown")

    def parse_file(self, path: str, data: bytes | None = None) -> list[Part]:
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        return self.parse_text(data.decode("utf-8", errors="replace"))

    def parse_text(self, text: str) -> list[Part]:
        text, assets = _extract_data_uris(text)
        text = text.replace("\r\n", "\n").replace("\r", "\n").replace("\0", "�")
        blocks = _Blocks()
        lines = text.split("\n")
        if lines and lines[-1] == "":
            lines.pop()
            open_end = False
        else:
            open_end = True
        blocks.parse(lines, open_end)
        parts: list[Part] = []
        for tok in blocks.tokens:
            if tok[0] == "heading":
                parts.append(TitlePart(content=tok[2], level=tok[1]))
            elif tok[0] == "fence":
                parts.append(CodePart(content=tok[2], language=tok[1]))
            elif tok[0] == "table":
                parts.append(TextPart(content="\n".join(tok[1])))
            else:
                content = tok[1]
                if content:
                    for m in re.finditer(r"asset://(\w+)", content):
                        parts.append(ImagePart(url=f"asset://{m.group(1)}"))
                    cleaned = re.sub(r"!\[[^\]]*\]\(asset://\w+\)", "", content).strip()
                    if cleaned:
                        parts.append(TextPart(content=cleaned))
        parts.extend(assets)
        return parts


class TextParser(BaseParser):
    supported_extensions = (".txt", ".log", ".py", ".json", ".yaml", ".yml",
                            ".csv", ".html", ".htm")

    def parse_file(self, path: str, data: bytes | None = None) -> list[Part]:
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        text = data.decode("utf-8", errors="replace")
        if path.endswith((".html", ".htm")):
            text = re.sub(r"<script.*?</script>|<style.*?</style>", "", text,
                          flags=re.S | re.I)
            text = re.sub(r"<[^>]+>", " ", text)
            text = re.sub(r"\s+", " ", text)
        return [TextPart(content=text.strip())]
