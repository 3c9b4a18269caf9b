"""A YAML subset for workflow definitions, in place of PyYAML's
``yaml.safe_load`` (which the port does not import).

Covered, with PyYAML's results for them:

  * block mappings (simple and ``?`` explicit keys) and block sequences,
    indentless sequences as mapping values and compact nested entries
    (``- - a``, ``- k: v``);
  * flow mappings ``{}`` and flow sequences ``[]``, over several lines;
  * plain, single-quoted and double-quoted scalars, each folded over
    several lines (double-quoted escapes and escaped line breaks too);
  * YAML 1.1's implicit int / float / bool / null resolution of plain
    scalars, as ``safe_load`` applies it (``yes`` is ``True``, ``0o7`` a
    string, ``1_000`` and ``0x1f`` ints, ``1:30`` base 60, ``1e3`` a
    string and ``1.0e+3`` a float);
  * comments, and one document with an optional ``---`` / ``...``.

Anything else raises ``ValueError`` naming the construct, never a
different tree: anchors, aliases, tags, block scalars (``|``, ``>``),
directives, several documents, timestamps, merge (``<<``) and value
(``=``) keys, collections as mapping keys, single-pair mappings inside a
flow sequence, tabs outside quoted scalars and line breaks other than
``\\n`` / ``\\r\\n`` / ``\\r``.
"""

from __future__ import annotations

import re
from typing import Any

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# the characters PyYAML's reader accepts in a stream
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
                            "\U00010000-\U0010FFFF]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_BLANK = " \n"
_FLOW_INDICATORS = ",[]{}"
# what may not start a plain scalar, and the construct each one opens
_REFUSED_START = {"&": "anchors (&)", "*": "aliases (*)", "!": "tags (!)",
                  "|": "block scalars (|)", ">": "block scalars (>)",
                  "%": "directives (%)", "@": "the reserved indicator @",
                  "`": "the reserved indicator `"}


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        out = 0
        for part in value.split(":"):
            out = out * 60 + int(part)
        return sign * out
    return sign * int(value)


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        out = 0.0
        for part in value.split(":"):
            out = out * 60 + float(part)
        return sign * out
    return sign * float(value)


def resolve(text: str) -> Any:
    """A plain scalar's value under YAML 1.1's implicit resolvers, tried in
    PyYAML's order (bool, float, int, merge, null, timestamp, value)."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if text == "<<":
        raise ValueError("YAML subset: merge keys (<<) are not supported")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise ValueError(f"YAML subset: timestamps ({text!r}) are not supported")
    if text == "=":
        raise ValueError("YAML subset: the value key (=) is not supported")
    return text


class _Scalar(str):
    """A scanned scalar before resolution: ``plain`` says whether the
    implicit resolvers apply; ``lines`` is how many lines it spans."""

    plain: bool
    lines: int


class _Parser:
    def __init__(self, text: str):
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        if text.startswith("\ufeff"):
            text = text[1:]
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise ValueError(f"YAML subset: unacceptable character "
                             f"{bad.group()!r} at offset {bad.start()}")
        for ch in ("\x85", "\u2028", "\u2029"):
            if ch in text:
                raise ValueError(f"YAML subset: the line break {ch!r} is not supported")
        self.s = text
        self.i = 0
        self.n = len(text)

    # -- positions -------------------------------------------------------------

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < self.n else ""

    def col(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def fail(self, what: str) -> ValueError:
        line = self.s.count("\n", 0, self.i) + 1
        return ValueError(f"YAML subset: {what} (line {line}, column {self.col() + 1})")

    def ws_after(self, k: int) -> bool:
        return self.peek(k) in ("", " ", "\n")

    def at_marker(self) -> bool:
        """A document marker (``---`` / ``...``) at column 0."""
        return (self.col() == 0 and self.s.startswith(("---", "..."), self.i)
                and self.ws_after(3))

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.i += 1
        if self.peek() == "\t":
            raise self.fail("tabs outside quoted scalars are not supported")

    def skip_comment(self) -> None:
        if self.peek() == "#":
            j = self.s.find("\n", self.i)
            self.i = self.n if j < 0 else j

    def skip_blank(self) -> None:
        """Spaces, comments and line breaks, up to the next token."""
        while True:
            self.skip_spaces()
            self.skip_comment()
            if self.peek() == "\n":
                self.i += 1
                continue
            return

    def end_of_line(self) -> None:
        """Only spaces and a comment may follow a value on its line."""
        self.skip_spaces()
        if self.peek() == "#" and self.s[self.i - 1] in _BLANK:
            self.skip_comment()
        if self.peek() not in ("", "\n"):
            raise self.fail(f"unexpected {self.peek()!r} after a value")

    # -- the document ------------------------------------------------------------

    def document(self) -> Any:
        self.skip_blank()
        if self.peek() == "%":
            raise self.fail("directives (%) are not supported")
        if self.at_marker() and self.peek() == "-":
            self.i += 3
            value = self.block_value(-1, indentless=False, compact=False)
        elif self.i < self.n:
            value = self.block_node(-1)
        else:
            value = None
        self.skip_blank()
        if self.at_marker() and self.peek() == ".":
            self.i += 3
            self.skip_blank()
        if self.i < self.n:
            if self.at_marker():
                raise self.fail("multiple documents are not supported")
            raise self.fail(f"unexpected {self.peek()!r}")
        return value

    # -- block context -------------------------------------------------------------

    def refuse_start(self) -> None:
        ch = self.peek()
        if ch in _REFUSED_START:
            raise self.fail(f"{_REFUSED_START[ch]} are not supported"
                            if ch not in "@`" else f"{_REFUSED_START[ch]} is not supported")

    def is_entry(self) -> bool:
        return self.peek() == "-" and self.ws_after(1)

    def block_value(self, parent: int, indentless: bool, compact: bool) -> Any:
        """The node after an indicator (``key:``, ``- ``, ``? ``) of a block
        collection at column ``parent``, or the document's root (-1)."""
        self.skip_spaces()
        if self.peek() in ("", "\n", "#"):
            self.skip_blank()
            if self.i >= self.n or self.at_marker():
                return None
            c = self.col()
            if indentless and c == parent and self.is_entry():
                return self.block_sequence(c)
            if c <= parent:
                return None
            return self.block_node(parent)
        # content on the indicator's own line
        if self.is_entry():
            if not compact:
                raise self.fail("a block sequence may not start on a mapping key's line")
            return self.block_sequence(self.col())
        if self.peek() == "?" and self.ws_after(1):
            if not compact:
                raise self.fail("a block mapping may not start on a mapping key's line")
            return self.block_mapping(self.col())
        return self.inline_node(parent, compact)

    def block_node(self, parent: int) -> Any:
        """A node whose first token starts a line, at a column > parent."""
        if self.is_entry():
            return self.block_sequence(self.col())
        if self.peek() == "?" and self.ws_after(1):
            return self.block_mapping(self.col())
        return self.inline_node(parent, compact=True)

    def inline_node(self, parent: int, compact: bool) -> Any:
        """A flow collection or a scalar; a scalar followed by ``:`` opens a
        block mapping at its column where ``compact`` allows one."""
        c = self.col()
        if self.peek() in "[{":
            value = self.flow_collection()
            self.skip_spaces()
            if self.peek() == ":":
                raise self.fail("collections as mapping keys are not supported")
            self.end_of_line()
            return value
        start = self.i
        scalar = self.scalar_token(parent)
        self.skip_spaces()
        if self.peek() == ":" and self.ws_after(1):
            if not compact:
                raise self.fail("mapping values are not allowed here")
            if scalar.lines > 1:
                raise self.fail("a simple key may not span lines")
            self.i = start
            return self.block_mapping(c)
        self.end_of_line()
        return self.value_of(scalar)

    def value_of(self, scalar: _Scalar) -> Any:
        return resolve(str(scalar)) if scalar.plain else str(scalar)

    def block_sequence(self, c: int) -> list:
        out = []
        while True:
            if not (self.col() == c and self.is_entry()):
                raise self.fail("expected a block sequence entry")
            self.i += 1
            out.append(self.block_value(c, indentless=False, compact=True))
            self.skip_blank()
            if self.i >= self.n or self.at_marker():
                return out
            if self.col() > c:
                raise self.fail("bad indentation of a sequence entry")
            if self.col() < c or not self.is_entry():
                return out

    def block_mapping(self, c: int) -> dict:
        out: dict = {}
        while True:
            if self.col() != c:
                raise self.fail("bad indentation of a mapping entry")
            if self.peek() == "?" and self.ws_after(1):
                self.i += 1
                key = self.block_value(c, indentless=False, compact=True)
                self.skip_blank()
                if self.col() == c and self.peek() == ":" and self.ws_after(1):
                    self.i += 1
                    value = self.block_value(c, indentless=True, compact=True)
                else:
                    value = None
            else:
                key = self.simple_key()
                self.i += 1  # the ':'
                value = self.block_value(c, indentless=True, compact=False)
            if isinstance(key, (list, dict)):
                raise self.fail("collections as mapping keys are not supported")
            out[key] = value
            self.skip_blank()
            if self.i >= self.n or self.at_marker() or self.col() < c:
                return out
            if self.col() > c:
                raise self.fail("bad indentation of a mapping entry")
            if self.is_entry():
                return out

    def simple_key(self) -> Any:
        if self.peek() in "[{":
            raise self.fail("collections as mapping keys are not supported")
        scalar = self.scalar_token(-1, one_line=True)
        self.skip_spaces()
        if scalar.lines > 1:
            raise self.fail("a simple key may not span lines")
        if not (self.peek() == ":" and self.ws_after(1)):
            raise self.fail("could not find the expected ':'")
        return self.value_of(scalar)

    # -- scalars -----------------------------------------------------------------

    def scalar_token(self, parent: int, one_line: bool = False,
                     flow: bool = False) -> _Scalar:
        ch = self.peek()
        start = self.i
        if ch in "'\"":
            text = self.quoted(ch == '"')
            plain = False
        else:
            self.refuse_start()
            text = self.plain(parent, flow, one_line)
            plain = True
        out = _Scalar(text)
        out.plain = plain
        out.lines = self.s.count("\n", start, self.i) + 1
        return out

    def plain(self, parent: int, flow: bool, one_line: bool) -> str:
        ch = self.peek()
        if ch in "-?:" and not self.ws_after(1) and (ch == "-" or not flow):
            pass  # '-x', and '?x' / ':x' in block context, start a plain scalar
        elif ch in "-?:,[]{}#'\"" or ch in _BLANK or ch == "":
            raise self.fail(f"a plain scalar may not start with {ch!r}")
        chunks: list[str] = []
        while True:
            j = self.i
            while j < self.n:
                c = self.s[j]
                if c == "\n":
                    break
                if c == ":" and (j + 1 >= self.n or self.s[j + 1] in _BLANK
                                 or (flow and self.s[j + 1] in _FLOW_INDICATORS)):
                    break
                if flow and c in _FLOW_INDICATORS:
                    break
                if c == "#" and j > self.i and self.s[j - 1] == " ":
                    break
                if c == "\t":
                    raise self.fail("tabs outside quoted scalars are not supported")
                j += 1
            piece = self.s[self.i:j].rstrip(" ")
            self.i = self.i + len(piece)
            chunks.append(piece)
            if one_line or self.s.startswith(" #", self.i) or self.peek() == "#":
                break
            # a line break: the scalar goes on where the next line is
            # indented past the parent collection (in flow context, anywhere)
            save = self.i
            self.skip_spaces()
            if self.peek() != "\n":
                self.i = save
                break
            breaks = 0
            while self.peek() == "\n":
                self.i += 1
                breaks += 1
                while self.peek() == " ":
                    self.i += 1
            if (self.i >= self.n or self.peek() == "#" or self.at_marker()
                    or (not flow and self.col() <= parent)):
                self.i = save
                break
            if self.peek() == "\t":
                raise self.fail("tabs outside quoted scalars are not supported")
            chunks.append(" " if breaks == 1 else "\n" * (breaks - 1))
            if flow and self.peek() in _FLOW_INDICATORS:
                chunks.pop()
                self.i = save
                break
            if self.peek() == ":" and self.ws_after(1):
                chunks.pop()
                self.i = save
                break
        return "".join(chunks)

    def quoted(self, double: bool) -> str:
        quote = '"' if double else "'"
        self.i += 1
        chunks: list[str] = []
        while True:
            ch = self.peek()
            if ch == "":
                raise self.fail("unexpected end of stream in a quoted scalar")
            if ch == quote:
                if not double and self.peek(1) == "'":
                    chunks.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(chunks)
            if double and ch == "\\":
                esc = self.peek(1)
                if esc in _ESCAPES:
                    chunks.append(_ESCAPES[esc])
                    self.i += 2
                elif esc in _ESCAPE_CODES:
                    width = _ESCAPE_CODES[esc]
                    digits = self.s[self.i + 2:self.i + 2 + width]
                    if len(digits) != width or any(d not in "0123456789abcdefABCDEF"
                                                   for d in digits):
                        raise self.fail("a bad escape in a double-quoted scalar")
                    chunks.append(chr(int(digits, 16)))
                    self.i += 2 + width
                elif esc == "\n":
                    self.i += 2
                    chunks.append(self.folded_breaks())
                else:
                    raise self.fail(f"unknown escape \\{esc} in a double-quoted scalar")
                continue
            if ch in " \t":
                j = self.i
                while self.peek() in (" ", "\t"):
                    self.i += 1
                if self.peek() == "\n":
                    continue  # whitespace before a break is folded away
                chunks.append(self.s[j:self.i])
                continue
            if ch == "\n":
                self.i += 1
                rest = self.folded_breaks()
                chunks.append(rest if rest else " ")
                continue
            j = self.i
            while self.i < self.n and self.s[self.i] not in " \t\n\\'\"":
                self.i += 1
            if self.i == j:  # the other quote character, or a backslash in ''
                self.i += 1
            chunks.append(self.s[j:self.i])

    def folded_breaks(self) -> str:
        """Past a line break inside a quoted scalar: each following empty
        line is one newline; the next line's leading whitespace goes."""
        out = []
        while True:
            while self.peek() in (" ", "\t"):
                self.i += 1
            if self.at_marker():
                raise self.fail("a document marker inside a quoted scalar")
            if self.peek() != "\n":
                return "".join(out)
            out.append("\n")
            self.i += 1

    # -- flow context --------------------------------------------------------------

    def skip_flow_blank(self) -> None:
        while True:
            while self.peek() in (" ", "\n"):
                self.i += 1
            if self.peek() == "\t":
                raise self.fail("tabs outside quoted scalars are not supported")
            if self.peek() == "#" and self.s[self.i - 1] in _BLANK:
                self.skip_comment()
                continue
            return

    def flow_collection(self) -> Any:
        if self.peek() == "[":
            return self.flow_sequence()
        return self.flow_mapping()

    def flow_node(self) -> Any:
        ch = self.peek()
        if ch in "[{":
            return self.flow_collection()
        if ch == "-" and self.ws_after(1):
            raise self.fail("block sequence entries are not allowed in flow context")
        if ch == "?":
            raise self.fail("'?' is not supported here")
        return self.value_of(self.scalar_token(-1, flow=True))

    def flow_sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip_flow_blank()
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.flow_node())
            self.skip_flow_blank()
            if self.peek() == ":":
                raise self.fail("single-pair mappings inside a flow sequence "
                                "are not supported")
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.fail("expected ',' or ']' in a flow sequence")

    def flow_mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip_flow_blank()
            if self.peek() == "}":
                self.i += 1
                return out
            if self.peek() == "?" and self.ws_after(1):
                self.i += 1
                self.skip_flow_blank()
            if self.peek() in "[{":
                raise self.fail("collections as mapping keys are not supported")
            if self.peek() in ":,}":
                raise self.fail("empty keys in a flow mapping are not supported")
            key = self.flow_node()
            self.skip_flow_blank()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_flow_blank()
                if self.peek() not in ",}":
                    value = self.flow_node()
                    self.skip_flow_blank()
            out[key] = value
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.fail("expected ',' or '}' in a flow mapping")


def load(text: str) -> Any:
    """``yaml.safe_load`` for the subset in the module docstring."""
    return _Parser(text).document()
