"""Readability-grade main-content extraction with stdlib only (a copy
of the JAX package's websearch/readability.py, which imports nothing
beyond the standard library).

The reference reads pages through trafilatura
(websearch/reader/providers/trafilatura_read_provider.py); rather than
depend on that library, this module implements the same class of
algorithm — block segmentation + text/link-density scoring — on top of
html.parser:

  1. parse the page into BLOCKS (text attributed to the nearest block
     ancestor: p, li, h*, pre, td, blockquote, div...);
  2. score each block by text length x (1 - link_density)^2, boosted for
     paragraph-like tags and sentence punctuation, zeroed inside
     boilerplate containers (nav/header/footer/aside/form);
  3. keep blocks above a fraction of the top score, in document order —
     the dense article cluster survives, link farms and chrome drop out.
"""

from __future__ import annotations

import html as html_lib
import re
from dataclasses import dataclass, field
from html.parser import HTMLParser

BLOCK_TAGS = {
    "p", "li", "h1", "h2", "h3", "h4", "h5", "h6", "pre", "blockquote",
    "td", "dd", "dt", "figcaption", "summary", "div", "section", "article",
    "main",
}
SKIP_TAGS = {"script", "style", "noscript", "svg", "template", "iframe",
             "button", "select", "option", "form"}
BOILERPLATE_TAGS = {"nav", "header", "footer", "aside", "menu"}
_SELF_CLOSING = {"br", "hr", "img", "meta", "link", "input"}


@dataclass
class _Block:
    tag: str
    text: list[str] = field(default_factory=list)
    link_chars: int = 0
    boilerplate: bool = False

    @property
    def content(self) -> str:
        return re.sub(r"\s+", " ", "".join(self.text)).strip()


class _BlockParser(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.blocks: list[_Block] = []
        self._stack: list[str] = []
        self._skip = 0
        self._boiler = 0
        self._link = 0
        self._current: _Block | None = None
        self.title = ""
        self._in_title = False

    def _flush(self) -> None:
        if self._current is not None and self._current.content:
            self.blocks.append(self._current)
        self._current = None

    def handle_starttag(self, tag, attrs):
        if tag in _SELF_CLOSING:
            if tag == "br" and self._current is not None:
                self._current.text.append(" ")
            return
        if tag == "title":
            self._in_title = True
        if tag in SKIP_TAGS:
            self._skip += 1
        if tag in BOILERPLATE_TAGS:
            self._boiler += 1
        if tag == "a":
            self._link += 1
        if tag in BLOCK_TAGS and not self._skip:
            self._flush()
            self._current = _Block(tag=tag, boilerplate=self._boiler > 0)
        self._stack.append(tag)

    def handle_endtag(self, tag):
        if tag in _SELF_CLOSING:
            return
        if tag == "title":
            self._in_title = False
        # tolerate unbalanced HTML: pop to the nearest matching open tag
        if tag in self._stack:
            while self._stack and self._stack[-1] != tag:
                self._stack.pop()
            if self._stack:
                self._stack.pop()
        if tag in SKIP_TAGS and self._skip:
            self._skip -= 1
        if tag in BOILERPLATE_TAGS and self._boiler:
            self._boiler -= 1
        if tag == "a" and self._link:
            self._link -= 1
        if tag in BLOCK_TAGS:
            self._flush()

    def close(self):
        super().close()
        self._flush()  # trailing unclosed block (broken HTML)

    def handle_data(self, data):
        if self._skip:
            return
        if self._in_title:
            self.title += data
            return
        if not data.strip():
            if self._current is not None:
                self._current.text.append(" ")
            return
        if self._current is None:
            self._current = _Block(tag="_text", boilerplate=self._boiler > 0)
        self._current.text.append(data)
        if self._link:
            self._current.link_chars += len(data)


def _score(b: _Block) -> float:
    text = b.content
    n = len(text)
    if n == 0 or b.boilerplate:
        return 0.0
    link_density = min(b.link_chars / n, 1.0)
    s = n * (1.0 - link_density) ** 2
    if b.tag in ("p", "pre", "blockquote"):
        s *= 1.5
    if b.tag.startswith("h"):
        s *= 1.2
    # sentence punctuation marks prose; link farms have few commas/periods
    s *= 1.0 + min(text.count(",") + text.count("."), 10) * 0.05
    return s


def extract_readable(html: str, max_chars: int = 20000,
                     min_fraction: float = 0.08) -> str:
    """Extract the main readable content of an HTML page.

    Returns title + the high-density text blocks in document order.
    """
    parser = _BlockParser()
    try:
        parser.feed(html)
        parser.close()
    except Exception:  # noqa: BLE001 — parser choked: degrade to stripping
        return _strip_all(html)[:max_chars]
    blocks = parser.blocks
    if not blocks:
        return _strip_all(html)[:max_chars]
    scores = [_score(b) for b in blocks]
    top = max(scores)
    if top <= 0:
        return ""
    cut = top * min_fraction
    kept = [b.content for b, s in zip(blocks, scores)
            if s >= cut and s > 20]
    if not kept:  # page of short snippets: keep the best one
        kept = [blocks[scores.index(top)].content]
    title = re.sub(r"\s+", " ", parser.title).strip()
    out = (title + "\n\n" if title else "") + "\n\n".join(kept)
    return out[:max_chars]


def _strip_all(html: str) -> str:
    html = re.sub(r"<script.*?</script>|<style.*?</style>", " ", html,
                  flags=re.S | re.I)
    html = re.sub(r"<[^>]+>", " ", html)
    return re.sub(r"[ \t]+", " ", html_lib.unescape(html)).strip()
