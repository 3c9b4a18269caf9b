"""Structure-aware rechunker (port of the JAX package's chunk/chunking.py).

Re-implements the semantics of the reference chunker
(super_rag/chunk/chunking.py: title-hierarchy grouping :90-118,
token-budgeted merge with title guard :120-202, recursive split over
leveled CJK+Latin separators :276-288, overlap cut :343, small-chunk
merge :358) against our Part model:

  * parts stream in document order; TitlePart pushes/pops a title stack,
    content accumulates into sections keyed by the current title path;
  * sections pack greedily into chunks up to ``chunk_size`` tokens,
    merging only while the title path prefix is shared;
  * oversized text splits recursively: paragraphs -> lines -> sentences
    (CJK 。！？；and Latin .!?;) -> clauses -> words, with ``overlap``
    trailing tokens carried into the next chunk;
  * trailing small chunks merge into their predecessor when they fit.

Token counting is pluggable; the default approximates a BPE tokenizer
(words + digits count 1 per ~4 chars, CJK chars count 1 each), so that
chunking needs no tokenizer files.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from super_rag_tpu_torch.fileparser.base import (
    AssetBinPart,
    CodePart,
    ImagePart,
    Part,
    TitlePart,
)

_WORDISH = re.compile(r"[A-Za-z0-9_]+|[^\sA-Za-z0-9_]")
_CJK_CHAR = re.compile(r"[一-鿿぀-ヿ가-힯]")

# Separator ladder, coarse -> fine (reference uses 11 levels including CJK
# sentence enders; chunk/chunking.py:276-288).
SEPARATORS = [
    "\n\n",
    "\n",
    "。", "！", "？", "；",
    ". ", "! ", "? ", "; ",
    "，", ", ",
    " ",
]


def approx_token_count(text: str) -> int:
    """BPE-like token estimate: ~1 token per short word / 4 chars / CJK char."""
    n = 0
    for m in _WORDISH.finditer(text):
        w = m.group(0)
        if _CJK_CHAR.match(w):
            n += 1
        else:
            n += max(1, (len(w) + 3) // 4)
    return n


@dataclass
class Chunk:
    text: str
    title_path: tuple[str, ...] = ()
    metadata: dict = field(default_factory=dict)

    @property
    def padded_text(self) -> str:
        """Title-prefixed text for embedding (the reference prefixes title
        context before embedding — llm/embed/embedding_utils.py:55-79)."""
        if not self.title_path:
            return self.text
        return " > ".join(self.title_path) + "\n" + self.text


class Rechunker:
    def __init__(
        self,
        chunk_size: int = 400,
        chunk_overlap: int = 20,
        count_tokens: Optional[Callable[[str], int]] = None,
    ):
        assert chunk_overlap < chunk_size
        self.chunk_size = chunk_size
        self.overlap = chunk_overlap
        self.count = count_tokens or approx_token_count

    # -- section building ----------------------------------------------------

    def _sections(self, parts: Sequence[Part]) -> list[tuple[tuple[str, ...], str]]:
        """[(title_path, text)] in document order; consecutive titles with
        no content between them collapse into one path."""
        stack: list[tuple[int, str]] = []
        sections: list[tuple[tuple[str, ...], str]] = []
        buf: list[str] = []

        def flush():
            if buf:
                path = tuple(t for _, t in stack)
                sections.append((path, "\n\n".join(buf)))
                buf.clear()

        for p in parts:
            if isinstance(p, TitlePart):
                flush()
                while stack and stack[-1][0] >= p.level:
                    stack.pop()
                stack.append((p.level, p.content))
            elif isinstance(p, (AssetBinPart, ImagePart)):
                continue
            elif isinstance(p, CodePart):
                lang = getattr(p, "language", "")
                buf.append(f"```{lang}\n{p.content}```")
            else:
                if p.content.strip():
                    buf.append(p.content.strip())
        flush()
        # A trailing title with no content still yields an (empty) section so
        # the heading text itself is searchable.
        if not sections and stack:
            sections.append((tuple(t for _, t in stack), ""))
        return sections

    # -- recursive splitting ---------------------------------------------------

    def _split_recursive(self, text: str, level: int = 0) -> list[str]:
        if self.count(text) <= self.chunk_size:
            return [text] if text.strip() else []
        if level >= len(SEPARATORS):
            # hard cut by words
            words = text.split(" ")
            out, cur, cur_n = [], [], 0
            for w in words:
                n = self.count(w) or 1
                if cur and cur_n + n > self.chunk_size:
                    out.append(" ".join(cur))
                    cur, cur_n = [], 0
                cur.append(w)
                cur_n += n
            if cur:
                out.append(" ".join(cur))
            return out
        sep = SEPARATORS[level]
        pieces = [p for p in text.split(sep) if p.strip()]
        if len(pieces) <= 1:
            return self._split_recursive(text, level + 1)
        # keep the separator attached so sentences stay readable
        joined = [
            p + (sep if not sep.startswith("\n") and i < len(pieces) - 1 else "")
            for i, p in enumerate(pieces)
        ]
        out: list[str] = []
        cur: list[str] = []
        cur_n = 0
        for piece in joined:
            n = self.count(piece)
            if n > self.chunk_size:
                if cur:
                    out.append(sep.strip("\n").join(cur) if sep.startswith("\n")
                               else "".join(cur))
                    cur, cur_n = [], 0
                out.extend(self._split_recursive(piece, level + 1))
                continue
            if cur and cur_n + n > self.chunk_size:
                out.append("\n".join(cur) if sep.startswith("\n") else "".join(cur))
                cur, cur_n = [], 0
            cur.append(piece)
            cur_n += n
        if cur:
            out.append("\n".join(cur) if sep.startswith("\n") else "".join(cur))
        return [c for c in out if c.strip()]

    def _apply_overlap(self, pieces: list[str]) -> list[str]:
        if self.overlap <= 0 or len(pieces) <= 1:
            return pieces
        out = [pieces[0]]
        for prev, cur in zip(pieces, pieces[1:]):
            tail_words = prev.split()
            tail, n = [], 0
            for w in reversed(tail_words):
                n += self.count(w) or 1
                if n > self.overlap:
                    break
                tail.append(w)
            prefix = " ".join(reversed(tail))
            out.append((prefix + " " + cur).strip() if prefix else cur)
        return out

    # -- main entry --------------------------------------------------------------

    def rechunk(self, parts: Sequence[Part], metadata: Optional[dict] = None) -> list[Chunk]:
        metadata = metadata or {}
        chunks: list[Chunk] = []
        for path, text in self._sections(parts):
            if not text.strip():
                if path:
                    chunks.append(Chunk(text=path[-1], title_path=path,
                                        metadata=dict(metadata)))
                continue
            pieces = self._split_recursive(text)
            pieces = self._apply_overlap(pieces)
            for piece in pieces:
                chunks.append(Chunk(text=piece, title_path=path,
                                    metadata=dict(metadata)))

        # small-chunk merge: absorb tiny chunks into the previous one when
        # the title path matches and the budget allows (reference :358).
        merged: list[Chunk] = []
        for c in chunks:
            if (
                merged
                and merged[-1].title_path == c.title_path
                and self.count(merged[-1].text) + self.count(c.text)
                <= self.chunk_size
            ):
                merged[-1] = Chunk(
                    text=merged[-1].text + "\n\n" + c.text,
                    title_path=c.title_path,
                    metadata=merged[-1].metadata,
                )
            else:
                merged.append(c)
        for i, c in enumerate(merged):
            c.metadata["chunk_index"] = i
            c.metadata["title_path"] = " > ".join(c.title_path)
        return merged


def rechunk(
    parts: Sequence[Part],
    chunk_size: int = 400,
    chunk_overlap: int = 20,
    metadata: Optional[dict] = None,
) -> list[Chunk]:
    """Reference-compatible entry point (chunk/chunking.py:6)."""
    return Rechunker(chunk_size, chunk_overlap).rechunk(parts, metadata)
