"""Parser dispatch by extension (port of the JAX package's
fileparser/parser.py).

Markdown, plain text and image files parse here.  The JAX package's PDF
and office parsers (docx / xlsx / pptx and the legacy doc / ppt) are not
ported yet (ROADMAP A6c): a file with one of their extensions raises
``NotImplementedError`` instead of being decoded as text.  Unknown
extensions fall back to plain-text decoding, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

from super_rag_tpu_torch.fileparser.base import BaseParser, Part
from super_rag_tpu_torch.fileparser.image import ImageFileParser
from super_rag_tpu_torch.fileparser.markdown import MarkdownParser, TextParser

# the extensions of the JAX package's pdf and office parsers
UNPORTED_EXTENSIONS = frozenset({
    ".pdf", ".docx", ".xlsx", ".pptx", ".doc", ".ppt",
})


class DocParser:
    """Dispatch by extension; fall back down the chain on parse errors."""

    def __init__(self, extra_parsers: Optional[list[BaseParser]] = None):
        self.parsers: list[BaseParser] = [
            MarkdownParser(),
            *(extra_parsers or []),
            ImageFileParser(),
            TextParser(),
        ]

    def supported_extensions(self) -> set[str]:
        exts: set[str] = set()
        for p in self.parsers:
            exts.update(p.supported_extensions)
        return exts

    def parse_file(self, path: str, data: Optional[bytes] = None) -> list[Part]:
        ext = os.path.splitext(path)[1].lower()
        chain = [
            p for p in self.parsers if ext in p.supported_extensions
        ]
        if not chain and ext in UNPORTED_EXTENSIONS:
            raise NotImplementedError(
                f"{ext} files need a parser the PyTorch port has not ported "
                "yet (ROADMAP A6c)")
        chain = chain or [TextParser()]
        last_err: Optional[Exception] = None
        for parser in chain:
            try:
                return parser.parse_file(path, data)
            except Exception as e:  # try next parser in the chain
                last_err = e
        raise ValueError(f"all parsers failed for {path}: {last_err}")
