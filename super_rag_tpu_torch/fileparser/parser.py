"""Parser dispatch by extension with a fallback chain (port of the JAX
package's fileparser/parser.py).

The chain is the JAX package's: markdown, any extra parsers, then PDF,
docx, xlsx, pptx, the legacy doc and ppt, images, and plain text; an
unknown extension falls back to plain-text decoding.  The JAX package
puts its heavy adapters (docling, MinerU) ahead of the built-in PDF and
office parsers when those packages can be imported; the port has no such
adapters, so the built-in parsers always take these files.
"""

from __future__ import annotations

import os
from typing import Optional

from super_rag_tpu_torch.fileparser.base import BaseParser, Part
from super_rag_tpu_torch.fileparser.image import ImageFileParser
from super_rag_tpu_torch.fileparser.markdown import MarkdownParser, TextParser
from super_rag_tpu_torch.fileparser.office import DocxParser, PptxParser, XlsxParser
from super_rag_tpu_torch.fileparser.olebinary import LegacyDocParser, LegacyPptParser
from super_rag_tpu_torch.fileparser.pdf import PdfParser


class DocParser:
    """Dispatch by extension; fall back down the chain on parse errors."""

    def __init__(self, extra_parsers: Optional[list[BaseParser]] = None):
        self.parsers: list[BaseParser] = [
            MarkdownParser(),
            *(extra_parsers or []),
            PdfParser(), DocxParser(), XlsxParser(), PptxParser(),
            LegacyDocParser(), LegacyPptParser(), ImageFileParser(),
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
        ] or [TextParser()]
        last_err: Optional[Exception] = None
        for parser in chain:
            try:
                return parser.parse_file(path, data)
            except Exception as e:  # try next parser in the chain
                last_err = e
        raise ValueError(f"all parsers failed for {path}: {last_err}")
