"""Document part model and parser interface (port of the JAX package's
fileparser/base.py).

Mirrors the contract of the reference's Part hierarchy
(super_rag/fileparser/base.py:12-68: MarkdownPart/TextPart/TitlePart(level)/
CodePart/ImagePart/AssetBinPart and BaseParser with supported_extensions/
parse_file) so indexers and the chunker are parser-agnostic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Part:
    content: str = ""
    metadata: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "kind": type(self).__name__,
            "content": self.content,
            "metadata": self.metadata,
            **(
                {"level": self.level}  # type: ignore[attr-defined]
                if isinstance(self, TitlePart)
                else {}
            ),
        }

    @staticmethod
    def from_dict(d: dict) -> "Part":
        kind = d.get("kind", "TextPart")
        cls = _KINDS.get(kind, TextPart)
        if cls is TitlePart:
            return TitlePart(
                content=d.get("content", ""),
                metadata=d.get("metadata", {}),
                level=d.get("level", 1),
            )
        return cls(content=d.get("content", ""), metadata=d.get("metadata", {}))


@dataclass
class TextPart(Part):
    pass


@dataclass
class MarkdownPart(Part):
    pass


@dataclass
class TitlePart(Part):
    level: int = 1


@dataclass
class CodePart(Part):
    language: str = ""


@dataclass
class ImagePart(Part):
    """Reference to an image (URL or asset id) with optional alt text."""

    url: str = ""


@dataclass
class AssetBinPart(Part):
    """Binary asset (e.g. an extracted image) carried alongside parts."""

    data: bytes = b""
    mime_type: str = "application/octet-stream"
    asset_id: str = ""


_KINDS = {
    c.__name__: c
    for c in (Part, TextPart, MarkdownPart, TitlePart, CodePart, ImagePart)
}


class BaseParser:
    """Parser interface: file bytes/path -> list[Part]."""

    supported_extensions: tuple[str, ...] = ()

    def parse_file(self, path: str, data: Optional[bytes] = None) -> list[Part]:
        raise NotImplementedError
