"""Standalone image files as documents: scans, screenshots, photos (port
of the JAX package's fileparser/image.py).

The OCR engine (``fileparser/ocr.py``: tesseract, when installed)
recovers any text, and the raw image is always attached as an asset so
the vision-caption ladder (``index/vision.py``) indexes it.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from super_rag_tpu_torch.fileparser import ocr
from super_rag_tpu_torch.fileparser.base import (
    AssetBinPart,
    BaseParser,
    ImagePart,
    Part,
    TextPart,
)

_MIME = {
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
    ".bmp": "image/bmp",
    ".gif": "image/gif",
    ".tif": "image/tiff",
    ".tiff": "image/tiff",
    ".webp": "image/webp",
}


class ImageFileParser(BaseParser):
    supported_extensions = tuple(_MIME)

    def parse_file(self, path: str, data: Optional[bytes] = None) -> list[Part]:
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        ext = os.path.splitext(path)[1].lower()
        mime = _MIME.get(ext, "application/octet-stream")

        parts: list[Part] = []
        engine = ocr.default_ocr()
        if engine is not None:
            try:
                text = engine.image_to_text(data)
            except Exception:  # unreadable image: the asset still indexes
                text = ""
            if text:
                parts.append(TextPart(content=text))
        asset_id = hashlib.sha256(data).hexdigest()[:16]
        parts.append(AssetBinPart(data=data, mime_type=mime,
                                  asset_id=asset_id))
        parts.append(ImagePart(content=os.path.basename(path),
                               url=f"asset://{asset_id}"))
        return parts
