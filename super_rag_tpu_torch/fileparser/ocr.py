"""OCR engines for scanned documents (port of the JAX package's
fileparser/ocr.py).

  TesseractOCR   shells out to the `tesseract` binary when installed
                 (stdin image -> stdout text; no python deps)

``default_ocr()`` returns it when the binary is on the PATH, else None.
The JAX package's chain goes on to pytesseract and its Pillow glyph
engine; the port imports neither package, so an image that only those
read indexes only its caption here.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional


class OCREngine:
    name = "base"

    def image_to_text(self, image_bytes: bytes) -> str:
        raise NotImplementedError


class TesseractOCR(OCREngine):
    name = "tesseract"

    def __init__(self, binary: str = "tesseract", lang: str = "eng"):
        self.binary = binary
        self.lang = lang

    @classmethod
    def available(cls, binary: str = "tesseract") -> bool:
        return shutil.which(binary) is not None

    def image_to_text(self, image_bytes: bytes) -> str:
        proc = subprocess.run(
            [self.binary, "stdin", "stdout", "-l", self.lang],
            input=image_bytes, capture_output=True, timeout=120,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"tesseract failed: {proc.stderr.decode('utf-8', 'replace')[:200]}"
            )
        return proc.stdout.decode("utf-8", "replace").strip()


def default_ocr() -> Optional[OCREngine]:
    if TesseractOCR.available():
        return TesseractOCR()
    return None


def ocr_images(images: list[tuple[str, bytes]],
               engine: Optional[OCREngine] = None) -> list[str]:
    """OCR a list of (mime, bytes) page images; skips failed pages."""
    engine = engine or default_ocr()
    if engine is None:
        return []
    out = []
    for _mime, data in images:
        try:
            text = engine.image_to_text(data)
        except Exception:  # noqa: BLE001 — one bad page must not kill the doc
            text = ""
        out.append(text)
    return out
