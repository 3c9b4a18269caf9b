"""Vision index: image parts -> searchable text -> vector rows (port of the
JAX package's index/vision.py).

The ladder for each image part:

  1. a configured vision completion client captions the image;
  2. otherwise its alt text (or its asset id) in a line naming the
     document indexes it, so it is still discoverable.

Either way the output is text rows ingested with indexer='vision' so the
device-side indexer filter works unchanged.
"""

from __future__ import annotations

import base64
import logging
from typing import Callable, Optional

from super_rag_tpu_torch.fileparser.base import AssetBinPart, ImagePart, Part

logger = logging.getLogger(__name__)

# the JAX package's llm/prompts.py VISION_CAPTION, word for word
CAPTION_PROMPT = (
    "Describe this image in 2-3 sentences for search indexing. Include any "
    "visible text, charts, and key objects."
)


def vision_rows(
    parts: list[Part],
    vision_completion: Optional[Callable] = None,
    doc_name: str = "",
) -> list[dict]:
    """[{text, asset_id, data, mime_type}] rows for indexer='vision'.

    ``data`` carries the raw image bytes when the asset is embedded, so
    the indexer can compute an IMAGE embedding for the dense branch
    (models/image_embedder.py) while the caption text feeds BM25 — one
    row serves both image->image and text->image retrieval.
    """
    assets = {p.asset_id: p for p in parts if isinstance(p, AssetBinPart)}
    rows: list[dict] = []
    for p in parts:
        if not isinstance(p, ImagePart):
            continue
        asset_id = p.url.removeprefix("asset://")
        caption = ""
        asset = assets.get(asset_id)
        if vision_completion is not None and asset is not None:
            try:
                b64 = base64.b64encode(asset.data).decode()
                caption = str(vision_completion(
                    prompt=CAPTION_PROMPT,
                    images=[{"mime_type": asset.mime_type, "data": b64}],
                )).strip()
            except Exception:  # noqa: BLE001 — fall through to alt text
                logger.exception("vision captioning failed; using alt text")
        if not caption:
            alt = p.content.strip()
            caption = f"Image in {doc_name}: {alt}" if alt else (
                f"Image asset {asset_id} in {doc_name}"
            )
        rows.append({
            "text": caption,
            "asset_id": asset_id,
            "data": asset.data if asset is not None else None,
            "mime_type": asset.mime_type if asset is not None else None,
        })
    return rows
