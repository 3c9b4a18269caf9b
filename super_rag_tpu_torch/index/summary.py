"""Document summarization for the summary index (port of the JAX
package's index/summary.py).

Counterpart of the reference's map-reduce LLM summary
(index/summary_index.py:60: per-chunk map summaries reduced to one
document summary, embedded with indexer='summary' metadata).  When a
completion client is configured we run the same map-reduce; otherwise an
extractive fallback (lead sentences per chunk, budgeted) keeps the
summary index functional offline.
"""

from __future__ import annotations

import logging
import re
from typing import Callable, Optional

from super_rag_tpu_torch.chunk.chunking import approx_token_count
from super_rag_tpu_torch.llm.prompts import (
    SUMMARY_MAP as MAP_PROMPT,
    SUMMARY_REDUCE as REDUCE_PROMPT,
)

logger = logging.getLogger(__name__)

_SENT_SPLIT = re.compile(r"(?<=[.!?。！？])\s+")


def extractive_summary(chunks: list[str], budget_tokens: int = 300) -> str:
    """Lead-sentence extraction, spread across chunks."""
    out: list[str] = []
    used = 0
    for text in chunks:
        sents = _SENT_SPLIT.split(text.strip())
        if not sents:
            continue
        lead = sents[0].strip()
        n = approx_token_count(lead)
        if used + n > budget_tokens and out:
            break
        out.append(lead)
        used += n
    return " ".join(out)


def summarize_document(
    chunks: list[str],
    completion: Optional[Callable] = None,
    title: str = "",
    map_batch: int = 8,
) -> str:
    if not chunks:
        return ""
    if completion is None:
        return extractive_summary(chunks)
    try:
        partials = []
        for i in range(0, len(chunks), map_batch):
            block = "\n\n".join(chunks[i : i + map_batch])[:8000]
            partials.append(str(completion(prompt=MAP_PROMPT.format(text=block))))
        if len(partials) == 1:
            return partials[0].strip()
        return str(
            completion(
                prompt=REDUCE_PROMPT.format(title=title,
                                            parts="\n\n".join(partials)[:8000])
            )
        ).strip()
    except Exception:  # noqa: BLE001 — degrade to extractive
        logger.warning("summary completion failed; extractive summary instead",
                       exc_info=True)
        return extractive_summary(chunks)
