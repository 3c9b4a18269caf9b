"""Collection-level query engine: embed + dense + BM25 + RRF + rerank
(port of the JAX package's engine/collection.py).

The stages run as device ops over a shared ``DeviceIndex``;
``QueryBatcher`` (engine/batcher.py) coalesces concurrent requests into
one ``search_batch`` call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike
from super_rag_tpu_torch.engine.index import (
    INDEXER_CODES, DeviceIndex, FilterSpec, IndexSpec, _chat_hash)
from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
from super_rag_tpu_torch.trace.tracing import get_tracer

_TRACE = get_tracer()


@dataclass
class SearchHit:
    row: int
    score: float
    text: str
    metadata: dict
    recall_type: str  # vector_search | fulltext_search | hybrid | reranked


class CollectionEngine:
    """One collection: a DeviceIndex + an embedder (+ optional reranker).

    ``embedder`` is any object with ``embed(list[str]) -> [B, dim]``
    (tensor or array): the default HashEmbedder, or
    ``models/encoder_service.EncoderService``.  ``reranker`` is an
    optional callable ``(query, texts) -> scores``, such as
    ``service/rerank_service.RerankService``.
    """

    def __init__(
        self,
        spec: IndexSpec,
        embedder: Optional[Any] = None,
        reranker: Optional[Callable[[str, Sequence[str]], np.ndarray]] = None,
        hybrid_opts: Optional[dict] = None,
        device: DeviceLike = None,
    ):
        self.index = DeviceIndex(spec, device=device)
        self.embedder = embedder or HashEmbedder(dim=spec.dim,
                                                 device=self.index.device)
        self.reranker = reranker
        # per-collection fidelity-vs-speed knobs forwarded to search_hybrid
        self.hybrid_opts = hybrid_opts or {}

    def _embed(self, texts: list[str]) -> torch.Tensor:
        # an embedder with ``embed_device`` leaves its rows on its device
        # (no host sync, no round trip through host memory), as the
        # reference's ingest takes it (engine/collection.py:75-76)
        with _TRACE.stage("embed"):
            if hasattr(self.embedder, "embed_device"):
                emb = self.embedder.embed_device(texts)
            else:
                emb = self.embedder.embed(texts)
            return torch.as_tensor(emb, dtype=torch.float32).to(self.index.device)

    # -- ingest ---------------------------------------------------------------

    def ingest(
        self,
        texts: Sequence[str],
        metadata: Optional[Sequence[dict]] = None,
        indexer: str = "vector",
        chat_id: Optional[str] = None,
        embeddings: Optional[np.ndarray] = None,
    ) -> list[int]:
        """Insert texts; ``embeddings`` overrides the text embedder."""
        if embeddings is not None:
            emb = np.asarray(embeddings, np.float32)
        else:
            emb = self._embed(list(texts))
        return self.index.add(emb, texts, metadata, indexer=indexer,
                              chat_id=chat_id)

    def delete(self, rows: Sequence[int]) -> None:
        self.index.delete(rows)

    # -- search ---------------------------------------------------------------

    def _filter(self, index_types, chat_id, doc_rows) -> Optional[FilterSpec]:
        if index_types is None and chat_id is None and doc_rows is None:
            return None
        codes = (frozenset(INDEXER_CODES[t] for t in index_types)
                 if index_types is not None else None)
        return FilterSpec(
            indexers=codes,
            chat_hash=_chat_hash(chat_id) if chat_id else None,
            doc_rows=tuple(doc_rows) if doc_rows is not None else None,
        )

    def _hits(self, scores: np.ndarray, rows: np.ndarray, recall_type: str,
              min_score: Optional[float] = None) -> list[SearchHit]:
        out = []
        for s, r in zip(scores, rows):
            r = int(r)
            if r < 0 or not np.isfinite(s):
                continue
            if min_score is not None and s < min_score:
                continue
            meta = self.index.row_meta[r]
            if meta is None:
                continue
            md = {k: v for k, v in meta.items() if k != "text"}
            out.append(SearchHit(row=r, score=float(s), text=meta["text"],
                                 metadata=md, recall_type=recall_type))
        return out

    def search_by_image(self, image: bytes, top_k: int = 5,
                        chat_id: Optional[str] = None) -> list[SearchHit]:
        """Image -> image retrieval over vision rows (their dense vectors
        are image embeddings, ``models/image_embedder.py``)."""
        return self.search_image_vector(self.embed_image(image), top_k, chat_id)

    def embed_image(self, image: bytes) -> Optional[np.ndarray]:
        """The host half of ``search_by_image``: the image's ``[1, dim]``
        query vector (decode and DCT features), or None when the index
        is empty."""
        from super_rag_tpu_torch.models.image_embedder import embed_image

        dim = self.image_query_dim()
        return None if dim is None else embed_image(image, dim)

    def image_query_dim(self) -> Optional[int]:
        """The width of an image query vector, or None when the index is
        empty and there is nothing to search."""
        return self.index.spec.dim if self.index.size else None

    def search_image_vector(self, q: Optional[np.ndarray], top_k: int = 5,
                            chat_id: Optional[str] = None) -> list[SearchHit]:
        """The device half of ``search_by_image``: the vision rows nearest
        to the query vector ``q`` from ``embed_image``."""
        if q is None or self.index.size == 0:
            return []
        flt = self._filter(["vision"], chat_id, None)
        dv, di = self.index.search_dense(
            torch.from_numpy(q).to(self.index.device),
            min(top_k, self.index.size), flt)
        v, i = dv.cpu().numpy(), di.cpu().numpy()
        i = np.where(np.isfinite(v), i, -1)
        return self._hits(v[0], i[0], "vision_search")

    def search(self, query: str, top_k: int = 5, **kwargs) -> list[SearchHit]:
        """Single-query search (same options as ``search_batch``)."""
        return self.search_batch([query], top_k=top_k, **kwargs)[0]

    def search_batch(
        self,
        queries: Sequence[str],
        top_k: int = 5,
        mode: str = "hybrid",  # dense | fulltext | hybrid
        similarity_threshold: Optional[float] = None,
        index_types: Optional[Sequence[str]] = None,
        chat_id: Optional[str] = None,
        doc_rows: Optional[Sequence[int]] = None,
        rerank: bool = False,
        candidates: int = 100,
        rrf_k: int = 60,
    ) -> list[list[SearchHit]]:
        with _TRACE.stage("engine.search_batch"):
            if self.index.size == 0:
                return [[] for _ in queries]
            flt = self._filter(index_types, chat_id, doc_rows)
            k_recall = max(top_k, candidates if (rerank or mode == "hybrid") else top_k)
            k_recall = min(k_recall, self.index.size)

            # pad the batch to a power-of-two bucket so coalesced batches of
            # any size reuse a few shapes
            n_q = len(queries)
            bucket = 1 << max(0, n_q - 1).bit_length()
            padded = list(queries) + [""] * (bucket - n_q)

            if mode == "hybrid":
                res = self.index.search_hybrid(
                    self._embed(padded), padded, k=k_recall, candidates=k_recall,
                    flt=flt, rrf_k=rrf_k, **self.hybrid_opts)
                with _TRACE.stage("engine.copy"):
                    v, i = res.scores.cpu().numpy(), res.indices.cpu().numpy()
                take = k_recall if rerank else top_k
                with _TRACE.stage("engine.hits"):
                    results = [self._hits(v[b][:take], i[b][:take], "hybrid")
                               for b in range(n_q)]
                return self._maybe_rerank(queries, results, rerank, top_k)

            if mode == "dense":
                dv, di = self.index.search_dense(self._embed(padded), k_recall, flt)
                recall_type, min_score = "vector_search", similarity_threshold
            else:
                dv, di = self.index.search_bm25(padded, k_recall, flt)
                recall_type, min_score = "fulltext_search", None
            with _TRACE.stage("engine.copy"):
                v, i = dv.cpu().numpy(), di.cpu().numpy()
            i = np.where(np.isfinite(v), i, -1)
            with _TRACE.stage("engine.hits"):
                results = [self._hits(v[b][:top_k], i[b][:top_k], recall_type,
                                      min_score) for b in range(n_q)]
            return self._maybe_rerank(queries, results, rerank, top_k)

    def _maybe_rerank(self, queries, results, rerank: bool, top_k: int):
        """Fuse the given reranker's scores with the retrieval scores
        (z-scored sum per query) and keep the top_k."""
        if not rerank:
            return results
        if self.reranker is None:
            return [h[:top_k] for h in results]

        def z(x):
            s = float(x.std())
            return (x - x.mean()) / (s if s > 1e-6 else 1.0)

        reranked = []
        for q, hits in zip(queries, results):
            if not hits:
                reranked.append(hits)
                continue
            ce = np.asarray(self.reranker(q, [h.text for h in hits]), np.float32)
            base = np.asarray([h.score for h in hits], np.float32)
            scores = z(ce) + z(base)
            order = np.argsort(-scores)[:top_k]
            reranked.append([
                SearchHit(row=hits[int(p)].row, score=float(scores[p]),
                          text=hits[int(p)].text,
                          metadata=hits[int(p)].metadata,
                          recall_type="reranked")
                for p in order])
        return reranked
