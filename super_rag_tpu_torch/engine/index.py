"""Mutable device-resident hybrid index: dense + BM25 + filter columns
(port of the JAX package's engine/index.py).

  * capacity-class tensors — embeddings, the BM25 doc-term table and the
    filter columns are allocated in power-of-two capacities and grown by
    copy, exactly as the JAX package grows them, so both packages see the
    same shapes;
  * a write cursor + validity bitmap — inserts write at the cursor in
    place, deletes clear validity bits, and every query masks by validity;
  * filter columns as masked scoring — indexer-type codes and a chat hash
    compile to one boolean mask fed to the same search ops;
  * an optional IVF snapshot of the dense rows (``compact_dense``), the
    tier for large collections, re-clustered once churn passes 20 %.

Row metadata (chunk text, ids) stays on the host, keyed by row number.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.ops.bm25 import LexicalCorpus, bm25_search
from super_rag_tpu_torch.ops.bm25_inverted import (
    build_inverted, build_inverted_csr, inverted_bm25_search)
from super_rag_tpu_torch.ops.dense import DenseCorpus, Metric, dense_search
from super_rag_tpu_torch.ops.dense_topk import dense_topk
from super_rag_tpu_torch.ops.hybrid import HybridResult, hybrid_search
from super_rag_tpu_torch.ops.ivf import (
    build_ivf, build_ivf_streaming, ivf_search)
from super_rag_tpu_torch.ops.ivf_topk import ivf_topk
from super_rag_tpu_torch.ops.quant import quantize_int8
from super_rag_tpu_torch.ops.topk import merge_topk
from super_rag_tpu_torch.tokenize.analyzer import Analyzer, DocFrequency, fnv1a32

INDEXER_CODES = {"vector": 0, "summary": 1, "vision": 2, "graph": 3}

# capacity headroom each insert reserves (the JAX package pads its device
# writes to this many rows; keeping the same headroom keeps capacities equal)
WRITE_BLOCK = 256

# above this f32-corpus size, compact_dense streams the IVF build through
# host chunks instead of holding the f32 matrix on the device
IVF_STREAM_BUILD_BYTES = 2 << 30

# storage dtype <-> the name snapshots carry (numpy / JAX dtype names)
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
               torch.int8: "int8"}
DTYPES = {v: k for k, v in DTYPE_NAMES.items()}


@dataclass(frozen=True)
class IndexSpec:
    dim: int
    metric: Metric = Metric.COSINE
    dtype: torch.dtype = torch.bfloat16  # bfloat16 | float32 | int8
    bm25_slots: int = 64
    vocab_size: int = 1 << 17
    min_capacity: int = 4096
    # lexical snapshot layout: "table" = fixed [V, P] impact-truncated
    # postings (exact for small corpora, where P covers the runs); "csr" =
    # every posting stored, the query budget the only truncation; "auto" =
    # csr from csr_auto_rows rows on, as in the JAX package
    lex_tier: str = "auto"
    csr_auto_rows: int = 2_000_000
    # doc-sharded CSR: C id-disjoint shards aggregate as C narrow sorts
    # with exact results (ops/bm25_inverted.py CSRInvertedIndex); 1 =
    # unsharded
    csr_shards: int = 1


@dataclass(frozen=True)
class FilterSpec:
    """Query-time filter: indexer IN indexers (or no filter), chat scope
    (unscoped rows stay visible), and an optional row restriction."""

    indexers: Optional[frozenset[int]] = None
    chat_hash: Optional[int] = None
    doc_rows: Optional[tuple[int, ...]] = None


def _chat_hash(chat_id: Optional[str]) -> int:
    if not chat_id:
        return 0
    return int(fnv1a32(chat_id) & 0x7FFFFFFF) or 1


def _clear_rows(valid: torch.Tensor, rows: Sequence[int]) -> None:
    """Clear validity bits in place; rows outside [0, capacity) are
    dropped, never wrapped (a wrapped -1 would delete the last row)."""
    cap = valid.shape[0]
    keep = [int(r) for r in rows if 0 <= int(r) < cap]
    if keep:
        valid[torch.tensor(keep, dtype=torch.int64, device=valid.device)] = False


def _filter_mask(valid, indexer_code, chat_code, allowed_bits: int,
                 chat_value: int, has_chat: bool, has_indexers: bool):
    m = valid
    if has_indexers:
        code = indexer_code.to(torch.int64)
        bit = (torch.full_like(code, allowed_bits) >> code) & 1
        m = m & (bit == 1)
    if has_chat:
        m = m & ((chat_code == chat_value) | (chat_code == 0))
    return m


def _locked(fn):
    """Serialize index mutations and queries: writes are in place, so a
    query must never read a half-written block."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._mutex:
            return fn(self, *args, **kwargs)

    return wrapper


class DeviceIndex:
    """One collection's hybrid index on one device."""

    def __init__(self, spec: IndexSpec, analyzer: Optional[Analyzer] = None,
                 device: DeviceLike = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.analyzer = analyzer or Analyzer(vocab_size=spec.vocab_size)
        if self.analyzer.vocab_size != spec.vocab_size:
            raise ValueError("analyzer and spec disagree on vocab_size")
        self.df = DocFrequency()
        self.size = 0  # write cursor
        self._capacity = 0
        self.row_meta: list[Optional[dict]] = []
        # inverted lexical snapshot covers rows [0, _inverted_upto); the
        # fresh tail is scored doc-major until the next compaction
        self._inverted = None
        self._inverted_upto = 0
        self.auto_compact_rows = 8192
        # per-tile extraction cap of the fused dense top-k, widened by
        # calibrate_per_tile_k where a corpus concentrates winners
        self._per_tile_k = 2
        # IVF snapshot of the dense rows [0, _ivf_upto) (compact_dense)
        self._ivf = None
        self._ivf_upto = 0
        self._ivf_nprobe = 16
        self._ivf_nlist = None
        self._ivf_recall_target = None
        self._ivf_churn = 0  # inserts + deletes since the IVF snapshot
        self._mutex = threading.RLock()
        self._alloc(spec.min_capacity)

    # -- storage management ------------------------------------------------

    def _alloc(self, capacity: int) -> None:
        spec, dev, old = self.spec, self.device, self._capacity

        def grow(name, shape, dtype, fill=0):
            new = torch.full(shape, fill, dtype=dtype, device=dev)
            if old:
                new[:old] = getattr(self, name)
            return new

        self.emb = grow("emb", (capacity, spec.dim), spec.dtype)
        self.scales = (grow("scales", (capacity,), torch.float32)
                       if spec.dtype == torch.int8 else None)
        self.norms_sq = (grow("norms_sq", (capacity,), torch.float32)
                         if spec.metric == Metric.L2 else None)
        self.terms = grow("terms", (capacity, spec.bm25_slots), torch.int32,
                          fill=spec.vocab_size)
        self.tfs = grow("tfs", (capacity, spec.bm25_slots), torch.bfloat16)
        self.doc_len = grow("doc_len", (capacity,), torch.float32, 1)
        self.valid = grow("valid", (capacity,), torch.bool, False)
        self.indexer_code = grow("indexer_code", (capacity,), torch.int32)
        self.chat_code = grow("chat_code", (capacity,), torch.int32)
        self._capacity = capacity

    def _ensure_capacity(self, extra: int) -> None:
        need = self.size + extra
        cap = self._capacity
        while cap < need:
            cap *= 2
        if cap != self._capacity:
            self._alloc(cap)

    # -- mutation ------------------------------------------------------------

    def _prep_dense(self, embeddings):
        """Normalised (cosine) rows, their squared norms, and int8 codes +
        scales for int8 storage.  Host arrays are normalised with numpy,
        as the JAX package does; device tensors stay on the device."""
        cosine = self.spec.metric == Metric.COSINE
        if isinstance(embeddings, torch.Tensor):
            x = embeddings.to(self.device, torch.float32)
            if cosine:
                n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                x = x / torch.where(n > 0, n, torch.ones_like(n))
            norms = (x * x).sum(-1)
        else:
            x = np.asarray(embeddings, np.float32)
            if cosine:
                n = np.linalg.norm(x, axis=-1, keepdims=True)
                x = x / np.where(n > 0, n, 1.0)
            norms = torch.from_numpy((x * x).sum(-1).astype(np.float32))
            x = torch.from_numpy(np.ascontiguousarray(x))
        x, norms = x.to(self.device), norms.to(self.device)
        if self.spec.dtype == torch.int8:
            q, sc = quantize_int8(x)
            return q, sc, norms
        return x.to(self.spec.dtype), None, norms

    @_locked
    def add(
        self,
        embeddings,  # [M, dim] float: np.ndarray or torch.Tensor
        texts: Sequence[str],
        metadata: Optional[Sequence[dict]] = None,
        indexer: str = "vector",
        chat_id: Optional[str] = None,
    ) -> list[int]:
        """Insert rows; returns their row ids."""
        m = len(texts)
        if tuple(embeddings.shape) != (m, self.spec.dim):
            raise ValueError(f"embeddings shape {tuple(embeddings.shape)} != "
                             f"({m}, {self.spec.dim})")
        metadata = metadata or [{} for _ in range(m)]
        self._ensure_capacity(m + WRITE_BLOCK)
        emb_block, scale_block, norms = self._prep_dense(embeddings)
        terms, tfs, lens = self.analyzer.batch_doc_entries(
            list(texts), self.spec.bm25_slots)
        for r in range(m):
            row_terms = terms[r][terms[r] != self.analyzer.pad_id]
            self.df.add_doc(row_terms.tolist(), int(lens[r]))

        dev = self.device
        sl = slice(self.size, self.size + m)
        self.emb[sl] = emb_block
        if self.scales is not None:
            self.scales[sl] = scale_block
        if self.norms_sq is not None:
            self.norms_sq[sl] = norms
        self.terms[sl] = torch.from_numpy(terms).to(dev)
        self.tfs[sl] = torch.from_numpy(tfs).to(dev, torch.bfloat16)
        self.doc_len[sl] = torch.from_numpy(np.maximum(lens, 1.0)).to(dev)
        self.valid[sl] = True
        self.indexer_code[sl] = INDEXER_CODES.get(indexer, 0)
        self.chat_code[sl] = _chat_hash(chat_id)

        start = self.size
        self.row_meta.extend({"text": t, **md} for t, md in zip(texts, metadata))
        self.size = start + m
        self._ivf_churn += m
        return list(range(start, start + m))

    @_locked
    def delete(self, rows: Sequence[int]) -> None:
        """Clear rows; df is decremented once per live row (duplicates and
        dead rows are ignored)."""
        if not rows:
            return
        live = [r for r in dict.fromkeys(int(r) for r in rows)
                if 0 <= r < len(self.row_meta) and self.row_meta[r] is not None]
        if live:
            ridx = torch.tensor(live, dtype=torch.int64, device=self.device)
            terms_host = self.terms[ridx].cpu().numpy()
            lens_host = self.doc_len[ridx].cpu().numpy()
            for r, row_terms, dl in zip(live, terms_host, lens_host):
                row_terms = row_terms[row_terms != self.analyzer.pad_id]
                self.df.remove_doc(row_terms.tolist(), int(dl))
                self.row_meta[r] = None
        _clear_rows(self.valid, rows)
        self._ivf_churn += len(rows)

    @property
    def live_count(self) -> int:
        """Rows added and not deleted."""
        return sum(1 for m in self.row_meta if m is not None)

    # -- query ---------------------------------------------------------------

    def _mask(self, flt: Optional[FilterSpec]) -> torch.Tensor:
        if flt is None or (flt.indexers is None and flt.chat_hash is None
                           and flt.doc_rows is None):
            return self.valid
        bits = 0
        for c in flt.indexers or ():
            bits |= 1 << c
        m = _filter_mask(self.valid, self.indexer_code, self.chat_code, bits,
                         flt.chat_hash or 0,
                         has_chat=flt.chat_hash is not None,
                         has_indexers=flt.indexers is not None)
        if flt.doc_rows is not None:
            dm = torch.zeros(self._capacity, dtype=torch.bool,
                             device=self.device)
            dm[list(flt.doc_rows)] = True
            m = m & dm
        return m

    def dense_corpus(self) -> DenseCorpus:
        return DenseCorpus(values=self.emb, scales=self.scales,
                           norms_sq=self.norms_sq, live_rows=self.size)

    def _dense_rows_f32(self, rows) -> torch.Tensor:
        """Stored rows as f32 (int8 codes times their scales)."""
        emb = self.emb[rows].to(torch.float32)
        if self.scales is not None:
            emb = emb * self.scales[rows][:, None]
        return emb

    @_locked
    def compact_dense(self, nlist: Optional[int] = None, nprobe: int = 16,
                      kmeans_iters: int = 8,
                      recall_target: Optional[float] = None,
                      calib_sample: int = 32, calib_k: int = 10) -> None:
        """Build / refresh the IVF snapshot over the live rows (opt-in: the
        tier for large collections).  Corpora over
        ``IVF_STREAM_BUILD_BYTES`` as f32 stream through host chunks.

        ``recall_target`` tunes nprobe: sampled live rows are queried at
        doubling nprobe until recall@``calib_k`` against the exact flat
        search reaches it.  Churn (inserts + deletes) past 20 % of the
        snapshot re-clusters with the same settings."""
        n = self.size
        if n == 0:
            return
        if nlist is None:
            nlist = max(16, int(np.sqrt(n)))
        # build over LIVE rows only: dead rows would hold cluster capacity
        # and probe bandwidth until the next build
        valid_np = self.valid[:n].cpu().numpy()
        live = np.flatnonzero(valid_np).astype(np.int32)
        if live.size == 0:
            return
        all_live = live.size == n
        ids = None if all_live else live
        if n * self.spec.dim * 4 > IVF_STREAM_BUILD_BYTES:
            step = 262_144

            def chunks():
                for lo in range(0, n, step):
                    hi = min(lo + step, n)
                    block = self._dense_rows_f32(slice(lo, hi)).cpu().numpy()
                    if not all_live:
                        block = block[valid_np[lo:hi]]
                    if len(block):
                        yield block

            self._ivf = build_ivf_streaming(
                chunks, nlist=nlist, dtype=self.spec.dtype,
                metric=self.spec.metric, kmeans_iters=kmeans_iters, ids=ids,
                device=self.device)
        else:
            rows = (slice(0, n) if all_live
                    else torch.from_numpy(live).long().to(self.device))
            self._ivf = build_ivf(
                self._dense_rows_f32(rows), nlist=nlist, dtype=self.spec.dtype,
                metric=self.spec.metric, kmeans_iters=kmeans_iters, ids=ids)
        self._ivf_upto = n
        self._ivf_nprobe = nprobe
        self._ivf_nlist = nlist
        self._ivf_recall_target = recall_target
        self._ivf_churn = 0
        if recall_target is not None:
            self._ivf_nprobe = self._calibrate_nprobe(
                nprobe, recall_target, calib_sample, calib_k)

    def _calibrate_nprobe(self, nprobe: int, target: float, sample: int,
                          k: int) -> int:
        """Smallest nprobe (doubling from ``nprobe``) whose sampled
        recall@k against the exact flat search reaches ``target``."""
        if self.size < 2 * k:
            return nprobe
        q = self._sample_queries(sample)
        mask = self._mask(None)
        _, gold = dense_search(q, self.dense_corpus(), k=k,
                               metric=self.spec.metric, mask=mask)
        gold = gold.cpu().numpy()
        np_ = nprobe
        while True:
            _, got = ivf_search(q, self._ivf, k=k, nprobe=np_, mask=mask,
                                metric=self.spec.metric)
            recall = float(np.mean([
                len(set(a.tolist()) & set(b.tolist())) / k
                for a, b in zip(got.cpu().numpy(), gold)
            ]))
            if recall >= target or np_ >= self._ivf.nlist:
                return min(np_, self._ivf.nlist)
            np_ *= 2

    def _sample_queries(self, sample: int, seed: int = 0) -> torch.Tensor:
        """Live rows, slightly perturbed, as calibration queries."""
        live = [r for r, m in enumerate(self.row_meta) if m is not None]
        rng = np.random.default_rng(seed)
        rows = rng.choice(live, size=min(sample, len(live)), replace=False)
        ridx = torch.from_numpy(rows).to(self.device)
        q = self.emb[ridx].to(torch.float32)
        if self.scales is not None:
            q = q * self.scales[ridx][:, None]
        noise = 0.05 * rng.standard_normal(tuple(q.shape)).astype(np.float32)
        return q + torch.from_numpy(noise).to(self.device)

    @_locked
    def calibrate_per_tile_k(self, sample: int = 32, threshold: float = 0.98,
                             k: int = 10, cand: int = 100) -> int:
        """Exactness guard for the per-tile extraction cap: compare capped
        and uncapped extraction on sampled queries and widen the cap until
        their overlap reaches ``threshold``.  Runs at compaction."""
        if self.size < 64:
            return self._per_tile_k
        tile = 2048 if self._capacity >= 2048 else max(256, self._capacity)
        q = self._sample_queries(sample, seed=1)
        mask = self._mask(None)
        kk = min(cand, self.size)
        _, gold = dense_topk(q, self.dense_corpus(), k=kk,
                             metric=self.spec.metric, mask=mask, tile=tile,
                             device=self.device)
        gold_sets = [set(r.tolist()) for r in gold.cpu().numpy()]
        while self._per_tile_k < min(cand, tile):
            _, got = dense_topk(q, self.dense_corpus(), k=kk,
                                metric=self.spec.metric, mask=mask, tile=tile,
                                per_tile_k=self._per_tile_k,
                                device=self.device)
            overlap = float(np.mean([
                len(set(a.tolist()) & g) / max(len(g), 1)
                for a, g in zip(got.cpu().numpy(), gold_sets)
            ]))
            if overlap >= threshold:
                break
            self._per_tile_k *= 2
        return self._per_tile_k

    def _kernel_default(self, min_capacity: int) -> bool:
        return self.device.type == "cuda" and self._capacity >= min_capacity

    @_locked
    def search_dense(self, query_emb: torch.Tensor, k: int,
                     flt: Optional[FilterSpec] = None,
                     use_kernel: Optional[bool] = None,
                     nprobe: Optional[int] = None):
        """Dense top-k.  With an IVF snapshot: the probe-streaming kernels
        on the card (``ivf_topk``), the plain gather tier elsewhere, and
        rows added since the snapshot scanned flat and merged in."""
        mask = self._mask(flt)
        query_emb = query_emb.to(self.device)
        if self._ivf is not None and self._ivf_upto > 0:
            if use_kernel is None:
                use_kernel = self.device.type == "cuda"
            np_ = nprobe or self._ivf_nprobe
            if use_kernel:
                iv, ii = ivf_topk(query_emb, self._ivf, k=k, nprobe=np_,
                                  mask=mask, metric=self.spec.metric,
                                  device=self.device)
            else:
                iv, ii = ivf_search(query_emb, self._ivf, k=k, nprobe=np_,
                                    mask=mask, metric=self.spec.metric)
            if self._ivf_upto == self.size:
                return iv, ii
            # fresh tail scored flat, the snapshot's rows masked out
            rows = torch.arange(self._capacity, device=self.device)
            tail_mask = mask & (rows >= self._ivf_upto)
            tv, ti = dense_search(query_emb, self.dense_corpus(), k=k,
                                  metric=self.spec.metric, mask=tail_mask)
            return merge_topk(torch.cat([iv, tv], 1), torch.cat([ii, ti], 1),
                              k)
        if use_kernel is None:
            use_kernel = self._kernel_default(1024)
        if use_kernel:
            return dense_topk(query_emb, self.dense_corpus(), k=k,
                              metric=self.spec.metric, mask=mask, tile=2048,
                              device=self.device)
        return dense_search(query_emb, self.dense_corpus(), k=k,
                            metric=self.spec.metric, mask=mask)

    @_locked
    def compact_lexical(self, postings_per_term: int = 256) -> None:
        """(Re)build the inverted lexical snapshot from the live rows, on
        the index's device: the fixed table, or from ``csr_auto_rows`` rows
        on (``lex_tier="auto"``) the full CSR postings.  Dead rows are left
        out of the build (terms padded, tf zeroed) so they cannot displace
        live postings."""
        n = self.size
        if n == 0:
            return
        tier = self.spec.lex_tier
        if tier == "auto":
            tier = "csr" if n >= self.spec.csr_auto_rows else "table"
        dead = ~self.valid[:n]
        terms = torch.where(dead[:, None], self.spec.vocab_size,
                            self.terms[:n])
        tfs = torch.where(dead[:, None], 0.0, self.tfs[:n].to(torch.float32))
        # the old snapshot's memory goes before the build's transients
        self._inverted, self._inverted_upto = None, 0
        if tier == "csr":
            self._inverted = build_inverted_csr(
                terms, tfs, self.doc_len[:n], self.spec.vocab_size,
                avgdl=self.df.avgdl, shards=self.spec.csr_shards)
        else:
            self._inverted = build_inverted(
                terms, tfs, self.doc_len[:n], self.spec.vocab_size,
                postings_per_term=postings_per_term, avgdl=self.df.avgdl)
        del terms, tfs  # 3.8 GB at 10M x 48 slots, freed before the calibration
        self._inverted_upto = n
        # the compaction cadence is also the per-tile cap's guard cadence
        # (on the card only: the plain version at corpus scale is slow)
        if self._kernel_default(2048):
            self.calibrate_per_tile_k()

    def _maybe_autocompact(self) -> None:
        tail = self.size - self._inverted_upto
        if self._inverted is None:
            if self.size >= self.auto_compact_rows:
                self.compact_lexical()
        elif tail >= self.auto_compact_rows:
            self.compact_lexical()
        # churn past 20 % of the IVF snapshot (or the tail budget) leaves its
        # centroids stale and fresh rows to the flat scan: re-cluster
        if (self._ivf is not None
                and self._ivf_churn >= max(self.auto_compact_rows,
                                           self._ivf_upto // 5)):
            self.compact_dense(nlist=self._ivf_nlist, nprobe=self._ivf_nprobe,
                               recall_target=self._ivf_recall_target)

    def _query_arrays(self, queries: Sequence[str], max_terms: int):
        qt = np.full((len(queries), max_terms), self.analyzer.pad_id, np.int32)
        qi = np.zeros((len(queries), max_terms), np.float32)
        for i, q in enumerate(queries):
            qt[i], qi[i] = self.analyzer.query_entry(q, self.df, max_terms)
        return (torch.from_numpy(qt).to(self.device),
                torch.from_numpy(qi).to(self.device))

    def _lexical(self) -> LexicalCorpus:
        return LexicalCorpus(terms=self.terms, tfs=self.tfs,
                             doc_len=self.doc_len)

    @_locked
    def search_bm25(self, queries: Sequence[str], k: int,
                    flt: Optional[FilterSpec] = None, max_terms: int = 16):
        self._maybe_autocompact()
        qt, qi = self._query_arrays(queries, max_terms)
        mask = self._mask(flt)
        if self._inverted is not None and self._inverted_upto == self.size:
            return inverted_bm25_search(qt, qi, self._inverted, k=k, mask=mask)
        if self._inverted is None or self._inverted_upto == 0:
            return bm25_search(qt, qi, self._lexical(), self.df.avgdl,
                               vocab_size=self.spec.vocab_size, k=k, mask=mask)
        # inverted prefix + doc-major scan of only the fresh tail slice
        iv, ii = inverted_bm25_search(qt, qi, self._inverted, k=k, mask=mask)
        start, length, tail_lex, tail_mask = self._tail_slice(mask)
        tv, ti = bm25_search(qt, qi, tail_lex, self.df.avgdl,
                             vocab_size=self.spec.vocab_size,
                             k=min(k, length), mask=tail_mask)
        return merge_topk(torch.cat([iv, tv], 1), torch.cat([ii, ti + start], 1),
                          k)

    def _tail_slice(self, mask: torch.Tensor):
        """Slice covering rows [inverted_upto, size), rounded up to a
        power-of-two length: ``(start, length, LexicalCorpus, tail mask)``."""
        upto = self._inverted_upto
        tail_len = max(1, self.size - upto)
        length = max(WRITE_BLOCK, 1 << (tail_len - 1).bit_length())
        length = min(length, self._capacity)
        start = max(0, min(upto, self._capacity - length))
        sl = slice(start, start + length)
        rows = torch.arange(start, start + length, device=self.device)
        tail_mask = mask[sl] & (rows >= upto)
        tail_lex = LexicalCorpus(terms=self.terms[sl], tfs=self.tfs[sl],
                                 doc_len=self.doc_len[sl])
        return start, length, tail_lex, tail_mask

    @_locked
    def search_hybrid(
        self,
        query_emb: torch.Tensor,  # [B, dim]
        queries: Sequence[str],
        k: int,
        candidates: int = 100,
        flt: Optional[FilterSpec] = None,
        max_terms: int = 16,
        use_kernel: Optional[bool] = None,
        rrf_k: float = 60.0,
        rescore: bool = True,
        postings_per_query_term: int = 768,
        lex_deep_terms: int = 0,
        lex_deep_postings: Optional[int] = None,
        lex_approx_topk: bool = False,
        lex_gen: Optional[int] = None,
    ) -> HybridResult:
        """Dense + BM25 + RRF over the whole index (ops/hybrid.py); uses the
        inverted snapshot (table or CSR) plus a doc-major fresh tail once
        compacted, and the IVF snapshot when it covers every row.  On the
        card (capacity >= 2048) the dense branch runs the kernels, with int8
        queries for int8 storage and the calibrated per-tile cap for deep
        candidate lists.  ``lex_approx_topk`` is accepted for the
        reference's contract; the port's top-k is exact either way.
        ``lex_gen`` (default ``2 * candidates``, the reference's) is the
        lexical generation depth, which the reference's 10M configuration
        sets on ``hybrid_search`` itself."""
        self._maybe_autocompact()
        qt, qi = self._query_arrays(queries, max_terms)
        if use_kernel is None:
            use_kernel = self._kernel_default(2048)
        mask = self._mask(flt)
        tail_lex = tail_mask = None
        tail_offset = 0
        if self._inverted is not None and self._inverted_upto < self.size:
            tail_offset, _, tail_lex, tail_mask = self._tail_slice(mask)
        ivf = (self._ivf if self._ivf is not None
               and self._ivf_upto == self.size else None)
        return hybrid_search(
            query_emb.to(self.device), qt, qi, self.dense_corpus(),
            self._lexical(), self.df.avgdl,
            inverted=self._inverted, tail_lexical=tail_lex,
            tail_mask=tail_mask, tail_offset=tail_offset,
            vocab_size=self.spec.vocab_size, k=k, candidates=candidates,
            metric=self.spec.metric, mask=mask, rrf_k=rrf_k,
            use_kernel=use_kernel,
            per_tile_k=(self._per_tile_k
                        if (use_kernel and candidates >= 32) else None),
            ivf=ivf, nprobe=self._ivf_nprobe,
            rescore=rescore, postings_per_query_term=postings_per_query_term,
            lex_deep_terms=lex_deep_terms,
            lex_deep_postings=lex_deep_postings,
            lex_approx_topk=lex_approx_topk, lex_gen=lex_gen,
            int8_queries=use_kernel and self.spec.dtype == torch.int8,
            device=self.device,
        )

    # -- snapshot / restore --------------------------------------------------

    @_locked
    def snapshot_state(self) -> tuple[dict, dict]:
        """``(arrays, host_state)`` in the JAX package's snapshot layout:
        the same array names and dtypes (bf16 stored as f32), so a
        snapshot written by either package loads in the other."""
        n = self.size

        def host(t, dtype=None):
            t = t[:n]
            return (t if dtype is None else t.to(dtype)).cpu().numpy()

        emb_dtype = torch.float32 if self.emb.dtype == torch.bfloat16 else None
        arrays = {
            "emb": host(self.emb, emb_dtype),
            "terms": host(self.terms),
            "tfs": host(self.tfs, torch.float32),
            "doc_len": host(self.doc_len),
            "valid": host(self.valid),
            "indexer_code": host(self.indexer_code),
            "chat_code": host(self.chat_code),
        }
        if self.scales is not None:
            arrays["scales"] = host(self.scales)
        if self.norms_sq is not None:
            arrays["norms_sq"] = host(self.norms_sq)
        state = {
            "spec": {
                "dim": self.spec.dim,
                "metric": self.spec.metric.value,
                "dtype": DTYPE_NAMES[self.spec.dtype],
                "bm25_slots": self.spec.bm25_slots,
                "vocab_size": self.spec.vocab_size,
                "min_capacity": self.spec.min_capacity,
            },
            "size": n,
            "row_meta": self.row_meta,
            "df": self.df.state(),
        }
        return arrays, state

    @classmethod
    def from_snapshot(cls, arrays: dict, host: dict,
                      device: DeviceLike = None) -> "DeviceIndex":
        """Restore from ``snapshot_state`` output of either package.  The
        arrays may be numpy arrays or tensors (on any device)."""
        s = host["spec"]
        spec = IndexSpec(dim=s["dim"], metric=Metric(s["metric"]),
                         dtype=DTYPES[s["dtype"]], bm25_slots=s["bm25_slots"],
                         vocab_size=s["vocab_size"],
                         min_capacity=s["min_capacity"])
        idx = cls(spec, device=device)
        n = host["size"]
        idx._ensure_capacity(n)
        names = ["emb", "terms", "tfs", "doc_len", "valid", "indexer_code",
                 "chat_code", "scales", "norms_sq"]
        for name in names:
            dst = getattr(idx, name)
            if name not in arrays or dst is None:
                continue
            src = arrays[name]
            if not isinstance(src, torch.Tensor):  # JAX hands out read-only
                src = torch.from_numpy(np.require(src, requirements="W"))
            if tuple(src.shape) != (n, *dst.shape[1:]):
                raise ValueError(f"snapshot array {name} has shape "
                                 f"{tuple(src.shape)}, expected "
                                 f"({n}, {', '.join(map(str, dst.shape[1:]))})")
            dst[:n] = src.to(idx.device, dst.dtype)
        idx.size = n
        idx.row_meta = list(host["row_meta"])
        idx.df = DocFrequency.from_state(host["df"])
        return idx
