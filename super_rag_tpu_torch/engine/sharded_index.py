"""Mutable row-sharded hybrid index over a mesh of ranks (port of the JAX
package's engine/sharded_index.py).

The multi-device tier of the engine.  The same mutability model as the
one-device ``DeviceIndex`` (capacity classes, write cursor, validity
bitmap), with every row-aligned tensor cut into contiguous blocks: global
row ``r`` lives on the rank of row index ``r // (capacity / n)``.  Every
rank calls every method with the same arguments (SPMD): the host state
(row metadata, document frequencies, the fresh tail) is replicated, each
rank writes and scores only its own rows, and queries run
``parallel/sharded_hybrid.py`` (per-rank kernels + all_gather merge).

Growth moves rows between ranks: a larger capacity gives every rank a
larger block, so ``_alloc`` gathers the old blocks and each rank keeps
its new one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from super_rag_tpu_torch.engine.index import (
    DTYPE_NAMES, DTYPES, INDEXER_CODES, WRITE_BLOCK, FilterSpec, IndexSpec,
    _chat_hash, _filter_mask)
from super_rag_tpu_torch.ops.bm25 import LexicalCorpus
from super_rag_tpu_torch.ops.bm25_inverted import build_inverted
from super_rag_tpu_torch.ops.dense import DenseCorpus, Metric
from super_rag_tpu_torch.ops.ivf import build_ivf
from super_rag_tpu_torch.ops.hybrid import HybridResult
from super_rag_tpu_torch.ops.quant import quantize_int8
from super_rag_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce_sum, row_shards)
from super_rag_tpu_torch.parallel.sharded_hybrid import (
    FreshTail, sharded_hybrid_search)
from super_rag_tpu_torch.tokenize.analyzer import Analyzer, DocFrequency

# row-aligned tensors: name -> (dtype or None for the storage dtype, fill)
_COLUMNS = {
    "emb": (None, 0), "scales": (torch.float32, 0), "terms": (torch.int32, None),
    "tfs": (torch.bfloat16, 0), "doc_len": (torch.float32, 1),
    "valid": (torch.bool, False), "indexer_code": (torch.int32, 0),
    "chat_code": (torch.int32, 0),
}


class ShardedDeviceIndex:
    """Row-sharded mutable hybrid index (dense + BM25) over a mesh."""

    def __init__(self, spec: IndexSpec, mesh: Mesh,
                 analyzer: Optional[Analyzer] = None):
        if Metric(spec.metric) != Metric.COSINE:
            raise ValueError("the sharded tier takes cosine only")
        self.spec = spec
        self.mesh = mesh
        self.device = mesh.device
        self.n_dev = row_shards(mesh)
        self.analyzer = analyzer or Analyzer(vocab_size=spec.vocab_size)
        self.df = DocFrequency()
        self.size = 0
        self._capacity = 0
        self.row_meta: list[Optional[dict]] = []
        self._deleted: set[int] = set()
        self._clear_tail()
        self._inv = None
        self._inverted_upto = 0
        self._ivf = None
        self._ivf_upto = 0
        self._ivf_nprobe = 32
        # per-tile extraction cap of the sharded flat kernel: starts at the
        # conservative 8 (not the one-device 2) and stays there until
        # calibrate_per_tile_k, run at compaction, proves a cap lossless
        self._per_tile_k = 8
        self._alloc(self._round_cap(spec.min_capacity))

    def _clear_tail(self) -> None:
        self._tail_terms: list[np.ndarray] = []
        self._tail_tfs: list[np.ndarray] = []
        self._tail_dlen: list[np.ndarray] = []
        self._tail_rows: list[np.ndarray] = []
        self._tail_codes: list[np.ndarray] = []

    def _round_cap(self, n: int) -> int:
        unit = self.n_dev * WRITE_BLOCK
        return -(-n // unit) * unit

    @property
    def shard_rows(self) -> int:
        return self._capacity // self.n_dev

    @property
    def base(self) -> int:
        """The first global row of this rank's block."""
        return self.mesh.row_index * self.shard_rows

    def _columns(self):
        for name, (dtype, fill) in _COLUMNS.items():
            if name == "scales" and self.spec.dtype != torch.int8:
                continue
            tail = {"emb": (self.spec.dim,), "terms": (self.spec.bm25_slots,),
                    "tfs": (self.spec.bm25_slots,)}.get(name, ())
            yield (name, tail, dtype or self.spec.dtype,
                   self.spec.vocab_size if fill is None else fill)

    def _alloc(self, capacity: int) -> None:
        """Grow every column to ``capacity`` rows in all; the old blocks
        are gathered and each rank keeps its new block (rows move between
        ranks)."""
        old_cap, rows = self._capacity, capacity // self.n_dev
        lo = self.mesh.row_index * rows
        for name, tail, dtype, fill in self._columns():
            new = torch.full((rows, *tail), fill, dtype=dtype, device=self.device)
            if old_cap:
                full = torch.cat(all_gather(getattr(self, name), self.mesh.root))
                hi = min(lo + rows, old_cap)
                if hi > lo:
                    new[:hi - lo] = full[lo:hi]
                del full
            setattr(self, name, new)
        if self.spec.dtype != torch.int8:
            self.scales = None
        self._capacity = capacity

    def _ensure_capacity(self, extra: int) -> None:
        need = self.size + extra
        if need > self._capacity:
            cap = self._capacity
            while cap < need:
                cap *= 2
            self._alloc(self._round_cap(cap))

    def _write(self, start: int, blocks: dict) -> None:
        """Write rows ``[start, start + m)`` of the given columns: each rank
        its own part of them."""
        m = len(blocks["valid"])
        lo = max(start, self.base)
        hi = min(start + m, self.base + self.shard_rows)
        if hi <= lo:
            return
        for name, block in blocks.items():
            if block is None:
                continue
            if isinstance(block, np.ndarray):
                block = torch.from_numpy(np.ascontiguousarray(block))
            dst = getattr(self, name)
            dst[lo - self.base:hi - self.base] = block[lo - start:hi - start].to(
                self.device, dst.dtype)

    # -- mutation ------------------------------------------------------------

    def add(self, embeddings, texts: Sequence[str],
            metadata: Optional[Sequence[dict]] = None,
            indexer: str = "vector",
            chat_id: Optional[str] = None) -> list[int]:
        """Insert rows (every rank with the same arguments); returns their
        row ids."""
        m = len(texts)
        metadata = metadata or [{} for _ in range(m)]
        self._ensure_capacity(m + WRITE_BLOCK)

        x = np.asarray(embeddings, np.float32)
        nrm = np.linalg.norm(x, axis=-1, keepdims=True)
        x = torch.from_numpy(x / np.where(nrm > 0, nrm, 1.0))
        emb_block, scale_block = (quantize_int8(x) if self.spec.dtype == torch.int8
                                  else (x, None))
        terms, tfs, lens = self.analyzer.batch_doc_entries(
            list(texts), self.spec.bm25_slots)
        for r in range(m):
            row_terms = terms[r][terms[r] != self.analyzer.pad_id]
            self.df.add_doc(row_terms.tolist(), int(lens[r]))

        start = self.size
        code = INDEXER_CODES.get(indexer, 0)
        chat = _chat_hash(chat_id)
        self._write(start, {
            "emb": emb_block, "scales": scale_block, "terms": terms,
            "tfs": tfs.astype(np.float32), "doc_len": np.maximum(lens, 1.0),
            "valid": np.ones(m, bool), "indexer_code": np.full(m, code, np.int32),
            "chat_code": np.full(m, chat, np.int32)})
        self.row_meta.extend({"text": t, **md} for t, md in zip(texts, metadata))
        if self._inv is not None:
            # rows added after lexical compaction also land in the host
            # tail, which every rank scans replicated until the next one
            self._tail_terms.append(terms.astype(np.int32))
            self._tail_tfs.append(tfs.astype(np.float32))
            self._tail_dlen.append(np.maximum(lens, 1.0).astype(np.float32))
            self._tail_rows.append(np.arange(start, start + m, dtype=np.int32))
            self._tail_codes.append(np.stack([np.full(m, code, np.int32),
                                              np.full(m, chat, np.int32)], axis=1))
        self.size = start + m
        return list(range(start, start + m))

    def delete(self, rows: Sequence[int]) -> None:
        if not rows:
            return
        for r in rows:
            if r < len(self.row_meta) and self.row_meta[r] is not None:
                self.row_meta[r] = None
        local = [int(r) - self.base for r in rows
                 if self.base <= int(r) < self.base + self.shard_rows]
        if local:
            self.valid[torch.tensor(local, dtype=torch.int64, device=self.device)] = False
        self._deleted.update(int(r) for r in rows)

    # -- lexical compaction (per-shard inverted postings) --------------------

    def compact_lexical(self, postings_per_term: int = 256) -> None:
        """Build this rank's inverted postings over its own rows (local doc
        ids), dead rows left out of the posting budgets."""
        if self.size == 0:
            return
        dead = ~self.valid
        terms = torch.where(dead[:, None], self.spec.vocab_size, self.terms)
        tfs = torch.where(dead[:, None], 0.0, self.tfs.to(torch.float32))
        self._inv = build_inverted(terms, tfs, self.doc_len, self.spec.vocab_size,
                                   postings_per_term=postings_per_term,
                                   avgdl=self.df.avgdl)
        del terms, tfs
        self._inverted_upto = self.size
        self._clear_tail()
        # the per-tile cap's guard at compaction cadence (on the card only:
        # the plain version at corpus scale is slow)
        if self.device.type == "cuda" and self.shard_rows >= 2048:
            self.calibrate_per_tile_k()

    def _rows_f32(self, rows: np.ndarray) -> torch.Tensor:
        """Stored rows (codes times scales) by global id, replicated: each
        rank fills the rows it owns and a sum joins them (exact: one
        contribution a row)."""
        out = torch.zeros((len(rows), self.spec.dim), dtype=torch.float32,
                          device=self.device)
        local = (rows >= self.base) & (rows < self.base + self.shard_rows)
        if local.any():
            at = torch.from_numpy(np.flatnonzero(local)).to(self.device)
            src = torch.from_numpy(rows[local] - self.base).long().to(self.device)
            v = self.emb[src].to(torch.float32)
            if self.scales is not None:
                v = v * self.scales[src][:, None]
            out[at] = v
        return all_reduce_sum(out, self.mesh.root)

    def calibrate_per_tile_k(self, sample: int = 32, threshold: float = 0.98,
                             cand: int = 100) -> int:
        """Exactness guard for the sharded kernel's extraction cap: compare
        capped and exact (blocked plain) dense candidates on sampled stored
        rows and widen ``_per_tile_k`` until their overlap reaches
        ``threshold``.  Empty query strings keep the lexical branch silent,
        so the hybrid result is the dense order."""
        if self.size < 64:
            return self._per_tile_k
        alive = [r for r, m_ in enumerate(self.row_meta) if m_ is not None]
        if len(alive) < 2:
            return self._per_tile_k
        rng = np.random.default_rng(1)
        pick = rng.choice(len(alive), size=min(sample, len(alive)), replace=False)
        q = self._rows_f32(np.asarray(alive, np.int64)[pick])
        noise = 0.05 * rng.standard_normal(tuple(q.shape)).astype(np.float32)
        q = q + torch.from_numpy(noise).to(self.device)
        queries = [""] * q.shape[0]
        kk = min(cand, self.size)
        gold = self.search_hybrid(q, queries, k=kk, candidates=kk,
                                  use_kernel=False, rescore=False)
        gold_sets = [set(x for x in row.tolist() if x >= 0)
                     for row in gold.indices.cpu().numpy()]
        tile = min(2048, self.shard_rows)
        while self._per_tile_k < min(kk, tile):
            got = self.search_hybrid(q, queries, k=kk, candidates=kk,
                                     use_kernel=True, rescore=False)
            overlap = float(np.mean([
                len(set(x for x in a.tolist() if x >= 0) & g) / max(len(g), 1)
                for a, g in zip(got.indices.cpu().numpy(), gold_sets)]))
            if overlap >= threshold:
                break
            self._per_tile_k *= 2
        return self._per_tile_k

    # -- dense compaction (per-shard IVF tier) --------------------------------

    def compact_dense(self, nlist: int = 64, nprobe: int = 16,
                      kmeans_iters: int = 10,
                      capacity_factor: float = 1.5) -> None:
        """Build this rank's IVF tier: its live rows k-means clustered
        locally (local ids, seed = its row index), the same latency tier as
        ``DeviceIndex.compact_dense``, one a rank."""
        if self.size == 0:
            return
        emb = self.emb.to(torch.float32)
        if self.scales is not None:
            emb = emb * self.scales[:, None]
        loc = np.flatnonzero(self.valid.cpu().numpy()).astype(np.int32)
        ids = None
        if loc.size and loc.size < emb.shape[0]:
            # live rows only: dead rows would hold cluster capacity
            emb = emb[torch.from_numpy(loc).long().to(self.device)]
            ids = loc
        # an empty shard keeps its (all-masked) rows so every rank builds
        ivf = build_ivf(emb, nlist=nlist, capacity_factor=capacity_factor,
                        dtype=torch.int8 if self.spec.dtype == torch.int8
                        else torch.float32,
                        metric=self.spec.metric, kmeans_iters=kmeans_iters,
                        seed=self.mesh.row_index, ids=ids)
        # the sharded tier scores its clusters without the sign plane
        self._ivf = dataclasses.replace(ivf, sign_plane=None, of_sign_plane=None)
        self._ivf_upto = self.size
        self._ivf_nprobe = nprobe

    # -- query -------------------------------------------------------------

    def _mask(self, flt: Optional[FilterSpec]) -> torch.Tensor:
        """This rank's block of validity AND the metadata filters (the
        one-device ``DeviceIndex._mask`` semantics)."""
        if flt is None or (flt.indexers is None and flt.chat_hash is None
                           and flt.doc_rows is None):
            return self.valid
        bits = 0
        for c in flt.indexers or ():
            bits |= 1 << c
        m = _filter_mask(self.valid, self.indexer_code, self.chat_code, bits,
                         flt.chat_hash or 0, has_chat=flt.chat_hash is not None,
                         has_indexers=flt.indexers is not None)
        if flt.doc_rows is not None:
            rows = np.asarray(list(flt.doc_rows), np.int64) - self.base
            rows = rows[(rows >= 0) & (rows < self.shard_rows)]
            dm = torch.zeros(self.shard_rows, dtype=torch.bool, device=self.device)
            dm[torch.from_numpy(rows).to(self.device)] = True
            m = m & dm
        return m

    def _tail_arrays(self, flt: Optional[FilterSpec]) -> Optional[FreshTail]:
        """The replicated fresh tail (rows added since compact_lexical),
        padded to a power-of-two capacity class; its keep mask holds
        validity and the filters, computed on the host."""
        if not self._tail_rows:
            return None
        rows = np.concatenate(self._tail_rows)
        m = len(rows)
        cap = max(WRITE_BLOCK, 1 << (m - 1).bit_length())
        slots = self.spec.bm25_slots
        tt = np.full((cap, slots), self.spec.vocab_size, np.int32)
        tf_ = np.zeros((cap, slots), np.float32)
        tdl = np.ones(cap, np.float32)
        trow = np.full(cap, -1, np.int32)
        tt[:m] = np.concatenate(self._tail_terms)
        tf_[:m] = np.concatenate(self._tail_tfs)
        tdl[:m] = np.concatenate(self._tail_dlen)
        trow[:m] = rows
        codes = np.concatenate(self._tail_codes)  # [m, 2] indexer, chat
        keep = np.zeros(cap, bool)
        keep[:m] = (~np.isin(rows, list(self._deleted)) if self._deleted else True)
        if flt is not None:
            if flt.indexers is not None:
                keep[:m] &= np.isin(codes[:, 0], list(flt.indexers))
            if flt.chat_hash is not None:
                keep[:m] &= (codes[:, 1] == flt.chat_hash) | (codes[:, 1] == 0)
            if flt.doc_rows is not None:
                keep[:m] &= np.isin(rows, list(flt.doc_rows))
        dev = self.device
        return FreshTail(*(torch.from_numpy(a).to(dev) for a in (tt, tf_, tdl, trow, keep)))

    def search_hybrid(self, query_emb, queries: Sequence[str], k: int,
                      candidates: int = 100, max_terms: int = 16,
                      flt: Optional[FilterSpec] = None,
                      use_kernel: Optional[bool] = None,
                      rescore: bool = True) -> HybridResult:
        """Dense + BM25 + RRF over every rank's rows (every rank calls it
        with the same arguments and gets the same result).  On the card,
        with at least 2,048 rows a shard, the dense branch runs the
        ``dense_topk`` kernel on each shard (int8 queries for int8
        storage, the calibrated per-tile cap for deep candidate lists);
        a compacted IVF tier that covers every row takes its place."""
        qt = np.full((len(queries), max_terms), self.analyzer.pad_id, np.int32)
        qi = np.zeros((len(queries), max_terms), np.float32)
        for i, q in enumerate(queries):
            qt[i], qi[i] = self.analyzer.query_entry(q, self.df, max_terms)
        inv = self._inv
        tail = self._tail_arrays(flt) if inv is not None else None
        ivf = self._ivf if self._ivf is not None and self._ivf_upto == self.size else None
        shard_rows = self.shard_rows
        if use_kernel is None:
            use_kernel = self.device.type == "cuda" and shard_rows >= 2048
        if not isinstance(query_emb, torch.Tensor):
            query_emb = torch.from_numpy(np.asarray(query_emb, np.float32))
        live = min(max(self.size - self.base, 1), shard_rows)
        return sharded_hybrid_search(
            query_emb.to(torch.float32), torch.from_numpy(qt), torch.from_numpy(qi),
            DenseCorpus(values=self.emb, scales=self.scales, live_rows=live),
            LexicalCorpus(terms=self.terms, tfs=self.tfs, doc_len=self.doc_len),
            self._mask(flt), self.df.avgdl, self.mesh,
            vocab_size=self.spec.vocab_size, k=k, candidates=candidates,
            metric=self.spec.metric, inverted=inv,
            use_kernel=use_kernel and ivf is None,
            dense_tile=2048 if shard_rows >= 2048 else max(256, shard_rows),
            per_tile_k=self._per_tile_k if use_kernel and candidates >= 32 else None,
            int8_queries=use_kernel and self.spec.dtype == torch.int8,
            rescore=rescore, ivf=ivf, nprobe=self._ivf_nprobe, tail=tail)

    # -- snapshot / restore --------------------------------------------------

    def snapshot_state(self) -> tuple[dict, dict]:
        """Every shard gathered into the ``DeviceIndex.snapshot_state``
        layout (bf16 stored as f32), on every rank."""
        n = self.size
        arrays = {}
        for name, *_ in self._columns():
            full = torch.cat(all_gather(getattr(self, name), self.mesh.root))[:n]
            if full.dtype == torch.bfloat16:
                full = full.to(torch.float32)  # npz cannot hold bf16
            arrays[name] = full.cpu().numpy()
        host = {
            "spec": {
                "dim": self.spec.dim, "metric": Metric(self.spec.metric).value,
                "dtype": DTYPE_NAMES[self.spec.dtype],
                "bm25_slots": self.spec.bm25_slots,
                "vocab_size": self.spec.vocab_size,
                "min_capacity": self.spec.min_capacity,
            },
            "size": n,
            "row_meta": self.row_meta,
            "df": self.df.state(),
        }
        return arrays, host

    @classmethod
    def from_snapshot(cls, arrays: dict, host: dict,
                      mesh: Mesh) -> "ShardedDeviceIndex":
        """Restore a snapshot that either package wrote (numpy arrays or
        tensors): each rank keeps its block of the rows."""
        s = host["spec"]
        spec = IndexSpec(dim=s["dim"], metric=Metric(s["metric"]),
                         dtype=DTYPES[s["dtype"]], bm25_slots=s["bm25_slots"],
                         vocab_size=s["vocab_size"], min_capacity=s["min_capacity"])
        idx = cls(spec, mesh)
        n = host["size"]
        idx._ensure_capacity(n)
        blocks = {}
        for name, tail, _, _ in idx._columns():
            a = arrays[name]
            if not isinstance(a, torch.Tensor):  # JAX hands out read-only
                a = torch.from_numpy(np.require(a, requirements="W"))
            if tuple(a.shape) != (n, *tail):
                raise ValueError(f"snapshot array {name} has shape {tuple(a.shape)}, "
                                 f"expected {(n, *tail)}")
            blocks[name] = a
        idx._write(0, blocks)
        idx.size = n
        idx.row_meta = list(host["row_meta"])
        idx.df = DocFrequency.from_state(host["df"])
        return idx
