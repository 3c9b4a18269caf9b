"""The output check that decides ``correct``.

After the window, a sample of the answers (``trace.Picker``: drawn from
the seed over the positions of the dispatches that started in the window,
the longest query always in it) is judged against the plain reference
(``reference/``), which draws the inputs again from the seed and derives,
without the program, everything the program derived from them: tokens,
query embeddings, stored rows, term buckets, document frequencies, the
lexical generation under the stated budgets, BM25, the fusions and the
cross-encoder's scores.

Each sampled position brings what the timed path produced for it: the
query's embedding, the dense and the lexical candidate lists that went
into the fusion, the fused list, (reranked cells) the candidates and the
cross-encoder's scores, and the answer the client got.  The numbers, each
the worst over the sample:

- ``embed_err``: 1 - cos(program's query embedding, reference's);
- ``dense_err``: |program's dense score - reference's score of that row|;
- ``dense_gap``: the widest gap, in reference scores, by which the dense
  list misses what the per-tile selection keeps: within each tile of
  ``dense_tile`` rows, the j-th best of the listed rows against the
  tile's j-th best; and, past the list's last score, the best unlisted
  row of each tile that lists fewer rows than the cap could have taken
  (at least ``per_tile_k_min``, and as many as any tile lists);
- ``bm25_err``: |program's BM25 - reference's BM25 of that row| / the
  reference's;
- ``lex_gap``: the widest gap, as a share of the reference's score, by
  which the j-th best row of the lexical list lies below the j-th best of
  the reference's generation under the same budgets (``reference/
  lexical.py``), both in the reference's BM25; a missing row reads 1;
- ``rrf_err``: the fused list, the candidates and the answer against the
  reciprocal rank fusion of the program's own two lists (scores of the
  rows it kept, and the top scores it should have kept);
- ``ce_err``: |program's cross-encoder score - reference's| / (1 + |ref|);
- ``rerank_gap``: the widest gap by which the answer's rows lie below the
  reference's best in the reference's fused rerank score (z units);
- ``missing``: sampled positions for which the dispatch made no output,
  or whose answer no client with that query received.

Where the reference follows the program a step: the dense numbers take
the program's own query embedding (judged alone by ``embed_err``), the
lexical generation's pool takes the program's dense list (judged by the
dense numbers), ``rrf_err`` fuses the program's own two lists, and the
rerank fusion takes the candidates' retrieval scores (judged by
``rrf_err``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from benchmark import data
from benchmark.reference import bert, lexical, retrieval, text


@dataclass
class Sample:
    query: str
    emb: Optional[np.ndarray] = None
    dense: Optional[tuple] = None  # (rows, scores) [C]
    lex: Optional[tuple] = None  # (rows, scores) [C]
    fused: Optional[tuple] = None  # (rows, scores) [k_recall]
    cands: Optional[tuple] = None  # (rows, scores) handed to the reranker
    ce: Optional[np.ndarray] = None  # cross-encoder scores of cands
    answer: Optional[tuple] = None  # (rows, scores) as served
    found: bool = True


def verdict(numbers: dict, limits: dict, failed: int) -> tuple[bool, list, dict]:
    """``(correct, lines, compared)``: each number against its limit (a
    number with no limit is read and printed, not compared), every limit
    read, and no request failed."""
    lines, compared = [], {}
    ok = failed == 0
    for name, value in numbers.items():
        if name not in limits:
            lines.append(f"check {name} {float(value)!r} not compared")
            continue
        value, limit = float(value), float(limits[name]["limit"])
        compared[name] = {"value": value, "limit": limit}
        ok = ok and bool(value <= limit)
        lines.append(f"check {name} {value!r} limit {limit!r}")
    for name in limits:
        if name not in numbers:
            ok = False
            lines.append(f"check {name} not read, limit {limits[name]['limit']!r}")
    lines.append(f"check failed_requests {failed} limit 0")
    return ok, lines, compared


# -- the reference ------------------------------------------------------------

def _exact_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class Pass:
    """What one pass over the seed's inputs gives the judge."""
    dense_of: list  # per sample: {row: reference dense score}
    tile_top: Optional[torch.Tensor]  # [S, tiles, K] each tile's best reference scores
    bm25: torch.Tensor  # [S, N] every row's BM25 (float64; the control's bfloat16)
    postings: dict  # term -> (rows, impacts), the budgets' prefixes
    text_of: dict  # row -> reference row text
    top: Optional[tuple] = None  # the control's dense list (scores, rows) [S, C]


def data_pass(cfg: dict, seed: int, device, e: torch.Tensor, storage: str, idf_tab: torch.Tensor,
              avgdl: float, depth: dict, want_dense: list, tile_k: int, want_text: set,
              top_c: int = 0) -> Pass:
    """One pass over the chunks: cosine scores of the queries ``e``
    against the rows as stored in ``storage``, the scores of the rows in
    ``want_dense``, each tile's best ``tile_k`` (or, with ``top_c``, the
    best ``top_c`` over all rows); BM25 of every row for each query's
    idf table ``idf_tab`` [S, vocab + 1] (float64, or bfloat16 for the
    control); the postings prefixes of ``depth``; the texts asked for."""
    n, lex = cfg["rows"], cfg["lexical"]
    vocab, tile = lex["vocab"], cfg["dense_tile"]
    table = lexical.bucket_table(vocab, device)
    words = cfg.get("chunk_words", 0)
    wtable = data.word_table(vocab) if words and want_text else None
    S = e.shape[0]
    dense_of = [dict() for _ in range(S)]
    want = [np.asarray(sorted(set(int(r) for r in w if r >= 0)), np.int64) for w in want_dense]
    tops, text_of = [], {}
    bm25 = torch.empty((S, n), dtype=idf_tab.dtype, device=device)
    postings = lexical.Postings(depth, device)
    top = None
    if top_c:
        top = (torch.full((S, top_c), -math.inf, device=device),
               torch.full((S, top_c), -1, dtype=torch.int64, device=device))
    for c, lo, hi in data.chunks(n):
        x = retrieval.unit_rows(data.rows_chunk(seed, cfg, c, lo, hi, device))
        sc = e @ retrieval.stored_rows(x, storage).T
        del x
        for i, rows in enumerate(want):
            sel = rows[(rows >= lo) & (rows < hi)]
            if sel.size:
                got = sc[i, torch.from_numpy(sel - lo).to(device)].double().cpu().numpy()
                dense_of[i].update(zip(sel.tolist(), got.tolist()))
        if tile_k:
            if lo % tile:
                raise ValueError(f"chunks of {data.CHUNK} rows do not hold whole tiles of {tile}")
            pad = -(hi - lo) % tile
            st = torch.nn.functional.pad(sc, (0, pad), value=-math.inf).view(S, -1, tile)
            tops.append(torch.topk(st, min(tile_k, tile), dim=2).values)
        if top_c:
            v, i = torch.topk(sc, min(top_c, hi - lo), dim=1)
            tv, tp = torch.topk(torch.cat([top[0], v], 1), top_c, dim=1)
            top = (tv, torch.gather(torch.cat([top[1], i + lo], 1), 1, tp))
        del sc
        ranks, tfs, dl = data.lexical_chunk(seed, cfg, c, lo, hi, device)
        terms = data.terms_of(ranks, table)
        imp = lexical.impacts(tfs, dl, avgdl)
        postings.add(terms, imp, lo)
        del imp
        sat = retrieval.saturation(tfs, dl, avgdl, idf_tab.dtype)
        for i in range(S):
            bm25[i, lo:hi] = retrieval.bm25_rows(idf_tab[i], terms, sat)
        del sat
        rows = np.asarray(sorted(r for r in want_text if lo <= r < hi), np.int64)
        if rows.size and wtable is not None:
            tix = torch.from_numpy(rows - lo).to(device)
            for r, t in zip(rows.tolist(), data.row_texts(ranks[tix], tfs[tix], words, wtable)):
                text_of[r] = t
    return Pass(dense_of=dense_of, tile_top=torch.cat(tops, 1) if tops else None, bm25=bm25,
                postings=postings.finish(), text_of=text_of, top=top)


def _idf_tables(q_terms: list, idf64: np.ndarray, vocab: int, dtype, device) -> torch.Tensor:
    tab = torch.zeros((len(q_terms), vocab + 1), dtype=torch.float64)
    for i, qt in enumerate(q_terms):
        if qt:
            tab[i, qt] = torch.from_numpy(idf64[qt])
    return tab.to(dtype).to(device)


def _tile_gap(rows: np.ndarray, ref: list, top: torch.Tensor, tile: int, cap: int) -> float:
    """``dense_gap`` of one list: its rows ``rows`` (valid, with reference
    scores ``ref``) against the tiles' best scores ``top`` [tiles, > cap];
    a tile listing fewer than ``cap`` rows was not cut by the cap."""
    per: dict = {}
    for r, v in zip(rows.tolist(), ref):
        per.setdefault(r // tile, []).append(v)
    gap = 0.0
    top_h = top.double().cpu()
    for t, vs in per.items():
        vs = sorted(vs, reverse=True)
        best = top_h[t, :len(vs)].tolist()
        gap = max(gap, max(b - v for b, v in zip(best, vs)))
    if ref:
        listed = torch.zeros(top_h.shape[0], dtype=torch.long)
        for t, vs in per.items():
            listed[t] = len(vs)
        free = listed < cap
        nxt = top_h.gather(1, listed.clamp(max=top_h.shape[1] - 1)[:, None])[:, 0]
        over = nxt[free] - min(ref)
        if over.numel():
            gap = max(gap, float(over.max()))
    return gap


def _lex_gap(best: np.ndarray, got: np.ndarray) -> float:
    """The widest gap, as a share of ``best``'s j-th score, by which the
    j-th best of ``got`` lies below it (a missing entry reads 0)."""
    g = np.sort(np.asarray(got, np.float64))[::-1]
    gap = 0.0
    for j, b in enumerate(best):
        v = g[j] if j < g.size else 0.0
        gap = max(gap, (b - v) / b)
    return gap


def judge(samples: list[Sample], cfg: dict, traffic: dict, seed: int, device,
          control: Optional[dict] = None) -> dict:
    """The numbers of the sample against the reference (see the module's
    docstring); with ``control`` (``{"storage": ...}``), the control's own
    answers in the program's place."""
    _exact_off()
    enc, lex, opts = cfg["encoder"], cfg["lexical"], cfg["hybrid_opts"]
    vocab, n = lex["vocab"], cfg["rows"]
    rerank, top_k, cands = traffic["rerank"], traffic["top_k"], traffic["candidates"]
    kc = min(cands, n)
    numbers = {"missing": float(sum(1 for s in samples if not s.found))}
    samples = [s for s in samples if s.found]
    if not samples:
        numbers["missing"] = max(numbers["missing"], 1.0)
        return numbers
    qs = [s.query for s in samples]
    sd = data.model_weights(seed, enc, "encoder", device)
    toks = [text.encode(q, enc["model"]["vocab_size"], enc["max_len"]) for q in qs]
    e_ref = bert.embed(sd, enc["model"], toks, device)
    df, total_len = lexical.stats(cfg, seed, device)
    avgdl = total_len / n
    idf64 = retrieval.idf(df, n)
    q_terms = [text.query_terms(q, vocab) for q in qs]
    q_idf32 = [idf64[qt].astype(np.float32) for qt in q_terms]
    table_postings = lex.get("table_postings") if lex["index_type"] == "InvertedIndex" else None
    q_depth = [lexical.depths(qt, w, opts, table_postings) for qt, w in zip(q_terms, q_idf32)]
    depth: dict = {}
    for qt, ds in zip(q_terms, q_depth):
        for t, d in zip(qt, ds):
            depth[t] = max(depth.get(t, 0), d)
    kg = min(opts["lex_gen"], n)
    if control is not None:
        e_ctl = bert.embed(sd, enc["model"], toks, device, precision="float8")
        first = data_pass(cfg, seed, device, e_ctl, control["storage"],
                          _idf_tables(q_terms, idf64, vocab, torch.bfloat16, device), avgdl,
                          depth, [[] for _ in samples], 0, set(), top_c=kc)
        _control_lists(samples, e_ctl, first, q_terms, q_idf32, q_depth, kg, kc, top_k, rerank)
        del first
    del sd

    e_out = retrieval.unit_rows(torch.from_numpy(
        np.stack([np.asarray(s.emb, np.float32) for s in samples])).to(device))
    listed = [np.bincount(s.dense[0][s.dense[0] >= 0] // cfg["dense_tile"]).max(initial=0)
              for s in samples]
    cap = max(cfg["per_tile_k_min"], *listed)  # the cap keeps at least as many as any tile lists
    want_text = {int(r) for s in samples if s.cands is not None for r in s.cands[0]}
    p = data_pass(cfg, seed, device, e_out, cfg["storage_dtype"],
                  _idf_tables(q_terms, idf64, vocab, torch.float64, device), avgdl, depth,
                  [s.dense[0] for s in samples], cap + 1, want_text if rerank else set())

    emb_err = dense_err = dense_gap = bm25_err = lex_gap = rrf_err = 0.0
    for i, s in enumerate(samples):
        er = e_ref[i].double().cpu().numpy()
        eo = np.asarray(s.emb, np.float64)
        emb_err = max(emb_err, 1.0 - float(er @ eo / max(np.linalg.norm(eo), 1e-30)))
        rows, scores = s.dense
        ok = np.isfinite(scores) & (rows >= 0)
        ref_scores = [p.dense_of[i].get(int(r), -math.inf) for r in rows[ok]]
        for v, rv in zip(scores[ok], ref_scores):
            dense_err = max(dense_err, abs(v - rv))
        if int(ok.sum()) < kc:
            dense_gap = math.inf  # the list should be full
        else:
            dense_gap = max(dense_gap, _tile_gap(rows[ok], ref_scores, p.tile_top[i],
                                                 cfg["dense_tile"], cap))
        lrows, lscores = s.lex
        lok = np.isfinite(lscores) & (lscores > 0) & (lrows >= 0)
        ref_l = p.bm25[i][torch.from_numpy(lrows[lok]).to(device)].double().cpu().numpy()
        for v, rv in zip(lscores[lok], ref_l):
            bm25_err = max(bm25_err, abs(v - rv) / max(abs(rv), 1e-12))
        gen = lexical.generate(p.postings, q_terms[i], q_idf32[i], q_depth[i], kg)
        _, best = lexical.best_of_pool(np.concatenate([rows[ok], gen.cpu().numpy()]),
                                       p.bm25[i], kc)
        lex_gap = max(lex_gap, _lex_gap(best, ref_l))
        fused_ref = retrieval.rrf(np.where(ok, rows, -1).tolist(),
                                  np.where(lok, lrows, -1).tolist())
        rrf_err = max(rrf_err, _rrf_err(s, fused_ref, rerank, top_k))
    numbers.update(embed_err=emb_err, dense_err=dense_err, dense_gap=dense_gap,
                   bm25_err=bm25_err, lex_gap=lex_gap, rrf_err=rrf_err)
    if rerank:
        numbers.update(_rerank_numbers(samples, p, cfg, seed, device, top_k,
                                       "float8" if control is not None else None))
    return numbers


def _rrf_err(s: Sample, fused_ref: dict, rerank: bool, top_k: int) -> float:
    err = 0.0
    best = sorted(fused_ref.values(), reverse=True)
    frows, fscores = s.fused
    fok = frows >= 0
    lists = [(frows[fok], fscores[fok])]
    lists.append(s.cands if rerank else s.answer)
    for rows, scores in lists:
        if rows is None:
            return math.inf
        for r, v in zip(rows, scores):
            err = max(err, abs(v - fused_ref.get(int(r), math.inf)))
        for b, v in zip(best, scores):
            err = max(err, abs(b - v))
    if not rerank and len(s.answer[0]) != min(top_k, int(fok.sum())):
        return math.inf
    return err


def _rerank_numbers(samples: list, p: Pass, cfg: dict, seed: int, device, top_k: int,
                    control_precision: Optional[str]) -> dict:
    rr = cfg["reranker"]
    m = rr["model"]
    sd = data.model_weights(seed, rr, "reranker", device)
    ce_err = gap = 0.0
    for s in samples:
        if s.cands is None or (s.ce is None and control_precision is None):
            return {"ce_err": math.inf, "rerank_gap": math.inf}
        rows, base = s.cands
        pairs = [text.encode_pair(s.query, p.text_of[int(r)], m["vocab_size"], rr["max_len"])
                 for r in rows]
        ref = bert.cross_scores(sd, m, pairs, device).double().cpu().numpy()
        if control_precision is not None:
            s.ce = bert.cross_scores(sd, m, pairs, device,
                                     precision=control_precision).double().cpu().numpy()
            fused = retrieval.rerank_fuse(s.ce, base)
            order = np.argsort(-fused, kind="stable")[:top_k]
            s.answer = (rows[order], fused[order])
        ce_err = max(ce_err, float(np.max(np.abs(s.ce - ref) / (1.0 + np.abs(ref)))))
        fused_ref = retrieval.rerank_fuse(ref, base)
        of = dict(zip(rows.tolist(), fused_ref.tolist()))
        got = [of.get(int(r), -math.inf) for r in s.answer[0]]
        if len(got) != min(top_k, len(rows)):
            return {"ce_err": ce_err, "rerank_gap": math.inf}
        gap = max(gap, retrieval.widest_gap(np.sort(fused_ref)[::-1][:len(got)], got))
    return {"ce_err": ce_err, "rerank_gap": gap}


def _control_lists(samples: list, e_ctl: torch.Tensor, first: Pass, q_terms: list,
                   q_idf32: list, q_depth: list, kg: int, kc: int, top_k: int,
                   rerank: bool) -> None:
    """The control's lists in the program's place: its query embeddings
    and dense list (float8 or the next type down), its lexical generation
    and rescore in bfloat16 over the same budgets, their reciprocal rank
    fusion in bfloat16, and the answer (for a reranked cell the fused list
    becomes the candidates; the rerank follows in ``_rerank_numbers``)."""
    dv, di = first.top
    k_recall = max(top_k, kc)
    for i, s in enumerate(samples):
        s.emb = e_ctl[i].cpu().numpy()
        s.dense = (di[i].cpu().numpy(), dv[i].double().cpu().numpy())
        gen = lexical.generate(first.postings, q_terms[i], q_idf32[i], q_depth[i], kg,
                               dtype=torch.bfloat16)
        s.lex = lexical.best_of_pool(np.concatenate([s.dense[0], gen.cpu().numpy()]),
                                     first.bm25[i], kc)
        fused = retrieval.rrf(s.dense[0].tolist(), s.lex[0].tolist())
        fused = {r: float(torch.tensor(v).to(torch.bfloat16)) for r, v in fused.items()}
        order = sorted(fused, key=lambda r: -fused[r])[:k_recall]
        s.fused = (np.array(order, np.int64), np.array([fused[r] for r in order]))
        if rerank:
            s.cands = s.fused
        else:
            s.answer = (s.fused[0][:top_k], s.fused[1][:top_k])
