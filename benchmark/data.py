"""The benchmark's inputs, made from ``--seed`` on the device: corpus rows,
the doc-term table, row texts, query texts and model weights.

Every input is drawn in chunks of ``CHUNK`` rows, each chunk from a
generator of its own seeded by (seed, kind, chunk), so the reference can
draw any chunk again after the window without the program's copy.  The
recipes are frozen copies of the smoke's (``chip_smoke.py``): the zipf
draw ``_zipf`` (:670), the corpus ``make_corpus`` (:680; here only the raw
f32 rows, term ranks and tfs: the program's ingest derives codes and
buckets), the row texts ``row_texts`` (:1815) and the query words
``make_query_texts`` (:747).
"""

from __future__ import annotations

import hashlib
import math
from typing import Iterator

import numpy as np
import torch

from benchmark.reference.text import fnv1a32

CHUNK = 1 << 20


def generator(seed: int, kind: str, chunk: int, device) -> torch.Generator:
    """The generator of one chunk of one kind of input."""
    digest = hashlib.sha256(f"{int(seed)}:{kind}:{int(chunk)}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def chunks(n: int) -> Iterator[tuple[int, int, int]]:
    """(chunk index, first row, end row) of each chunk of ``n`` rows."""
    for c, lo in enumerate(range(0, n, CHUNK)):
        yield c, lo, min(n, lo + CHUNK)


def zipf(gen: torch.Generator, a: float, shape, device) -> torch.Tensor:
    """Inverse-CDF power-law draw, P(X = k) ~ k^-a, X >= 1."""
    u = torch.rand(shape, device=device, generator=gen).to(torch.float64)
    u = torch.clamp(u, min=1e-9)
    x = torch.exp(torch.log(u) * (-1.0 / (a - 1.0)))
    x = torch.clamp(x, max=2.0 ** 62)
    return torch.clamp(x.to(torch.int64), min=1)


def rows_chunk(seed: int, cfg: dict, c: int, lo: int, hi: int, device) -> torch.Tensor:
    """f32 ``[hi - lo, dim]`` iid Gaussian rows (not yet normalised)."""
    g = generator(seed, "rows", c, device)
    return torch.randn(hi - lo, cfg["dim"], device=device, generator=g)


def lexical_chunk(seed: int, cfg: dict, c: int, lo: int, hi: int, device):
    """``(ranks int32 [n, slots], tfs f32 [n, slots], doc_len f32 [n])``:
    zipfian term ranks (-1 on a pad slot) and term frequencies."""
    lex = cfg["lexical"]
    g = generator(seed, "lexical", c, device)
    n, slots, vocab = hi - lo, lex["slots"], lex["vocab"]
    ranks = ((zipf(g, lex["zipf_terms"], (n, slots), device) - 1) % vocab).to(torch.int32)
    tfs = torch.clamp(zipf(g, lex["zipf_tf"], (n, slots), device),
                      max=lex["tf_max"]).to(torch.float32)
    if lex["pad_share"] > 0:
        padded = torch.rand((n, slots), device=device, generator=g) < lex["pad_share"]
        ranks[padded] = -1
        tfs[padded] = 0.0
    doc_len = tfs.sum(1) * 2.0 + 1.0
    return ranks, tfs, doc_len


def bucket_table(vocab: int, hash_word, device) -> torch.Tensor:
    """int32 ``[vocab + 1]``: the bucket of the word ``t<rank>`` for each
    rank, by ``hash_word(word) -> bucket``; the last entry (rank -1, a pad
    slot) is the pad bucket ``vocab``."""
    table = [hash_word(f"t{r}") for r in range(vocab)] + [vocab]
    return torch.tensor(table, dtype=torch.int32, device=device)


def terms_of(ranks: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[ranks.long() % table.shape[0]]


def doc_freq(terms: torch.Tensor, vocab: int) -> torch.Tensor:
    """int64 ``[vocab]``: documents holding each bucket (pad excluded)."""
    st = torch.sort(terms, dim=1).values
    first = torch.ones_like(st, dtype=torch.bool)
    first[:, 1:] = st[:, 1:] != st[:, :-1]
    uniq = st[first]
    return torch.bincount(uniq[uniq < vocab].long(), minlength=vocab)


WORD_TABLE_WIDTH = 8


def row_texts(ranks: torch.Tensor, tfs: torch.Tensor, words: int,
              word_table: np.ndarray) -> list[str]:
    """Each row's text: its own words ``t<rank>`` in slot order, each
    repeated tf times, the sequence repeated until it is ``words`` long.
    ``word_table`` is ``word_table(vocab)``."""
    out: list[str] = []
    pos = torch.arange(words, device=ranks.device)
    for lo in range(0, ranks.shape[0], 131072):
        r, tf = ranks[lo:lo + 131072], tfs[lo:lo + 131072].to(torch.int64)
        cum = torch.cumsum(tf, 1)
        total = torch.clamp(cum[:, -1:], min=1)
        slot = torch.searchsorted(cum, (pos[None] % total).contiguous(), right=True)
        word = torch.gather(r, 1, slot.clamp(max=r.shape[1] - 1)).clamp(min=0)
        block = word_table[word.to(torch.int32).cpu().numpy()].tobytes().decode("ascii")
        width = WORD_TABLE_WIDTH * words
        out.extend(block[i:i + width] for i in range(0, len(block), width))
    return out


def word_table(vocab: int) -> np.ndarray:
    return np.array([f"t{r}".ljust(WORD_TABLE_WIDTH).encode() for r in range(vocab)],
                    dtype=f"S{WORD_TABLE_WIDTH}")


def query_lengths(count: int, lo: int, hi: int, a: float, seed: int) -> list[int]:
    """``count`` query lengths in ``[lo, hi]`` words, P(L) ~ L^-a: the same
    multiset for every seed (the quantiles of the law), in an order drawn
    from the seed."""
    ls = np.arange(lo, hi + 1)
    p = ls.astype(np.float64) ** -a
    cdf = np.cumsum(p / p.sum())
    qs = (np.arange(count) + 0.5) / count
    lengths = ls[np.searchsorted(cdf, qs)]
    order = torch.randperm(count, generator=generator(seed, "queries", 1, "cpu"))
    return [int(x) for x in lengths[order.numpy()]]


def query_rows(seed: int, n: int, count: int) -> np.ndarray:
    """The rows whose words make the queries (drawn from the seed)."""
    g = generator(seed, "queries", 0, "cpu")
    return torch.randint(0, n, (count,), generator=g).numpy()


def query_texts(row_ranks: np.ndarray, lengths: list[int], df: np.ndarray,
                n: int, vocab: int) -> list[str]:
    """Up to ``lengths[i]`` discriminative words (df <= max(64, N / 50)) of
    each query row, distinct by bucket, in slot order."""
    df_cap = max(64, n // 50)
    texts = []
    for rr, want in zip(row_ranks, lengths):
        words, seen = [], set()
        for r in rr.tolist():
            if r < 0:
                continue
            bucket = fnv1a32(f"t{r}") & (vocab - 1)
            if bucket in seen or df[bucket] > df_cap:
                continue
            seen.add(bucket)
            words.append(f"t{r}")
            if len(words) == want:
                break
        texts.append(" ".join(words))
    return texts


def query_pool(cfg: dict, traffic: dict, seed: int, device) -> list[str]:
    """The traffic's query pool, made from the inputs alone (one pass over
    the term table for the document frequencies); the same texts as the
    pool the system's set-up makes in its own pass."""
    n, lex = cfg["rows"], cfg["lexical"]
    vocab = lex["vocab"]
    table = bucket_table(vocab, lambda w: fnv1a32(w) & (vocab - 1), device)
    df = torch.zeros(vocab, dtype=torch.int64, device=device)
    qrows = query_rows(seed, n, traffic["pool"])
    qranks = np.zeros((len(qrows), lex["slots"]), np.int32)
    for c, lo, hi in chunks(n):
        ranks, _, _ = lexical_chunk(seed, cfg, c, lo, hi, device)
        df += doc_freq(terms_of(ranks, table), vocab)
        sel = np.flatnonzero((qrows >= lo) & (qrows < hi))
        if sel.size:
            qranks[sel] = ranks[torch.from_numpy(qrows[sel] - lo).to(device)].cpu().numpy()
    qw = traffic["query_words"]
    lengths = query_lengths(len(qrows), qw["min"], qw["max"], qw["zipf"], seed)
    return query_texts(qranks, lengths, df.cpu().numpy(), n, vocab)


# -- model weights ------------------------------------------------------------

def _bert_shapes(m: dict, prefix: str, head: bool) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of a HF BERT state dict; kind is ``w`` (a
    matrix or table), ``b`` (a bias), ``g`` (a LayerNorm scale) or ``n``
    (a LayerNorm shift)."""
    h, f = m["hidden_size"], m["intermediate_size"]
    out = [(f"{prefix}embeddings.word_embeddings.weight", (m["vocab_size"], h), "w"),
           (f"{prefix}embeddings.position_embeddings.weight",
            (m["max_position_embeddings"], h), "w"),
           (f"{prefix}embeddings.token_type_embeddings.weight",
            (m["type_vocab_size"], h), "w"),
           (f"{prefix}embeddings.LayerNorm.weight", (h,), "g"),
           (f"{prefix}embeddings.LayerNorm.bias", (h,), "n")]
    for i in range(m["num_hidden_layers"]):
        p = f"{prefix}encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            out += [(p + name + ".weight", (h, h), "w"), (p + name + ".bias", (h,), "b")]
        out += [(p + "attention.output.LayerNorm.weight", (h,), "g"),
                (p + "attention.output.LayerNorm.bias", (h,), "n"),
                (p + "intermediate.dense.weight", (f, h), "w"),
                (p + "intermediate.dense.bias", (f,), "b"),
                (p + "output.dense.weight", (h, f), "w"),
                (p + "output.dense.bias", (h,), "b"),
                (p + "output.LayerNorm.weight", (h,), "g"),
                (p + "output.LayerNorm.bias", (h,), "n")]
    if head:
        out += [(f"{prefix}pooler.dense.weight", (h, h), "w"),
                (f"{prefix}pooler.dense.bias", (h,), "b"),
                ("classifier.weight", (1, h), "w"), ("classifier.bias", (1,), "b")]
    return out


def bert_state_dict(seed: int, model: dict, kind: str, device, std: float = 0.02) -> dict:
    """A HF BERT state dict (``BertModel``, or with ``kind == "reranker"``
    ``BertForSequenceClassification`` with one label) at the model's
    widths, drawn in one call on ``device``: matrices and tables
    N(0, ``std``), biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.1) and
    shifts N(0, 0.1) (non-trivial, so a reference that dropped one would
    not agree).  A configuration's model group may state ``init_std``:
    at 0.02 a cross-encoder's scores of one query's candidates spread by
    about 0.005, less than bfloat16 rounds them."""
    head = kind == "reranker"
    shapes = _bert_shapes(model, "bert." if head else "", head)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, device=device, generator=generator(seed, kind, 0, device))
    scale = {"w": std, "b": 0.02, "g": 0.1, "n": 0.1}
    sd, at = {}, 0
    for name, shape, k in shapes:
        size = math.prod(shape)
        t = flat[at:at + size].view(shape).mul_(scale[k])
        sd[name] = t.add_(1.0) if k == "g" else t
        at += size
    return sd


def model_weights(seed: int, group: dict, kind: str, device) -> dict:
    """The state dict of a configuration's model group (``encoder`` or
    ``reranker``), at its ``init_std`` where it states one."""
    return bert_state_dict(seed, group["model"], kind, device, group.get("init_std", 0.02))
