"""Cross-encoder reranker training: listwise softmax over mined negatives
(port of the JAX package's train/rerank.py).

For each (query, positive) pair the positive is scored against N
negatives in one forward batch and the softmax is pushed toward the
positive.  The negatives are hard ones, mined from the trained dual
encoder's own top-k (the two-stage retrieve-then-rerank training loop),
topped up with random ones.  One card, eager PyTorch, the optimizer of
``train/optim.py``; the mining search is the plain exact
``ops/dense.py dense_search`` (in the JAX package too it is plain XLA,
outside any Pallas kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.models.cross_encoder import CrossEncoder
from super_rag_tpu_torch.models.encoder import init_params, load_flax_params
from super_rag_tpu_torch.train.contrastive import apply_gradients, to_device
from super_rag_tpu_torch.train.optim import trainer_optimizer
from super_rag_tpu_torch.train.pairs import Pair


@dataclass(frozen=True)
class RerankTrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    grad_clip: float = 1.0
    total_steps: Optional[int] = None
    n_negatives: int = 7


class CEState(NamedTuple):
    params: dict  # name -> the module's parameter tensor (trained in place)
    opt_state: Any
    step: int


def _optimizer(cfg: RerankTrainConfig):
    return trainer_optimizer(cfg.learning_rate, cfg.weight_decay, cfg.warmup_steps,
                             cfg.grad_clip, cfg.total_steps)


def create_ce_state(model: CrossEncoder, generator: Optional[torch.Generator],
                    cfg: RerankTrainConfig, backbone_params=None) -> CEState:
    """The state of ``model``'s parameters, drawn from flax's initialisers
    with ``generator`` (None: the module's current weights).

    ``backbone_params``: warm-start the transformer backbone from the
    TRAINED dual encoder (the same Backbone module): its flax tree, e.g.
    ``flax_params(encoder)["backbone"]``.  A from-scratch CE has to relearn token
    matching and stays at chance for thousands of steps, while a
    retriever-initialized one only learns the pair head (the standard
    retriever->reranker init)."""
    if generator is not None:
        init_params(model, generator)
    if backbone_params is not None:
        load_flax_params(model.backbone, backbone_params)  # copies in place
    params = dict(model.named_parameters())
    return CEState(params=params, opt_state=_optimizer(cfg).init(list(params.values())),
                   step=0)


def make_ce_train_step(model: CrossEncoder, cfg: RerankTrainConfig):
    """batch: ids/mask/type_ids of shape [B*(1+n), S]; candidate 0 of each
    group is the positive.  Returns ``(state, {loss, accuracy, grad_norm})``
    (f32 scalars on the device)."""
    opt = _optimizer(cfg)
    group = 1 + cfg.n_negatives

    def step_fn(state: CEState, batch: dict):
        dev = next(iter(state.params.values())).device
        tt = batch.get("type_ids")
        with torch.enable_grad():
            scores = model(to_device(batch["ids"], dev), to_device(batch["mask"], dev),
                           None if tt is None else to_device(tt, dev))
            scores = scores.reshape(-1, group)
            label_logits = scores[:, 0]
            loss = (torch.logsumexp(scores, dim=-1) - label_logits).mean()
            acc = (torch.argmax(scores, dim=-1) == 0).float().sum() * (1.0 / scores.shape[0])
            opt_state, g_norm = apply_gradients(opt, state, loss)
        return (CEState(params=state.params, opt_state=opt_state, step=state.step + 1),
                {"loss": loss.detach(), "accuracy": acc, "grad_norm": g_norm})

    return step_fn


def mine_hard_negatives(
    pairs: Sequence[Pair],
    embed_fn,  # callable texts -> [N, D] unit-norm np array
    n_hard: int = 4,
    block: int = 2048,
    max_overlap: float = 0.6,
    band: Optional[int] = None,
    skip_hardest: int = 0,
    rng: Optional[np.random.Generator] = None,
    device: DeviceLike = None,
) -> list[list[int]]:
    """For each pair, indices (into ``pairs``) of the encoder's strongest
    WRONG positives for its query: the negatives that actually teach the
    reranker to out-rank its own retriever.  The exact search runs on
    ``device`` (None: the card).

    ``band``/``skip_hardest`` denoise false negatives (the RocketQA
    observation: the retriever's VERY top wrong answers are often
    actually relevant, and training against them teaches the CE to
    suppress right answers).  With ``band=B``, negatives are sampled
    from the filtered top-B candidates after dropping the first
    ``skip_hardest``, instead of taking the absolute hardest ones.

    ``max_overlap`` drops candidates whose word-set Jaccard overlap with
    the true positive exceeds the threshold: corpora with boilerplate
    (docstrings, legal templates) surface near-duplicates of the positive
    as the retriever's top wrong answers, and labeling those "negative"
    is noise that pins the listwise loss at chance level."""
    from super_rag_tpu_torch.ops.dense import build_corpus, dense_search

    dev = resolve_device(device)
    docs = [p.positive for p in pairs]
    d_emb = np.asarray(embed_fn(docs))
    q_emb = np.asarray(embed_fn([p.query for p in pairs]))
    corpus = build_corpus(torch.from_numpy(np.ascontiguousarray(d_emb, np.float32)).to(dev),
                          dtype=torch.float32)
    word_sets = [frozenset(d.lower().split()) for d in docs]
    out: list[list[int]] = []
    # extra headroom: some candidates get filtered
    k = band if band else (n_hard * 2 + 1)
    k = max(k, n_hard + skip_hardest + 1)
    for lo in range(0, len(pairs), block):
        q = torch.from_numpy(np.ascontiguousarray(q_emb[lo : lo + block], np.float32)).to(dev)
        _, ids = dense_search(q, corpus, k=min(k, len(pairs)))
        ids = ids.cpu().numpy()
        for row, qi in enumerate(range(lo, min(lo + block, len(pairs)))):
            pos_words = word_sets[qi]
            cands = []
            for x in ids[row]:
                x = int(x)
                if x == qi or x < 0:
                    continue
                inter = len(pos_words & word_sets[x])
                union = len(pos_words | word_sets[x]) or 1
                if inter / union > max_overlap:
                    continue  # near-duplicate of the positive: skip
                cands.append(x)
            cands = cands[skip_hardest:]
            if band and rng is not None and len(cands) > n_hard:
                sel = rng.choice(len(cands), size=n_hard, replace=False)
                negs = [cands[i] for i in sorted(sel)]
            else:
                negs = cands[:n_hard]
            out.append(negs)
    return out


def ce_batches(
    pairs: Sequence[Pair],
    hard_negs: Sequence[Sequence[int]],
    tokenizer,
    rng: np.random.Generator,
    cfg: RerankTrainConfig,
    batch_queries: int = 16,
    max_len: int = 160,
) -> Iterator[dict]:
    """Pack [B*(1+n), S] pair batches: positive first, then hard negatives
    topped up with random ones.  A ``max_len`` past the model's position
    table makes the step raise (``models/encoder.py Backbone``): pass the
    model's ``cfg.max_len``."""
    order = rng.permutation(len(pairs))
    for lo in range(0, len(order) - batch_queries + 1, batch_queries):
        qs, ds = [], []
        for qi in order[lo : lo + batch_queries]:
            qi = int(qi)
            cands = [qi] + list(hard_negs[qi])[: cfg.n_negatives]
            # top up with random negatives; once the distinct pool is
            # exhausted (tiny corpora, large n_negatives) repeat existing
            # negatives instead of spinning forever on uniqueness
            while len(cands) < 1 + cfg.n_negatives and len(cands) < len(pairs):
                r = int(rng.integers(0, len(pairs)))
                if r != qi and r not in cands:
                    cands.append(r)
            while len(cands) < 1 + cfg.n_negatives:
                cands.append(cands[1 + int(rng.integers(0, len(cands) - 1))]
                             if len(cands) > 1 else qi)
            for ci in cands:
                qs.append(pairs[qi].query)
                ds.append(pairs[ci].positive)
        ids, mask, tt = tokenizer.encode_pairs(qs, ds, max_len=max_len)
        yield {"ids": ids, "mask": mask, "type_ids": tt}


def rerank_with_ce(
    model: CrossEncoder,
    params,
    tokenizer,
    query: str,
    docs: Sequence[str],
    max_len: int = 160,
    batch: int = 256,
) -> np.ndarray:
    """Scores for one query against candidate docs (descending = better).
    ``params`` is a state's ``params`` (name -> tensor), or None for the
    module's own weights."""
    dev = next(model.parameters()).device
    scores = []
    for lo in range(0, len(docs), batch):
        chunk = docs[lo : lo + batch]
        ids, mask, tt = tokenizer.encode_pairs([query] * len(chunk), chunk,
                                               max_len=max_len)
        args = tuple(torch.from_numpy(a).to(dev) for a in (ids, mask, tt))
        with torch.inference_mode():
            s = (model(*args) if params is None
                 else torch.func.functional_call(model, params, args))
        scores.append(s.float().cpu().numpy())
    return np.concatenate(scores)
