"""The port's one-card training (``super_rag_tpu_torch/train/``) against the
JAX package's ``train/`` on the same parameters and batches: the optax
chain and its schedules, InfoNCE, the contrastive and cross-encoder
steps over several updates, hard-negative mining, CE batches, pairs, the
docstring harvest, and a checkpoint the port trains loading in both
packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from super_rag_tpu.engine.collection import CollectionEngine as JEngine
from super_rag_tpu.engine.index import IndexSpec as JSpec
from super_rag_tpu.models import cross_encoder as jce
from super_rag_tpu.models import encoder as jenc
from super_rag_tpu.models import encoder_service as jsvc
from super_rag_tpu.models.tokenization import HashTokenizer as JTok
from super_rag_tpu.service import rerank_service as jrr
from super_rag_tpu.train import contrastive as jtc
from super_rag_tpu.train import corpus as jcorpus
from super_rag_tpu.train import pairs as jpairs
from super_rag_tpu.train import rerank as jtr
from super_rag_tpu_torch import convert
from super_rag_tpu_torch.engine.collection import CollectionEngine as TEngine
from super_rag_tpu_torch.engine.index import IndexSpec as TSpec
from super_rag_tpu_torch.models import cross_encoder as tce
from super_rag_tpu_torch.models import encoder as tenc
from super_rag_tpu_torch.models import encoder_service as tsvc
from super_rag_tpu_torch.models.tokenization import HashTokenizer as TTok
from super_rag_tpu_torch.service import rerank_service as trr
from super_rag_tpu_torch.train import contrastive as ttc
from super_rag_tpu_torch.train import corpus as tcorpus
from super_rag_tpu_torch.train import optim as topt
from super_rag_tpu_torch.train import pairs as tpairs
from super_rag_tpu_torch.train import rerank as ttr

# the optimizer alone: the same f32 operations, one order of the norm's sum
OPT_RTOL = 1e-6
# a step of the tiny f32 encoder: the forward's sums in other orders
# (test_torch_encoder's 2e-5), carried through the loss and the updates
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
PARAM_ATOL = 2e-5
# bf16 activations: both round every product to bf16, in other places
BF16_LOSS_RTOL = 2e-2
CE_SCORE_TOL = 1e-5
STEPS = 4

TINY = dict(vocab_size=97, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128,
            max_len=128, type_vocab_size=2)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def cfgs(dtype: str = "float32"):
    return (jenc.EncoderConfig(**TINY, dtype=getattr(jnp, dtype)),
            tenc.EncoderConfig(**TINY, dtype=getattr(torch, dtype)))


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def assert_params_close(jparams, tmodel, atol: float, what: str,
                        lr_sum: float = 0.0) -> None:
    """Every parameter within ``atol``.  Two are held within 2 x the summed
    step sizes instead: the attention's key biases and the CE's classifier
    bias.  Their gradient is zero in exact arithmetic (a softmax ignores a
    constant added to all of its inputs: a query's key scores, a group's
    candidate scores), so Adam moves them by normalised rounding noise, up
    to about the step size an update, in both packages."""
    want = tenc.flatten_tree(to_numpy(jparams))
    got = tenc.flatten_tree(tenc.flax_params(tmodel))
    assert set(want) == set(got)
    for k in want:
        noise = k.endswith(("attention/key/bias", "classifier/bias"))
        tol = max(atol, 2 * lr_sum) if noise else atol
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=f"{what}: {k}")


def token_batch(seed: int, b: int = 8, s: int = 16) -> dict:
    """Paired q / d share a token prefix, so there is signal to learn; the
    masks cut some rows short."""
    rng = np.random.default_rng(seed)
    base = rng.integers(3, 97, (b, 6)).astype(np.int32)
    q = np.concatenate([base, rng.integers(3, 97, (b, s - 6)).astype(np.int32)], 1)
    d = np.concatenate([base, rng.integers(3, 97, (b, s - 6)).astype(np.int32)], 1)
    qm = np.arange(s)[None] < rng.integers(8, s + 1, (b, 1))
    dm = np.arange(s)[None] < rng.integers(10, s + 1, (b, 1))
    return {"q_ids": q, "q_mask": qm, "d_ids": d, "d_mask": dm}


# -- the optimizer and its schedules ------------------------------------------

@pytest.mark.parametrize("name,jax_sched,port_sched", [
    ("linear warmup 3", lambda: optax.linear_schedule(0.0, 1e-3, 3),
     lambda: topt.linear_schedule(0.0, 1e-3, 3)),
    ("linear warmup 0 (constant 0)", lambda: optax.linear_schedule(0.0, 1e-3, 0),
     lambda: topt.linear_schedule(0.0, 1e-3, 0)),
    ("warmup cosine", lambda: optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10, end_value=2e-5),
     lambda: topt.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10, end_value=2e-5)),
    ("trainer, total 10", lambda: optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, 4, 10, end_value=3e-4 * 0.02),
     lambda: topt.trainer_schedule(3e-4, 4, 10)),
    ("trainer, warmup 0 and total 6", lambda: optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, 0, 6, end_value=3e-4 * 0.02),
     lambda: topt.trainer_schedule(3e-4, 0, 6)),
])
def test_schedules_match_optax(name, jax_sched, port_sched):
    js, ts = jax_sched(), port_sched()
    want = np.array([float(js(jnp.asarray(c, jnp.int32))) for c in range(16)], np.float32)
    got = np.array([float(ts(c)) for c in range(16)], np.float32)
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=0)
    if name.startswith("warmup cosine"):
        # 0, 5e-4, 1e-3, 9.627e-4, ..., 2e-5 from step 10 on
        np.testing.assert_allclose(got[:4], [0, 5e-4, 1e-3, 9.627e-4], rtol=1e-4)
        np.testing.assert_allclose(got[10:], 2e-5, rtol=1e-6)
    if "constant 0" in name:
        assert not got.any()  # warmup_steps=0 without total_steps never learns


@pytest.mark.parametrize("clip", [1e3, 0.5])
@pytest.mark.parametrize("total_steps", [None, 7])
def test_clipped_adamw_matches_optax(clip, total_steps):
    """Five updates of a random tree of parameters by random gradients:
    optax's ``chain(clip_by_global_norm, adamw)`` and the port's agree in
    every parameter (the small clip scales every step's gradients)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (7,), "c": {"d": (3, 4, 2), "e": (1,)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    opt = optax.chain(
        optax.clip_by_global_norm(clip),
        optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, max(total_steps, 3),
                                                       end_value=2e-4)
                    if total_steps else optax.linear_schedule(0.0, 1e-2, 2),
                    weight_decay=0.05))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    leaves, treedef = jax.tree.flatten(params)
    tp = [torch.tensor(a) for a in leaves]
    port = topt.trainer_optimizer(1e-2, 0.05, 2, clip, total_steps)
    tstate = port.init(tp)
    for step in range(5):
        grads = [rng.standard_normal(a.shape).astype(np.float32) for a in leaves]
        jg = jax.tree.unflatten(treedef, [jnp.asarray(g) for g in grads])
        updates, jstate = opt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate, norm = port.update(tp, [torch.tensor(g) for g in grads], tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)), rtol=OPT_RTOL)
        for w, g in zip(jax.tree.leaves(jp), tp):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OPT_RTOL, atol=0,
                                       err_msg=f"step {step}")
    assert tstate.count == 5
    if step >= 1:
        assert not np.allclose(tp[0].numpy(), leaves[0])  # it moved


def test_info_nce_loss_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    d = q + 2.0 * rng.standard_normal((12, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jl, ja = jtc.info_nce_loss(jnp.asarray(q), jnp.asarray(d), 0.05)
    tl, ta = ttc.info_nce_loss(torch.tensor(q), torch.tensor(d), 0.05)
    assert 0.5 < float(jl) < 5
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(ta) == float(ja)


# -- the contrastive step ------------------------------------------------------

def _jax_grad_norm(model, params, batch, temperature):
    def loss_fn(p):
        q = model.apply({"params": p}, batch["q_ids"], batch["q_mask"])
        d = model.apply({"params": p}, batch["d_ids"], batch["d_mask"])
        return jtc.info_nce_loss(q, d, temperature)[0]

    return float(optax.global_norm(jax.grad(loss_fn)(params)))


@pytest.mark.parametrize("total_steps", [None, 6])
def test_contrastive_steps_match_jax(total_steps):
    """STEPS updates of the tiny f32 encoder from the same flax-init
    parameters and batches: loss, accuracy and gradient norm at each step,
    and every parameter after it."""
    jcfg, tcfg = cfgs()
    cfg = jtc.TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=total_steps)
    tc = ttc.TrainConfig(**dataclasses.asdict(cfg))
    jmodel = jenc.TextEncoder(jcfg)
    jstate = jtc.create_train_state(jmodel, jax.random.PRNGKey(1), cfg)
    tmodel = convert.encoder_from_jax(to_numpy(jstate.params), tcfg, device="cpu")
    tstate = ttc.create_train_state(tmodel, None, tc)
    jstep, tstep = jtc.make_train_step(jmodel, cfg), ttc.make_train_step(tmodel, tc)
    lr_sum = 0.0
    for i in range(STEPS):
        lr_sum += float(topt.trainer_schedule(1e-3, 2, total_steps)(i))
        batch = token_batch(10 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want_norm = _jax_grad_norm(jmodel, jstate.params, jb, cfg.temperature)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        np.testing.assert_allclose(float(tm["grad_norm"]), want_norm, rtol=GRAD_NORM_RTOL)
        assert_params_close(jstate.params, tmodel, PARAM_ATOL, f"step {i}", lr_sum)
    assert tstate.step == int(jstate.step) == STEPS
    # the first update's lr is 0: one step alone moves nothing (optax)
    assert tstate.opt_state.count == STEPS


def test_contrastive_bf16_loss_near_jax():
    jcfg, tcfg = cfgs("bfloat16")
    cfg = jtc.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    jmodel = jenc.TextEncoder(jcfg)
    jstate = jtc.create_train_state(jmodel, jax.random.PRNGKey(2), cfg)
    tmodel = convert.encoder_from_jax(to_numpy(jstate.params), tcfg, device="cpu")
    tstate = ttc.create_train_state(tmodel, None, ttc.TrainConfig(**dataclasses.asdict(cfg)))
    jstep, tstep = jtc.make_train_step(jmodel, cfg), ttc.make_train_step(
        tmodel, ttc.TrainConfig(**dataclasses.asdict(cfg)))
    for i in range(3):
        batch = token_batch(20 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=BF16_LOSS_RTOL)
    for p in tmodel.parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()


def test_loss_falls_over_eight_steps():
    """The port alone, as the JAX package's test_loss_decreases: the same
    batch eight times, the loss falls and the step counts to 8."""
    cfg = tenc.EncoderConfig(vocab_size=256, hidden_dim=32, num_layers=2, num_heads=4,
                             mlp_dim=64, max_len=32, dtype=torch.float32)
    model = tenc.TextEncoder(cfg)
    tc = ttc.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    state = ttc.create_train_state(model, torch.Generator().manual_seed(0), tc)
    step = ttc.make_train_step(model, tc)
    rng = np.random.default_rng(0)
    base = rng.integers(3, 256, (16, 4)).astype(np.int32)
    batch = {"q_ids": np.concatenate([base, rng.integers(3, 256, (16, 8)).astype(np.int32)], 1),
             "q_mask": np.ones((16, 12), bool),
             "d_ids": np.concatenate([base, rng.integers(3, 256, (16, 8)).astype(np.int32)], 1),
             "d_mask": np.ones((16, 12), bool)}
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] and losses[1] == losses[0]  # step 0 has lr 0
    assert state.step == 8


# -- the cross-encoder step ------------------------------------------------------

def ce_batch(seed: int, queries: int = 3, group: int = 4, s: int = 16) -> dict:
    """Groups of one positive (repeating the query's tokens) and
    ``group - 1`` random negatives, as the JAX package's
    test_ce_train_step_learns."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((queries * group, s), np.int32)
    tt = np.zeros_like(ids)
    for qi in range(queries):
        qtok = rng.integers(3, 97, 4)
        for ci in range(group):
            dtok = qtok if ci == 0 else rng.integers(3, 97, 4)
            row = qi * group + ci
            ids[row, :11] = [1, *qtok, 2, *dtok, 2]
            tt[row, 6:11] = 1
    return {"ids": ids, "mask": ids > 0, "type_ids": tt}


@pytest.mark.parametrize("total_steps", [None, 20])
@pytest.mark.parametrize("warm", [False, True])
def test_ce_steps_match_jax(warm, total_steps):
    """STEPS cross-encoder updates from the same parameters: from flax
    init, and warm-started from an encoder's backbone (its flax tree)."""
    jcfg, tcfg = cfgs()
    cfg = jtr.RerankTrainConfig(n_negatives=3, learning_rate=3e-3, warmup_steps=2,
                                total_steps=total_steps)
    tc = ttr.RerankTrainConfig(**dataclasses.asdict(cfg))
    enc = to_numpy(jenc.TextEncoder(jcfg).init_params(jax.random.PRNGKey(7)))
    jmodel = jce.CrossEncoder(jcfg)
    jstate = jtr.create_ce_state(jmodel, jax.random.PRNGKey(8), cfg,
                                 backbone_params=enc["backbone"] if warm else None)
    cold = to_numpy(jmodel.init_params(jax.random.PRNGKey(8)))
    tmodel = convert.cross_encoder_from_jax(cold, tcfg, device="cpu")
    tstate = ttr.create_ce_state(tmodel, None, tc,
                                 backbone_params=enc["backbone"] if warm else None)
    assert_params_close(jstate.params, tmodel, 0.0, "state")
    jstep, tstep = jtr.make_ce_train_step(jmodel, cfg), ttr.make_ce_train_step(tmodel, tc)
    lr_sum = 0.0
    for i in range(STEPS):
        lr_sum += float(topt.trainer_schedule(3e-3, 2, total_steps)(i))
        batch = ce_batch(30 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        assert_params_close(jstate.params, tmodel, PARAM_ATOL, f"step {i}", lr_sum)
    assert tstate.step == STEPS


# -- mining, CE batches, rerank_with_ce ---------------------------------------------

def doc_pairs(n: int = 40, seed: int = 5):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]
    out = []
    for i in range(n):
        doc = " ".join(rng.choice(words, 12)) + f" tail{i % 7}"
        out.append((f"query {i} " + " ".join(rng.choice(words, 3)), doc))
    return out


def embedder(dim: int = 16, seed: int = 6, dupes: bool = False):
    """texts -> unit rows of a seeded table keyed by text (two docs share
    one vector when ``dupes``: a tie)."""
    rng = np.random.default_rng(seed)
    table: dict = {}

    def embed(texts):
        rows = []
        for t in texts:
            key = t.replace("tail3", "tail4") if dupes else t
            if key not in table:
                v = rng.standard_normal(dim).astype(np.float32)
                table[key] = v / np.linalg.norm(v)
            rows.append(table[key])
        return np.stack(rows)

    return embed


@pytest.mark.parametrize("kw", [
    dict(n_hard=4),
    dict(n_hard=3, band=10, seed=11),
    dict(n_hard=3, skip_hardest=2),
    dict(n_hard=5, band=12, skip_hardest=1, seed=12, max_overlap=0.3),
    dict(n_hard=4, block=16),
    dict(n_hard=4, dupes=True),
])
def test_mine_hard_negatives_matches_jax(kw):
    kw = dict(kw)
    seed = kw.pop("seed", None)
    dupes = kw.pop("dupes", False)
    raw = doc_pairs()
    jp = [jpairs.Pair(q, d) for q, d in raw]
    tp = [tpairs.Pair(q, d) for q, d in raw]
    rng = (lambda: np.random.default_rng(seed)) if seed is not None else (lambda: None)
    want = jtr.mine_hard_negatives(jp, embedder(dupes=dupes), rng=rng(), **kw)
    got = ttr.mine_hard_negatives(tp, embedder(dupes=dupes), rng=rng(), device="cpu", **kw)
    assert got == want and any(want)


@pytest.mark.parametrize("n_negatives,pairs_n", [(3, 40), (7, 5), (2, 2)])
def test_ce_batches_match_jax(n_negatives, pairs_n):
    raw = doc_pairs(pairs_n)
    jp = [jpairs.Pair(q, d) for q, d in raw]
    tp = [tpairs.Pair(q, d) for q, d in raw]
    hard = [[(i + 1) % pairs_n, (i + 3) % pairs_n][: max(0, pairs_n - 1)]
            for i in range(pairs_n)]
    cfg = jtr.RerankTrainConfig(n_negatives=n_negatives)
    want = list(jtr.ce_batches(jp, hard, JTok(vocab_size=97), np.random.default_rng(9), cfg,
                               batch_queries=2, max_len=64))
    got = list(ttr.ce_batches(tp, hard, TTok(vocab_size=97), np.random.default_rng(9),
                              ttr.RerankTrainConfig(n_negatives=n_negatives),
                              batch_queries=2, max_len=64))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def test_rerank_with_ce_matches_jax():
    jcfg, tcfg = cfgs()
    params = to_numpy(jce.CrossEncoder(jcfg).init_params(jax.random.PRNGKey(3)))
    docs = [d for _, d in doc_pairs(13)]
    want = jtr.rerank_with_ce(jce.CrossEncoder(jcfg), params, JTok(vocab_size=97),
                              "query w3 w9", docs, max_len=tcfg.max_len, batch=5)
    tmodel = convert.cross_encoder_from_jax(params, tcfg, device="cpu")
    state = ttr.create_ce_state(tmodel, None, ttr.RerankTrainConfig())
    for p in (None, state.params):
        got = ttr.rerank_with_ce(tmodel, p, TTok(vocab_size=97), "query w3 w9", docs,
                                 max_len=tcfg.max_len, batch=5)
        assert got.shape == (13,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=CE_SCORE_TOL)


def test_ce_past_the_position_table_is_refused():
    """``ce_batches`` / ``rerank_with_ce`` default to 160 tokens; over a
    128-row position table the JAX gather clamps, the port raises."""
    _, tcfg = cfgs()
    tmodel = tenc.init_params(convert.cross_encoder_from_jax(
        to_numpy(jce.CrossEncoder(cfgs()[0]).init_params(jax.random.PRNGKey(3))), tcfg,
        device="cpu"), torch.Generator().manual_seed(0))
    long_doc = " ".join(f"w{i}" for i in range(300))
    with pytest.raises(ValueError, match="position table"):
        ttr.rerank_with_ce(tmodel, None, TTok(vocab_size=97), "q", [long_doc])


# -- pairs and the corpus harvest ------------------------------------------------------

CHUNKS = [
    "Dense retrieval ranks chunks. It embeds every one! Then it searches? Yes.",
    "One sentence only",
    "First sentence here. Second one follows. 第三句。第四句！",
    "Alpha beta gamma. Delta epsilon zeta eta theta iota kappa.",
]


@pytest.mark.parametrize("kw", [{}, dict(samples_per_chunk=2), dict(keep_prob=0.5),
                                dict(min_sentences=3, samples_per_chunk=3, keep_prob=0.3)])
def test_ict_pairs_identical(kw):
    want = list(jpairs.ict_pairs(CHUNKS, np.random.default_rng(1), **kw))
    got = list(tpairs.ict_pairs(CHUNKS, np.random.default_rng(1), **kw))
    assert [(p.query, p.positive) for p in got] == [(p.query, p.positive) for p in want]
    assert want


def test_title_pairs_and_batches_identical():
    metas = [{"title_path": "Doc > Part", "text": "one two three four five six seven eight"},
             {"title_path": "", "text": "no title here at all but long enough words"},
             {"title_path": "Short", "text": "too short"},
             {"title_path": "A > B > C", "text": CHUNKS[0] * 2}]
    want = list(jpairs.title_pairs(metas))
    got = list(tpairs.title_pairs(metas))
    assert [(p.query, p.positive) for p in got] == [(p.query, p.positive) for p in want]
    both = [tpairs.Pair(q, d) for q, d in doc_pairs(11)]
    jboth = [jpairs.Pair(q, d) for q, d in doc_pairs(11)]
    wb = list(jpairs.pairs_to_batches(jboth, JTok(vocab_size=97), 4, max_len=32))
    gb = list(tpairs.pairs_to_batches(both, TTok(vocab_size=97), 4, max_len=32))
    assert len(gb) == len(wb) == 2
    for g, w in zip(gb, wb):
        for k in ("q_ids", "q_mask", "d_ids", "d_mask"):
            np.testing.assert_array_equal(g[k], w[k])


def test_pairs_from_engine_identical():
    texts = [c for c in CHUNKS] + [f"Chunk {i} speaks. Of things {i}." for i in range(6)]
    meta = [{"document_id": f"d{i}", "title_path": f"T{i} > S" if i % 2 else ""}
            for i in range(len(texts))]
    je = JEngine(JSpec(dim=16, dtype=jnp.float32, vocab_size=1 << 12))
    te = TEngine(TSpec(dim=16, dtype=torch.float32, vocab_size=1 << 12), device="cpu")
    je.ingest(texts, metadata=meta)
    te.ingest(texts, metadata=meta)
    je.delete([2])
    te.delete([2])
    want = jpairs.pairs_from_engine(je, np.random.default_rng(4), max_pairs=9)
    got = tpairs.pairs_from_engine(te, np.random.default_rng(4), max_pairs=9)
    assert [(p.query, p.positive) for p in got] == [(p.query, p.positive) for p in want]
    assert len(want) == 9


def test_harvest_docstrings_identical(tmp_path, monkeypatch):
    """Over a temporary site-packages of .py files: the same deduplicated
    docstrings, the same package list."""
    long = "This docstring explains the function at length. " * 6
    files = {
        "pkga/__init__.py": f'"""{long}"""\n',
        "pkga/mod.py": f'def f():\n    """{long} f."""\n\nclass C:\n    """short"""\n',
        "pkga/sub/deep.py": f'async def g():\n    """{long.upper()}"""\n',
        "pkga/broken.py": "def (:\n",
        "pkgb/x.py": f'"""{long}"""\n\ndef h():\n    """{long} h, a different tail of text."""\n',
        "_private/y.py": f'"""{long}"""\n',
        "pkgc-1.0.dist-info/z.py": f'"""{long}"""\n',
    }
    for rel, body in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body)
    (tmp_path / "loose.py").write_text("x = 1\n")
    import sysconfig

    monkeypatch.setattr(sysconfig, "get_paths", lambda *a, **k: {"purelib": str(tmp_path)})
    assert tcorpus.all_site_packages() == jcorpus.all_site_packages() == ("pkga", "pkgb")
    for kw in ({"packages": None}, {"packages": ("pkgb", "pkga", "nope")},
               {"packages": None, "min_chars": 10, "max_files_per_pkg": 2},
               {"packages": None, "max_docs": 2}):
        want = jcorpus.harvest_docstrings(**kw)
        assert tcorpus.harvest_docstrings(**kw) == want and want, kw


# -- a checkpoint the port trains --------------------------------------------------------

def test_trained_checkpoint_loads_in_both_packages(tmp_path):
    """Three port steps of the encoder and of the CE (warm-started from
    it); the checkpoints load in both packages' ``load_params`` and
    services, which embed and score alike."""
    _, tcfg = cfgs()
    model = tenc.TextEncoder(tcfg)
    tc = ttc.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    state = ttc.create_train_state(model, torch.Generator().manual_seed(3), tc)
    step = ttc.make_train_step(model, tc)
    for i in range(3):
        state, _ = step(state, token_batch(40 + i))
    ce = tce.CrossEncoder(tcfg)
    rc = ttr.RerankTrainConfig(n_negatives=3, learning_rate=1e-3, warmup_steps=1)
    ce_state = ttr.create_ce_state(ce, torch.Generator().manual_seed(4), rc,
                                   backbone_params=tenc.flax_params(model)["backbone"])
    ce_step = ttr.make_ce_train_step(ce, rc)
    for i in range(3):
        ce_state, _ = ce_step(ce_state, ce_batch(50 + i))
    enc_path, ce_path = str(tmp_path / "enc"), str(tmp_path / "ce")
    tsvc.save_params(tenc.flax_params(model), enc_path, tcfg)
    tsvc.save_params(tenc.flax_params(ce), ce_path, tcfg)

    jparams, jcfg = jsvc.load_params(enc_path)
    assert jcfg.dtype == jnp.float32 and jcfg.hidden_dim == tcfg.hidden_dim
    texts = [d for _, d in doc_pairs(6)]
    want = jsvc.EncoderService(cfg=jcfg, params=jparams, max_len=64).embed(texts)
    got = tsvc.EncoderService.from_checkpoint(enc_path, max_len=64, device="cpu").embed(texts)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)
    cparams, ccfg = jsvc.load_params(ce_path)
    want = jrr.RerankService(ccfg, params=cparams, max_len=64)("query w1 w2", texts)
    got = trr.RerankService.from_checkpoint(ce_path, max_len=64, device="cpu")(
        "query w1 w2", texts)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=CE_SCORE_TOL)
    with torch.no_grad():
        trained = tenc.flax_params(model)["backbone"]["layer_0"]["mlp_in"]["kernel"]
    assert np.array_equal(np.asarray(jparams["backbone"]["layer_0"]["mlp_in"]["kernel"]),
                          trained)


# -- the (dp, tp) mesh -----------------------------------------------------------

# the mesh step against the one-device step: the same f32 operations with
# the row-parallel products and the dp gradients summed in another order
MESH_LOSS_RTOL = LOSS_RTOL
MESH_PARAM_ATOL = PARAM_ATOL
MESH_STEPS = 2


def test_param_shardings_cover_tree():
    """Every parameter has a split, the JAX ``_spec_for`` rule in the port's
    ``[out, in]`` layout: the JAX kernel spec transposed, biases alike."""
    from jax.sharding import PartitionSpec

    jcfg, tcfg = cfgs()
    model = tenc.TextEncoder(tcfg)
    specs = ttc.param_shardings(model)
    flax_leaf = {}
    for mname, m in model.named_modules():
        leaves = {tenc.Dense: ("kernel", "bias"), tenc.Embed: ("embedding",),
                  tenc.LayerNorm: ("scale", "bias")}.get(type(m), ())
        for attr, leaf in zip(("weight", "bias"), leaves):
            flax_leaf[f"{mname}.{attr}"] = leaf
    jparams = jenc.TextEncoder(jcfg).init_params(jax.random.PRNGKey(0))
    jspecs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        spec = tuple(jtc._spec_for(path, leaf))
        jspecs[key] = spec + (None,) * (leaf.ndim - len(spec))
    assert len(specs) == len(jspecs)
    for name, spec in specs.items():
        leaf = flax_leaf[name]
        want = jspecs["/".join(name.split(".")[:-1] + [leaf])]
        assert spec == (want[::-1] if leaf == "kernel" else want), name
    assert specs["backbone.layer_0.attention.query.weight"] == ("tp", None)
    assert specs["backbone.layer_0.mlp_out.weight"] == (None, "tp")
    assert specs["backbone.layer_0.mlp_out.bias"] == (None,)
    assert PartitionSpec("tp") == jtc._spec_for(
        (jax.tree_util.DictKey("query"), jax.tree_util.DictKey("bias")), np.zeros(4))


@pytest.mark.parametrize("tp", [3, 5])
def test_tp_must_divide_heads_and_mlp(tp):
    from super_rag_tpu_torch.parallel.mesh import Mesh

    _, tcfg = cfgs()
    mesh = Mesh(("dp", "tp"), (1, tp), (0, 0), (None, None), torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        ttc.param_shardings(tenc.TextEncoder(tcfg), mesh)


@pytest.fixture(scope="module")
def mesh_runs(eight_devices):
    """Two steps from the same flax-init parameters and batches: the JAX
    package's (2, 2) mesh step, the port's on 2 x 2 gloo ranks, and the
    port's one-device step."""
    import torch_rank_cases as rc
    from super_rag_tpu_torch.parallel.launch import spawn

    jcfg, tcfg = cfgs()
    cfg = jtc.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    jmodel = jenc.TextEncoder(jcfg)
    mesh = jtc.train_mesh(eight_devices[:4], tp=2)
    jstate = jtc.create_train_state(jmodel, jax.random.PRNGKey(3), cfg, mesh=mesh)
    init = to_numpy(jstate.params)
    jstep = jtc.make_train_step(jmodel, cfg, mesh=mesh)
    batches = [token_batch(40 + i) for i in range(MESH_STEPS)]
    jax_metrics = []
    for batch in batches:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        norm = _jax_grad_norm(jmodel, jstate.params, jb, cfg.temperature)
        jstate, jm = jstep(jstate, jstep.place_batch(batch))
        jax_metrics.append({"loss": float(jm["loss"]), "grad_norm": norm})

    tmodel = convert.encoder_from_jax(init, tcfg, device="cpu")
    tc = ttc.TrainConfig(**dataclasses.asdict(cfg))
    tstate = ttc.create_train_state(tmodel, None, tc)
    tstep = ttc.make_train_step(tmodel, tc)
    one = []
    for batch in batches:
        tstate, tm = tstep(tstate, batch)
        one.append({k: float(v) for k, v in tm.items()})

    cfg_dict = {**TINY, "dtype": torch.float32}
    ranks = spawn(rc.mesh_train_steps, 4, device="cpu", timeout_s=rc.SPAWN_TIMEOUT_S,
                  args=(2, cfg_dict, dataclasses.asdict(cfg), init, batches))
    lr_sum = sum(float(topt.trainer_schedule(1e-3, 1, None)(i)) for i in range(MESH_STEPS))
    return {"jax": (jax_metrics, jstate.params), "one": (one, tmodel),
            "ranks": ranks, "lr_sum": lr_sum}


def test_mesh_step_matches_one_device_and_jax(mesh_runs):
    """dp 2 x tp 2: loss, gradient norm and every parameter after two
    steps equal the port's one-device step and the JAX package's mesh
    step (``tests/test_train.py test_sharded_matches_unsharded``), within
    the one-device step's tolerances."""
    jax_metrics, jparams = mesh_runs["jax"]
    one, tmodel = mesh_runs["one"]
    for run in mesh_runs["ranks"]:
        for got, want_one, want_jax in zip(run["metrics"], one, jax_metrics):
            np.testing.assert_allclose(got["loss"], want_one["loss"], rtol=MESH_LOSS_RTOL)
            np.testing.assert_allclose(got["loss"], want_jax["loss"], rtol=MESH_LOSS_RTOL)
            np.testing.assert_allclose(got["grad_norm"], want_one["grad_norm"],
                                       rtol=GRAD_NORM_RTOL)
            np.testing.assert_allclose(got["grad_norm"], want_jax["grad_norm"],
                                       rtol=GRAD_NORM_RTOL)
            assert got["accuracy"] == want_one["accuracy"]
        whole = tenc.TextEncoder(cfgs()[1])
        tenc.load_flax_params(whole, run["params"])
        assert_params_close(jparams, whole, MESH_PARAM_ATOL, "mesh vs JAX mesh",
                            mesh_runs["lr_sum"])
        assert_params_close(tenc.flax_params(tmodel), whole, MESH_PARAM_ATOL,
                            "mesh vs one device", mesh_runs["lr_sum"])


def test_mesh_ranks_hold_their_shards(mesh_runs):
    """rank = dp * 2 + tp; a column-parallel weight holds half the rows, a
    row-parallel one half the columns, the rest whole."""
    specs = ttc.param_shardings(tenc.TextEncoder(cfgs()[1]))
    full = {n: tuple(p.shape) for n, p in tenc.TextEncoder(cfgs()[1]).named_parameters()}
    for rank, run in enumerate(mesh_runs["ranks"]):
        assert tuple(run["coords"]) == (rank // 2, rank % 2)
        for name, shape in run["shapes"].items():
            want = tuple(s // 2 if ax == "tp" else s for s, ax in zip(full[name], specs[name]))
            assert shape == want, name
