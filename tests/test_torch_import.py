"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package, and its entry points refuse to fall back to the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "super_rag_tpu_torch")

MODULES = [
    "super_rag_tpu_torch", "super_rag_tpu_torch.convert",
    "super_rag_tpu_torch.ops.dense_topk", "super_rag_tpu_torch.ops.hybrid",
    "super_rag_tpu_torch.ops.ivf", "super_rag_tpu_torch.ops.ivf_topk",
    "super_rag_tpu_torch.engine", "super_rag_tpu_torch.engine.batcher",
    "super_rag_tpu_torch.engine.snapshot", "super_rag_tpu_torch.models",
    "super_rag_tpu_torch.tokenize", "super_rag_tpu_torch.tokenize.native_bpe",
    "super_rag_tpu_torch.models.encoder", "super_rag_tpu_torch.models.cross_encoder",
    "super_rag_tpu_torch.models.tokenization", "super_rag_tpu_torch.models.subword",
    "super_rag_tpu_torch.models.encoder_service", "super_rag_tpu_torch.models.hf_loader",
    "super_rag_tpu_torch.models.image_embedder", "super_rag_tpu_torch.service",
    "super_rag_tpu_torch.service.rerank_service", "super_rag_tpu_torch.config",
    "super_rag_tpu_torch.store", "super_rag_tpu_torch.store.objectstore",
    "super_rag_tpu_torch.tokenize.native", "super_rag_tpu_torch.engine.manager",
    "super_rag_tpu_torch.ops.bm25_inverted", "super_rag_tpu_torch.app",
    "super_rag_tpu_torch.api.http", "super_rag_tpu_torch.api.auth",
    "super_rag_tpu_torch.api.routes", "super_rag_tpu_torch.schema.model",
    "super_rag_tpu_torch.schema.view_models", "super_rag_tpu_torch.store.db",
    "super_rag_tpu_torch.store.models", "super_rag_tpu_torch.nodeflow.engine",
    "super_rag_tpu_torch.nodeflow.runners", "super_rag_tpu_torch.fileparser.parser",
    "super_rag_tpu_torch.chunk.chunking", "super_rag_tpu_torch.tasks.scheduler",
    "super_rag_tpu_torch.tasks.reconciler", "super_rag_tpu_torch.tasks.document",
    "super_rag_tpu_torch.service.context", "super_rag_tpu_torch.service.collection_service",
    "super_rag_tpu_torch.service.document_service", "chip_smoke", "tune_ivf_probe",
    "super_rag_tpu_torch.models.image_decode", "super_rag_tpu_torch.index.vision",
    "super_rag_tpu_torch.fileparser.image", "super_rag_tpu_torch.fileparser.ocr",
    "super_rag_tpu_torch.utils.sevenzip", "super_rag_tpu_torch.utils.uncompress",
    "super_rag_tpu_torch.tasks.worker", "super_rag_tpu_torch.store.sources",
    "super_rag_tpu_torch.fileparser.pdf", "super_rag_tpu_torch.fileparser.office",
    "super_rag_tpu_torch.fileparser.olebinary", "super_rag_tpu_torch.llm",
    "super_rag_tpu_torch.llm.prompts", "super_rag_tpu_torch.kg",
    "super_rag_tpu_torch.kg.extract", "super_rag_tpu_torch.kg.construct",
    "super_rag_tpu_torch.kg.service", "super_rag_tpu_torch.nodeflow.runners.graph_search",
    "super_rag_tpu_torch.nodeflow.runners.merge", "super_rag_tpu_torch.llm.errors",
    "super_rag_tpu_torch.llm.client", "super_rag_tpu_torch.llm.signed",
    "super_rag_tpu_torch.llm.resolver", "super_rag_tpu_torch.exceptions",
    "super_rag_tpu_torch.index.summary", "super_rag_tpu_torch.nodeflow.runners.llm",
    "super_rag_tpu_torch.nodeflow", "super_rag_tpu_torch.nodeflow.models",
    "super_rag_tpu_torch.nodeflow.yamlsub", "super_rag_tpu_torch.nodeflow.parser",
    "super_rag_tpu_torch.nodeflow.registry",
    "super_rag_tpu_torch.nodeflow.runners.fulltext_search",
    "super_rag_tpu_torch.service.workflow_service", "super_rag_tpu_torch.agent",
    "super_rag_tpu_torch.agent.ag_ui", "super_rag_tpu_torch.agent.code_runner",
    "super_rag_tpu_torch.agent.planner", "super_rag_tpu_torch.agent.runtime",
    "super_rag_tpu_torch.agent.session_manager", "super_rag_tpu_torch.agent.skills",
    "super_rag_tpu_torch.websearch", "super_rag_tpu_torch.websearch.service",
    "super_rag_tpu_torch.websearch.readability", "super_rag_tpu_torch.api.wsflow",
    "super_rag_tpu_torch.service.chat_service", "super_rag_tpu_torch.evals",
    "super_rag_tpu_torch.mcp", "super_rag_tpu_torch.mcp.server",
    "super_rag_tpu_torch.api.webui", "super_rag_tpu_torch.cli", "super_rag_tpu_torch.train",
    "super_rag_tpu_torch.train.pairs", "super_rag_tpu_torch.train.corpus",
    "super_rag_tpu_torch.train.optim", "super_rag_tpu_torch.train.contrastive",
    "super_rag_tpu_torch.train.rerank", "super_rag_tpu_torch.parallel",
    "super_rag_tpu_torch.parallel.mesh", "super_rag_tpu_torch.parallel.launch",
    "super_rag_tpu_torch.parallel.sharded", "super_rag_tpu_torch.parallel.sharded_hybrid",
    "super_rag_tpu_torch.engine.sharded_index", "super_rag_tpu_torch.entry",
    "super_rag_tpu_torch.trace", "super_rag_tpu_torch.trace.tracing",
]
# the multi-device slice's modules, also imported in a spawned rank
MULTI_DEVICE = [m for m in MODULES if m.startswith((
    "super_rag_tpu_torch.parallel", "super_rag_tpu_torch.engine.sharded_index",
    "super_rag_tpu_torch.entry", "super_rag_tpu_torch.trace"))]
# third-party packages the JAX package's serving seam and trainers use and the
# card's machine may lack; the port replaces each (jinja2, torch's own
# dependency, is allowed)
FORBIDDEN = ("pydantic", "pydantic_core", "yaml", "httpx", "markdown_it", "PIL", "ray",
             "cryptography", "websockets", "httpcore", "optax", "flax")


def test_import_pulls_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        f"for m in {MODULES!r}: __import__(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'super_rag_tpu' or m.startswith('super_rag_tpu.')"
        f" or m == 'bench' or m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad, 'jinja2' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] True"


def test_a_spawned_rank_imports_no_jax():
    """A rank that ``parallel/launch.py`` spawns imports the multi-device
    modules and nothing of JAX, though this test process holds both."""
    import torch_rank_cases as rc
    from super_rag_tpu_torch.parallel.launch import spawn

    assert len(MULTI_DEVICE) == 9
    out = spawn(rc.imported_modules, 2, device="cpu", timeout_s=rc.SPAWN_TIMEOUT_S,
                args=(MULTI_DEVICE,))
    assert out == [[], []]


def test_source_names_no_jax_import_or_jax_package_path():
    pattern = re.compile(
        r"^\s*(import jax|from jax)|from super_rag_tpu\.|import super_rag_tpu\b"
        r"|super_rag_tpu/|import bench\b|from bench\b"
        r"|^\s*(import|from) (pydantic|yaml|httpx|httpcore|websockets|markdown_it|cryptography"
        r"|optax|flax)"
        r"\b", re.M)
    scanned = 0
    for dirpath, _, files in os.walk(PORT):
        if "_build" in dirpath:
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                with open(os.path.join(dirpath, f)) as fh:
                    hits = pattern.findall(fh.read())
                assert not hits, f"{f}: {hits}"
                scanned += 1
    assert scanned >= 60


@pytest.mark.parametrize("entry", ["resolve_device", "DeviceIndex",
                                   "CollectionEngine", "HashEmbedder",
                                   "dense_topk", "hybrid_search", "ivf_topk",
                                   "build_ivf_streaming", "EncoderService",
                                   "RerankService", "encoder_from_jax",
                                   "cross_encoder_from_jax", "csr_from_jax",
                                   "EngineManager", "build_context", "App",
                                   "KnowledgeGraphService", "cli", "mine_hard_negatives",
                                   "entry", "dryrun_multichip", "spawn"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, monkeypatch, tmp_path):
    from super_rag_tpu_torch import convert, resolve_device
    from super_rag_tpu_torch.engine import CollectionEngine, DeviceIndex, IndexSpec
    from super_rag_tpu_torch.engine.manager import EngineManager
    from super_rag_tpu_torch.models import HashEmbedder
    from super_rag_tpu_torch.models.encoder import EncoderConfig
    from super_rag_tpu_torch.models.encoder_service import EncoderService
    from super_rag_tpu_torch.ops.dense import build_corpus
    from super_rag_tpu_torch.ops.dense_topk import dense_topk
    from super_rag_tpu_torch.ops.hybrid import hybrid_search
    from super_rag_tpu_torch.ops.ivf import build_ivf, build_ivf_streaming
    from super_rag_tpu_torch.ops.ivf_topk import ivf_topk
    from super_rag_tpu_torch.app import App
    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.kg import KnowledgeGraphService
    from super_rag_tpu_torch.service.context import build_context
    from super_rag_tpu_torch.store.db import Database
    from super_rag_tpu_torch.service.rerank_service import RerankService
    from super_rag_tpu_torch.train.pairs import Pair
    from super_rag_tpu_torch.train.rerank import mine_hard_negatives
    from super_rag_tpu_torch import entry as entries
    from super_rag_tpu_torch.parallel.launch import spawn

    def cli_context():
        from super_rag_tpu_torch import cli

        monkeypatch.delenv("SUPER_RAG_FORCE_CPU", raising=False)
        with cli._ctx():
            pass

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = IndexSpec(dim=16, vocab_size=1 << 10, min_capacity=256)
    corpus = build_corpus(torch.randn(40, 16))
    q = torch.randn(2, 16)
    qt = torch.full((2, 4), 1 << 10, dtype=torch.int32)
    ivf = build_ivf(torch.randn(40, 16), nlist=4, kmeans_iters=1)
    tiny = EncoderConfig(vocab_size=50, hidden_dim=16, num_layers=1, num_heads=2,
                         mlp_dim=32, max_len=64)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "DeviceIndex": lambda: DeviceIndex(spec),
        "CollectionEngine": lambda: CollectionEngine(spec),
        "HashEmbedder": lambda: HashEmbedder(dim=16),
        "dense_topk": lambda: dense_topk(q, corpus, k=3),
        "hybrid_search": lambda: hybrid_search(
            q, qt, torch.zeros(2, 4), corpus, None, 1.0,
            vocab_size=1 << 10, k=3),
        "ivf_topk": lambda: ivf_topk(q, ivf, k=3),
        "build_ivf_streaming": lambda: build_ivf_streaming(
            lambda: iter([torch.randn(40, 16).numpy()]), nlist=4),
        "EncoderService": lambda: EncoderService(cfg=tiny),
        "RerankService": lambda: RerankService(config=tiny),
        "encoder_from_jax": lambda: convert.encoder_from_jax({}, tiny),
        "cross_encoder_from_jax": lambda: convert.cross_encoder_from_jax({}, tiny),
        "csr_from_jax": lambda: convert.csr_from_jax({}),
        "EngineManager": lambda: EngineManager(),
        "build_context": lambda: build_context(Settings(data_dir=str(tmp_path))),
        "App": lambda: App(Settings(data_dir=str(tmp_path))),
        "KnowledgeGraphService": lambda: KnowledgeGraphService(Database(":memory:")),
        "cli": lambda: cli_context(),
        "mine_hard_negatives": lambda: mine_hard_negatives(
            [Pair("q", "d"), Pair("r", "e")], lambda t: np.eye(len(t), 4, dtype=np.float32)),
        "entry": lambda: entries.entry(),
        "dryrun_multichip": lambda: entries.dryrun_multichip(2),
        "spawn": lambda: spawn(entries._dryrun_rank, 2),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    # named explicitly, the CPU works
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['chip_smoke.py']; import chip_smoke; "
         "sys.exit(chip_smoke.main())"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
