"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package, and its entry points refuse to fall back to the CPU."""

import os
import re
import subprocess
import sys

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
    "super_rag_tpu_torch.ops.bm25_inverted", "chip_smoke", "tune_ivf_probe",
]


def test_import_pulls_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        f"for m in {MODULES!r}: __import__(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'super_rag_tpu' or m.startswith('super_rag_tpu.')"
        " or m == 'bench']\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_source_names_no_jax_import_or_jax_package_path():
    pattern = re.compile(
        r"^\s*(import jax|from jax)|from super_rag_tpu\.|import super_rag_tpu\b"
        r"|super_rag_tpu/|import bench\b|from bench\b", re.M)
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
    assert scanned >= 28


@pytest.mark.parametrize("entry", ["resolve_device", "DeviceIndex",
                                   "CollectionEngine", "HashEmbedder",
                                   "dense_topk", "hybrid_search", "ivf_topk",
                                   "build_ivf_streaming", "EncoderService",
                                   "RerankService", "encoder_from_jax",
                                   "cross_encoder_from_jax", "csr_from_jax",
                                   "EngineManager"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, monkeypatch):
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
    from super_rag_tpu_torch.service.rerank_service import RerankService

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
