#!/usr/bin/env python3
"""Smoke run of the PyTorch port (super_rag_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                          # every phase and gate
    python3 chip_smoke.py --phases http,workflows  # or SMOKE_PHASES=http,workflows

With ``--phases`` (or ``SMOKE_PHASES``) it runs the device, build and two
[small] phases, then the named phases (from full, wide, serve, ivf,
ivf-serve, semantic, csr, engine, http, docs, graph, providers,
workflows, chat, mcp, train, multi) in their usual order, with those that feed them ([serve]
needs [full], [ivf-serve] needs [ivf]), and lists their kernel rows; an
unknown phase exits non-zero before anything runs.

Phases, each printing one line with its seconds:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA;
  2. build: nvcc builds the kernels from super_rag_tpu_torch/csrc;
  3. kernel vs plain version at small shapes, every mode (int8 x int8 must
     match bit for bit, the float modes within a stated tolerance), for
     the dense top-k (both variants: the sorted-selection tensor-core
     kernel for every mode at every kt (f32 as three TF32 products; the
     deep selection above kt 128, to the tile's 2,048), split tiles
     included, at D up to 4,096 in its one form; the int8 register-list
     kernel at kt <= 8),
     each launch checked against the variant and mode counters, and
     both IVF kernels; prints the ptxas report (registers, shared memory,
     spills) of every kernel built;
  4. full size: 1M x 768 int8 corpus + 64-slot zipfian BM25 table made on
     the card from a seed, DeviceIndex + compact_lexical, then
     search_hybrid at batch 512 (the tensor-core kernel launched and held
     bit for bit against its plain version, the hybrid result against the
     same path on the plain version, the dense top-10 against an exact
     f32 search: recall >= 0.9), and timings of the kernel, the
     sorted-selection kernel on the same inputs, the plain version, a
     library yardstick, the whole search_hybrid batch and its stages;
     then [wide]: a seeded 1M x 1,536 int8 corpus searched at batch 512
     through dense_topk (the register-list kernel), bit for bit against
     its plain version, timed beside the sorted-selection kernel; and a
     default (bf16) collection at scale, a seeded 1M x 768
     bf16 corpus searched at batch 512, per-tile cap 2, through dense_topk
     (the sorted-selection kernel, one launch in mode bf16), within the
     bf16 tolerance of its plain version, and an f32 collection at scale,
     a seeded 1M x 768 f32 corpus searched at batch 512 and 64 (the
     sorted-selection kernel's TF32 mode, one launch each, within the f32
     tolerance), each timed beside the library call
     (bf16 or f32 matmul + topk) and its bound;
  5. serving: >= 256 concurrent text requests through QueryBatcher over
     a CollectionEngine on that index, each checked against a direct
     search_batch of the same query;
  6. IVF tier: a clustered 1M x 768 int8 corpus made on the card,
     DeviceIndex + compact_lexical + compact_dense(nlist 1024, nprobe 16)
     (timed streaming build), search_hybrid at batch 32 (the union
     kernel) and search_dense at batch 512 (the tensor-core per-query
     kernel over its tile-major work list) with their launches counted
     per variant, each kernel held against its plain version
     at those calls' inputs, the batch-32 hybrid result against the same
     path on the plain versions (bit for bit for every query whose union
     candidate list matches the plain version's; RRF scores equal where
     ids agree for the others, which differ at near-ties of the tensor
     cores' sums), recall@10 against an exact f32 dot (gated) and cosine
     search, timings of the calls, the kernels, the plain versions and
     a library yardstick each, and search_dense B = 512 stage by stage;
     then an f32 collection (IVF_F32_ROWS x 768 f32 rows by the same
     recipe over the same texts, compact_dense(nlist 1024, nprobe 16)):
     search_hybrid at batch 32 through the union kernel's f32 mode
     (three TF32 products), held against its plain version and timed;
  7. IVF serving: >= 128 concurrent requests through
     QueryBatcher(max_batch=32) on the IVF index, each answer equal to a
     direct search_batch of its dispatch's batch, one union-kernel launch
     per dispatch;
  8. semantic tier: the encoder and cross-encoder at the in-repo
     checkpoints' config (6 x 256, bf16; weights drawn from flax's
     initialisers with a seed), f32 on the card held against the CPU and
     bf16 against f32; a 1M x 256 int8 index whose rows' texts are their
     own words; search_batch(hybrid, rerank, top-100 -> top-5) at batch 32
     (one tensor-core dense_topk launch at D = 256, held bit for bit
     against its plain version; every top-5 among the hybrid top-100),
     chunk embedding (16,384 texts at [128, 128]), query embedding (512),
     hybrid without rerank at 512, each forward's FLOPs and bound, and 64
     reranked requests through QueryBatcher(max_batch=32), each with the
     rows of a direct search_batch;
  9. CSR lexical tier at the north star's 10,002,432 rows x 768 int8 with
     a 48-slot zipfian table: compact_lexical picks CSR by itself;
     search_hybrid at batch 512 and 32 with the 10M budgets (pq 2048 +
     deep 4 x 16384, lex_gen 250), unsharded and with 16 doc shards,
     stage by stage; gates: CSR generation at full coverage equals the
     exact doc-major BM25 top-100, the 16-shard build equals it too, the
     dense_topk kernel inside the call is bit-equal to its plain version,
     dense recall@10 >= 0.9, hybrid fidelity against an exact hybrid
     (RRF of the exact branches) >= 0.8;
  10. engine layer: EngineManager builds an engine from a collection
     config, 65,536 texts ingested (native analyzer and Python loop
     timed), snapshot to a LocalObjectStore, a fresh manager restores from
     the store alone and answers as the original, batched_search through a
     QueryBatcher equals direct searches;
  11. HTTP serving seam: the port's own App (HTTP server, auth, audit,
     nodeflow, QueryBatcher, ThreadScheduler ingest) on the card at the
     deployment's defaults, driven over a socket with http.client: the
     [semantic] encoder and cross-encoder as checkpoints the port writes,
     a bf16 collection (the deployment's default), an int8 one and an f32
     one (all on dense_topk's tensor cores; the f32 one with half the
     request counts), HTTP_DOCS markdown documents uploaded
     to each by 8 clients (chunks/s to the last COMPLETE), HTTP_QUERIES
     queries from one client and from 64, with and without rerank (p50, p99, requests/s,
     batcher dispatches), one request split into stages by wrapped
     methods, and gates: a. statuses and sizes; b. every single-client
     answer equals a direct search_batch + RerankService; c. no ERROR
     record, exactly the reranked requests' items reranked (an unreranked
     request runs no cross-encoder), the encoders on the card; d. each
     dispatch launched dense_topk in the variant its kt selects, held
     against its plain version at the largest served batch, and a direct
     search_dense(k=200) over the default collection (the deep selection)
     against its plain version; e. a
     deleted document leaves the search; f. a fresh App on the same
     data directory answers as before the restart;
  12. the rest of the search and document routes: the App with the
     process ingest backend (worker subprocesses, stopped with the App)
     and a local object store; text documents through documents/upload +
     documents/confirm and a .zip, 256 PNG and BMP images through the
     two-phase upload, a .zip and a .tar.gz into a collection with the
     vision index; gates: a. the chunk texts equal a thread-backend App's;
     b. DOCS_IMAGE_QUERIES image searches, each its own asset first, equal to a direct
     search_by_image, one tensor-core dense_topk launch each, the kernel
     held against its plain version; c. assets, preview and object with
     byte ranges, and a path outside the document refused; d. rebuilds;
     e. a bulk delete checks the whole batch first; f. API keys and
     change-password;
  13. the stdlib document parsers and the knowledge graph: the App with
     the thread backend and the encoder; 24 documents written here from
     the seed by stdlib writers (zipfile, zlib, struct, an OLE compound
     file), 4 each of .pdf (with a FlateDecode RGB image), .docx, .xlsx,
     .pptx, .doc and .ppt, into a bf16 collection with
     ``enable_knowledge_graph``; the graph ingest split into extraction,
     node resolution (host, device) and device writes; gates: a. every
     document COMPLETE, its chunks those of a parse here and holding its
     sentences; b. a ``KnowledgeGraphService(device="cpu")`` fed the same
     chunk texts holds the same nodes, facts and invalidations as the
     served graph (``/graph/stats``, ``/graph``); c. GRAPH_QUERIES graph searches
     and as many ``use_graph`` searches from one client, each equal to the CPU
     graph's answer up to ties; d. each graph dispatch launched
     ``dense_topk_tcs_kernel`` with a mask, the kernel held against its
     plain version; e. a deleted document's facts leave both graphs;
     f. no ERROR record;
  14. the model providers: the provider tests' stub OpenAI-compatible
     provider (``tests/llm_stub.py``) in this process (a standard-library
     HTTP server in a thread: 1,536-dim
     embeddings, query-term-overlap rerank, a lead-words summary
     completion), registered with its key, models and default-model tags
     through the App's routes, the App restarted so that its completion
     client resolves at boot; collection P (bf16, text-embedding-3-small
     through the stub, the stub's rerank, the summary index) with
     PROV_DOCS documents; gates: a. every document COMPLETE with its
     vector and summary index, P's engine a RemoteEmbedder of dim 1,536,
     the stub's calls as expected, no fallback logged; b. PROV_QUERIES unreranked
     and as many reranked searches (of other queries) equal an ``App(device="cpu")`` fed the same
     documents by the same stub, up to ties; c. each dispatch launched
     dense_topk's sorted-selection tensor-core kernel (bf16, D = 1,536),
     the kernel held against its plain
     version at the served shapes and timed beside its bound and the
     library call, and the same at text-embedding-3-large's 3,072 over as
     many seeded rows, driven through ``dense_topk``; d. ``POST
     /v1/embeddings`` returns collection O's encoder vectors bit for
     bit, and a second App's collection S, embedded through it, answers
     as O (tensor cores, D = 256); e. no ERROR record;
  15. the workflows: the App as [http] sets it up, collection A (bf16) of
     WF_DOCS_A and B (int8) of WF_DOCS_B documents of [http]'s recipe; a
     saved workflow of the reference's RAG shape (start ->
     vector_search + fulltext_search over A and B -> merge (rrf) ->
     rerank (the cross-encoder) -> llm (echoes the top document))
     created by ``POST /api/v1/workflows`` and edited into a second
     version, its definition also written as YAML and parsed by the
     port's parser; WF_SINGLE runs from one client, WF_CONCURRENT from
     WF_CLIENTS clients, WF_ONE_SHOT one-shot runs of the YAML text and
     WF_STREAM streamed ones (p50, p99, runs/s, batcher dispatches), one
     run split into stages; gates: a. statuses, a workflow_run row and
     one node_run row per node for every run, the streamed events in
     order; b. each single-client run's node outputs equal an in-process
     run of the same definition with no batcher (search and merge
     outputs to the bit, rerank items equal, CE scores within 2e-2); c.
     every vector_search dispatch launched dense_topk's tensor-core
     kernel (bf16 for A, int8 for B), held against its plain version at
     the largest served batch of each; d. the cross-encoder ran on the
     card once a run; e. a deleted workflow takes its versions and runs;
     f. no ERROR record;
  16. chats, agents, sharing and the audit log ([chat], gates a-g);
  17. the MCP endpoint, the console, the CLI and the evals: the App as
     [chat] sets it up, collection M (bf16) of MCP_DOCS documents; over an
     API key, initialize, tools/list, MCP_QUERIES ``search_collection``
     calls reranked and as many not from one client, MCP_CONCURRENT from
     MCP_CLIENTS clients (p50, p99, requests/s), ``search_chat_files``
     over a chat's file, a batch with a notification, an offline
     ``web_search``; gates: a. the protocol, and each single-client call's
     items equal a direct ``POST /searches``; b. the chat-file search
     answers from the chat's file; c. each dispatch over M launched
     ``dense_topk_tcs_kernel`` once, the kernel held against its
     plain version at the largest served batch; d. ``GET /`` the console,
     ``GET /mcp`` 405; e. the CLI as subprocesses on the card (ingest,
     collections, search with the hits of an in-process
     ``execute_search``, snapshot); f. ``evaluate_engine`` over M (each
     query a section's own words) above MCP_EVAL_FLOOR;
  18. one-card training at the checkpoints' width (6 x 256, bf16 over f32
     parameters, flax-init weights from a seed) on docstrings harvested
     from the card machine's site-packages, cut to ICT pairs:
     TRAIN_STEPS contrastive steps at batch TRAIN_BATCH (ms a step,
     pairs/s, idle share), 19 hard negatives mined for MINE_PAIRS pairs,
     CE_STEPS cross-encoder steps at CE_QUERIES x 20 candidates
     warm-started from the trained backbone; gates: a. one f32 step on the
     card equals the CPU's (loss, gradient norm); b. both losses fall; c.
     the checkpoints read back and serve: hybrid + rerank over rows the
     trained encoder embedded launches one tensor-core dense_topk, bit for
     bit against its plain version; d. every parameter finite;
  19. the multi-device path over torch.distributed ranks spawned by
     ``parallel/launch.py``: NCCL with a rank a card (up to 4) where there
     are two or more cards, else two gloo ranks sharing the one (the
     candidates staged through the host); every rank makes the [full]
     recipe's seeded 1M x 768 int8 corpus and keeps its block of rows;
     gates: a. ``sharded_dense_search`` at B = 512, 100 candidates, at
     exact per-tile depth equals the one-device ``dense_topk`` bit for bit
     (ids too), and at per_tile_k 2 each rank's kernel equals its plain
     version bit for bit (recall@10 against the exact printed); b.
     ``sharded_hybrid_search`` over per-shard table postings on the kernels
     equals itself on the plain versions (its top-10 overlap with the
     one-device ``hybrid_search`` printed); c. ``entry.dryrun_multichip``
     on the same backend and world; d. dp x tp steps of the [semantic]
     encoder in f32 (tp 2) equal the one-device steps; e. a traced span
     (``trace_function(device_profile_dir=...)``) around a sharded search
     writes a Chrome trace holding the dense_topk kernel's events; each
     rank's kernel time at its shard (bound, plain, library), the
     all_gather and merge times, the sharded call against the one-device
     call;
  20. a ``{"kernels": [...]}`` JSON line;
  21. last line: ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  There is no CPU path: without a
CUDA device, or without the package beside it, it exits non-zero and
prints no result.  Nothing is written under the repo except the kernel
and analyzer libraries in super_rag_tpu_torch/_build/; the engine, HTTP,
docs, graph, providers, workflows, chat, MCP and training phases' data
(the providers' response caches and the CLI's data dir too) and the
[multi] phase's trace and rendezvous files go to temporary directories
that they remove; its ranks are stopped before it returns.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# full-size configuration: the repo's north-star single-card setup
N_ROWS = 1_000_000
DIM = 768
SLOTS = 64
VOCAB = 1 << 17
BATCH = 512
CANDIDATES = 100
TOP_K = 10
QUERY_TERMS = 6
SERVE_REQUESTS = 256
SEED = 0
TIMED_REPS = 20
DEVICE = "cuda"
# the IVF tier: the reference's own IVF setting at 1M x 768 int8
# (scripts/bench_p50.py: compact_dense(nlist=1024, nprobe=16) over 2048
# clustered centres); B = 32 hybrid takes the union kernel, B = 512
# search_dense the per-query kernel
IVF_CENTERS = 2048
IVF_NLIST = 1024
IVF_NPROBE = 16
IVF_HYBRID_BATCH = 32
IVF_DENSE_BATCH = 512
IVF_SERVE_REQUESTS = 128
IVF_F32_ROWS = N_ROWS  # the f32 collection of [ivf] (the union's f32 mode)
# the CSR lexical tier at the north star's scale: scripts/bench_10m.py's
# rows and lexical recipe (48 slots over 2^17 buckets, 16 discriminative
# query terms, pq 2048 + deep 4 x 16384, lex_gen 250), the flat dense tier
CSR_ROWS = 8192 * 1221
CSR_SLOTS = 48
CSR_QUERY_TERMS = 16
CSR_BATCH = 512
CSR_SMALL_BATCH = 32
CSR_PQ = 2048
CSR_DEEP_TERMS = 4
CSR_DEEP_POSTINGS = 16384
CSR_LEX_GEN = 250
CSR_SHARDS = 16
CSR_GATE_QUERIES = 8
CSR_EVAL_QUERIES = 64
# CSR impacts are bf16 (relative rounding <= 2^-9), the doc-major scorer's
# f32: a sum of nonnegative weights stays within 2^-9, held at 2^-8
CSR_BF16_RTOL = 2.0 ** -8
# the engine layer: texts ingested through EngineManager / CollectionEngine
ENGINE_TEXTS = 65_536
ENGINE_WORDS = 128
ENGINE_INGEST_BATCH = 2048
ENGINE_QUERIES = 64
ENGINE_PY_TEXTS = 16_384  # of them, ingested again with the Python analyzer; all until [train]
# the HTTP serving seam: the port's App at the deployment's defaults, each
# collection fed HTTP_DOCS markdown documents of HTTP_SECTIONS sections (one
# chunk each) of HTTP_WORDS zipfian words
HTTP_DOCS = 32  # at 64 the phase ran past 120 s on an H100
HTTP_SECTIONS = 512
HTTP_WORDS = 96
HTTP_UPLOADERS = 8
HTTP_QUERIES = 64  # 128 until [chat] joined the smoke (608 s); 256 before a 900 s run
HTTP_CLIENTS = 64
HTTP_SINGLE_QUERIES = 16  # of HTTP_QUERIES, from one client; 32 until the f32 per-query
# search joined [ivf], all 64 until [mcp], [train] joined
HTTP_TOP_K = 5
HTTP_CANDIDATES = 100
HTTP_STAGE_REQUESTS = 4  # 8 until the f32 per-query search joined [ivf], 16 until [mcp],
# [train], 32 until [workflows] joined the smoke
HTTP_RESTART_QUERIES = 16  # a collection; 32 until the f32 per-query search joined [ivf],
# 64 until [workflows] joined
HTTP_DEEP_K = 200  # a direct search_dense over the default collection: the deep selection
HTTP_DEEP_QUERIES = 32
# the f32 collection ("index_dtype": "float32") takes 1 / HTTP_F32_SHARE of
# every request count above
HTTP_F32_SHARE = 2
HTTP_INGEST_TIMEOUT_S = 600.0
# [docs]: the rest of the search and document routes, the process ingest
# backend, archives and the image route
DOCS_TEXT_DOCS = 32  # 16 staged + confirmed, 16 in one .zip
DOCS_TEXT_SECTIONS = 128
DOCS_IMAGES = 128  # 3/4 PNG (32 staged, the rest in one .zip), 1/4 BMP in one .tar.gz; was 256
DOCS_IMAGE_SIZE = 256
DOCS_IMAGE_QUERIES = 32  # PNG and BMP; 64 until [mcp] and [train] joined the smoke
DOCS_WORKERS = 2
DOCS_PHOTOS = ((1080, 1920), (3000, 4000))  # HD, 12 MP: the largest is searched
DOCS_TIMED_PHOTOS = 1  # of them, decoded and timed on the host too; both until [train] joined
# [graph]: the stdlib document formats into a collection with the knowledge graph
GRAPH_DOCS_PER_FORMAT = 4  # x 6 formats: .pdf .docx .xlsx .pptx .doc .ppt
GRAPH_SENTENCES = 48  # a document's seeded sentences, each one or two facts
GRAPH_ORGS = 200
GRAPH_PEOPLE = 150
GRAPH_QUERIES = 16  # POST graph/search, and as many with use_graph; was 64
GRAPH_TOP_K = 5
GRAPH_IMAGE = 48  # each PDF's FlateDecode RGB image is 48 x 48
GRAPH_MIN_FACTS = 1000  # gate a: the graph the documents make is at least this big
GRAPH_MIN_ENTITIES = 300
PROV_DIM = 1536  # OpenAI's text-embedding-3-small
PROV_WIDE_DIM = 3072  # text-embedding-3-large: its kernel rows, over P's shape
STUB_KEY = "sk-smoke-stub-key"
# collection P: 16 documents x PROV_SECTIONS sections of the [http] recipe (32
# until [workflows] joined the smoke: P's ingest and its CPU twin's halve)
PROV_DOCS = 8  # 16 until [mcp] and [train] joined the smoke, 32 until [workflows]
# 256, not 512: at 512 (16,416 rows) the phase ran 160.7 s on an H100, the CPU
# twin repeating the host-bound ingest and every App's stop snapshotting it
PROV_SECTIONS = 256
PROV_QUERIES = 16  # unreranked, and as many others reranked, from one client; was 64
PROV_S_DOCS = 8  # collections O (onboard encoder) and S (O's encoder through /v1/embeddings)
PROV_S_SECTIONS = 64
PROV_S_QUERIES = 16
PROV_ROUND_TRIPS = 64
PROV_TOP_K = 5
PROV_CANDIDATES = 100
PROV_EMBED_BATCH = 64  # RemoteEmbedder's batch
PROV_MAP_BATCH = 8  # index/summary.py's map batch
WF_DOCS_A = 16  # [workflows] collection A (bf16): 16 x HTTP_SECTIONS sections, 8,192 chunks
WF_DOCS_B = 8  # collection B (int8): 4,096 chunks
WF_SINGLE = 16  # saved-workflow runs from one client; was 64
WF_CONCURRENT = 32  # saved-workflow runs from WF_CLIENTS clients; 64 before
WF_CLIENTS = 16
WF_ONE_SHOT = 8  # POST /workflows/run of the definition's YAML text
WF_STREAM = 8  # POST /workflows/run/stream
WF_STAGE_RUNS = 16
WF_TOP_K = 50  # vector_search and fulltext_search, each over A and B
WF_RERANK_TOP_K = 5
CHAT_DOCS = 8  # [chat] collection K (bf16): 8 x HTTP_SECTIONS sections, 4,096 chunks
CHAT_SINGLE = 32  # SSE turns from one client, over CHAT_SINGLE_CHATS chats; 64 before
CHAT_SINGLE_CHATS = 8
CHAT_CONCURRENT = 32  # SSE turns from CHAT_CLIENTS clients, one chat each; 64 before
CHAT_CLIENTS = 16
CHAT_FRONTEND = 8  # POST /chat/completions/frontend, half JSON, half SSE
CHAT_WS = 8  # chat WebSocket turns, CHAT_WS_STOPS of them stopped mid-stream
CHAT_WS_STOPS = 2  # was 4 of 16
CHAT_FILE_SEARCHES = 8
CHAT_AGENT_WS = 8  # agent WebSocket turns
CHAT_AGENT_AG_UI = 8  # AG-UI turns
CHAT_SHARED_SEARCHES = 8  # user B's searches of the shared collection
CHAT_STAGE_TURNS = 8
MCP_DOCS = 8  # [mcp] collection M (bf16): 8 x HTTP_SECTIONS sections, 4,096 chunks
MCP_QUERIES = 16  # search_collection calls from one client, reranked; as many unreranked
# (32 until the f32 per-query search joined [ivf])
MCP_CONCURRENT = 16  # reranked search_collection calls from MCP_CLIENTS clients (32 until
# the f32 per-query search joined [ivf])
MCP_CLIENTS = 16
MCP_FILE_SEARCHES = 8
MCP_EVAL_PER_DOC = 8  # evaluate_engine: sections of each document, each its own query
MCP_EVAL_WORDS = 24  # a query: the first words of its section
# floors by mode: the hybrid fuses BM25 with the seeded (untrained) encoder's
# ranking, which puts the section in the top 10 but rarely first (on an H100:
# recall@1 0.25, @10 1.0, MRR 0.4627); BM25 alone ranks it first
MCP_EVAL_FLOOR = {"hybrid": {"recall@10": 0.9, "mrr": 0.35},
                  "fulltext": {"recall@1": 0.9, "recall@10": 0.95}}
CLI_DOCS = 2  # the CLI ingests this many of M's documents into a data dir of its own
CLI_TIMEOUT_S = 300
TRAIN_FILES_PER_PKG = 300  # [train]: the docstring harvest of the card's site-packages
TRAIN_MAX_DOCS = 4_000
TRAIN_BATCH = 256  # contrastive pairs a step, each side at [256, <= 128]
TRAIN_STEPS = 30  # 40 until the f32 per-query search joined [ivf]
TRAIN_LR = 3e-4  # scripts/semantic_eval.py's accelerator recipe
TRAIN_CHECK_BATCH = 8  # gate a: one f32 step on the card and on the CPU
MINE_PAIRS = 4096
MINE_NEGATIVES = 19
CE_QUERIES = 8  # a CE step: 8 queries x (1 + 19) candidates = [160, <= 128]
CE_STEPS = 80  # 100 until the f32 per-query search joined [ivf]
CE_LR = 2e-4  # at 1e-4 (RerankTrainConfig's default) the loss fell only 3.005 -> 2.971 on an H100
TRAIN_SERVE_ROWS = 1024  # gate c: harvested rows embedded by the trained encoder, int8
TRAIN_SERVE_QUERIES = 32
SEM_ROWS = 1_000_000
SEM_WORDS = 128  # words a row's text holds: every (query, row) pair fills 128 tokens
SEM_CHUNKS = 16_384  # 65,536 until [workflows] joined the smoke
SEM_CHUNK_BATCH = 128
SEM_QUERY_BATCH = 512
SEM_RERANK_QUERIES = 32
SEM_RERANK_BATCH = 32
SEM_SERVE_REQUESTS = 32  # 64 until [mcp] and [train] joined the smoke
SEM_CHECK_TEXTS = 128
SEM_STAGE_REPS = 2  # c's stage timing (~3.4 s a round); was 10
SEM_CPU_TEXTS = 16  # a full-width CPU forward at [16, 128] takes about a second
# the semantic tier: the in-repo encoder_semantic checkpoints' config
# (checkpoints/encoder_semantic{,_reranker}.json); the weights are drawn
# from flax's initialisers with a seed (checkpoints/ is not copied to the
# card), over a 1M-row index of the encoder's 256-dim embeddings
SEMANTIC_CONFIG = {"vocab_size": 30522, "hidden_dim": 256, "num_layers": 6,
                   "num_heads": 8, "mlp_dim": 1024, "max_len": 128,
                   "type_vocab_size": 2, "layer_norm_eps": 1e-12,
                   "embed_dim": None, "dtype": "bfloat16"}

# H100 SXM published peaks (dense): HBM bytes/s, int8 and bf16 operations/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12  # the f32 mode's three products a multiply-add
F32_CUDA_CORE_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = TIMED_REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each between two
    CUDA events on the current stream, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = TIMED_REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` + a device synchronize, on the host
    clock (end to end: host work and device work together)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernel vs plain version at small shapes ------------------------

def _tolerance(d: int, ref: torch.Tensor) -> float:
    """Float modes: both sides take exact products and sum D of them in f32
    in different orders, so they may differ by up to ~D ulps of the
    largest score."""
    finite = ref[torch.isfinite(ref)]
    scale = float(finite.abs().max()) if finite.numel() else 1.0
    return d * 2.0 ** -23 * (scale + 1.0)


def _compare(got_v, got_i, ref_v, ref_i, exact: bool, tol: float,
             scores=None) -> float:
    """Raise unless kernel and plain outputs agree; returns max |diff| over
    finite values.  Ids are compared where values are finite; in the
    float modes an id may differ only at a near-tie: the slot's plain
    value lies within ``tol`` of a neighbour's, or the id got scores
    (``scores``, the plain [B, N] scores) within ``tol`` of it."""
    fin = torch.isfinite(ref_v)
    if not torch.equal(fin, torch.isfinite(got_v)):
        raise AssertionError("kernel and plain version disagree on -inf slots")
    diff = (got_v - ref_v).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        if not (torch.equal(got_v, ref_v) and torch.equal(got_i[fin], ref_i[fin])):
            raise AssertionError(f"int8 x int8 mismatch (max |diff| {err})")
        return err
    if err > tol:
        raise AssertionError(f"values differ by {err} > tolerance {tol}")
    bad = fin & (got_i != ref_i)
    if bad.any():
        prev = torch.nn.functional.pad((ref_v[..., 1:] - ref_v[..., :-1]).abs(),
                                       (1, 0), value=float("inf"))
        nxt = torch.nn.functional.pad((ref_v[..., 1:] - ref_v[..., :-1]).abs(),
                                      (0, 1), value=float("inf"))
        near_tie = torch.minimum(prev, nxt) <= tol
        if scores is not None:
            got_s = torch.gather(scores.expand(got_i.shape[0], -1, -1), -1,
                                 torch.where(fin, got_i, 0).long())
            near_tie |= (got_s - ref_v).abs() <= tol
        if (bad & ~near_tie).any():
            raise AssertionError("ids differ away from any near-tie")
    return err


def phase_small() -> int:
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.dense import Metric, build_corpus

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    b, n, d, k = 20, 5000, 96, 10  # ragged: B % 16, N % tile, D % 256
    modes = [("int8 x int8", torch.int8, True), ("int8 + bf16 q", torch.int8, False),
             ("bf16", torch.bfloat16, False), ("f32", torch.float32, False)]
    cases = 0
    for metric in (Metric.COSINE, Metric.DOT, Metric.L2):
        x = torch.randn(n, d, device=DEVICE, generator=gen)
        queries = torch.randn(b, d, device=DEVICE, generator=gen)
        keep = torch.rand(n, device=DEVICE, generator=gen) < 0.6
        for name, dtype, i8q in modes:
            corpus = build_corpus(x, metric=metric, dtype=dtype)
            for tile in (200, 1024, 2048):
                for mask in (None, keep):
                    for ptk in (None, 2):
                        q, qs, kt, _ = dt.prepare(queries, corpus, k, metric, tile,
                                                  i8q, ptk)
                        norms = corpus.norms_sq if metric == Metric.L2 else None
                        args = (q, qs, corpus.values, corpus.scales, norms, mask, n,
                                tile, kt)
                        got = dt.tile_topk(*args)
                        ref = dt.tile_topk_plain(*args)
                        torch.cuda.synchronize()
                        _compare(*got, *ref, exact=i8q,
                                 tol=_tolerance(d, ref[0]),
                                 scores=dt.plain_scores(*args[:6], 0, n))
                        cases += 1
    # int8 x int8 at every list depth: the register-list kernel (kt <= 8,
    # any D, forced here: these grids are too small for it to be chosen)
    # and the sorted-selection kernel (any D: sorted lists at kt <= 128,
    # the deep selection at kt 129, 256 and the tile's 2,048); ragged B
    # and D, a
    # mask with an all-masked tile, duplicate rows (ties); every one
    # bit-equal to the plain version
    sms = dt._sm_count(torch.cuda.current_device())
    wide = ((1, 1040), (17, 1536), (130, 3072), (1, 4096))  # D above 1,024
    for bq, dq in ((1, 16), (17, 48), (130, 768), *wide):
        codes = torch.randint(-127, 128, (n, dq), device=DEVICE, generator=gen,
                              dtype=torch.int8)
        codes[64:96] = codes[:32]
        row_scale = torch.rand(n, device=DEVICE, generator=gen) * 0.01 + 0.001
        row_scale[64:96] = row_scale[:32]
        q8 = torch.randint(-127, 128, (bq, dq), device=DEVICE, generator=gen,
                           dtype=torch.int8)
        qs8 = torch.rand(bq, device=DEVICE, generator=gen) * 0.01 + 0.001
        keep = torch.rand(n, device=DEVICE, generator=gen) < 0.7
        keep[2048:4096] = False
        for kt in (1, 2, 3, 8, 9, 32, 100, dt.TC_MAX_KT, dt.TC_MAX_KT + 1, 256, 2048):
            got_variant = dt.kernel_variant(dt.MODE_INT8, kt, dq, bq, -(-n // 2048), sms)
            if got_variant != "tcs":
                raise AssertionError(f"kt={kt}, D={dq} took {got_variant}, not tcs")
            forced = kt <= dt.LIST_MAX_KT
            for variant in ("tcs", "tc") if forced else ("tcs",):
                for mask in (None, keep):
                    args = (q8, qs8, codes, row_scale, None, mask, n, 2048, kt)
                    before = _counts()
                    with mock.patch.object(dt, "kernel_variant",
                                           lambda *a, v=variant, **kw: v):
                        got = dt.tile_topk(*args)
                    _expect_launch(before, variant, dt.MODE_INT8)
                    ref = dt.tile_topk_plain(*args)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                        raise AssertionError(f"int8 {variant} kernel differs from plain at "
                                             f"B={bq}, D={dq}, kt={kt}")
                    cases += 1
    # bf16 queries on the tensor cores, bf16 rows and int8 codes, and f32
    # queries on f32 rows (three TF32 products), at every list depth and
    # split, the deep selection's kt 129, 256 and the tile's own included:
    # within _tolerance, ids equal but at near-ties
    for mode in (dt.MODE_BF16, dt.MODE_INT8_BF16, dt.MODE_F32):
        for bq, dq in ((1, 16), (17, 96), (64, 256), (130, 768), *wide):
            x = torch.randn(n, dq, device=DEVICE, generator=gen)
            x[64:96] = x[:32]
            if mode == dt.MODE_BF16:
                values, row_scale = x.to(torch.bfloat16), None
            elif mode == dt.MODE_F32:
                values, row_scale = x, None
            else:
                values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                row_scale = torch.rand(n, device=DEVICE, generator=gen) * 0.01 + 0.001
            qb = torch.randn(bq, dq, device=DEVICE, generator=gen)
            qb = qb if mode == dt.MODE_F32 else qb.to(torch.bfloat16)
            keep = torch.rand(n, device=DEVICE, generator=gen) < 0.7
            keep[2048:4096] = False
            for depth in (1, 5, 9, 32, 100, dt.TC_MAX_KT, dt.TC_MAX_KT + 1, 256, "tile"):
                for tile in (200, 2048):
                    kt = tile if depth == "tile" else depth
                    if dt.kernel_variant(mode, kt, dq, bq, -(-n // tile), sms) != "tcs":
                        raise AssertionError(f"mode {mode} at kt={kt}, D={dq} did not take "
                                             f"the tcs kernel")
                    args = (qb, None, values, row_scale, None, keep, n, tile, kt)
                    before = _counts()
                    got = dt.tile_topk(*args)
                    _expect_launch(before, "tcs", mode)
                    ref = dt.tile_topk_plain(*args)
                    torch.cuda.synchronize()
                    _compare(*got, *ref, exact=False, tol=_tolerance(dq, ref[0]),
                             scores=dt.plain_scores(*args[:6], 0, n))
                    cases += 1
    return cases


# the _counts() key of each tensor-core mode (ops/dense_topk.py MODE_*), and
# of the register-list kernel's launches alone (dense_topk_tc counts both
# tensor-core kernels)
TC_MODE_KEYS = {0: "dense_topk_tc_int8", 1: "dense_topk_tc_int8_bf16", 2: "dense_topk_tc_bf16",
                3: "dense_topk_tc_f32"}
LIST_KEY = "dense_topk_tc_list"
# the kernels line's variant of the register-list kernel's rows, and of
# the sorted-selection kernel's row at scale
LIST_VARIANT = "tc (persistent, TMA ring, wgmma m64n128k32 s8)"
TCS_VARIANT = "tcs (TMA ring, wgmma m64nNk16 bf16 / k32 s8, rows as M, rank-merged lists)"
TCS_F32_VARIANT = "tcs f32 (TMA ring, 3 x wgmma m64nNk8 tf32 on rna planes, A from registers)"
TCS_DEEP_VARIANT = ("tcs deep (TMA ring, wgmma, the slice's scores kept; radix select, "
                    "bitonic sort a warp a query)")


def _expect_launch(before: dict, variant: str, mode: int) -> None:
    """Raise unless exactly one dense_topk kernel launched since ``before``
    (``_counts()``): the ``variant`` ("tc" or "tcs") in ``mode``."""
    after = _counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    want = {"dense_topk_tc": 1, TC_MODE_KEYS[mode]: 1,
            **({LIST_KEY: 1} if variant == "tc" else {})}
    if moved != want:
        raise AssertionError(f"{variant} (mode {mode}) launched {moved}, not {want}")


# -- phase 4: the full-size corpus, made on the card --------------------------

def _zipf(gen, a: float, shape) -> torch.Tensor:
    """Inverse-CDF power-law draw, P(X = k) ~ k^-a, X >= 1 (the recipe of
    the repo's benchmark corpus, drawn on the card)."""
    u = torch.rand(shape, device=DEVICE, generator=gen).to(torch.float64)
    u = torch.clamp(u, min=1e-9)
    x = torch.exp(torch.log(u) * (-1.0 / (a - 1.0)))
    x = torch.clamp(x, max=2.0 ** 62)
    return torch.clamp(x.to(torch.int64), min=1)


def make_corpus(n: int, gen: torch.Generator, centers=None, dim: int = DIM,
                slots: int = SLOTS, vocab: int = VOCAB, pad: float = 0.2):
    """Codes, scales and a zipfian doc-term table of ``slots`` slots over
    ``vocab`` buckets on the card (a ``pad`` share of the slots padded),
    plus the host state a DeviceIndex snapshot carries.  Term buckets are
    the analyzer's hashes of the words ``t<rank>``, so text queries made
    of those words hit the same buckets.  Rows are iid Gaussian, or,
    given ``centers``, a random centre plus N(0, 1) noise (the repo's
    clustered IVF recipe); build_corpus L2-normalises and quantizes them.
    Returns the int32 ranks too (-1 on pad slots)."""
    from super_rag_tpu_torch.ops.dense import build_corpus
    from super_rag_tpu_torch.tokenize.analyzer import fnv1a32

    codes = torch.empty((n, dim), dtype=torch.int8, device=DEVICE)
    scales = torch.empty((n,), dtype=torch.float32, device=DEVICE)
    step = 131072
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        x = torch.randn(hi - lo, dim, device=DEVICE, generator=gen)
        if centers is not None:
            x += centers[torch.randint(0, centers.shape[0], (hi - lo,),
                                       device=DEVICE, generator=gen)]
        c = build_corpus(x, dtype=torch.int8)
        codes[lo:hi], scales[lo:hi] = c.values, c.scales

    bucket_of_rank = torch.tensor([fnv1a32(f"t{r}") & (vocab - 1)
                                   for r in range(vocab)],
                                  dtype=torch.int32, device=DEVICE)
    ranks = ((_zipf(gen, 1.3, (n, slots)) - 1) % vocab).to(torch.int32)
    terms = bucket_of_rank[ranks]
    tfs = torch.clamp(_zipf(gen, 2.0, (n, slots)), max=8).to(torch.float32)
    if pad > 0:
        padded = torch.rand((n, slots), device=DEVICE, generator=gen) < pad
        terms[padded] = vocab
        tfs[padded] = 0.0
        ranks[padded] = -1
        del padded
    doc_len = tfs.sum(1) * 2.0 + 1.0

    sorted_terms = torch.sort(terms, dim=1).values
    first = torch.ones_like(sorted_terms, dtype=torch.bool)
    first[:, 1:] = sorted_terms[:, 1:] != sorted_terms[:, :-1]
    uniq = sorted_terms[first]
    del sorted_terms, first
    df = torch.bincount(uniq[uniq < vocab].long(), minlength=vocab)
    del uniq
    df_host = df.cpu().numpy()
    arrays = {
        "emb": codes, "scales": scales, "terms": terms, "tfs": tfs,
        "doc_len": doc_len,
        "valid": torch.ones(n, dtype=torch.bool, device=DEVICE),
        "indexer_code": torch.zeros(n, dtype=torch.int32, device=DEVICE),
        "chat_code": torch.zeros(n, dtype=torch.int32, device=DEVICE),
    }
    host = {
        "spec": {"dim": dim, "metric": "cosine", "dtype": "int8",
                 "bm25_slots": slots, "vocab_size": vocab,
                 "min_capacity": 4096},
        "size": n,
        "row_meta": [{"text": f"chunk {r}"} for r in range(n)],
        "df": {"df": {int(t): int(df_host[t]) for t in np.flatnonzero(df_host)},
               "num_docs": n,
               "total_len": float(doc_len.to(torch.float64).sum())},
    }
    return arrays, host, ranks, df_host


def make_query_texts(ranks, df_host, gen, count: int, terms: int = QUERY_TERMS,
                     vocab: int = VOCAB) -> list[str]:
    """Queries of up to ``terms`` discriminative words from random rows
    (df <= max(64, N/50), as the repo's benchmarks pick them)."""
    n = ranks.shape[0]
    rows = torch.randint(0, n, (count,), device=DEVICE, generator=gen)
    row_ranks = ranks[rows].cpu().numpy()
    df_cap = max(64, n // 50)
    from super_rag_tpu_torch.tokenize.analyzer import fnv1a32

    texts = []
    for rr in row_ranks:
        words, seen = [], set()
        for r in rr.tolist():
            if r < 0:
                continue
            bucket = fnv1a32(f"t{r}") & (vocab - 1)
            if bucket in seen or df_host[bucket] > df_cap:
                continue
            seen.add(bucket)
            words.append(f"t{r}")
            if len(words) == terms:
                break
        texts.append(" ".join(words))
    return texts


def library_topk(q_i8, q_scale, codes, scales, mask, n, tile, kt):
    """Yardstick only, never used by the port: torch._int_mm (cuBLASLt
    int8 GEMM) + the same epilogue + torch.topk per tile, in chunks."""
    b = q_i8.shape[0]
    num_tiles = -(-n // tile)
    out_v = torch.empty((num_tiles, b, kt), dtype=torch.float32, device=DEVICE)
    tiles_per_chunk = 32
    for t0 in range(0, num_tiles, tiles_per_chunk):
        t1 = min(num_tiles, t0 + tiles_per_chunk)
        r0, r1 = t0 * tile, min(n, t1 * tile)
        s = torch._int_mm(q_i8, codes[r0:r1].t()).to(torch.float32)
        s = s * q_scale[:, None] * scales[None, r0:r1]
        s = torch.where(mask[None, r0:r1], s, float("-inf"))
        s = torch.nn.functional.pad(s, (0, (t1 - t0) * tile - (r1 - r0)),
                                    value=float("-inf"))
        out_v[t0:t1] = torch.topk(s.view(b, t1 - t0, tile), kt, dim=-1).values.transpose(0, 1)
    return out_v


def exact_topk(queries, corpus, mask, n: int, cosine: bool = False,
               k: int = TOP_K) -> torch.Tensor:
    """Ids of the exact f32 top-``k`` over the stored rows (codes x
    scales) of the first ``n`` rows, for cosine queries: the dot with the
    stored rows, or with ``cosine`` the cosine (the rows renormalised, as
    the IVF build renormalises them)."""
    from super_rag_tpu_torch.ops.dense import normalize_queries

    qn = normalize_queries(queries, "cosine")
    b = qn.shape[0]
    gold = torch.empty((b, 0), device=DEVICE)
    gold_i = torch.empty((b, 0), dtype=torch.int64, device=DEVICE)
    for lo in range(0, n, 131072):
        hi = min(n, lo + 131072)
        rows = corpus.values[lo:hi].to(torch.float32) * corpus.scales[lo:hi, None]
        if cosine:
            rows = normalize_queries(rows, "cosine")
        s = qn @ rows.T
        s = torch.where(mask[None, lo:hi], s, float("-inf"))
        v, i = torch.topk(torch.cat([gold, s], 1), k)
        gold_i = torch.gather(torch.cat([gold_i, torch.arange(lo, hi, device=DEVICE)
                                         .expand(b, -1)], 1), 1, i)
        gold = v
    return gold_i


def recall_at_k(got: torch.Tensor, gold: torch.Tensor) -> float:
    return float(np.mean([len(set(a[:TOP_K]) & set(b)) / TOP_K for a, b in
                          zip(got.cpu().tolist(), gold.cpu().tolist())]))


def phase_full(results: dict):
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from super_rag_tpu_torch.ops import dense_topk as dt

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    arrays, host, ranks, df_host = make_corpus(N_ROWS, gen)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = DeviceIndex.from_snapshot(arrays, host, device=DEVICE)
    del arrays
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.compact_lexical(postings_per_term=max(256, N_ROWS // 500))
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    log(f"[full] corpus {N_ROWS} x {DIM} int8 + {SLOTS}-slot table made on the "
        f"card in {t_gen:.2f} s; DeviceIndex in {t_load:.2f} s (capacity "
        f"{idx._capacity}); compact_lexical (torch build + per_tile_k "
        f"calibration -> {idx._per_tile_k}) in {t_compact:.2f} s")

    q_emb = torch.randn(BATCH, DIM, device=DEVICE, generator=gen)
    texts = make_query_texts(ranks, df_host, gen, BATCH)
    del ranks

    # the main path, counted
    _reset_counts()
    t0 = time.perf_counter()
    res = idx.search_hybrid(q_emb, texts, k=TOP_K, candidates=CANDIDATES)
    torch.cuda.synchronize()
    counts = _counts()
    launches = counts["dense_topk_tc"]
    log(f"[full] search_hybrid batch {BATCH}: first call {time.perf_counter() - t0:.3f} s, "
        f"launches {counts}")
    if launches < 1 or counts[LIST_KEY] < 1:
        raise AssertionError("search_hybrid did not launch the register-list dense_topk kernel")
    ids = res.indices.cpu().numpy()
    if ids.shape != (BATCH, TOP_K) or not np.isfinite(res.scores.cpu().numpy()).all():
        raise AssertionError("hybrid result has the wrong shape or non-finite scores")
    if len(set(ids[0].tolist())) != TOP_K or ids.min() < 0:
        raise AssertionError("hybrid result rows are not TOP_K distinct rows")

    # the whole hybrid batch against the same path on the plain version
    with mock.patch.object(dt, "tile_topk", dt.tile_topk_plain):
        res_plain = idx.search_hybrid(q_emb, texts, k=TOP_K, candidates=CANDIDATES)
    if not (torch.equal(res.indices, res_plain.indices)
            and torch.equal(res.scores, res_plain.scores)):
        raise AssertionError("hybrid result differs between kernel and plain version")

    # the kernel against its plain version at the main path's inputs: the
    # index's live rows (its capacity past them is padding, not scanned)
    corpus = idx.dense_corpus()
    mask = idx._mask(None)
    n = corpus.live_rows
    tile = 2048
    q, qs, kt, _ = dt.prepare(q_emb, corpus, CANDIDATES, tile=tile,
                              int8_queries=True, per_tile_k=idx._per_tile_k)
    args = (q, qs, corpus.values, corpus.scales, None, mask, n, tile, kt)
    kv, ki = dt.tile_topk(*args)
    pv, pi = dt.tile_topk_plain(*args)
    torch.cuda.synchronize()
    err = _compare(kv, ki, pv, pi, exact=True, tol=0.0)
    log(f"[full] kernel vs plain [num_tiles={kv.shape[0]}, B={BATCH}, kt={kt}]: "
        f"bit-equal (max |diff| {err})")

    sms = dt._sm_count(torch.cuda.current_device())
    if dt.kernel_variant(dt.MODE_INT8, kt, DIM, BATCH, kv.shape[0], sms) != "tc":
        raise AssertionError(f"the main path's kt={kt} left the register-list kernel")
    kernel_ms = cuda_ms(lambda: dt.tile_topk(*args))
    # the other kernel on the same inputs, for the record: the
    # sorted-selection one
    with mock.patch.object(dt, "kernel_variant", lambda *a, **kw: "tcs"):
        sv, si = dt.tile_topk(*args)
        _compare(sv, si, pv, pi, exact=True, tol=0.0)
        tcs_ms = cuda_ms(lambda: dt.tile_topk(*args))
    plain_ms = cuda_ms(lambda: dt.tile_topk_plain(*args))
    lib_ms = cuda_ms(lambda: library_topk(q, qs, corpus.values, corpus.scales,
                                          mask, n, tile, kt))
    hybrid_ms = host_ms(lambda: idx.search_hybrid(q_emb, texts, k=TOP_K,
                                                  candidates=CANDIDATES))
    num_tiles = kv.shape[0]
    nbytes = (n * DIM + n * 4 + n + BATCH * DIM + BATCH * 4
              + num_tiles * BATCH * kt * 8)
    bound, bound_by = bound_ms(nbytes, 2.0 * BATCH * n * DIM, INT8_OPS_PER_S)
    log(f"[full] dense_topk register-list kernel {kernel_ms:.3f} ms (sorted-selection "
        f"kernel {tcs_ms:.3f} ms, bit-equal), "
        f"plain {plain_ms:.3f} ms, "
        f"library (_int_mm + topk) {lib_ms:.3f} ms, bound {bound:.3f} ms "
        f"({bound_by}); search_hybrid batch {BATCH}: {hybrid_ms:.3f} ms "
        f"({BATCH / hybrid_ms * 1e3:.1f} queries/s)")
    # quality against an exact reference: the dense branch's top-10
    # (int8 queries, per-tile cap) vs an exact f32 search of the same
    # stored rows (codes x scales) for 64 queries
    sample = q_emb[:64]
    _, got = dt.dense_topk(sample, corpus, TOP_K, mask=mask, tile=tile,
                           int8_queries=True, per_tile_k=idx._per_tile_k,
                           device=DEVICE)
    recall = recall_at_k(got, exact_topk(sample, corpus, mask, n))
    log(f"[full] dense recall@{TOP_K} vs exact f32 over the stored rows "
        f"(64 queries): {recall:.4f}")
    if recall < 0.9:
        raise AssertionError(f"dense recall@{TOP_K} {recall} < 0.9")
    results["recall"] = recall

    # where the batch's time goes, stage by stage (each timed alone)
    from super_rag_tpu_torch.ops.bm25_inverted import inverted_bm25_search

    t0 = time.perf_counter()
    qt, qi = idx._query_arrays(texts, 16)
    analyze_ms = (time.perf_counter() - t0) * 1e3
    # the served path embeds its texts first (CollectionEngine.search_batch)
    embedder = HashEmbedder(dim=DIM, device=DEVICE)
    embed_ms = host_ms(lambda: embedder.embed(texts))
    dense_ms = cuda_ms(lambda: dt.dense_topk(
        q_emb, corpus, CANDIDATES, mask=mask, tile=tile, int8_queries=True,
        per_tile_k=idx._per_tile_k, device=DEVICE))
    lex_ms = cuda_ms(lambda: inverted_bm25_search(
        qt, qi, idx._inverted, k=2 * CANDIDATES, mask=mask,
        postings_per_query_term=768))
    args64 = (q[:64], qs[:64]) + args[2:]
    kernel64_ms = cuda_ms(lambda: dt.tile_topk(*args64))
    bound64, bound64_by = bound_ms(nbytes - (BATCH - 64) * (DIM + 4 + num_tiles * kt * 8),
                                   2.0 * 64 * n * DIM, INT8_OPS_PER_S)
    log(f"[full] breakdown at batch {BATCH}: query embedding (hash embedder, "
        f"not part of search_hybrid) {embed_ms:.3f} ms; host query analysis {analyze_ms:.3f} ms, "
        f"dense branch (prep + kernel + merge) {dense_ms:.3f} ms, inverted "
        f"BM25 generation {lex_ms:.3f} ms, rest (rescore + RRF) "
        f"{hybrid_ms - analyze_ms - dense_ms - lex_ms:.3f} ms; kernel at "
        f"batch 64: {kernel64_ms:.3f} ms (bound {bound64:.3f} ms, {bound64_by})")
    results["dense_topk"] = {
        "variant": LIST_VARIANT, "launches": counts[LIST_KEY],
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms, "tcs_ms": tcs_ms,
        "batch64_ms": kernel64_ms,
    }
    results["hybrid_ms"] = hybrid_ms
    return idx, texts, embedder


WIDE_DIM = 1536  # phase_wide: the flat 1M-row int8 corpus at text-embedding-3-small's width
WIDE_F32_SMALL_BATCH = 64  # phase_wide: the f32 corpus's second batch (a served batch_max)


def phase_wide(results: dict) -> None:
    """int8 x int8 at 1M x WIDE_DIM (the remote embeddings' width), B =
    BATCH, per-tile cap 2: one ``dense_topk`` call through the
    register-list kernel (its queries stream through the ring like the
    rows), held bit for bit against its plain version and timed beside the
    library call and its bound, and beside the sorted-selection kernel on
    the same inputs (this width's route before the register-list kernel
    took it).  Then a
    default collection at scale: a seeded 1M x DIM bf16 corpus (``IndexSpec``'s default dtype), B = BATCH,
    per-tile cap 2, one ``dense_topk`` call, which must launch the
    sorted-selection kernel once in mode bf16, held within the bf16
    tolerance of its plain version and timed beside the library call (bf16
    matmul + topk) and its bound.  Then an f32 collection at scale: a
    seeded 1M x DIM f32 corpus, B = BATCH and WIDE_F32_SMALL_BATCH, cap 2,
    one ``dense_topk`` call each, which must launch the sorted-selection
    kernel once in mode f32 (three TF32 products), held within the f32
    tolerance of its plain version and timed beside the library call (f32
    matmul with TF32 off + topk) and its bound."""
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.dense import build_corpus

    def wlog(msg: str) -> None:
        log(f"[wide] {msg} (on {results['card']})")

    def one_call(corpus, q_emb, int8_queries: bool) -> tuple:
        """One counted dense_topk call: its tile_topk arguments and the
        counters it moved."""
        calls: dict = {}
        _reset_counts()
        counts0 = _counts()
        with mock.patch.object(dt, "tile_topk", _recording(calls, "tile", dt.tile_topk)):
            dt.dense_topk(q_emb, corpus, TOP_K, tile=2048, int8_queries=int8_queries,
                          per_tile_k=2, device=DEVICE)
        torch.cuda.synchronize()
        return calls["tile"], {k: v - counts0[k] for k, v in _counts().items() if v - counts0[k]}

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    corpus = build_corpus(torch.randn(N_ROWS, WIDE_DIM, device=DEVICE, generator=gen),
                          dtype=torch.int8)
    q_emb = torch.randn(BATCH, WIDE_DIM, device=DEVICE, generator=gen)
    args, launched = one_call(corpus, q_emb, True)
    if launched != {"dense_topk_tc": 1, TC_MODE_KEYS[dt.MODE_INT8]: 1, LIST_KEY: 1}:
        raise AssertionError(f"[wide] dense_topk at D = {WIDE_DIM} launched {launched}")
    row = _served_kernel_row(args, 1, 1, wlog)
    if row["variant"] != "tc":
        raise AssertionError(f"[wide] took {row['variant']}")
    row["variant"] = LIST_VARIANT
    kv, ki = dt.tile_topk_plain(*args)
    with mock.patch.object(dt, "kernel_variant", lambda *a, **kw: "tcs"):
        sv, si = dt.tile_topk(*args)
        if not (torch.equal(sv, kv) and torch.equal(si, ki)):
            raise AssertionError("[wide] the tcs kernel differs from the plain version")
        row["tcs_ms"] = cuda_ms(lambda: dt.tile_topk(*args))
    wlog(f"on the same inputs, the sorted-selection kernel (this width's route before) "
         f"{row['tcs_ms']:.3f} ms, bit-equal")
    results["dense_topk_1m_wide"] = row
    del corpus, q_emb, args, kv, ki, sv, si
    torch.cuda.empty_cache()

    # a default (bf16) collection at scale, through the sorted-selection kernel
    corpus = build_corpus(torch.randn(N_ROWS, DIM, device=DEVICE, generator=gen),
                          dtype=torch.bfloat16)
    q_emb = torch.randn(BATCH, DIM, device=DEVICE, generator=gen)
    args, launched = one_call(corpus, q_emb, False)
    if launched != {"dense_topk_tc": 1, TC_MODE_KEYS[dt.MODE_BF16]: 1}:
        raise AssertionError(f"[wide] the bf16 1M x {DIM} dense_topk launched {launched}")
    row = _served_kernel_row(args, 1, 1, wlog)
    if row["variant"] != "tcs":
        raise AssertionError(f"[wide] the bf16 1M x {DIM} call took {row['variant']}")
    row["variant"] = TCS_VARIANT
    results["dense_topk_1m_bf16"] = row
    del corpus, q_emb, args
    torch.cuda.empty_cache()

    # an f32 collection at scale (3.07 GB of rows): the sorted-selection
    # kernel's TF32 mode at B = BATCH and WIDE_F32_SMALL_BATCH
    corpus = build_corpus(torch.randn(N_ROWS, DIM, device=DEVICE, generator=gen),
                          dtype=torch.float32)
    for b, key in ((BATCH, "dense_topk_1m_f32"), (WIDE_F32_SMALL_BATCH, "dense_topk_1m_f32_b64")):
        q_emb = torch.randn(b, DIM, device=DEVICE, generator=gen)
        args, launched = one_call(corpus, q_emb, False)
        if launched != {"dense_topk_tc": 1, TC_MODE_KEYS[dt.MODE_F32]: 1}:
            raise AssertionError(f"[wide] the f32 1M x {DIM} dense_topk at B = {b} "
                                 f"launched {launched}")
        row = _served_kernel_row(args, 1, 1, wlog)
        if row["variant"] != "tcs":
            raise AssertionError(f"[wide] the f32 call at B = {b} took {row['variant']}")
        row["variant"] = TCS_F32_VARIANT
        results[key] = row
        del q_emb, args
        torch.cuda.empty_cache()


# -- phase 5: serving through CollectionEngine + QueryBatcher ----------------

def phase_serve(idx, texts, embedder) -> dict:
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import IndexSpec
    from super_rag_tpu_torch.ops import dense_topk as dt

    engine = CollectionEngine(
        IndexSpec(dim=DIM, dtype=torch.int8, bm25_slots=SLOTS, vocab_size=VOCAB,
                  min_capacity=4096),
        embedder=embedder, device=DEVICE)
    engine.index = idx
    requests = texts[:SERVE_REQUESTS]
    batcher = QueryBatcher(max_batch=64)

    async def serve():
        return await asyncio.gather(*(batcher.search(engine, t, top_k=TOP_K)
                                      for t in requests))

    try:
        _reset_counts()
        t0 = time.perf_counter()
        answers = asyncio.run(serve())
        wall = time.perf_counter() - t0
        launches = _counts()["dense_topk_tc"]
    finally:
        batcher.close()
    if launches < 1:
        raise AssertionError("served requests did not launch the tensor-core dense_topk "
                             "kernel")
    for text, got in zip(requests, answers):
        want = engine.search_batch([text], top_k=TOP_K)[0]
        if ([(h.row, h.score) for h in got] != [(h.row, h.score) for h in want]
                or len(got) != TOP_K):
            raise AssertionError(f"batched answer differs for {text!r}")
    stats = batcher.stats()
    # one dispatch's worth, stage by stage: the embedding of 64 texts and
    # the whole search_batch of them (embedding + search_hybrid + hits)
    batch = requests[:64]
    embed64_ms = host_ms(lambda: embedder.embed(batch), reps=10)
    batch64_ms = host_ms(lambda: engine.search_batch(batch, top_k=TOP_K), reps=10)
    log(f"[serve] {len(requests)} concurrent requests in {wall:.3f} s: "
        f"{stats['dispatches']} dispatches, {stats['queries']} queries, "
        f"tensor-core dense_topk launches {launches}; every answer equals a direct "
        f"search_batch; search_batch of 64 texts {batch64_ms:.3f} ms, of "
        f"which embedding {embed64_ms:.3f} ms")
    return stats


# -- the IVF dense tier ------------------------------------------------------

def _scores_err(got: torch.Tensor, ref: torch.Tensor, d: int) -> tuple[float, float]:
    """Raise unless two raw candidate-score arrays agree: the same -inf
    slots, finite values within ``_tolerance`` (sums of exact products,
    or of f32 products, in other orders).  Returns (max |diff|, tol)."""
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError("kernel and plain version disagree on -inf slots")
    tol = _tolerance(d, ref)
    diff = (got - ref).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    if err > tol:
        raise AssertionError(f"scores differ by {err} > tolerance {tol}")
    return err, tol


def _compare_candidates(got: torch.Tensor, ref: torch.Tensor, d: int, k: int) -> float:
    """Kernel vs plain candidate scores ``[B, ...]``: the raw arrays within
    tolerance, then their top-k as the glue takes it (stable_topk), ids
    equal up to near-ties (``_compare``).  Returns max |diff|."""
    from super_rag_tpu_torch.ops.topk import stable_topk

    err, tol = _scores_err(got, ref, d)
    b = ref.shape[0]
    gv, gi = stable_topk(got.reshape(b, -1), k)
    rv, ri = stable_topk(ref.reshape(b, -1), k)
    _compare(gv[None], gi[None], rv[None], ri[None], exact=False, tol=tol,
             scores=ref.reshape(b, -1))
    return err


def phase_small_ivf() -> int:
    """Both IVF routes against their plain versions at small shapes:
    every values mode, a ragged capacity (200) and a 128-multiple one,
    D = 96 and 1536, empty slots, with and without a keep-mask and the
    residual add-back; probe lists with repeats, that cover every tile
    (nprobe = nlist), that all hold one tile, and that put every query on
    the same two tiles (a tile over several groups of the work list).
    Each per-query call must launch the tensor-core per-query kernel."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    nlist, b = 12, 20
    cases = 0
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        for cap, d in ((200, 96), (256, 96), (200, 1536)):
            x = torch.randn(nlist, cap, d, device=DEVICE, generator=gen)
            if dtype == torch.int8:
                values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                scales = torch.rand(nlist, cap, device=DEVICE, generator=gen) * 0.01
            else:
                values, scales = x.to(dtype), None
            row_ids = torch.randperm(nlist * cap, device=DEVICE, generator=gen).to(
                torch.int32).reshape(nlist, cap)
            row_ids[torch.rand(nlist, cap, device=DEVICE, generator=gen) < 0.2] = -1
            q = torch.randn(b, d, device=DEVICE, generator=gen).to(
                torch.float32 if dtype == torch.float32 else torch.bfloat16)
            cs_all = torch.randn(b, nlist, device=DEVICE, generator=gen)
            keep = torch.rand(nlist * cap, device=DEVICE, generator=gen) < 0.7
            union_sets = [torch.tensor([3, 0, 11, 7], dtype=torch.int32, device=DEVICE),
                          torch.arange(nlist, dtype=torch.int32, device=DEVICE)]
            one_tile = torch.randint(0, nlist, (b, 5), device=DEVICE, generator=gen,
                                     dtype=torch.int32)
            one_tile[:, 2] = 7
            probe_sets = [torch.randint(0, nlist, (b, 5), device=DEVICE, generator=gen,
                                        dtype=torch.int32),
                          torch.stack([torch.randperm(nlist, device=DEVICE, generator=gen)
                                       for _ in range(b)]).to(torch.int32),
                          one_tile,
                          torch.tensor([[11, 4]], dtype=torch.int32,
                                       device=DEVICE).repeat(b, 2)]
            for residual in (False, True):
                for mask in (None, keep):
                    cs = cs_all if residual else None
                    for tiles in union_sets:
                        args = (q, tiles, values, scales, cs, row_ids, mask)
                        _compare_candidates(it.union_scores(*args),
                                            it.union_scores_plain(*args), d, 10)
                        cases += 1
                    for probes in probe_sets:
                        args = (q, probes, values, scales, cs, row_ids, mask)
                        before = it.probe_tc_launches.count
                        got = it.probe_scores(*args)
                        if it.probe_tc_launches.count != before + 1:
                            raise AssertionError(f"{dtype} per-query call did not launch "
                                                 f"the tensor-core per-query kernel")
                        _compare_candidates(got, it.probe_scores_plain(*args), d, 10)
                        cases += 1
    torch.cuda.synchronize()
    return cases


def _reset_counts() -> None:
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops import ivf_topk as it

    for counter in (dt.tc_launches, dt.list_launches, *dt.tc_mode_launches.values(),
                    it.union_tc_launches, it.probe_tc_launches):
        counter.count = 0


def _counts() -> dict:
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops import ivf_topk as it

    return {"dense_topk_tc": dt.tc_launches.count,
            **{TC_MODE_KEYS[m]: c.count for m, c in dt.tc_mode_launches.items()},
            LIST_KEY: dt.list_launches.count,
            "ivf_union_tc": it.union_tc_launches.count,
            "ivf_probe_tc": it.probe_tc_launches.count}


def _recording(calls: dict, name: str, fn):
    """``fn`` that keeps the arguments of its last call in ``calls``."""
    def wrapped(*args):
        calls[name] = args
        return fn(*args)
    return wrapped


def _dense_stages(idx, qa, mask, want):
    """search_dense at qa's batch on the per-query route, stage by stage
    (each timed alone on CUDA events): probe selection, work-list build,
    the tensor-core kernel, top-k of the [B, nprobe * C] candidates, the
    overflow scan + sign-plane refine.  The staged result must equal
    ``want``, the (scores, ids) of the call itself.  Returns the stage
    times, the work list, the kernel's ms (f32 values: with the queries'
    planes kernel) and the library yardstick's ms: one torch.bmm of the
    groups' tiles against their queries, padded to the group size, both
    gathered beforehand (not timed) in the queries' type, bf16 or f32
    (TF32 off)."""
    from super_rag_tpu_torch.ops import ivf_topk as it
    from super_rag_tpu_torch.ops.dense import normalize_queries
    from super_rag_tpu_torch.ops.ivf import attach_overflow_and_refine
    from super_rag_tpu_torch.ops.topk import stable_topk

    ivf = idx._ivf
    b = qa.shape[0]
    nlist, cap, _ = ivf.values.shape
    nprobe = min(idx._ivf_nprobe, nlist)

    def select():
        q = normalize_queries(qa, idx.spec.metric)
        cs = q @ ivf.centroids.T
        return q, cs, stable_topk(cs, nprobe)[1].to(torch.int32)

    q, cs, probes = select()
    groups = it.probe_groups(probes, nlist, it.PROBE_QG)
    compute = torch.float32 if ivf.values.dtype == torch.float32 else torch.bfloat16
    q_in = q.to(compute).contiguous()
    cs_in = cs.contiguous() if ivf.residual else None
    out = torch.empty((b, nprobe, cap), dtype=torch.float32, device=DEVICE)

    def kernel():
        it._probe_tc(q_in, groups, nprobe, ivf.values, ivf.scales, cs_in, ivf.row_ids,
                     mask, out)

    kernel()
    cv = out.reshape(b, -1)
    fv, pos = stable_topk(cv, TOP_K)
    floc = torch.gather(probes.long(), 1, pos // cap) * cap + pos % cap
    fi = torch.where(torch.isfinite(fv), ivf.row_ids.reshape(-1)[floc], -1)

    def tail():
        return attach_overflow_and_refine(q, cs, ivf, fv, fi, floc, TOP_K, mask=mask)

    got = tail()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("search_dense staged for timing differs from the call")
    stages = {
        "probe selection": cuda_ms(select),
        "work-list build": cuda_ms(lambda: it.probe_groups(probes, nlist, it.PROBE_QG)),
        "tensor-core kernel": cuda_ms(kernel),
        f"top-{TOP_K} of [{b}, {nprobe * cap}]": cuda_ms(lambda: stable_topk(cv, TOP_K)),
        "overflow scan" + (" + sign-plane refine" if ivf.sign_plane is not None else ""):
            cuda_ms(tail),
    }
    # the yardstick's operands: group g's tile and its queries, padded
    n_groups = int(groups.group_off[-1])
    g = torch.arange(n_groups, device=DEVICE, dtype=torch.int32)
    tile_of = torch.searchsorted(groups.group_off, g, right=True) - 1
    first = groups.pair_off[tile_of] + (g - groups.group_off[tile_of]) * it.PROBE_QG
    slot = first[:, None] + torch.arange(it.PROBE_QG, device=DEVICE)[None]
    filled = slot < groups.pair_off[tile_of + 1][:, None]
    pairs = groups.order.long()[slot.clamp(max=b * nprobe - 1)]
    qblk = torch.where(filled[..., None], q_in[pairs // nprobe], 0).transpose(1, 2)
    tiles = ivf.values[tile_of.long()].to(compute)
    lib_ms = cuda_ms(lambda: torch.bmm(tiles, qblk), reps=10)
    del tiles, qblk
    return stages, groups, stages["tensor-core kernel"], lib_ms


def phase_ivf(results: dict):
    """The IVF tier at full size: clustered 1M x 768 int8 corpus made on
    the card, DeviceIndex + compact_lexical + compact_dense(nlist 1024,
    nprobe 16) (the streaming build), then search_hybrid at B = 32 (union
    kernel) and search_dense at B = 512 (per-query kernel), each kernel
    held against its plain version at those calls' inputs; then the f32
    collection (``_ivf_f32``)."""
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import ivf_topk as it
    from super_rag_tpu_torch.ops.bm25_inverted import inverted_bm25_search

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    t0 = time.perf_counter()
    centers = torch.randn(IVF_CENTERS, DIM, device=DEVICE, generator=gen) * 3.0
    arrays, host, ranks, df_host = make_corpus(N_ROWS, gen, centers=centers)
    idx = DeviceIndex.from_snapshot(arrays, host, device=DEVICE)
    # the lexical table, kept for the f32 collection over the same texts
    lex = {k: v for k, v in arrays.items() if k not in ("emb", "scales")}
    del arrays
    idx.compact_lexical(postings_per_term=max(256, N_ROWS // 500))
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.compact_dense(nlist=IVF_NLIST, nprobe=IVF_NPROBE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    ivf = idx._ivf
    of_rows = 0 if ivf.overflow is None else ivf.overflow.size
    log(f"[ivf] clustered corpus {N_ROWS} x {DIM} int8 ({IVF_CENTERS} centres x 3.0 "
        f"+ N(0,1), normalised) + DeviceIndex + compact_lexical in {t_make:.2f} s; "
        f"compact_dense(nlist={IVF_NLIST}, nprobe={IVF_NPROBE}) streaming build in "
        f"{t_build:.2f} s: capacity C={ivf.capacity}, overflow rows {of_rows}, "
        f"residual {ivf.residual}, sign plane {ivf.sign_plane is not None}")
    t0 = time.perf_counter()
    calibrated = idx._calibrate_nprobe(IVF_NPROBE, 0.95, 32, TOP_K)
    log(f"[ivf] _calibrate_nprobe(from {IVF_NPROBE}, recall target 0.95) would pick "
        f"nprobe {calibrated} ({time.perf_counter() - t0:.2f} s; printed only, "
        f"the index keeps {idx._ivf_nprobe})")

    qa = centers[torch.randint(0, IVF_CENTERS, (IVF_DENSE_BATCH,), device=DEVICE,
                               generator=gen)]
    qa = qa + torch.randn(IVF_DENSE_BATCH, DIM, device=DEVICE, generator=gen)
    texts = make_query_texts(ranks, df_host, gen, IVF_DENSE_BATCH)
    del ranks
    q32, t32 = qa[:IVF_HYBRID_BATCH], texts[:IVF_HYBRID_BATCH]

    # main path 1: search_hybrid at B = 32, the union kernel's tier; the
    # wrappers' operands are kept to hold each kernel against its plain
    # version at exactly these inputs
    calls: dict = {}
    _reset_counts()
    with mock.patch.object(it, "union_scores",
                           _recording(calls, "union", it.union_scores)):
        res = idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES)
    torch.cuda.synchronize()
    hyb_counts = _counts()
    if hyb_counts["ivf_union_tc"] < 1:
        raise AssertionError(f"search_hybrid B={IVF_HYBRID_BATCH} launched no tensor-core "
                             f"union kernel: {hyb_counts}")
    ids = res.indices.cpu().numpy()
    if (ids.shape != (IVF_HYBRID_BATCH, TOP_K) or ids.min() < 0
            or not np.isfinite(res.scores.cpu().numpy()).all()):
        raise AssertionError("IVF hybrid result has the wrong shape or empty slots")
    # main path 2: search_dense at B = 512, the per-query kernel's tier
    _reset_counts()
    with mock.patch.object(it, "probe_scores",
                           _recording(calls, "probe", it.probe_scores)):
        dv, di = idx.search_dense(qa, k=TOP_K)
    torch.cuda.synchronize()
    dense_counts = _counts()
    if dense_counts["ivf_probe_tc"] < 1:
        raise AssertionError(f"search_dense B={IVF_DENSE_BATCH} launched no tensor-core "
                             f"per-query kernel: {dense_counts}")
    if tuple(di.shape) != (IVF_DENSE_BATCH, TOP_K) or int(di.min()) < 0:
        raise AssertionError("IVF search_dense result has the wrong shape")
    log(f"[ivf] launches: search_hybrid B={IVF_HYBRID_BATCH} {hyb_counts}; "
        f"search_dense B={IVF_DENSE_BATCH} {dense_counts}")

    mask = idx._mask(None)
    cap = ivf.capacity
    # union kernel vs plain at the B = 32 call's inputs
    from super_rag_tpu_torch.ops.topk import stable_topk

    uargs = calls["union"]
    q_in, union = uargs[0], uargs[1]
    uk, up = it.union_scores(*uargs), it.union_scores_plain(*uargs)
    union_err = _compare_candidates(uk, up, DIM, CANDIDATES)
    n_union = union.shape[0]
    # queries whose candidate lists (the top-CANDIDATES of the union scores)
    # come out in the same order on the kernel and on the plain version
    ki_ = stable_topk(uk.reshape(IVF_HYBRID_BATCH, -1), CANDIDATES)[1]
    pi_ = stable_topk(up.reshape(IVF_HYBRID_BATCH, -1), CANDIDATES)[1]
    same_cands = (ki_ == pi_).all(1)
    del uk, up, ki_, pi_

    # the whole B = 32 hybrid result against the same path on the plain
    # versions: bit-equal for every query whose candidate list is the plain
    # version's; a query whose list differs (only at near-ties of the union
    # scores, checked above: the tensor cores add in their own order) is
    # held to the kernel's contract: RRF scores equal where ids are
    with mock.patch.object(it, "union_scores", it.union_scores_plain), \
            mock.patch.object(it, "probe_scores", it.probe_scores_plain):
        res_plain = idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES)
    rows_eq = ((res.indices == res_plain.indices).all(1)
               & (res.scores == res_plain.scores).all(1))
    dense_err = (float((res.dense_scores - res_plain.dense_scores)[same_cands].abs().max())
                 if bool(same_cands.any()) else 0.0)
    if bool((same_cands & ~rows_eq).any()) or dense_err > 1e-6:
        raise AssertionError(f"IVF hybrid differs between kernel and plain version for a "
                             f"query with the same candidates (dense {dense_err})")
    same_ids = res.indices == res_plain.indices
    if not torch.equal(res.scores[same_ids], res_plain.scores[same_ids]):
        raise AssertionError("IVF hybrid RRF scores differ where the ids agree")
    log(f"[ivf] hybrid B={IVF_HYBRID_BATCH} on the kernels vs the plain versions: "
        f"{int(same_cands.sum())} of {IVF_HYBRID_BATCH} queries have the same candidate "
        f"list and equal the plain result bit for bit (dense branch scores max |diff| "
        f"{dense_err}, limit 1e-6: the sign-plane refine re-scores the pool from the "
        f"codes); {int((~rows_eq).sum())} rows differ, each where the candidate list "
        f"differs at a near-tie, with RRF scores equal where ids agree")

    # per-query kernel vs plain at the B = 512 call's inputs
    pargs = calls["probe"]
    probes_a = pargs[1]
    pk, pp = it.probe_scores(*pargs), it.probe_scores_plain(*pargs)
    probe_err = _compare_candidates(pk, pp, DIM, TOP_K)
    del pk, pp
    log(f"[ivf] union kernel vs plain [B={IVF_HYBRID_BATCH}, U={n_union}, C={cap}]: "
        f"max |diff| {union_err:.3g}; tensor-core per-query kernel vs plain [B={IVF_DENSE_BATCH}, "
        f"nprobe={IVF_NPROBE}, C={cap}]: max |diff| {probe_err:.3g} (tolerance "
        f"D * 2^-23 * (max|s| + 1); top-k ids equal up to near-ties)")

    # recall@10 of the IVF tier against an exact f32 search of the stored rows
    n = idx.size
    gold = exact_topk(qa[:64], idx.dense_corpus(), mask, n)
    gold_cos = exact_topk(qa[:64], idx.dense_corpus(), mask, n, cosine=True)
    recall_probe = recall_at_k(di[:64], gold)
    got_union = torch.cat([idx.search_dense(qa[lo:lo + IVF_HYBRID_BATCH], k=TOP_K)[1]
                           for lo in (0, IVF_HYBRID_BATCH)])
    recall_union = recall_at_k(got_union, gold)
    log(f"[ivf] dense recall@{TOP_K} at nprobe {IVF_NPROBE} (64 queries) vs the exact "
        f"f32 dot with the stored rows: {recall_probe:.4f} (per-query route, "
        f"B={IVF_DENSE_BATCH}: own probes), {recall_union:.4f} (union route, "
        f"B={IVF_HYBRID_BATCH}: the batch's probe union); vs the exact cosine with "
        f"the stored rows (the IVF's own metric): {recall_at_k(di[:64], gold_cos):.4f} "
        f"(per-query), {recall_at_k(got_union, gold_cos):.4f} (union)")
    if recall_probe < 0.5:
        raise AssertionError(f"IVF recall@{TOP_K} {recall_probe} < 0.5")

    # timings
    qa32 = qa[:IVF_HYBRID_BATCH]
    hyb32_ms = host_ms(lambda: idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES))
    # where the B = 32 hybrid batch's time goes, stage by stage (each alone)
    t0 = time.perf_counter()
    qt, qi = idx._query_arrays(t32, 16)
    analyze32_ms = (time.perf_counter() - t0) * 1e3
    dense32_branch_ms = cuda_ms(lambda: it.ivf_topk(q32, ivf, CANDIDATES,
                                                    nprobe=idx._ivf_nprobe, mask=mask,
                                                    device=DEVICE))
    lex32_ms = cuda_ms(lambda: inverted_bm25_search(
        qt, qi, idx._inverted, k=2 * CANDIDATES, mask=mask, postings_per_query_term=768))
    _reset_counts()
    idx.search_hybrid(qa, texts, k=TOP_K, candidates=CANDIDATES)
    big_counts = _counts()
    hyb512_ms = host_ms(lambda: idx.search_hybrid(qa, texts, k=TOP_K,
                                                  candidates=CANDIDATES), reps=10)
    dense512_ms = host_ms(lambda: idx.search_dense(qa, k=TOP_K), reps=10)
    dense32_ms = host_ms(lambda: idx.search_dense(qa32, k=TOP_K))
    union_ms = cuda_ms(lambda: it.union_scores(*uargs))
    union_plain_ms = cuda_ms(lambda: it.union_scores_plain(*uargs), reps=5)
    # library yardstick: one cuBLAS bf16 matmul of the query block against
    # the union tiles, gathered beforehand (the gather is not timed)
    tiles_bf16 = ivf.values[union.long()].reshape(n_union * cap, DIM).to(torch.bfloat16)
    union_lib_ms = cuda_ms(lambda: q_in @ tiles_bf16.T)
    del tiles_bf16
    probe_wrapper_ms = cuda_ms(lambda: it.probe_scores(*pargs), reps=10)
    probe_plain_ms = cuda_ms(lambda: it.probe_scores_plain(*pargs), reps=3, warmup=1)
    b32, b512 = IVF_HYBRID_BATCH, IVF_DENSE_BATCH
    u_bytes = (n_union * cap * (DIM + 4 + 4 + 1) + b32 * DIM * 2 + n_union * 4
               + b32 * n_union * 4 + b32 * n_union * cap * 4)
    u_bound, u_by = bound_ms(u_bytes, 2.0 * b32 * n_union * cap * DIM, BF16_OPS_PER_S)
    distinct = int(torch.unique(probes_a).numel())
    p_bytes = (distinct * cap * (DIM + 4 + 4 + 1) + b512 * DIM * 2
               + b512 * IVF_NPROBE * (4 + 4) + b512 * IVF_NPROBE * cap * 4)
    p_bound, p_by = bound_ms(p_bytes, 2.0 * b512 * IVF_NPROBE * cap * DIM, BF16_OPS_PER_S)
    per_query_reads_ms = b512 * IVF_NPROBE * cap * DIM / HBM_BYTES_PER_S * 1e3
    stages, groups, probe_ms, probe_lib_ms = _dense_stages(idx, qa, mask, (dv, di))
    n_groups = int(groups.group_off[-1])
    log(f"[ivf] breakdown of search_hybrid B={b32}: host query analysis "
        f"{analyze32_ms:.3f} ms, dense branch (ivf_topk: probes + union kernel + "
        f"top-{CANDIDATES} + overflow scan + sign-plane refine) {dense32_branch_ms:.3f} ms, "
        f"inverted BM25 generation {lex32_ms:.3f} ms, rest (rescore + RRF) "
        f"{hyb32_ms - analyze32_ms - dense32_branch_ms - lex32_ms:.3f} ms")
    log(f"[ivf] search_hybrid B={b32} (union tier) {hyb32_ms:.3f} ms; B={b512} "
        f"(whole-index scan tier, launches {big_counts}) {hyb512_ms:.3f} ms; "
        f"search_dense B={b512} (per-query tier) {dense512_ms:.3f} ms, B={b32} "
        f"(union tier) {dense32_ms:.3f} ms")
    log(f"[ivf] union tensor-core kernel {union_ms:.3f} ms, plain {union_plain_ms:.3f} ms, library "
        f"(cuBLAS bf16 matmul over the pre-gathered {n_union} tiles, gather not timed) "
        f"{union_lib_ms:.3f} ms, bound {u_bound:.3f} ms ({u_by}: {u_bytes / 1e9:.3f} GB)")
    log(f"[ivf] per-query kernel, variant tc (mma.sync m16n8k16 bf16, tile-major over "
        f"{n_groups} groups of <= {it.PROBE_QG} pairs on {distinct} tiles, grid of "
        f"{groups.max_groups} groups), launches {dense_counts['ivf_probe_tc']} in "
        f"search_dense B={b512}: kernel {probe_ms:.3f} ms, with the work list "
        f"{probe_wrapper_ms:.3f} ms, plain {probe_plain_ms:.3f} ms, library (torch.bmm of "
        f"the {n_groups} groups' tiles against their queries padded to {it.PROBE_QG}, "
        f"bf16, gathered beforehand, gather not timed) {probe_lib_ms:.3f} ms, bound "
        f"{p_bound:.3f} ms ({p_by}: {distinct} distinct tiles read once, "
        f"{p_bytes / 1e9:.3f} GB); reading each query's own tiles moves "
        f"{b512 * IVF_NPROBE * cap * DIM / 1e9:.2f} GB, {per_query_reads_ms:.3f} ms")
    rest = dense512_ms - sum(stages.values())
    log(f"[ivf] breakdown of search_dense B={b512} ({dense512_ms:.3f} ms): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in stages.items())
        + f", rest (gathers, host) {rest:.3f} ms")
    results["ivf_union"] = {
        "variant": "tc (mma.sync m16n8k16 bf16)", "launches": hyb_counts["ivf_union_tc"],
        "max_abs_err": union_err, "ms": union_ms, "plain_ms": union_plain_ms,
        "bound_ms": u_bound, "bound_by": u_by, "library_ms": union_lib_ms,
    }
    results["ivf_probe"] = {
        "variant": "tc (mma.sync m16n8k16 bf16)", "launches": dense_counts["ivf_probe_tc"],
        "max_abs_err": probe_err, "ms": probe_ms, "plain_ms": probe_plain_ms,
        "bound_ms": p_bound, "bound_by": p_by, "library_ms": probe_lib_ms,
        "with_work_list_ms": probe_wrapper_ms,
    }
    del uargs, pargs, calls
    torch.cuda.empty_cache()
    _ivf_f32(results, gen, centers, lex, host, qa, t32)
    return idx, texts


def _ivf_f32(results: dict, gen, centers, lex: dict, host: dict, qa, t32) -> None:
    """An f32 IVF collection at D = DIM: IVF_F32_ROWS rows by [ivf]'s
    clustered recipe (its centres, fresh noise), f32 rows as an f32
    collection stores them, over [ivf]'s lexical table (the same texts);
    compact_lexical + compact_dense(nlist 1024, nprobe 16); search_hybrid
    at B = 32 through the union route, which must launch the union kernel
    in its f32 mode (three TF32 products on the tensor cores), held
    against its plain version at the call's inputs (scores within the
    float tolerance, the candidate top-k's ids equal up to near-ties),
    and the whole hybrid result against the same path on the plain
    versions; then search_dense at B = IVF_DENSE_BATCH (``qa``) through
    the per-query route (the batch's [B, U, C] union array would pass
    UNION_OUT_BYTES_MAX), which must launch the per-query kernel in its
    f32 mode and no union kernel, held alike, its whole result against
    the plain versions' (within the tolerance, ids equal up to near-ties;
    bit for bit for each query whose candidate list, ids and scores, is
    the plain version's) and, bit for bit, against the same call on the
    union kernel's scores of the probed tiles, and timed stage by stage.  Each kernel is timed
    beside its plain version, the library call (f32, TF32 off, over the
    tiles gathered beforehand) and its bound."""
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import ivf_topk as it
    from super_rag_tpu_torch.ops.dense import build_corpus
    from super_rag_tpu_torch.ops.topk import stable_topk

    n = IVF_F32_ROWS
    t0 = time.perf_counter()
    emb = torch.empty((n, DIM), dtype=torch.float32, device=DEVICE)
    step = 131072
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        x = torch.randn(hi - lo, DIM, device=DEVICE, generator=gen)
        x += centers[torch.randint(0, centers.shape[0], (hi - lo,), device=DEVICE,
                                   generator=gen)]
        emb[lo:hi] = build_corpus(x, dtype=torch.float32).values
    arrays = {"emb": emb, **{k: v[:n] for k, v in lex.items()}}
    spec = dict(host["spec"], dtype="float32")
    idx = DeviceIndex.from_snapshot(arrays, dict(host, spec=spec, size=n,
                                                 row_meta=host["row_meta"][:n]),
                                    device=DEVICE)
    del arrays, emb
    idx.compact_lexical(postings_per_term=max(256, n // 500))
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.compact_dense(nlist=IVF_NLIST, nprobe=IVF_NPROBE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    ivf = idx._ivf
    if ivf.values.dtype != torch.float32:
        raise AssertionError(f"[ivf] the f32 collection's IVF holds {ivf.values.dtype}")
    log(f"[ivf] f32 collection: {n} x {DIM} f32 rows (the clustered recipe) + "
        f"DeviceIndex + compact_lexical in {t_make:.2f} s; compact_dense(nlist="
        f"{IVF_NLIST}, nprobe={IVF_NPROBE}) in {t_build:.2f} s: capacity "
        f"C={ivf.capacity}, residual {ivf.residual}")

    q32 = qa[:IVF_HYBRID_BATCH]
    calls: dict = {}
    _reset_counts()
    with mock.patch.object(it, "union_scores", _recording(calls, "union", it.union_scores)):
        res = idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES)
    torch.cuda.synchronize()
    counts = _counts()
    uargs = calls["union"]
    if counts["ivf_union_tc"] < 1 or uargs[2].dtype != torch.float32 or \
            counts["ivf_probe_tc"]:
        raise AssertionError(f"[ivf] f32 search_hybrid B={IVF_HYBRID_BATCH} launched "
                             f"{counts} (values {uargs[2].dtype})")
    ids = res.indices.cpu().numpy()
    if (ids.shape != (IVF_HYBRID_BATCH, TOP_K) or ids.min() < 0
            or not np.isfinite(res.scores.cpu().numpy()).all()):
        raise AssertionError("[ivf] f32 hybrid result has the wrong shape or empty slots")
    uk, up = it.union_scores(*uargs), it.union_scores_plain(*uargs)
    err = _compare_candidates(uk, up, DIM, CANDIDATES)
    b = IVF_HYBRID_BATCH
    same_cands = (stable_topk(uk.reshape(b, -1), CANDIDATES)[1]
                  == stable_topk(up.reshape(b, -1), CANDIDATES)[1]).all(1)
    del uk, up
    with mock.patch.object(it, "union_scores", it.union_scores_plain), \
            mock.patch.object(it, "probe_scores", it.probe_scores_plain):
        res_plain = idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES)
    rows_eq = ((res.indices == res_plain.indices).all(1)
               & (res.scores == res_plain.scores).all(1))
    if bool((same_cands & ~rows_eq).any()):
        raise AssertionError("[ivf] f32 hybrid differs between kernel and plain version "
                             "for a query with the same candidates")
    same_ids = res.indices == res_plain.indices
    if not torch.equal(res.scores[same_ids], res_plain.scores[same_ids]):
        raise AssertionError("[ivf] f32 hybrid RRF scores differ where the ids agree")

    q_in, union = uargs[0], uargs[1]
    n_union, cap = union.shape[0], ivf.capacity
    k_ms = cuda_ms(lambda: it.union_scores(*uargs))
    p_ms = cuda_ms(lambda: it.union_scores_plain(*uargs), reps=5)
    tiles = ivf.values[union.long()].reshape(n_union * cap, DIM)
    lib_ms = cuda_ms(lambda: q_in @ tiles.T)
    del tiles
    nbytes = (n_union * cap * (DIM * 4 + 4 + 1) + b * DIM * 4 + n_union * 4
              + b * n_union * 4 + b * n_union * cap * 4)
    bound, by = bound_ms(nbytes, 3 * 2.0 * b * n_union * cap * DIM, TF32_OPS_PER_S)
    log(f"[ivf] f32 search_hybrid B={b}: launches {counts}; {int(same_cands.sum())} of {b} "
        f"queries have the plain version's candidate list and equal its result bit for "
        f"bit, RRF scores equal where ids agree; union kernel (f32: 3 x mma.sync m16n8k8 "
        f"tf32) vs plain [B={b}, U={n_union}, C={cap}]: max |diff| {err:.3g} (tolerance "
        f"D * 2^-23 * (max|s| + 1)); kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
        f"(f32 matmul, TF32 off, over the pre-gathered tiles) {lib_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({by}: {nbytes / 1e9:.3f} GB) (on {results['card']})")
    results["ivf_union_f32"] = {
        "variant": "tc f32 (3 x mma.sync m16n8k8 tf32 on rna planes)",
        "launches": counts["ivf_union_tc"], "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": lib_ms, "rows": n,
        "union_tiles": n_union, "capacity": cap,
    }
    del uargs
    _ivf_f32_dense(results, idx, qa)


def _ivf_f32_dense(results: dict, idx, qa) -> None:
    """search_dense at B = IVF_DENSE_BATCH over the f32 collection: the
    per-query kernel's f32 mode on a main path (``_ivf_f32``)."""
    from super_rag_tpu_torch.ops import ivf_topk as it
    from super_rag_tpu_torch.ops.dense import normalize_queries
    from super_rag_tpu_torch.ops.topk import stable_topk

    ivf = idx._ivf
    b, cap = qa.shape[0], ivf.capacity
    calls: dict = {}
    _reset_counts()
    with mock.patch.object(it, "probe_scores", _recording(calls, "probe", it.probe_scores)):
        dv, di = idx.search_dense(qa, k=TOP_K)
    torch.cuda.synchronize()
    counts = _counts()
    pargs = calls["probe"]
    if counts["ivf_probe_tc"] < 1 or counts["ivf_union_tc"] or pargs[2].dtype != torch.float32:
        raise AssertionError(f"[ivf] f32 search_dense B={b} launched {counts} (values "
                             f"{pargs[2].dtype})")
    if (tuple(di.shape) != (b, TOP_K) or int(di.min()) < 0
            or not bool(torch.isfinite(dv).all())):
        raise AssertionError("[ivf] f32 search_dense result has the wrong shape or empty slots")
    probes = pargs[1]
    nprobe = probes.shape[1]
    pk, pp = it.probe_scores(*pargs), it.probe_scores_plain(*pargs)
    err = _compare_candidates(pk, pp, DIM, TOP_K)
    kv, ki = stable_topk(pk.reshape(b, -1), TOP_K)
    rv, ri = stable_topk(pp.reshape(b, -1), TOP_K)
    same_list = (ki == ri).all(1) & (kv == rv).all(1)
    same_ids = (ki == ri).all(1)
    del pk, pp, kv, ki, rv, ri
    # the whole result against the same call on the plain versions, ids
    # up to near-ties by the f32 score of every row (a row's stored f32
    # values, in the IVF tiles or the overflow, against the normalised query)
    mask = idx._mask(None)
    with mock.patch.object(it, "union_scores", it.union_scores_plain), \
            mock.patch.object(it, "probe_scores", it.probe_scores_plain):
        pv, pi = idx.search_dense(qa, k=TOP_K)
    tol = _tolerance(DIM, pv)
    every = normalize_queries(qa, idx.spec.metric) @ idx.dense_corpus().values[:idx.size].T
    res_err = _compare(dv[None], di[None], pv[None], pi[None], exact=False, tol=tol,
                       scores=every)
    del every
    rows_eq = (di == pi).all(1) & (dv == pv).all(1)
    if bool((same_list & ~rows_eq).any()):
        raise AssertionError("[ivf] f32 search_dense differs from the plain versions' for a "
                             "query with the same candidate list")

    # and against the same call with each query's scores taken from the
    # union kernel over the probed tiles: one kernel body, so bit for bit
    def via_union(q, probes_, values, scales, cs_in, row_ids, mask_):
        tiles = torch.unique(probes_)
        u = it.union_scores(q, tiles, values, scales, cs_in, row_ids, mask_)
        at = torch.searchsorted(tiles, probes_).long()
        return torch.gather(u, 1, at[:, :, None].expand(-1, -1, u.shape[2]))

    with mock.patch.object(it, "probe_scores", via_union):
        uv, ui = idx.search_dense(qa, k=TOP_K)
    if not (torch.equal(uv, dv) and torch.equal(ui, di)):
        raise AssertionError("[ivf] f32 search_dense on the per-query route differs from the "
                             "union kernel's scores gathered")
    del uv, ui
    stages, groups, k_ms, lib_ms = _dense_stages(idx, qa, mask, (dv, di))
    p_ms = cuda_ms(lambda: it.probe_scores_plain(*pargs), reps=3, warmup=1)
    distinct = int(torch.unique(probes).numel())
    n_groups = int(groups.group_off[-1])
    nbytes = (distinct * cap * (DIM * 4 + 4 + 1) + b * DIM * 4 + b * nprobe * (4 + 4)
              + b * nprobe * cap * 4)
    bound, by = bound_ms(nbytes, 3 * 2.0 * b * nprobe * cap * DIM, TF32_OPS_PER_S)
    log(f"[ivf] f32 search_dense B={b} (per-query route): launches {counts}; per-query "
        f"kernel (f32: 3 x mma.sync m16n8k8 tf32, tile-major over {n_groups} groups of <= "
        f"{it.PROBE_QG} pairs on {distinct} tiles) vs plain [B={b}, nprobe={nprobe}, C={cap}]: "
        f"max |diff| {err:.3g} (tolerance D * 2^-23 * (max|s| + 1)); the result vs the plain "
        f"versions': max |diff| {res_err:.3g} within {tol:.3g}, ids equal up to near-ties; "
        f"{int(same_ids.sum())} of {b} queries have the plain version's candidate ids, "
        f"{int(same_list.sum())} its candidate ids and scores and equal its result bit for "
        f"bit, {int(rows_eq.sum())} rows bit-equal in all; every row equals the same call on "
        f"the union kernel's scores of the probed tiles bit for bit")
    log(f"[ivf] f32 per-query kernel (with its query planes) {k_ms:.3f} ms, plain {p_ms:.3f} "
        f"ms, library (torch.bmm, f32, TF32 off, of the {n_groups} groups' tiles against "
        f"their queries padded to {it.PROBE_QG}, gathered beforehand) {lib_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({by}: {distinct} distinct tiles read once, {nbytes / 1e9:.3f} GB); "
        f"search_dense B={b} stages: "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in stages.items())
        + f" (on {results['card']})")
    results["ivf_probe_f32"] = {
        "variant": "tc f32 (3 x mma.sync m16n8k8 tf32 on rna planes)",
        "launches": counts["ivf_probe_tc"], "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": lib_ms, "distinct_tiles": distinct,
        "groups": n_groups, "capacity": cap,
    }


def phase_ivf_serve(idx, texts) -> dict:
    """>= 128 concurrent text requests through QueryBatcher(max_batch=32)
    over a CollectionEngine on the IVF index.  The union tier scores each
    query against its batch's probe union (the reference's semantics), so
    each answer is held against a direct search_batch of the batch it was
    dispatched in; every dispatch must launch the union kernel once."""
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import IndexSpec
    from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from super_rag_tpu_torch.ops import ivf_topk as it

    engine = CollectionEngine(
        IndexSpec(dim=DIM, dtype=torch.int8, bm25_slots=SLOTS, vocab_size=VOCAB,
                  min_capacity=4096),
        embedder=HashEmbedder(dim=DIM, device=DEVICE), device=DEVICE)
    engine.index = idx
    requests = list(dict.fromkeys(texts))[:IVF_SERVE_REQUESTS]
    if len(requests) < IVF_SERVE_REQUESTS:
        raise AssertionError(f"only {len(requests)} distinct query texts")
    dispatched = []
    direct = engine.search_batch

    def recording(queries, **kw):
        dispatched.append((list(queries), kw))
        return direct(queries, **kw)

    engine.search_batch = recording
    batcher = QueryBatcher(max_batch=IVF_HYBRID_BATCH)

    async def serve():
        return await asyncio.gather(*(batcher.search(engine, t, top_k=TOP_K)
                                      for t in requests))

    try:
        _reset_counts()
        t0 = time.perf_counter()
        answers = asyncio.run(serve())
        wall = time.perf_counter() - t0
        counts = _counts()
    finally:
        batcher.close()
    stats = batcher.stats()
    if counts["ivf_union_tc"] != stats["dispatches"] or stats["dispatches"] != len(dispatched):
        raise AssertionError(f"union launches {counts} != dispatches {stats['dispatches']}")
    served = dict(zip(requests, answers))
    for queries, kw in dispatched:
        for text, want in zip(queries, direct(queries, **kw)):
            got = served[text]
            if ([(h.row, h.score) for h in got] != [(h.row, h.score) for h in want]
                    or len(got) != TOP_K):
                raise AssertionError(f"served answer differs for {text!r}")
    sizes = sorted(len(q) for q, _ in dispatched)
    log(f"[ivf-serve] {len(requests)} concurrent requests in {wall:.3f} s: "
        f"{stats['dispatches']} dispatches (sizes {sizes}), tensor-core union kernel "
        f"launches {counts['ivf_union_tc']} (all launches {counts}); every answer equals a direct "
        f"search_batch of its dispatch's batch")
    return stats


# -- the semantic tier: encoder -> hybrid search -> cross-encoder rerank ------

def semantic_config(dtype: torch.dtype):
    """The checkpoints' EncoderConfig at activation ``dtype``."""
    from super_rag_tpu_torch.models.encoder import EncoderConfig

    return EncoderConfig(**{**SEMANTIC_CONFIG, "dtype": dtype})


def row_texts(ranks: torch.Tensor, tfs: torch.Tensor, words: int) -> list[str]:
    """Each row's text: its own words ``t<rank>`` in slot order, each
    repeated tf times, the sequence repeated until it is ``words`` long
    (a chunk that fills the encoders' 128-token bucket).  Built on the
    card (a searchsorted of each position into the row's cumulative tf),
    joined on the host from fixed-width 8-byte words."""
    table = np.array([f"t{r}".ljust(8).encode() for r in range(VOCAB)], dtype="S8")
    out: list[str] = []
    pos = torch.arange(words, device=DEVICE)
    for lo in range(0, ranks.shape[0], 131072):
        r, tf = ranks[lo:lo + 131072], tfs[lo:lo + 131072].to(torch.int64)
        cum = torch.cumsum(tf, 1)
        total = torch.clamp(cum[:, -1:], min=1)
        slot = torch.searchsorted(cum, (pos[None] % total).contiguous(), right=True)
        word = torch.gather(r, 1, slot.clamp(max=r.shape[1] - 1)).clamp(min=0)
        row = table[word.to(torch.int32).cpu().numpy()]
        out.extend(b.decode() for b in row.view(f"S{8 * words}").ravel().tolist())
    return out


def encoder_flops(b: int, s: int, cfg, pooler: bool = False) -> float:
    """Multiply-adds x 2 of one forward at [b, s]: the Q, K, V and output
    products, the two attention products and the MLP of every layer (and
    the cross-encoder's pooler and head)."""
    h, m = cfg.hidden_dim, cfg.mlp_dim
    per_layer = 2.0 * b * s * (4 * h * h + 2 * h * m) + 4.0 * b * s * s * h
    return cfg.num_layers * per_layer + (2.0 * b * (h * h + h) if pooler else 0.0)


def encoder_bound(b: int, s: int, model, flops: float) -> tuple[float, str]:
    """The forward's bound: its stored (f32) weights read once, except
    the token table, of which the b * s rows gathered; ids, mask and
    type ids read once; the output written once."""
    emb = model.backbone.token_embed.weight
    weights = sum(p.numel() for p in model.parameters()) - emb.numel()
    nbytes = weights * 4 + b * s * (emb.shape[1] * 4 + 4 + 1 + 4) + b * emb.shape[1] * 4
    return bound_ms(nbytes, flops, BF16_OPS_PER_S)


def interleaved_ms(fns: dict, reps: int = 10, warmup: int = 1) -> dict:
    """Median milliseconds of each function + a device synchronize, on the
    host clock; the functions run in turn within each repetition, so a
    drift of the shared host falls on all of them alike."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times: dict = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def device_busy(fn, wall_ms: float, reps: int = 5, top: int = 0) -> str:
    """The card's kernel time and kernel count per call of ``fn``, from a
    torch.profiler trace, and the idle share of ``wall_ms`` (the call's
    untraced CUDA-event time) that leaves: the card waiting on the host's
    launches.  ``top`` > 0 adds the kernels that took the most device time
    a call, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "device busy time not measured (the trace holds no kernel)"
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    out = (f"{len(kernels) / reps:.0f} kernels, busy {busy:.3f} ms "
           f"(idle {max(0.0, 1 - busy / wall_ms):.1%} of the call)")
    if top:
        by_name: dict = {}
        for e in kernels:
            k = by_name.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3 / reps
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
        out += "; top kernels a call: " + "; ".join(
            f"{name[:70]} x{n / reps:.0f} {ms:.3f} ms ({ms / busy:.1%})"
            for name, (n, ms) in ranked)
    return out


def burst_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Milliseconds a call of ``fn`` in a burst of ``calls`` back-to-back
    calls between two CUDA events (median of ``reps`` bursts): the card's
    time where it outpaces the host's launch path, else the host's."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _close(got, want, rel: float) -> float:
    """Raise unless |got - want| <= rel * (1 + |want|); return the largest
    |got - want| / (1 + |want|)."""
    err = float(((got - want).abs() / (1 + want.abs())).max())
    if not err <= rel:
        raise AssertionError(f"scores differ by {err} (1 + |s|) > {rel} (1 + |s|)")
    return err


def semantic_checks(enc, rr, texts: list[str], queries: list[str]) -> dict:
    """The encoder and cross-encoder in f32 on the card (TF32 off) against
    the same modules and weights on the CPU, and the bf16 modules on the
    card against their f32 run on the card.  Returns the margins."""
    from super_rag_tpu_torch import convert
    from super_rag_tpu_torch.models.cross_encoder import rerank_scores
    from super_rag_tpu_torch.models.encoder import flax_params

    cfg32 = semantic_config(torch.float32)
    enc_p, ce_p = flax_params(enc.model), flax_params(rr.model)
    ids, mask = enc.tokenizer.encode_batch(texts, max_len=enc.max_len)
    pids, pmask, ptt = rr.tokenizer.encode_pairs(
        [queries[i % len(queries)] for i in range(len(texts))], texts, max_len=rr.max_len)

    def run(model, dev, n, pairs=False):
        args = (pids, pmask, ptt) if pairs else (ids, mask)
        args = [torch.from_numpy(a[:n]).to(dev) for a in args]
        with torch.inference_mode():
            return (rerank_scores(model, *args) if pairs else model(*args)).float().cpu()

    out = {}
    n_cpu = SEM_CPU_TEXTS
    enc32 = convert.encoder_from_jax(enc_p, cfg32, device=DEVICE)
    ce32 = convert.cross_encoder_from_jax(ce_p, cfg32, device=DEVICE)
    emb_card, ce_card = run(enc32, DEVICE, len(texts)), run(ce32, DEVICE, len(texts), True)
    emb_cpu = run(convert.encoder_from_jax(enc_p, cfg32, device="cpu"), "cpu", n_cpu)
    ce_cpu = run(convert.cross_encoder_from_jax(ce_p, cfg32, device="cpu"), "cpu", n_cpu, True)
    out["f32_emb_err"] = float((emb_card[:n_cpu] - emb_cpu).abs().max())
    if not out["f32_emb_err"] <= 1e-5:
        raise AssertionError(f"f32 embeddings on the card differ from the CPU by "
                             f"{out['f32_emb_err']} > 1e-5")
    out["f32_ce_err"] = _close(ce_card[:n_cpu], ce_cpu, 1e-4)
    emb16, ce16 = run(enc.model, DEVICE, len(texts)), run(rr.model, DEVICE, len(texts), True)
    out["bf16_min_cos"] = float((emb16 * emb_card).sum(1).min())
    out["bf16_emb_err"] = float((emb16 - emb_card).abs().max())
    if not (out["bf16_min_cos"] >= 0.9995 and out["bf16_emb_err"] <= 1e-2):
        raise AssertionError(f"bf16 embeddings vs f32: min cosine {out['bf16_min_cos']} "
                             f"(limit 0.9995), max |diff| {out['bf16_emb_err']} (limit 1e-2)")
    out["bf16_ce_err"] = _close(ce16, ce_card, 2e-2)
    out["ce_abs_max"] = float(ce_card.abs().max())
    return out


def phase_semantic(results: dict):
    """The served path of hybrid search + cross-encoder rerank: query texts
    -> EncoderService (TextEncoder) -> CollectionEngine.search_batch(hybrid,
    rerank) -> DeviceIndex.search_hybrid (flat tier, dense_topk at D = 256)
    -> RerankService (CrossEncoder) -> z-fused top-5, over 1M rows of
    256-dim int8 embeddings and the zipfian 64-slot lexical table, each
    row's text its own words; the encoders at the checkpoints' full width
    with seeded weights."""
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import DeviceIndex, IndexSpec
    from super_rag_tpu_torch.models.encoder_service import EncoderService
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.service.rerank_service import RerankService

    cfg = semantic_config(torch.bfloat16)
    dim, seq = cfg.out_dim, cfg.max_len
    enc = EncoderService(cfg, batch_size=SEM_CHUNK_BATCH, max_len=seq, seed=SEED,
                         device=DEVICE)
    rr = RerankService(cfg, max_len=seq, batch_size=SEM_RERANK_BATCH, seed=SEED + 1,
                       device=DEVICE)
    forwards = {"encoder": 0, "cross_encoder": 0}

    def counting(name):
        def hook(module, args):
            if args[0].device.type == torch.device(DEVICE).type:
                forwards[name] += 1
        return hook

    enc.model.register_forward_pre_hook(counting("encoder"))
    rr.model.register_forward_pre_hook(counting("cross_encoder"))

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    t0 = time.perf_counter()
    arrays, host, ranks, df_host = make_corpus(SEM_ROWS, gen, dim=dim)
    torch.cuda.synchronize()
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    texts_all = row_texts(ranks, arrays["tfs"], SEM_WORDS)
    host["row_meta"] = [{"text": t} for t in texts_all]
    t_texts = time.perf_counter() - t0
    idx = DeviceIndex.from_snapshot(arrays, host, device=DEVICE)
    del arrays, host
    idx.compact_lexical(postings_per_term=max(256, SEM_ROWS // 500))
    torch.cuda.synchronize()
    engine = CollectionEngine(
        IndexSpec(dim=dim, dtype=torch.int8, bm25_slots=SLOTS, vocab_size=VOCAB,
                  min_capacity=4096), embedder=enc, reranker=rr, device=DEVICE)
    engine.index = idx
    queries = make_query_texts(ranks, df_host, gen, SEM_QUERY_BATCH)
    del ranks
    log(f"[semantic] on {results['card']}: corpus {SEM_ROWS} x {dim} int8 + "
        f"{SLOTS}-slot table in {t_corpus:.2f} s; row texts ({SEM_WORDS} words each) "
        f"in {t_texts:.2f} s; "
        f"encoder and cross-encoder {cfg.num_layers} layers x {cfg.hidden_dim} "
        f"({cfg.num_heads} heads, MLP {cfg.mlp_dim}, vocab {cfg.vocab_size}, "
        f"{str(cfg.dtype)[6:]}), weights drawn from flax's initialisers (seeds "
        f"{SEED}, {SEED + 1}), HashTokenizer")

    # hard checks: f32 on the card vs the CPU, bf16 vs f32 on the card
    checks = semantic_checks(enc, rr, texts_all[:SEM_CHECK_TEXTS], queries)
    log(f"[semantic] f32 (TF32 off) card vs CPU, {SEM_CPU_TEXTS} texts / pairs: "
        f"embeddings max |diff| {checks['f32_emb_err']:.3g} (limit 1e-5), CE scores "
        f"{checks['f32_ce_err']:.3g} (1 + |s|) (limit 1e-4); bf16 vs f32 on the card, "
        f"{SEM_CHECK_TEXTS} texts / pairs: embeddings min cosine "
        f"{checks['bf16_min_cos']:.6f} (limit 0.9995), max |diff| "
        f"{checks['bf16_emb_err']:.3g} (limit 1e-2), CE scores "
        f"{checks['bf16_ce_err']:.3g} (1 + |s|) (limit 2e-2; max |s| "
        f"{checks['ce_abs_max']:.3f})")

    # the main path, counted: B = 32 hybrid + rerank top-100 -> top-5
    q32 = queries[:SEM_RERANK_QUERIES]
    calls: dict = {}
    _reset_counts()
    forwards.update(encoder=0, cross_encoder=0)
    with mock.patch.object(dt, "tile_topk", _recording(calls, "tile", dt.tile_topk)):
        hits = engine.search_batch(q32, mode="hybrid", rerank=True,
                                   candidates=CANDIDATES, top_k=5)
    torch.cuda.synchronize()
    counts = _counts()
    n_fwd = dict(forwards)
    if counts["dense_topk_tc"] != 1 or counts[LIST_KEY] != 1:
        raise AssertionError(f"hybrid + rerank B={len(q32)} launched {counts}, not one "
                             f"register-list dense_topk")
    want_ce = len(q32) * -(-CANDIDATES // SEM_RERANK_BATCH)
    if n_fwd["encoder"] < 1 or n_fwd["cross_encoder"] != want_ce:
        raise AssertionError(f"forwards on cuda {n_fwd}; expected >= 1 encoder and "
                             f"{want_ce} cross-encoder forwards")
    cands = engine.search_batch(q32, mode="hybrid", candidates=CANDIDATES,
                                top_k=CANDIDATES)
    for q, got, cand in zip(q32, hits, cands):
        if len(got) != 5 or len(cand) != CANDIDATES:
            raise AssertionError(f"{q!r}: {len(got)} reranked hits of "
                                 f"{len(cand)} candidates")
        if not {h.row for h in got} <= {h.row for h in cand}:
            raise AssertionError(f"{q!r}: a reranked row is not among the hybrid "
                                 f"top-{CANDIDATES}")
        if not all(np.isfinite(h.score) and h.recall_type == "reranked" for h in got):
            raise AssertionError(f"{q!r}: reranked hits malformed")
    log(f"[semantic] search_batch(hybrid, rerank, candidates {CANDIDATES}, top_k 5) "
        f"B={len(q32)}: launches {counts}, forwards on cuda {n_fwd}; every top-5 "
        f"lies in its query's hybrid top-{CANDIDATES}")

    # dense_topk at this path's shape (D = 256) against its plain version
    targs = calls["tile"]
    kv, ki = dt.tile_topk(*targs)
    pv, pi = dt.tile_topk_plain(*targs)
    torch.cuda.synchronize()
    err = _compare(kv, ki, pv, pi, exact=True, tol=0.0)
    q8, n, tile, kt = targs[0], targs[6], targs[7], targs[8]
    b = q8.shape[0]
    k_ms = cuda_ms(lambda: dt.tile_topk(*targs))
    p_ms = cuda_ms(lambda: dt.tile_topk_plain(*targs), reps=10)
    keep = targs[5] if targs[5] is not None else torch.ones(n, dtype=torch.bool,
                                                             device=DEVICE)
    lib_ms = cuda_ms(lambda: library_topk(*targs[:4], keep, n, tile, kt), reps=10)
    num_tiles = kv.shape[0]
    nbytes = n * dim + n * 4 + n + b * dim + b * 4 + num_tiles * b * kt * 8
    k_bound, k_by = bound_ms(nbytes, 2.0 * b * n * dim, INT8_OPS_PER_S)
    log(f"[semantic] dense_topk register-list kernel vs plain [num_tiles={num_tiles}, "
        f"B={b}, D={dim}, kt={kt}]: bit-equal (max |diff| {err}); kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms, library (_int_mm + topk) {lib_ms:.3f} ms, bound "
        f"{k_bound:.3f} ms ({k_by})")
    results["dense_topk"]["semantic"] = {
        "launches": counts[LIST_KEY], "batch": b, "dim": dim,
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": k_bound,
        "bound_by": k_by, "library_ms": lib_ms}

    # a. chunk embedding, SEM_CHUNKS texts at [128, 128]
    chunks = texts_all[:SEM_CHUNKS]
    ids, mask = enc.tokenizer.encode_batch(chunks[:SEM_CHUNK_BATCH], max_len=seq)
    if ids.shape != (SEM_CHUNK_BATCH, seq):
        raise AssertionError(f"chunk batch tokenized to {ids.shape}")
    ids_d, mask_d = torch.from_numpy(ids).to(DEVICE), torch.from_numpy(mask).to(DEVICE)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: enc.model(ids_d, mask_d))
        fwd_busy = device_busy(lambda: enc.model(ids_d, mask_d), fwd_ms)
    enc.embed_device(chunks[:SEM_CHUNK_BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = enc.embed_device(chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, len(chunks), SEM_CHUNK_BATCH):
        enc.tokenizer.encode_batch(chunks[lo:lo + SEM_CHUNK_BATCH], max_len=seq)
    tok_s = time.perf_counter() - t0
    if tuple(emb.shape) != (len(chunks), dim) or not bool(torch.isfinite(emb).all()):
        raise AssertionError("chunk embeddings malformed")
    norms = emb.norm(dim=1)
    if float((norms - 1).abs().max()) > 1e-3:
        raise AssertionError("chunk embeddings are not unit-norm")
    e_flops = encoder_flops(SEM_CHUNK_BATCH, seq, cfg)
    e_bound, e_by = encoder_bound(SEM_CHUNK_BATCH, seq, enc.model, e_flops)
    log(f"[semantic] a. EncoderService.embed_device of {len(chunks)} chunks at "
        f"[{SEM_CHUNK_BATCH}, {seq}]: {wall:.3f} s, {len(chunks) / wall:.0f} chunks/s "
        f"(host tokenization alone {tok_s:.3f} s); TextEncoder forward "
        f"[{SEM_CHUNK_BATCH}, {seq}] {fwd_ms:.3f} ms ({SEM_CHUNK_BATCH / fwd_ms * 1e3:.0f} "
        f"chunks/s on the card), {fwd_busy}, {e_flops / 1e9:.2f} GFLOP, bound "
        f"{e_bound:.3f} ms ({e_by})")
    del emb

    # b. query embedding, B = 512
    qemb_ms = host_ms(lambda: enc.embed(queries), reps=10)
    qids, _ = enc.tokenizer.encode_batch(queries[:SEM_CHUNK_BATCH], max_len=seq)
    q_flops = encoder_flops(SEM_CHUNK_BATCH, qids.shape[1], cfg)
    q_bound, q_by = encoder_bound(SEM_CHUNK_BATCH, qids.shape[1], enc.model, q_flops)
    log(f"[semantic] b. EncoderService.embed of {len(queries)} queries: {qemb_ms:.3f} ms "
        f"({len(queries) // SEM_CHUNK_BATCH} forwards at [{SEM_CHUNK_BATCH}, "
        f"{qids.shape[1]}], each {q_flops / 1e9:.2f} GFLOP, bound {q_bound:.3f} ms ({q_by}))")

    # c. hybrid + rerank, B = 32, and its stages
    q_emb = engine._embed(q32)
    cand_texts = [[h.text for h in c] for c in cands]
    c_ms = interleaved_ms({
        "total": lambda: engine.search_batch(q32, mode="hybrid", rerank=True,
                                             candidates=CANDIDATES, top_k=5),
        "embed": lambda: engine._embed(q32),
        "search_hybrid": lambda: idx.search_hybrid(q_emb, q32, k=CANDIDATES,
                                                   candidates=CANDIDATES),
        "rerank": lambda: [rr(q, t) for q, t in zip(q32, cand_texts)],
    }, reps=SEM_STAGE_REPS)
    pids, pmask, ptt = rr.tokenizer.encode_pairs([q32[0]] * SEM_RERANK_BATCH,
                                                 cand_texts[0][:SEM_RERANK_BATCH],
                                                 max_len=rr.max_len)
    if pids.shape != (SEM_RERANK_BATCH, seq):
        raise AssertionError(f"rerank pairs tokenized to {pids.shape}, not the "
                             f"{seq} bucket")
    pargs = [torch.from_numpy(a).to(DEVICE) for a in (pids, pmask, ptt)]
    with torch.inference_mode():
        ce_ms = cuda_ms(lambda: rr.model(*pargs))
        ce_busy = device_busy(lambda: rr.model(*pargs), ce_ms)
    t0 = time.perf_counter()
    for q, t in zip(q32, cand_texts):
        rr.tokenizer.encode_pairs([q] * len(t), t, max_len=rr.max_len)
    pair_tok_ms = (time.perf_counter() - t0) * 1e3
    c_flops = encoder_flops(SEM_RERANK_BATCH, seq, cfg, pooler=True)
    c_bound, c_by = encoder_bound(SEM_RERANK_BATCH, seq, rr.model, c_flops)
    log(f"[semantic] c. search_batch(hybrid, rerank=True, candidates {CANDIDATES}, "
        f"top_k 5) B={len(q32)}: {c_ms['total']:.3f} ms; stages (each alone, in "
        f"turn): embed {c_ms['embed']:.3f} ms, search_hybrid "
        f"{c_ms['search_hybrid']:.3f} ms, rerank {c_ms['rerank']:.3f} ms (pair "
        f"tokenization {pair_tok_ms:.3f} ms; {want_ce} CrossEncoder forwards at "
        f"[{SEM_RERANK_BATCH}, {seq}], each {ce_ms:.3f} ms, {ce_busy}, "
        f"{c_flops / 1e9:.2f} GFLOP, bound {c_bound:.3f} ms ({c_by})), rest "
        f"{c_ms['total'] - c_ms['embed'] - c_ms['search_hybrid'] - c_ms['rerank']:.3f} ms")

    # d. hybrid without rerank, B = 512
    q_emb512 = engine._embed(queries)
    d_ms = interleaved_ms({
        "total": lambda: engine.search_batch(queries, mode="hybrid", top_k=TOP_K),
        "embed": lambda: engine._embed(queries),
        "search_hybrid": lambda: idx.search_hybrid(q_emb512, queries, k=CANDIDATES,
                                                   candidates=CANDIDATES),
    })
    log(f"[semantic] d. search_batch(hybrid, top_k {TOP_K}) B={len(queries)}: "
        f"{d_ms['total']:.3f} ms; stages (each alone, in turn): embed "
        f"{d_ms['embed']:.3f} ms, search_hybrid {d_ms['search_hybrid']:.3f} ms, rest "
        f"{d_ms['total'] - d_ms['embed'] - d_ms['search_hybrid']:.3f} ms")

    # e. served: 64 requests through QueryBatcher(max_batch=32) with rerank
    requests = list(dict.fromkeys(queries))[:SEM_SERVE_REQUESTS]
    batcher = QueryBatcher(max_batch=SEM_RERANK_QUERIES)

    async def serve():
        return await asyncio.gather(*(batcher.search(
            engine, t, mode="hybrid", rerank=True, candidates=CANDIDATES, top_k=5)
            for t in requests))

    try:
        _reset_counts()
        t0 = time.perf_counter()
        answers = asyncio.run(serve())
        serve_s = time.perf_counter() - t0
        served_counts = _counts()
    finally:
        batcher.close()
    stats = batcher.stats()
    if served_counts["dense_topk_tc"] != stats["dispatches"]:
        raise AssertionError(f"served launches {served_counts} != dispatches {stats}")
    worst = 0.0
    for text, got in zip(requests, answers):
        want = engine.search_batch([text], mode="hybrid", rerank=True,
                                   candidates=CANDIDATES, top_k=5)[0]
        if [h.row for h in got] != [h.row for h in want] or len(got) != 5:
            raise AssertionError(f"served answer differs for {text!r}")
        worst = max(worst, _close(torch.tensor([h.score for h in got]),
                                  torch.tensor([h.score for h in want]), 2e-2))
    log(f"[semantic] e. {len(requests)} concurrent requests (rerank) through "
        f"QueryBatcher(max_batch={SEM_RERANK_QUERIES}) in {serve_s:.3f} s: "
        f"{stats['dispatches']} dispatches, dense_topk launches "
        f"{served_counts['dense_topk_tc']}; every answer has the rows of a direct "
        f"search_batch, scores within {worst:.3g} (1 + |s|) (limit 2e-2)")


# -- the CSR lexical tier at the north star's 10M chunks -----------------------

def _compare_rel(got_v, got_i, ref_v, ref_i, rtol: float, scores) -> float:
    """Raise unless two top-k lists agree as tests/torch_parity.py holds
    them: the same -inf slots, finite values within ``rtol`` relative,
    and an id that differs only where its ``scores`` value (the reference
    scorer's [B, N] scores) lies within that tolerance of the slot's
    reference value (a tie).  Returns the largest relative difference."""
    fin = torch.isfinite(ref_v)
    if not torch.equal(fin, torch.isfinite(got_v)):
        raise AssertionError("the two lists disagree on empty slots")
    ref0 = torch.where(fin, ref_v, 0.0)
    tol = rtol * ref0.abs()
    diff = torch.where(fin, (got_v - ref_v).abs(), 0.0)
    if bool((diff > tol).any()):
        raise AssertionError(f"scores differ by {float(diff.max())} > {rtol} relative")
    got_s = torch.gather(scores, 1, torch.where(fin, got_i, 0).long())
    bad = fin & (got_i != ref_i) & ((got_s - ref0).abs() > 2 * tol)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} ids differ away from any tie")
    rel = diff / ref0.abs().clamp(min=1e-30)
    return float(rel.max()) if rel.numel() else 0.0


def _bm25_all_scores(idx, qt, qi, step: int = 1 << 20) -> torch.Tensor:
    """Exact doc-major BM25 of every live row for each query ``[B, N]``,
    in row blocks (the doc-major scorer of ops/bm25.py)."""
    from super_rag_tpu_torch.ops.bm25 import _bm25_block, _idf_table, clamp_avgdl

    table = _idf_table(qt, qi, idx.spec.vocab_size)
    avgdl = clamp_avgdl(idx.df.avgdl, qt.device)
    n = idx.size
    out = torch.empty((qt.shape[0], n), dtype=torch.float32, device=qt.device)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[:, lo:hi] = _bm25_block(table, idx.terms[lo:hi], idx.tfs[lo:hi],
                                    idx.doc_len[lo:hi], avgdl, 1.2, 0.75)
    return out


def _ranked_topk(scores: torch.Tensor, k: int):
    """Top-``k`` per row, value descending and lowest index first among
    ties (a topk of a little more, then a stable re-sort)."""
    v, i = torch.topk(scores, min(scores.shape[1], 4 * k))
    i, order = torch.sort(i, dim=1)
    v = torch.gather(v, 1, order)
    v, order = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(i, 1, order)[:, :k].to(torch.int32)


def _csr_stages(idx, q_emb, texts, opts: dict, reps: int) -> dict:
    """search_hybrid at one batch, and its stages each timed alone: host
    query analysis, the dense branch (its kernel apart), the CSR gather,
    the sort + segment sum + top-k (with the shard merge), and the rest
    (exact rescore + RRF + glue) as the remainder."""
    from super_rag_tpu_torch.ops import bm25_inverted as bi
    from super_rag_tpu_torch.ops import dense_topk as dt

    calls: dict = {}
    with mock.patch.object(dt, "tile_topk", _recording(calls, "tile", dt.tile_topk)):
        idx.search_hybrid(q_emb, texts, k=TOP_K, candidates=CANDIDATES, **opts)
    total = host_ms(lambda: idx.search_hybrid(q_emb, texts, k=TOP_K,
                                              candidates=CANDIDATES, **opts), reps=reps)
    t0 = time.perf_counter()
    qt, qi = idx._query_arrays(texts, 16)
    analysis = (time.perf_counter() - t0) * 1e3
    corpus, mask = idx.dense_corpus(), idx._mask(None)
    dense = cuda_ms(lambda: dt.dense_topk(q_emb, corpus, CANDIDATES, mask=mask, tile=2048,
                                          int8_queries=True, per_tile_k=idx._per_tile_k,
                                          device=DEVICE), reps=reps)
    targs = calls["tile"]
    kernel = cuda_ms(lambda: dt.tile_topk(*targs), reps=reps)
    def gather():
        return bi._csr_gather_budgets(qt, qi, idx._inverted, mask,
                                      opts["postings_per_query_term"],
                                      opts["lex_deep_terms"], opts["lex_deep_postings"])

    ids, w = gather()
    k_gen = min(opts["lex_gen"], idx.size)
    stages = {
        "total": total, "host query analysis": analysis,
        "dense branch": dense, "dense_topk kernel": kernel,
        "CSR gather": cuda_ms(gather, reps=reps),
        "sort + segment sum + top-k": cuda_ms(lambda: bi._csr_aggregate(ids, w, k_gen),
                                              reps=reps),
        "width": int(ids.shape[-1]) * (ids.shape[1] if ids.dim() == 3 else 1),
    }
    stages["rest (rescore + RRF)"] = (total - analysis - dense - stages["CSR gather"]
                                      - stages["sort + segment sum + top-k"])
    return stages


def _log_stages(tag: str, b: int, st: dict) -> None:
    log(f"[csr] {tag} search_hybrid B={b}: {st['total']:.3f} ms "
        f"({b / st['total'] * 1e3:.1f} queries/s); stages (each alone): host query "
        f"analysis {st['host query analysis']:.3f} ms, dense branch "
        f"{st['dense branch'] - st['dense_topk kernel']:.3f} ms + kernel "
        f"{st['dense_topk kernel']:.3f} ms, CSR gather {st['CSR gather']:.3f} ms "
        f"({st['width']} postings a query), sort + segment sum + top-k "
        f"{st['sort + segment sum + top-k']:.3f} ms, rest (rescore + RRF) "
        f"{st['rest (rescore + RRF)']:.3f} ms")


def phase_csr(results: dict) -> None:
    """The north star's lexical scale on the card: 10,002,432 rows x 768
    int8 with a 48-slot zipfian doc-term table (scripts/bench_10m.py's
    lexical recipe, no pad slots; the 1M smoke's flat dense tier in place
    of its IVF).  compact_lexical must pick the CSR tier by itself; then
    search_hybrid at B = 512 and 32 with the 10M budgets, unsharded and
    with 16 doc shards, gated: (a) CSR generation at full coverage is the
    exact doc-major BM25 top-k, (b) the 16-shard build gives the same, (c)
    the dense_topk kernel launched inside search_hybrid is bit-equal to its
    plain version, (d) dense recall@10 >= 0.9; hybrid fidelity against an
    exact hybrid gold >= 0.8."""
    import dataclasses

    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.bm25_inverted import (
        CSRInvertedIndex, _shard_depth, inverted_bm25_search)
    from super_rag_tpu_torch.ops.fusion import rrf_fuse

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arrays, host, ranks, df_host = make_corpus(CSR_ROWS, gen, dim=DIM, slots=CSR_SLOTS,
                                               vocab=VOCAB, pad=0.0)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = DeviceIndex.from_snapshot(arrays, host, device=DEVICE)
    del arrays, host
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if idx.spec.lex_tier != "auto" or idx.size < idx.spec.csr_auto_rows:
        raise AssertionError("the 10M index is not on the auto tier past csr_auto_rows")
    t0 = time.perf_counter()
    idx.compact_lexical()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    csr = idx._inverted
    if not isinstance(csr, CSRInvertedIndex) or csr.shards != 1:
        raise AssertionError(f"compact_lexical at {idx.size} rows built {type(csr).__name__}")
    e = csr.postings_docs.shape[0]
    csr_bytes = e * 6 + csr.offsets.numel() * 4
    log(f"[csr] on {results['card']}: corpus {CSR_ROWS} x {DIM} int8 + {CSR_SLOTS}-slot zipfian table (V = "
        f"{VOCAB}, no pad slots) made on the card in {t_gen:.2f} s; DeviceIndex in "
        f"{t_load:.2f} s (capacity {idx._capacity}); compact_lexical with lex_tier "
        f"'auto' picked {type(csr).__name__} (csr_auto_rows {idx.spec.csr_auto_rows}): "
        f"{t_compact:.2f} s with the per_tile_k calibration (-> {idx._per_tile_k}); "
        f"{e} postings, {csr_bytes / 1e9:.3f} GB of CSR arrays; card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB at peak in this phase")

    q_all = torch.randn(CSR_BATCH, DIM, device=DEVICE, generator=gen)
    texts = make_query_texts(ranks, df_host, gen, CSR_BATCH, terms=CSR_QUERY_TERMS,
                             vocab=VOCAB)
    del ranks
    opts = dict(postings_per_query_term=CSR_PQ, lex_deep_terms=CSR_DEEP_TERMS,
                lex_deep_postings=CSR_DEEP_POSTINGS, lex_gen=CSR_LEX_GEN, rescore=True)

    # the main path, counted: search_hybrid at B = 512 on the CSR tier
    calls: dict = {}
    _reset_counts()
    with mock.patch.object(dt, "tile_topk", _recording(calls, "tile", dt.tile_topk)):
        res = idx.search_hybrid(q_all, texts, k=TOP_K, candidates=CANDIDATES, **opts)
    torch.cuda.synchronize()
    counts = _counts()
    if counts["dense_topk_tc"] < 1 or counts[LIST_KEY] < 1:
        raise AssertionError(f"search_hybrid on the CSR tier launched {counts}, not the "
                             f"register-list dense_topk")
    ids = res.indices.cpu().numpy()
    if (ids.shape != (CSR_BATCH, TOP_K) or ids.min() < 0
            or not np.isfinite(res.scores.cpu().numpy()).all()):
        raise AssertionError("CSR hybrid result has the wrong shape or empty slots")

    # (c) the kernel inside that call against its plain version
    targs = calls["tile"]
    kv, ki = dt.tile_topk(*targs)
    pv, pi = dt.tile_topk_plain(*targs)
    torch.cuda.synchronize()
    k_err = _compare(kv, ki, pv, pi, exact=True, tol=0.0)
    q8, n_scan, tile, kt = targs[0], targs[6], targs[7], targs[8]
    num_tiles = kv.shape[0]
    del kv, ki, pv, pi
    k_ms = cuda_ms(lambda: dt.tile_topk(*targs))
    p_ms = cuda_ms(lambda: dt.tile_topk_plain(*targs), reps=5, warmup=1)
    keep = targs[5] if targs[5] is not None else torch.ones(n_scan, dtype=torch.bool,
                                                             device=DEVICE)
    lib_ms = cuda_ms(lambda: library_topk(*targs[:4], keep, n_scan, tile, kt), reps=5,
                     warmup=1)
    b = q8.shape[0]
    nbytes = (n_scan * DIM + n_scan * 4 + n_scan + b * DIM + b * 4
              + num_tiles * b * kt * 8)
    k_bound, k_by = bound_ms(nbytes, 2.0 * b * n_scan * DIM, INT8_OPS_PER_S)
    log(f"[csr] (c) dense_topk inside search_hybrid B={b} [num_tiles={num_tiles}, "
        f"kt={kt}]: launches {counts}; bit-equal to its plain version (max |diff| "
        f"{k_err}); kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library (_int_mm + topk, "
        f"in 32-tile chunks) {lib_ms:.3f} ms, bound {k_bound:.3f} ms ({k_by}; "
        f"{nbytes / 1e9:.2f} GB, {2.0 * b * n_scan * DIM / 1e12:.2f} T int8 operations)")
    results["dense_topk_10m"] = {
        "variant": LIST_VARIANT, "launches": counts[LIST_KEY],
        "rows": n_scan, "batch": b, "max_abs_err": k_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": k_bound, "bound_by": k_by, "library_ms": lib_ms}

    # exact references for 64 queries: BM25 scores of every row, the exact
    # BM25 and dense top-100, and the exact hybrid (RRF of the two)
    ev = CSR_EVAL_QUERIES
    qt, qi = idx._query_arrays(texts[:ev], 16)
    mask = idx._mask(None)
    corpus = idx.dense_corpus()
    full_bm25 = _bm25_all_scores(idx, qt, qi)
    gold_lv, gold_li = _ranked_topk(full_bm25, CANDIDATES)
    gold_lex = torch.where(gold_lv > 0, gold_li, -1)
    gold_di = exact_topk(q_all[:ev], corpus, mask, idx.size, k=CANDIDATES)
    gold_hyb = rrf_fuse(gold_di.to(torch.int32), gold_lex, k=TOP_K)[1]

    # (a) full coverage: a budget at the longest run of the gate queries'
    # terms makes CSR generation exact BM25
    g = CSR_GATE_QUERIES
    qg, qig = qt[:g], qi[:g]
    live = qg < VOCAB
    runs = (csr.offsets[qg.long() + 1] - csr.offsets[qg.long()])[live]
    budget = int(runs.max())
    t0 = time.perf_counter()
    cv, ci = inverted_bm25_search(qg, qig, csr, k=CANDIDATES, mask=mask,
                                  postings_per_query_term=budget)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    rv = torch.where(gold_lv[:g] > 0, gold_lv[:g], float("-inf"))
    a_err = _compare_rel(cv, ci, rv, gold_lex[:g], CSR_BF16_RTOL, full_bm25[:g])
    # the unsharded tier's own scores of its top-4096, the tie rule of (b)
    uv, ui = inverted_bm25_search(qg, qig, csr, k=4096, mask=mask,
                                  postings_per_query_term=budget)
    csr_scores = torch.full((g, idx.size), float("-inf"), device=DEVICE)
    csr_scores.scatter_(1, ui.clamp(min=0).long(), torch.where(ui >= 0, uv, float("-inf")))
    del uv, ui
    log(f"[csr] (a) {g} queries at full coverage (budget {budget} = the longest run of "
        f"their terms, {int(live.sum())} terms, {t_full:.3f} s): CSR generation top-"
        f"{CANDIDATES} = the exact doc-major BM25 top-{CANDIDATES}: ids equal up to ties, "
        f"scores within {a_err:.3g} relative (limit {CSR_BF16_RTOL:.3g}: bf16 impacts)")

    # lexical generation overlap and hybrid fidelity over the 64 queries
    gen_v, gen_i = inverted_bm25_search(qt, qi, csr, k=CSR_LEX_GEN, mask=mask,
                                        postings_per_query_term=CSR_PQ,
                                        deep_terms=CSR_DEEP_TERMS,
                                        deep_postings=CSR_DEEP_POSTINGS)
    lex_overlap = float(np.mean([
        len(set(a) & {x for x in gl if x >= 0}) / max(1, sum(1 for x in gl if x >= 0))
        for a, gl in zip(gen_i.cpu().tolist(), gold_lex.cpu().tolist())]))
    fidelity = recall_at_k(res.indices[:ev], gold_hyb)
    _, got_d = dt.dense_topk(q_all[:ev], corpus, TOP_K, mask=mask, tile=2048,
                             int8_queries=True, per_tile_k=idx._per_tile_k, device=DEVICE)
    recall = recall_at_k(got_d, gold_di[:, :TOP_K])
    log(f"[csr] {ev} queries: lexical generation (pq {CSR_PQ} + deep {CSR_DEEP_TERMS} x "
        f"{CSR_DEEP_POSTINGS}, top-{CSR_LEX_GEN}) holds {lex_overlap:.4f} of the exact BM25 "
        f"top-{CANDIDATES}; hybrid top-{TOP_K} fidelity against the exact hybrid (RRF of the "
        f"exact dense and exact BM25 top-{CANDIDATES}) {fidelity:.4f} (gate 0.8); (d) dense "
        f"recall@{TOP_K} vs exact f32 over the stored rows {recall:.4f} (gate 0.9)")
    if fidelity < 0.8:
        raise AssertionError(f"hybrid fidelity {fidelity} < 0.8")
    if recall < 0.9:
        raise AssertionError(f"dense recall@{TOP_K} {recall} < 0.9")
    del full_bm25, gen_v, gen_i

    # stage times, unsharded
    stages = {}
    for bb in (CSR_BATCH, CSR_SMALL_BATCH):
        stages[(1, bb)] = _csr_stages(idx, q_all[:bb], texts[:bb], opts,
                                      reps=10 if bb == CSR_BATCH else 20)
        _log_stages("C=1", bb, stages[(1, bb)])

    # (b) 16 doc shards: the same index recompacted, full coverage equal
    idx.spec = dataclasses.replace(idx.spec, csr_shards=CSR_SHARDS)
    del csr
    t0 = time.perf_counter()
    idx.compact_lexical()
    torch.cuda.synchronize()
    t_compact16 = time.perf_counter() - t0
    csr16 = idx._inverted
    if not isinstance(csr16, CSRInvertedIndex) or csr16.shards != CSR_SHARDS:
        raise AssertionError("the csr_shards=16 compaction did not build 16 shards")
    lens = (csr16.offsets[:, qg.long() + 1] - csr16.offsets[:, qg.long()])
    depth = _shard_depth(budget, CSR_SHARDS)
    if int(lens.max()) > depth:
        raise AssertionError(f"a shard run of {int(lens.max())} > the shard depth {depth}")
    sv, si = inverted_bm25_search(qg, qig, csr16, k=CANDIDATES, mask=mask,
                                  postings_per_query_term=budget)
    b_err = _compare_rel(sv, si, cv, ci, 1e-6, csr_scores)
    log(f"[csr] (b) csr_shards={CSR_SHARDS}: compact_lexical {t_compact16:.2f} s; at full "
        f"coverage (per-shard depth {depth} >= the longest shard run {int(lens.max())}) "
        f"the result equals the unsharded one: ids up to ties, scores within "
        f"{b_err:.3g} relative (limit 1e-6)")
    res16 = idx.search_hybrid(q_all, texts, k=TOP_K, candidates=CANDIDATES, **opts)
    fid16 = recall_at_k(res16.indices[:ev], gold_hyb)
    log(f"[csr] C={CSR_SHARDS} hybrid fidelity {fid16:.4f}; rows equal to C=1 for "
        f"{int((res16.indices == res.indices).all(1).sum())} of {CSR_BATCH} queries")
    for bb in (CSR_BATCH, CSR_SMALL_BATCH):
        stages[(CSR_SHARDS, bb)] = _csr_stages(idx, q_all[:bb], texts[:bb], opts,
                                               reps=10 if bb == CSR_BATCH else 20)
        _log_stages(f"C={CSR_SHARDS}", bb, stages[(CSR_SHARDS, bb)])
    results["csr"] = {"fidelity": fidelity, "lex_overlap": lex_overlap, "recall": recall,
                      "stages": {f"C={c} B={bb}": st for (c, bb), st in stages.items()}}
    del idx, res, res16


# -- the engine layer under the serving seam ---------------------------------

def phase_engine(results: dict) -> None:
    """EngineManager (Settings with its data directory in a temporary
    directory outside the repo, a LocalObjectStore as its snapshot
    store) builds an engine from a collection config with ``hybrid``
    keys; 65,536 texts go in through CollectionEngine.ingest (timed, the
    analyzer's share with the native path and with the Python loop); the
    index is snapshotted to the store and a fresh manager restores it from
    the store alone; the restored engine's hybrid answers must equal the
    original's, and batched_search through a QueryBatcher must equal a
    direct search."""
    import dataclasses
    import shutil
    import tempfile

    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.engine.batcher import QueryBatcher, batched_search
    from super_rag_tpu_torch.engine.manager import EngineManager
    from super_rag_tpu_torch.engine.snapshot import snapshot_exists, store_snapshot_exists
    from super_rag_tpu_torch.store.objectstore import LocalObjectStore
    from super_rag_tpu_torch.tokenize import native
    from super_rag_tpu_torch.tokenize.analyzer import Analyzer

    if not native.available():
        raise AssertionError("the native analyzer did not build here (g++)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    try:
        store = LocalObjectStore(os.path.join(tmp, "objects"))
        config = {"embedding": {"dim": DIM}, "index_dtype": "int8", "bm25_slots": SLOTS,
                  "vocab_size": VOCAB,
                  "hybrid": {"rescore": True, "postings_per_query_term": 768,
                             "lex_deep_terms": 2, "lex_deep_postings": 4096}}

        def manager(name):
            m = EngineManager(dataclasses.replace(Settings(),
                                                  data_dir=os.path.join(tmp, name)),
                              device=DEVICE)
            m.snapshot_store = store
            return m

        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        ranks = ((_zipf(gen, 1.3, (ENGINE_TEXTS, SLOTS)) - 1) % VOCAB).to(torch.int32)
        tfs = torch.clamp(_zipf(gen, 2.0, (ENGINE_TEXTS, SLOTS)), max=4)
        texts = row_texts(ranks, tfs, ENGINE_WORDS)
        queries = list(dict.fromkeys(" ".join(t.split()[3:7]) for t in texts[::509]))
        queries = queries[:ENGINE_QUERIES]
        del ranks, tfs

        analyzer_s = {"t": 0.0}
        real = Analyzer.batch_doc_entries

        def timed(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real(self, *a, **kw)
            finally:
                analyzer_s["t"] += time.perf_counter() - t0

        def ingest(eng, count=None, **kw):
            analyzer_s["t"] = 0.0
            with mock.patch.object(Analyzer, "batch_doc_entries",
                                   lambda self, t, s: timed(self, t, s, **kw)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for lo in range(0, count or len(texts), ENGINE_INGEST_BATCH):
                    eng.ingest(texts[lo:lo + ENGINE_INGEST_BATCH])
                torch.cuda.synchronize()
                return time.perf_counter() - t0, analyzer_s["t"]

        m1 = manager("a")
        eng = m1.get("c", config)
        if (eng.hybrid_opts != config["hybrid"]
                or eng.index.device.type != torch.device(DEVICE).type):
            raise AssertionError(f"engine built with {eng.hybrid_opts} on {eng.index.device}")
        wall, ana = ingest(eng)
        py_eng = manager("p").get("py", config)
        n_py = ENGINE_PY_TEXTS
        py_wall, py_ana = ingest(py_eng, count=n_py, prefer_native=False)
        if not (torch.equal(py_eng.index.terms[:n_py], eng.index.terms[:n_py])
                and torch.equal(py_eng.index.tfs[:n_py], eng.index.tfs[:n_py])):
            raise AssertionError("the native and Python analyzers indexed other terms")
        del py_eng
        log(f"[engine] on {results['card']}: EngineManager engine (int8, {DIM}-dim hash embedder, hybrid keys "
            f"{sorted(config['hybrid'])}) ingested {len(texts)} texts of {ENGINE_WORDS} "
            f"words in batches of {ENGINE_INGEST_BATCH}: {wall:.3f} s, "
            f"{len(texts) / wall:.0f} chunks/s, analyzer {ana:.3f} s ({ana / wall:.1%}, "
            f"native); the first {n_py} again with prefer_native=False {py_wall:.3f} s, "
            f"{n_py / py_wall:.0f} chunks/s, analyzer {py_ana:.3f} s "
            f"({py_ana / py_wall:.1%}); both indexed the same terms and tfs")

        t0 = time.perf_counter()
        want = eng.search_batch(queries, top_k=TOP_K)
        t_first = time.perf_counter() - t0
        m1.snapshot("c")
        if not store_snapshot_exists(store, "snapshots/c"):
            raise AssertionError("the snapshot did not reach the store")
        m2 = manager("b")  # a fresh machine: no file snapshot
        if snapshot_exists(m2._snapshot_path("c")):
            raise AssertionError("the fresh manager sees a file snapshot")
        t0 = time.perf_counter()
        restored = m2.get("c", config)
        t_restore = time.perf_counter() - t0
        if restored.index.size != eng.index.size or restored is eng:
            raise AssertionError("the store restore holds other rows")
        _reset_counts()
        got = restored.search_batch(queries, top_k=TOP_K)
        torch.cuda.synchronize()
        counts = _counts()
        if counts["dense_topk_tc"] < 1:
            raise AssertionError(f"the restored engine's search launched {counts}")
        for q, g_, w_ in zip(queries, got, want):
            if ([(h.row, h.score) for h in g_] != [(h.row, h.score) for h in w_]
                    or len(g_) != TOP_K):
                raise AssertionError(f"restored answer differs for {q!r}: "
                                     f"{[(h.row, h.score) for h in g_]} vs "
                                     f"{[(h.row, h.score) for h in w_]}")
        batcher = QueryBatcher(max_batch=32)

        async def serve():
            return await asyncio.gather(*(batched_search({"batcher": batcher}, restored,
                                                         q, top_k=TOP_K) for q in queries))

        try:
            served = asyncio.run(serve())
        finally:
            batcher.close()
        for q, s_ in zip(queries, served):
            direct = restored.search(q, top_k=TOP_K)
            if [(h.row, h.score) for h in s_] != [(h.row, h.score) for h in direct]:
                raise AssertionError(f"batched_search differs from a direct search for {q!r}")
        log(f"[engine] snapshot to the LocalObjectStore and restore by a fresh manager "
            f"from the store alone ({t_restore:.3f} s); the restored engine's "
            f"search_batch(hybrid) of {len(queries)} queries equals the original's "
            f"(first search {t_first:.3f} s with the lexical compaction; launches "
            f"{counts}); {len(queries)} batched_search requests through "
            f"QueryBatcher(max_batch=32) in {batcher.stats()['dispatches']} dispatches "
            f"equal direct searches")
        results["engine"] = {"chunks_per_s": len(texts) / wall,
                             "analyzer_share": ana / wall,
                             "chunks_per_s_python": len(texts) / py_wall,
                             "analyzer_share_python": py_ana / py_wall}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the HTTP serving seam: the port's own app over a socket ------------------

class _AppThread:
    """The port's App on its own asyncio loop in a thread, as a deployment
    runs it (``python -m super_rag_tpu_torch.app``) but stoppable."""

    def __init__(self, cfg, device: str = None):
        import threading

        from super_rag_tpu_torch.app import App

        self.loop = asyncio.new_event_loop()
        self.app = None
        self.error = None
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def boot():
                try:
                    self.app = App(cfg, background_tasks=True, device=device or DEVICE)
                    await self.app.start(port=0)
                except Exception as e:  # noqa: BLE001 — raised below
                    self.error = e
                ready.set()

            self.loop.run_until_complete(boot())
            if self.error is None:
                self.loop.run_forever()
            self.loop.close()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not ready.wait(300):
            raise AssertionError("the app did not start in 300 s")
        if self.error is not None:
            raise self.error

    def stop(self) -> None:
        asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop).result(300)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        if self.thread.is_alive():
            raise AssertionError("the app's thread did not stop")


class _Client:
    """One keep-alive HTTP/1.1 connection (the standard library's
    http.client), JSON in and out."""

    def __init__(self, port: int, token: str = ""):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        self.token = token

    def call(self, method: str, path: str, body=None):
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        data = None if body is None else json.dumps(body).encode()
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        payload = resp.read()
        if (resp.getheader("Content-Type") or "").startswith("application/json"):
            return resp.status, json.loads(payload)
        return resp.status, payload.decode()

    def close(self) -> None:
        self.conn.close()


class WSClient:
    """An RFC 6455 client on the standard library's socket (the card's
    machine has no websockets package): the upgrade handshake with its
    Sec-WebSocket-Accept check, masked text frames out, the server's
    unmasked frames in (a ping answered), and the close handshake.  Every
    read waits at most ``timeout`` seconds."""

    GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

    def __init__(self, port: int, path: str, token: str = "", timeout: float = 60.0):
        import base64
        import hashlib
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        auth = f"Authorization: Bearer {token}\r\n" if token else ""
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
                           f"{auth}\r\n").encode())
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            self._fill()
        head, _, self.buf = self.buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        headers = {k.strip().lower(): v.strip()
                   for k, _, v in (ln.partition(":") for ln in lines[1:])}
        want = base64.b64encode(hashlib.sha1((key + self.GUID).encode()).digest()).decode()
        if lines[0].split(" ")[1:2] != ["101"] or headers.get("sec-websocket-accept") != want:
            self.sock.close()
            raise ConnectionError(f"websocket upgrade refused: {lines[0]!r}")

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("connection closed")
        self.buf += chunk

    def _take(self, n: int) -> bytes:
        while len(self.buf) < n:
            self._fill()
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def _send(self, opcode: int, payload: bytes) -> None:
        import struct

        n = len(payload)
        head = bytes([0x80 | opcode])
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 1 << 16:
            head += bytes([0x80 | 126]) + struct.pack("!H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack("!Q", n)
        mask = os.urandom(4)
        key = int.from_bytes((mask * (n // 4 + 1))[:n], "big") if n else 0
        body = (int.from_bytes(payload, "big") ^ key).to_bytes(n, "big") if n else b""
        self.sock.sendall(head + mask + body)

    def send_json(self, data) -> None:
        self._send(0x1, json.dumps(data).encode())

    def recv_json(self):
        """The next text frame as JSON; None once the server closes."""
        import struct

        buffer = b""
        while True:
            b0, b1 = self._take(2)
            opcode, n = b0 & 0x0F, b1 & 0x7F
            if n == 126:
                n = struct.unpack("!H", self._take(2))[0]
            elif n == 127:
                n = struct.unpack("!Q", self._take(8))[0]
            if b1 & 0x80:
                raise ConnectionError("a server frame must not be masked")
            payload = self._take(n)
            if opcode == 0x8:
                return None
            if opcode == 0x9:
                self._send(0xA, payload)
                continue
            if opcode == 0xA:
                continue
            buffer += payload
            if b0 & 0x80:
                return json.loads(buffer.decode())

    def close(self) -> None:
        """The close handshake: our close frame, then the server's, then EOF."""
        try:
            self._send(0x8, (1000).to_bytes(2, "big"))
            while self.recv_json() is not None:
                pass
        except (ConnectionError, OSError):
            pass
        finally:
            self.sock.close()


def _expect(status, body, want: int, what: str):
    if status != want:
        raise AssertionError(f"{what}: HTTP {status}, expected {want}: {str(body)[:300]}")
    return body


def _login(port: int) -> str:
    c = _Client(port)
    try:
        st, body = c.call("POST", "/api/v1/auth/login",
                          {"username": "smoke", "password": "smoke-password"})
        return _expect(st, body, 200, "login")["token"]
    finally:
        c.close()


def _metrics(port: int, token: str) -> dict:
    c = _Client(port, token)
    try:
        st, text = c.call("GET", "/metrics")
    finally:
        c.close()
    _expect(st, text, 200, "metrics")
    out = {}
    for line in text.splitlines():
        if line.startswith("super_rag_batcher_"):
            name, value = line.split()
            out[name[len("super_rag_batcher_"):]] = float(value)
    return out


def _pctl(ms: list, q: float) -> float:
    return float(np.percentile(np.asarray(ms), q))


def http_corpus(gen, n_docs: int = None, sections: int = None,
                n_queries: int = None) -> tuple[list, list]:
    """``n_docs`` (HTTP_DOCS) markdown documents, each a title and
    ``sections`` (HTTP_SECTIONS) sections of HTTP_WORDS zipfian words (the
    [semantic] recipe: words ``t<rank>``, a row's own words repeated by tf),
    and ``n_queries`` (HTTP_QUERIES) distinct queries of discriminative
    words from random sections."""
    from super_rag_tpu_torch.tokenize.analyzer import fnv1a32

    n_docs = HTTP_DOCS if n_docs is None else n_docs
    sections = HTTP_SECTIONS if sections is None else sections
    n_queries = HTTP_QUERIES if n_queries is None else n_queries
    n = n_docs * sections
    ranks = ((_zipf(gen, 1.3, (n, SLOTS)) - 1) % VOCAB).to(torch.int32)
    tfs = torch.clamp(_zipf(gen, 2.0, (n, SLOTS)), max=4)
    paras = row_texts(ranks, tfs, HTTP_WORDS)
    bucket_of_rank = torch.tensor([fnv1a32(f"t{r}") & (VOCAB - 1) for r in range(VOCAB)],
                                  dtype=torch.int64, device=DEVICE)
    terms = torch.sort(bucket_of_rank[ranks.long()], dim=1).values
    first = torch.ones_like(terms, dtype=torch.bool)
    first[:, 1:] = terms[:, 1:] != terms[:, :-1]
    df_host = torch.bincount(terms[first], minlength=VOCAB).cpu().numpy()
    queries = list(dict.fromkeys(make_query_texts(ranks, df_host, gen, 4 * n_queries)))
    queries = [q for q in queries if q][:n_queries]
    if len(queries) < n_queries:
        raise AssertionError(f"only {len(queries)} distinct queries")
    docs = []
    for d in range(n_docs):
        body = "".join(f"## section {d}.{s}\n\n{paras[d * sections + s].strip()}\n\n"
                       for s in range(sections))
        docs.append((f"doc{d:03d}.md", f"# doc {d}\n\n{body}"))
    return docs, queries


class _Stages:
    """Per-request stage times of the served search, by wrapping the
    package's methods from outside (no timer lives in the package)."""

    def __init__(self):
        self.ms: dict = {}
        self.patches = []

    def _add(self, name: str, t0: float) -> None:
        self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def wrap_async(self, cls, attr: str, name: str):
        orig = getattr(cls, attr)

        async def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return await orig(*args, **kw)
            finally:
                self._add(name, t0)
        self.patches.append(mock.patch.object(cls, attr, wrapped))

    def wrap_sync(self, cls, attr: str, name: str, sync: bool = False):
        orig = getattr(cls, attr)

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                out = orig(*args, **kw)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                self._add(name, t0)
        self.patches.append(mock.patch.object(cls, attr, wrapped))

    def __enter__(self):
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.stop()


def _library_topk_float(q, values, scales, mask, n, tile, kt):
    """Yardstick only, never used by the port: torch.matmul in the queries'
    type (bf16: a cuBLAS GEMM with f32 output, an int8 corpus converted to
    bf16 chunk by chunk; f32: SGEMM, TF32 off as main sets it) + the same
    epilogue + torch.topk per tile, in chunks."""
    b = q.shape[0]
    num_tiles = -(-n // tile)
    out_v = torch.empty((num_tiles, b, kt), dtype=torch.float32, device=DEVICE)
    tiles_per_chunk = 32
    for t0 in range(0, num_tiles, tiles_per_chunk):
        t1 = min(num_tiles, t0 + tiles_per_chunk)
        r0, r1 = t0 * tile, min(n, t1 * tile)
        v = values[r0:r1]
        s = torch.matmul(q, (v if v.dtype == q.dtype else v.to(q.dtype)).T).to(torch.float32)
        if scales is not None:
            s = s * scales[None, r0:r1]
        if mask is not None:
            s = torch.where(mask[None, r0:r1], s, float("-inf"))
        s = torch.nn.functional.pad(s, (0, (t1 - t0) * tile - (r1 - r0)),
                                    value=float("-inf"))
        out_v[t0:t1] = torch.topk(s.view(b, t1 - t0, tile), kt, dim=-1).values.transpose(0, 1)
    return out_v


def _served_kernel_row(args, launches: int, dispatches: int, hlog) -> dict:
    """dense_topk at one served batch's shape: the kernel against its plain
    version (bit for bit for int8 x int8, within _tolerance for bf16 and
    f32), and the kernel, plain, library and bound times.  An f32 call's
    operations are its three TF32 products at the TF32 rate (the CUDA
    cores' f32 time for the same work is logged beside it)."""
    from super_rag_tpu_torch.ops import dense_topk as dt

    q, qs, values, scales, norms, mask, n, tile, kt = args
    b, d = q.shape
    kv, ki = dt.tile_topk(*args)
    pv, pi = dt.tile_topk_plain(*args)
    torch.cuda.synchronize()
    exact = q.dtype == torch.int8
    tol = 0.0 if exact else _tolerance(d, pv)
    err = _compare(kv, ki, pv, pi, exact=exact, tol=tol,
                   scores=None if exact else dt.plain_scores(*args[:6], 0, n))
    k_ms = cuda_ms(lambda: dt.tile_topk(*args))
    p_ms = cuda_ms(lambda: dt.tile_topk_plain(*args), reps=10)
    keep = mask if mask is not None else torch.ones(n, dtype=torch.bool, device=DEVICE)
    f32 = q.dtype == torch.float32
    if exact:
        lib_ms = cuda_ms(lambda: library_topk(*args[:4], keep, n, tile, kt), reps=10)
        lib = "_int_mm + topk"
    else:
        lib_ms = cuda_ms(lambda: _library_topk_float(q, values, scales, keep, n, tile, kt),
                         reps=10)
        lib = "f32 matmul, TF32 off, + topk" if f32 else "bf16 matmul + topk"
    num_tiles = kv.shape[0]
    esize = values.element_size()
    nbytes = (n * d * esize + (n * 4 if scales is not None else 0) + n
              + b * d * q.element_size() + (b * 4 if qs is not None else 0)
              + num_tiles * b * kt * 8)
    k_bound, k_by = bound_ms(nbytes, (3 if f32 else 1) * 2.0 * b * n * d,
                             INT8_OPS_PER_S if exact else
                             TF32_OPS_PER_S if f32 else BF16_OPS_PER_S)
    cuda_core = (f"; f32 on the CUDA cores alone {2.0 * b * n * d / F32_CUDA_CORE_OPS_PER_S * 1e3:.4f} "
                 f"ms" if f32 else "")
    variant = dt.kernel_variant(dt._mode(q, values), kt, d, b, -(-n // tile),
                                dt._sm_count(torch.cuda.current_device()))
    # in bursts, where the card's time shows once it outpaces the host's
    # launch path (one call between two events includes that path)
    k_burst = burst_ms(lambda: dt.tile_topk(*args))
    lib_burst = burst_ms(lambda: _library_topk_float(q, values, scales, keep, n, tile, kt)
                         if not exact else library_topk(*args[:4], keep, n, tile, kt))
    hlog(f"dense_topk {variant} kernel vs plain at the served batch [num_tiles="
         f"{num_tiles}, B={b}, D={d}, kt={kt}, {str(values.dtype)[6:]}]: "
         f"{'bit-equal' if exact else f'within {tol:.3g}'} (max |diff| {err:.3g}); "
         f"kernel {k_ms:.3f} ms ({k_burst:.4f} ms a call in bursts of 50), plain "
         f"{p_ms:.3f} ms, library ({lib}) {lib_ms:.3f} ms ({lib_burst:.4f} ms in "
         f"bursts), bound {k_bound:.4f} ms ({k_by}{cuda_core}); {launches} launches over "
         f"{dispatches} dispatches")
    return {"launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": k_bound, "bound_by": k_by, "library_ms": lib_ms,
            "burst_ms": k_burst, "library_burst_ms": lib_burst,
            "batch": b, "dim": d, "kt": kt, "variant": variant,
            "launches_per_dispatch": launches / max(dispatches, 1)}


def phase_http(results: dict) -> None:
    """The port's own App (HTTP server, auth, audit, nodeflow, QueryBatcher,
    ThreadScheduler ingest) on the card, driven over a socket by the
    standard library's http.client at the deployment's defaults: the
    [semantic] encoder and cross-encoder (6 x 256, bf16, seeded weights
    written as checkpoints by the port), three collections (the default
    bf16 index, an int8 one and an f32 one, all on dense_topk's
    tensor-core route: f32 as three TF32 products), HTTP_DOCS markdown
    documents uploaded to each by HTTP_UPLOADERS clients; then searches
    from one client and from HTTP_CLIENTS, with and without rerank (the
    f32 collection 1 / HTTP_F32_SHARE of every request count), one
    request split into stages, and gates a-f (statuses and sizes, served
    = direct, no degrade, the kernel ran on the tensor cores and matches
    its plain version, also a direct search_dense at k 200 (the deep
    selection), delete, restart)."""
    import dataclasses
    import logging
    import shutil
    import tempfile
    import threading

    from super_rag_tpu_torch.api.http import HttpServer
    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.models.encoder import flax_params
    from super_rag_tpu_torch.models.encoder_service import EncoderService, save_params
    from super_rag_tpu_torch.nodeflow.engine import NodeflowEngine
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.service.collection_service import CollectionService
    from super_rag_tpu_torch.service.rerank_service import RerankService

    card = results["card"]

    def hlog(msg: str) -> None:
        log(f"[http] {msg} (on {card})")

    class _Errors(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(f"{record.name}: {record.getMessage()}")

    errors = _Errors()
    port_logger = logging.getLogger("super_rag_tpu_torch")
    port_logger.addHandler(errors)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    apps: list = []
    c = None
    try:
        # -- the deployment: checkpoints the port writes, Settings, the app
        t0 = time.perf_counter()
        cfg = semantic_config(torch.bfloat16)
        enc = EncoderService(cfg, max_len=cfg.max_len, seed=SEED, device=DEVICE)
        rr = RerankService(cfg, max_len=cfg.max_len, seed=SEED + 1, device=DEVICE)
        save_params(flax_params(enc.model), os.path.join(tmp, "enc"), cfg)
        save_params(flax_params(rr.model), os.path.join(tmp, "ce"), cfg)
        del enc, rr
        settings = dataclasses.replace(
            Settings(), data_dir=os.path.join(tmp, "data"), port=0,
            reranker_checkpoint=os.path.join(tmp, "ce"), ingest_backend="thread",
            batch_max=64, default_top_k=HTTP_TOP_K, rerank_candidates=HTTP_CANDIDATES,
            chunk_size=400, encoder_checkpoint="")
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        docs, queries = http_corpus(gen)
        srv = _AppThread(settings)
        apps.append(srv)
        port = srv.app.port
        c = _Client(port)
        _expect(*c.call("POST", "/api/v1/auth/register",
                        {"username": "smoke", "password": "smoke-password"}), 201,
                "register")
        c.close()
        token = _login(port)
        c = _Client(port, token)
        colls = {}
        for name, extra in (("default", {}), ("int8", {"index_dtype": "int8"}),
                            ("f32", {"index_dtype": "float32"})):
            config = {"embedding": {"provider": "onboard",
                                    "model": os.path.join(tmp, "enc")}, **extra}
            body = _expect(*c.call("POST", "/api/v1/collections",
                                   {"title": name, "config": config}), 201,
                           f"create collection {name}")
            colls[name] = body["id"]
        engines = {name: srv.app.ctx.engines.get(cid) for name, cid in colls.items()}
        reranker = srv.app.ctx.reranker_for(srv.app.ctx.db.get_collection(
            colls["default"])["config"])
        for name, eng in engines.items():
            if not (isinstance(eng.embedder, EncoderService)
                    and eng.embedder.device.type == torch.device(DEVICE).type
                    and eng.index.device.type == torch.device(DEVICE).type):
                raise AssertionError(f"gate c: collection {name} embeds with "
                                     f"{type(eng.embedder).__name__} on "
                                     f"{getattr(eng.embedder, 'device', None)}")
        if not (isinstance(reranker, RerankService)
                and reranker.device.type == torch.device(DEVICE).type):
            raise AssertionError(f"gate c: the reranker is {type(reranker).__name__}")
        want_dtypes = {"default": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
        # each collection's divisor of the request counts
        share = {name: HTTP_F32_SHARE if name == "f32" else 1 for name in colls}
        for name, eng in engines.items():
            if eng.index.spec.dtype != want_dtypes[name]:
                raise AssertionError(f"collection {name} stores {eng.index.spec.dtype}")
        hlog(f"App on port {port} (ThreadScheduler ingest, {settings.ingest_host_workers} "
             f"host workers, batch_max {settings.batch_max}, top_k {HTTP_TOP_K}, rerank "
             f"candidates {HTTP_CANDIDATES}, chunk_size {settings.chunk_size}); encoder and "
             f"cross-encoder {cfg.num_layers} x {cfg.hidden_dim} ({cfg.num_heads} heads, MLP "
             f"{cfg.mlp_dim}, max_len {cfg.max_len}, bf16) from checkpoints the port wrote "
             f"(seeds {SEED}, {SEED + 1}); collections default (bf16 index), int8 and f32; "
             f"{len(docs)} documents x {HTTP_SECTIONS} sections of {HTTP_WORDS} words; set-up "
             f"{time.perf_counter() - t0:.2f} s")

        # -- ingest: HTTP_UPLOADERS clients upload; wait for every COMPLETE
        ingest = {}
        for name, cid in colls.items():
            failures: list = []

            def upload(mine):
                uc = _Client(port, token)
                try:
                    for dname, text in mine:
                        st, body = uc.call("POST", f"/api/v1/collections/{cid}/documents",
                                           {"name": dname, "content": text})
                        if st != 201:
                            failures.append((dname, st, str(body)[:200]))
                finally:
                    uc.close()

            t_first = time.perf_counter()
            threads = [threading.Thread(target=upload, args=(docs[i::HTTP_UPLOADERS],))
                       for i in range(HTTP_UPLOADERS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(HTTP_INGEST_TIMEOUT_S)
            t_uploaded = time.perf_counter()
            if failures or any(th.is_alive() for th in threads):
                raise AssertionError(f"gate a: uploads to {name} failed: {failures[:3]}")
            while True:
                listing = _expect(*c.call("GET", f"/api/v1/collections/{cid}/documents"),
                                  200, "list documents")
                status = [d["status"] for d in listing]
                if "FAILED" in status:
                    raise AssertionError(f"a document of {name} FAILED: "
                                         f"{[d for d in listing if d['status'] == 'FAILED'][:1]}")
                if len(status) == len(docs) and set(status) == {"COMPLETE"}:
                    break
                if time.perf_counter() - t_first > HTTP_INGEST_TIMEOUT_S:
                    raise AssertionError(f"ingest of {name} not complete after "
                                         f"{HTTP_INGEST_TIMEOUT_S} s: {status.count('COMPLETE')}"
                                         f" of {len(docs)}")
                time.sleep(0.1)
            wall = time.perf_counter() - t_first
            chunks = engines[name].index.live_count
            if chunks != len(docs) * HTTP_SECTIONS:
                raise AssertionError(f"{name} holds {chunks} chunks, expected "
                                     f"{len(docs) * HTTP_SECTIONS}")
            ingest[name] = {"chunks": chunks, "s": wall, "chunks_per_s": chunks / wall}
            hlog(f"ingest {name}: {len(docs)} documents ({chunks} chunks) through POST "
                 f"/api/v1/collections/{{cid}}/documents from {HTTP_UPLOADERS} clients; "
                 f"uploads answered in {t_uploaded - t_first:.3f} s, every document "
                 f"COMPLETE after {wall:.3f} s: {chunks / wall:.0f} chunks/s (first upload "
                 f"to last completion, polled every 0.1 s)")

        # warm each collection once: its first search compacts the lexical
        # index and calibrates the per-tile cap (not part of the timed runs)
        for name, cid in colls.items():
            _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                            {"query": queries[0], "use_rerank": False}), 201, "warm-up")

        # -- searches: one client, then HTTP_CLIENTS concurrent clients
        served: dict = {}
        runs: dict = {}
        calls: dict = {}
        real_tile_topk = dt.tile_topk

        def largest(*args):
            """dense_topk, keeping the arguments of the largest batch
            served under the key ``calls["keep"]``."""
            key = calls.get("keep")
            if key is not None and args[0].shape[0] >= calls.get(
                    key, (torch.empty(0),))[0].shape[0]:
                calls[key] = args
            return real_tile_topk(*args)

        def delta(before: dict) -> dict:
            after = _counts()
            return {k: after[k] - before[k] for k in after}

        # cross-encoder calls per (collection, use_rerank): none unreranked
        ce_calls: dict = {}
        running: list = [None]
        real_rerank = RerankService.__call__

        def counted_rerank(self, *args, **kw):
            ce_calls[running[0]] = ce_calls.get(running[0], 0) + 1
            return real_rerank(self, *args, **kw)

        _reset_counts()
        with mock.patch.object(dt, "tile_topk", largest), \
                mock.patch.object(RerankService, "__call__", counted_rerank):
            for name, cid in colls.items():
                m0 = _metrics(port, token)
                for rerank in (False, True):
                    running[0] = (name, rerank)
                    body = {"use_rerank": rerank, "top_k": HTTP_TOP_K}
                    lat, items = [], []
                    counts0 = _counts()
                    for q in queries[:HTTP_SINGLE_QUERIES // share[name]]:
                        t1 = time.perf_counter()
                        st, out = c.call("POST", f"/api/v1/collections/{cid}/searches",
                                         {**body, "query": q})
                        lat.append((time.perf_counter() - t1) * 1e3)
                        _expect(st, out, 201, "search")
                        items.append(out["items"])
                    served[(name, rerank)] = items
                    m1 = _metrics(port, token)
                    runs[(name, rerank, 1)] = {
                        "requests": len(lat), "p50": _pctl(lat, 50), "p99": _pctl(lat, 99),
                        "dispatches": m1["dispatches"] - m0["dispatches"],
                        "queries": m1["queries"] - m0["queries"],
                        "launches": delta(counts0)}
                    m0 = m1

                    n_clients = HTTP_CLIENTS // share[name]
                    per = HTTP_QUERIES // HTTP_CLIENTS
                    clat: list = []
                    cfail: list = []
                    calls["keep"] = (name, rerank)
                    counts0 = _counts()
                    barrier = threading.Barrier(n_clients + 1)

                    def client(k):
                        cc = _Client(port, token)
                        try:
                            barrier.wait()
                            for q in queries[k * per:(k + 1) * per]:
                                t1 = time.perf_counter()
                                st, out = cc.call("POST",
                                                  f"/api/v1/collections/{cid}/searches",
                                                  {**body, "query": q})
                                clat.append((time.perf_counter() - t1) * 1e3)
                                if st != 201 or len(out["items"]) != HTTP_TOP_K:
                                    cfail.append((st, str(out)[:200]))
                        finally:
                            cc.close()

                    threads = [threading.Thread(target=client, args=(k,))
                               for k in range(n_clients)]
                    for th in threads:
                        th.start()
                    barrier.wait()
                    t1 = time.perf_counter()
                    for th in threads:
                        th.join(600)
                    cwall = time.perf_counter() - t1
                    if cfail or any(th.is_alive() for th in threads):
                        raise AssertionError(f"gate a: concurrent searches failed: {cfail[:3]}")
                    m1 = _metrics(port, token)
                    runs[(name, rerank, n_clients)] = {
                        "requests": len(clat), "p50": _pctl(clat, 50), "p99": _pctl(clat, 99),
                        "rps": len(clat) / cwall,
                        "dispatches": m1["dispatches"] - m0["dispatches"],
                        "queries": m1["queries"] - m0["queries"],
                        "launches": delta(counts0)}
                    m0 = m1
                    calls["keep"] = None
        torch.cuda.synchronize()
        for (name, rerank, clients), r in sorted(runs.items()):
            extra = (f", {r['rps']:.1f} requests/s" if clients > 1 else "")
            launched = {k: v for k, v in r["launches"].items() if v}
            hlog(f"search {name} use_rerank={rerank}, {clients} client(s), "
                 f"{r['requests']} requests: p50 {r['p50']:.3f} ms, p99 {r['p99']:.3f} ms"
                 f"{extra}; batcher {r['dispatches']:.0f} dispatches, average batch "
                 f"{r['queries'] / max(r['dispatches'], 1):.2f}; launches {launched}")

        # gate a (sizes) and c (the cross-encoder orders exactly the
        # reranked requests: an unreranked one keeps the hybrid order)
        for (name, rerank), items in ((k, v) for k, v in served.items()
                                      if isinstance(k[1], bool)):
            for q, its in zip(queries, items):
                if len(its) != HTTP_TOP_K:
                    raise AssertionError(f"gate a: {name} answered {len(its)} items "
                                         f"for {q!r}")
                if any((it["recall_type"] == "reranked") != rerank for it in its):
                    raise AssertionError(f"gate c: {name} rerank={rerank}: recall types "
                                         f"{[it['recall_type'] for it in its]} for {q!r}")

        for name in colls:
            if ce_calls.get((name, False), 0) or not ce_calls.get((name, True), 0):
                raise AssertionError(f"gate c: cross-encoder calls {ce_calls}: an "
                                     f"unreranked request ran it, or no reranked one")
        hlog(f"gate c: cross-encoder calls per (collection, use_rerank): {ce_calls}")

        # gate d: in every run each dispatch launched dense_topk on the
        # tensor cores, in the variant its shape selects (kt of a reranked
        # request follows the per-tile cap that compaction calibrated on
        # this collection's data), counted in its mode
        variants = {}
        sms = dt._sm_count(torch.cuda.current_device())
        for (name, rerank, clients), r in runs.items():
            q, _, values, *_, n_scan, tile, kt = calls[(name, rerank)]
            mode = dt._mode(q, values)
            variant = dt.kernel_variant(mode, kt, q.shape[1], q.shape[0],
                                        -(-n_scan // tile), sms)
            key = TC_MODE_KEYS[mode]
            variants[(name, rerank)] = (variant, kt, key)
            if r["launches"][key] < r["dispatches"] or r["dispatches"] < 1:
                raise AssertionError(f"gate d: {name} rerank={rerank} {clients} client(s): "
                                     f"{r['launches']} over {r['dispatches']} dispatches")
        hlog("gate d: every dispatch launched dense_topk on the tensor cores: " + "; ".join(
            f"{n_} use_rerank={rr_} {v} ({key}) at kt {kt} (per-tile cap "
            f"{engines[n_].index._per_tile_k})"
            for (n_, rr_), (v, kt, key) in variants.items()))

        # gate b: each single-client answer equals a direct call on the same
        # engine: search_batch(hybrid) of the flow's recall depth, then, for
        # a reranked request, the RerankService over those candidates ->
        # top_k (an unreranked one keeps the hybrid hits, scores and all)
        worst = 0.0
        for name in colls:
            eng = engines[name]
            for rerank in (False, True):
                depth = HTTP_CANDIDATES if rerank else HTTP_TOP_K
                for q, its in zip(queries, served[(name, rerank)]):
                    cand = eng.search_batch([q], mode="hybrid", top_k=depth,
                                            candidates=depth)[0]
                    if not rerank:
                        want = [(h.metadata["document_id"], h.row, h.recall_type, h.score)
                                for h in cand[:HTTP_TOP_K]]
                        got = [(it["metadata"]["document_id"], it["metadata"]["row"],
                                it["recall_type"], it["score"]) for it in its]
                        if got != want:
                            raise AssertionError(f"gate b: {name} unreranked: served "
                                                 f"{got} != direct {want} for {q!r}")
                        continue
                    scores = np.asarray(reranker(q, [h.text for h in cand]))
                    order = np.argsort(-scores)[:HTTP_TOP_K]
                    want = [(cand[int(i)].metadata["document_id"], cand[int(i)].row,
                             "reranked") for i in order]
                    got = [(it["metadata"]["document_id"], it["metadata"]["row"],
                            it["recall_type"]) for it in its]
                    if got != want:
                        raise AssertionError(f"gate b: {name} rerank={rerank}: served "
                                             f"{got} != direct {want} for {q!r}")
                    worst = max(worst, _close(torch.tensor([it["score"] for it in its]),
                                              torch.tensor([float(scores[int(i)])
                                                            for i in order]), 2e-2))
        hlog(f"gate b: all {sum(len(v) for v in served.values())} single-client answers "
             f"equal a direct "
             f"search_batch (unreranked: items, rows, recall types and scores to the "
             f"bit) or search_batch + RerankService in-process (reranked: items, rows, "
             f"recall types; scores within {worst:.3g} (1 + |s|), limit 2e-2)")

        # the kernel at the largest served batch of each run, against its
        # plain version: four rows, each collection unreranked (kt 5) and
        # reranked (kt as calibrated)
        for (name, rerank), (variant, _, key) in variants.items():
            mine = [r for (n_, rr_, _), r in runs.items() if n_ == name and rr_ == rerank]
            row = _served_kernel_row(calls[(name, rerank)],
                                     sum(r["launches"][key] for r in mine),
                                     sum(r["dispatches"] for r in mine), hlog)
            tag = {"default": "bf16"}.get(name, name)
            results[f"dense_topk_http_{tag}{'_rerank' if rerank else ''}"] = row

        # the deep selection: a direct search_dense(k = HTTP_DEEP_K) over the
        # default collection's engine (the flat scan at the exact per-tile
        # depth, kt = k > 128), one sorted-selection launch in its mode,
        # against the same call on the plain version
        eng = engines["default"]
        q_deep = eng._embed(queries[:HTTP_DEEP_QUERIES])
        deep_calls: dict = {}
        c0 = _counts()
        with mock.patch.object(dt, "tile_topk", _recording(deep_calls, "tile", dt.tile_topk)):
            dv, di = eng.index.search_dense(q_deep, k=HTTP_DEEP_K)
        torch.cuda.synchronize()
        moved = {k: v - c0[k] for k, v in _counts().items() if v - c0[k]}
        dargs = deep_calls["tile"]
        d_mode = dt._mode(dargs[0], dargs[2])
        if moved != {"dense_topk_tc": 1, TC_MODE_KEYS[d_mode]: 1} or dargs[8] != HTTP_DEEP_K:
            raise AssertionError(f"gate d: search_dense(k={HTTP_DEEP_K}) launched {moved} "
                                 f"at kt {dargs[8]}")
        with mock.patch.object(dt, "tile_topk", dt.tile_topk_plain):
            pdv, pdi = eng.index.search_dense(q_deep, k=HTTP_DEEP_K)
        deep_err = _compare(dv[None], di[None], pdv[None], pdi[None], exact=False,
                            tol=_tolerance(dargs[0].shape[1], pdv),
                            scores=dt.plain_scores(*dargs[:6], 0, dargs[6]))
        if tuple(di.shape) != (HTTP_DEEP_QUERIES, HTTP_DEEP_K) or not bool(
                torch.isfinite(dv).all()):
            raise AssertionError(f"gate d: search_dense(k={HTTP_DEEP_K}) answered "
                                 f"{tuple(di.shape)}, finite {bool(torch.isfinite(dv).all())}")
        row = _served_kernel_row(dargs, 1, 1, hlog)
        row["variant"] = TCS_DEEP_VARIANT
        results["dense_topk_deep"] = row
        hlog(f"gate d: search_dense(k={HTTP_DEEP_K}) over the default collection "
             f"({dargs[6]} rows, B={HTTP_DEEP_QUERIES}): one sorted-selection launch in "
             f"mode {d_mode} at kt {dargs[8]} (the deep selection), its top-{HTTP_DEEP_K} "
             f"within the tolerance of the plain version's (max |diff| {deep_err:.3g}), "
             f"ids equal but at near-ties")

        # -- one reranked request split into stages, by wrapped methods
        stage_rows = {}
        for name, cid in colls.items():
            staged = HTTP_STAGE_REQUESTS // share[name]
            st_ = _Stages()
            st_.wrap_async(HttpServer, "_dispatch", "dispatch")
            st_.wrap_async(CollectionService, "execute_search", "execute_search")
            st_.wrap_async(NodeflowEngine, "execute_nodeflow", "nodeflow")
            st_.wrap_async(QueryBatcher, "search", "batcher")
            st_.wrap_sync(CollectionEngine, "search_batch", "search_batch")
            st_.wrap_sync(CollectionEngine, "_embed", "embed", sync=True)
            st_.wrap_sync(DeviceIndex, "search_hybrid", "search_hybrid", sync=True)
            st_.wrap_sync(RerankService, "__call__", "rerank")
            client_ms = []
            with st_:
                for q in queries[:staged]:
                    t1 = time.perf_counter()
                    _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                                    {"query": q}), 201, "staged search")
                    client_ms.append((time.perf_counter() - t1) * 1e3)
            # the server's dispatch wrapper records its time after the
            # response is written, so the client may see it first
            deadline = time.perf_counter() + 5.0
            while (len(st_.ms.get("dispatch", ())) < staged
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
            ms = {k: np.asarray(v) for k, v in st_.ms.items()}
            ms["client"] = np.asarray(client_ms)
            if any(len(v) != staged for v in ms.values()):
                raise AssertionError(f"stage counts {({k: len(v) for k, v in ms.items()})}")
            split = {
                "client total": ms["client"],
                "HTTP + client (outside the handler)": ms["client"] - ms["dispatch"],
                "route + auth + audit + sqlite": ms["dispatch"] - ms["execute_search"],
                "service set-up (collection, reranker)": ms["execute_search"] - ms["nodeflow"],
                "nodeflow (engine, templates, models)": (ms["nodeflow"] - ms["batcher"]
                                                         - ms["rerank"]),
                "batcher wait": ms["batcher"] - ms["search_batch"],
                "device search (search_batch)": ms["search_batch"],
                "  embed (query encoder)": ms["embed"],
                "  search_hybrid (dense_topk + BM25 + RRF)": ms["search_hybrid"],
                "  hits (host)": ms["search_batch"] - ms["embed"] - ms["search_hybrid"],
                "rerank (CrossEncoder, 100 pairs)": ms["rerank"],
            }
            stage_rows[name] = {k: float(np.median(v)) for k, v in split.items()}
            hlog(f"stages of one served request ({name}, use_rerank=True, median of "
                 f"{staged}): " + "; ".join(
                     f"{k.strip()} {v:.3f} ms" for k, v in stage_rows[name].items()))

        # -- gate e: a deleted document's rows leave the search
        cid = colls["default"]
        q0 = next(q for q, its in zip(queries, served[("default", False)]) if its)
        first = _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                                {"query": q0, "use_rerank": False}), 201, "search")
        did = first["items"][0]["metadata"]["document_id"]
        _expect(*c.call("DELETE", f"/api/v1/documents/{did}"), 204, "delete")
        right_after = _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                                      {"query": q0, "use_rerank": False}), 201, "search")
        stale = sum(it["metadata"]["document_id"] == did for it in right_after["items"])
        t1 = time.perf_counter()
        if not srv.app.ctx.scheduler.wait_idle(120):
            raise AssertionError("gate e: the delete task did not drain")
        drained_ms = (time.perf_counter() - t1) * 1e3
        hits_of_did = [q for q, its in zip(queries, served[("default", True)])
                       if any(it["metadata"]["document_id"] == did for it in its)]
        for q in [q0] + hits_of_did[:16]:
            out = _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                                  {"query": q}), 201, "search")
            if any(it["metadata"]["document_id"] == did for it in out["items"]):
                raise AssertionError(f"gate e: deleted document {did} still served for {q!r}")
        _expect(*c.call("GET", f"/api/v1/documents/{did}"), 404, "deleted document")
        hlog(f"gate e: DELETE /api/v1/documents/{{did}} answered 204; the search right "
             f"after it still held {stale} of its rows (the ThreadScheduler deletes on "
             f"its device worker; drained {drained_ms:.1f} ms later); after the drain "
             f"none of its rows is served for {1 + len(hits_of_did[:16])} queries that "
             f"had them")

        # -- gate f: stop (snapshot), a fresh App on the same data_dir
        restart_q = {name: queries[:HTTP_RESTART_QUERIES // share[name]] for name in colls}
        before = {}
        for name, cid in colls.items():
            before[name] = [_expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                                            {"query": q}), 201, "search")["items"]
                            for q in restart_q[name]]
        c.close()
        t1 = time.perf_counter()
        srv.stop()
        apps.remove(srv)
        stop_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        srv = _AppThread(settings)
        apps.append(srv)
        start_s = time.perf_counter() - t1
        port = srv.app.port
        token = _login(port)
        c = _Client(port, token)
        worst = 0.0
        first_ms = None
        for name, cid in colls.items():
            for q, want in zip(restart_q[name], before[name]):
                t1 = time.perf_counter()
                got = _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                                      {"query": q}), 201, "search after restart")["items"]
                if first_ms is None:
                    first_ms = (time.perf_counter() - t1) * 1e3
                key = lambda its: [(it["metadata"]["document_id"], it["metadata"]["row"],  # noqa: E731
                                    it["recall_type"]) for it in its]
                if key(got) != key(want):
                    raise AssertionError(f"gate f: {name} after restart {key(got)} != "
                                         f"{key(want)} for {q!r}")
                worst = max(worst, _close(torch.tensor([it["score"] for it in got]),
                                          torch.tensor([it["score"] for it in want]), 2e-2))
        c.close()
        hlog(f"gate f: App.stop() (snapshots) {stop_s:.3f} s; a fresh App on the same "
             f"data_dir started in {start_s:.3f} s and, after a new login, answered "
             f"{sum(map(len, restart_q.values()))} searches with the same items (first request "
             f"{first_ms:.3f} ms; scores within {worst:.3g} (1 + |s|), limit 2e-2)")

        # gate c: no degrade anywhere in the phase
        if errors.records:
            raise AssertionError(f"gate c: {len(errors.records)} ERROR records: "
                                 f"{errors.records[:3]}")
        results["http"] = {"ingest": ingest, "runs": {f"{k[0]}/rerank={k[1]}/clients={k[2]}": v
                                                      for k, v in runs.items()},
                           "stages": stage_rows}
        hlog("gates a-f passed; no ERROR record from the port's loggers")
    finally:
        if c is not None:
            c.close()  # the server's stop waits for its open connections
        for app in apps:
            app.stop()
        port_logger.removeHandler(errors)
        shutil.rmtree(tmp, ignore_errors=True)


# -- [docs]: the rest of the search and document routes ------------------------

def smooth_images(count: int, size: int, seed: int) -> list:
    """``count`` distinct [size, size, 3] uint8 images: a few seeded
    low-frequency waves per channel, no two alike."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = []
    for _ in range(count):
        img = np.zeros((size, size, 3), np.float32)
        for c in range(3):
            for _ in range(3):
                fx, fy = rng.uniform(0.5, 6.0, 2)
                ph = rng.uniform(0, 2 * np.pi)
                img[..., c] += np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
        img = (img - img.min()) / (img.max() - img.min() + 1e-6) * 255.0
        out.append(img.astype(np.uint8))
    return out


def png_file(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG (filter type Sub on every row) with zlib and struct."""
    import struct
    import zlib

    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(np.int16)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]
    raw = np.concatenate([np.ones((h, 1), np.uint8), (sub & 0xFF).astype(np.uint8)],
                         axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def bmp_file(img: np.ndarray) -> bytes:
    """A 24-bit bottom-up BI_RGB BMP with struct."""
    import struct

    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    body = b"".join(r.tobytes() + bytes(stride - w * 3) for r in img[::-1, :, ::-1])
    return (b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body), 2835, 2835, 0, 0)
            + body)


def photo_image(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w, 3] uint8 with what a photo has: smooth gradients, edges and
    sensor noise (seeded)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.3, 4.0, 2) / max(h, w)
            img[..., c] += 40 * np.sin(2 * np.pi * (fx * xx + fy * yy) + rng.uniform(0, 6.3))
    for _ in range(24):  # flat objects with hard edges
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + rng.integers(h // 20, h // 4), x0:x0 + rng.integers(w // 20, w // 4)] \
            += rng.uniform(-60, 60, 3)
    img += 128 + rng.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


_STD_Q = (np.array([  # ITU T.81 K.1, natural order
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32))


def jpeg_file(img: np.ndarray, quality: int = 90) -> bytes:
    """A baseline JPEG (JFIF, 4:2:0, libjpeg's quality scaling of the K.1
    tables, the K.3 Huffman tables) of an [h, w, 3] uint8 image, encoded
    with numpy: float DCT, then vectorized Huffman coding and bit packing."""
    import struct

    from super_rag_tpu_torch.models.image_decode import _STD_HUFFMAN, _ZIGZAG

    h, w, _ = img.shape
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((q * scale + 50) // 100, 1, 255) for q in _STD_Q]
    f = img.astype(np.float32)
    ycc = [0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
           -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128,
           0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128]
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    ycc = [np.pad(p, ((0, H - h), (0, W - w)), mode="edge") for p in ycc]
    ycc[1:] = [p.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3)) for p in ycc[1:]]
    k = np.arange(8)
    dct = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / 16) * np.sqrt(2 / 8)
    dct[0] /= np.sqrt(2)
    zz = []
    for ci, p in enumerate(ycc):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        coef = np.einsum("uy,abyx,vx->abuv", dct, blocks, dct).reshape(bh, bw, 64)
        q = qts[0 if ci == 0 else 1]
        zz.append(np.rint(coef / q)[..., _ZIGZAG].astype(np.int64))
    # MCU order: Y00 Y01 Y10 Y11 Cb Cr
    my, mx = H // 16, W // 16
    y = zz[0].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    seq = np.concatenate([y, zz[1].reshape(-1, 1, 64), zz[2].reshape(-1, 1, 64)], axis=1)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    seq = seq.reshape(-1, 64)
    # Huffman code tables: symbol -> (code, length)
    tabs = {}
    for (cls, slot), (counts, syms) in _STD_HUFFMAN.items():
        counts, syms = bytes.fromhex(counts), bytes.fromhex(syms)
        code, k2, ctab, ltab = 0, 0, np.zeros(256, np.int64), np.zeros(256, np.int64)
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                ctab[syms[k2]], ltab[syms[k2]] = code, length
                code += 1
                k2 += 1
            code <<= 1
        tabs[(cls, slot)] = (ctab, ltab)

    def size_bits(v):
        a = np.abs(v)
        s = np.zeros_like(a)
        nz = a > 0
        s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
        return s, np.where(v < 0, v + (1 << s) - 1, v)

    slot = (comp > 0).astype(np.int64)
    dc = seq[:, 0].copy()
    diff = np.empty_like(dc)
    for c in range(3):
        at = np.flatnonzero(comp == c)
        diff[at] = np.diff(dc[at], prepend=0)
    keys, vals, lens = [], [], []
    s, extra = size_bits(diff)
    for sl in (0, 1):
        m = slot == sl
        ctab, ltab = tabs[(0, sl)]
        keys.append(np.flatnonzero(m) * 4096)
        vals.append((ctab[s[m]] << s[m]) | extra[m])
        lens.append(ltab[s[m]] + s[m])
    b, kk = np.nonzero(seq[:, 1:])
    kk = kk + 1
    prev = np.zeros_like(kk)
    same = np.r_[False, b[1:] == b[:-1]]
    prev[same] = kk[:-1][same[1:]]
    run = kk - prev - 1
    v = seq[b, kk]
    s, extra = size_bits(v)
    sl = slot[b]
    for t in (0, 1):
        m = sl == t
        ctab, ltab = tabs[(1, t)]
        sym = ((run[m] % 16) << 4) | s[m]
        keys.append(b[m] * 4096 + kk[m] * 32 + 4)
        vals.append((ctab[sym] << s[m]) | extra[m])
        lens.append(ltab[sym] + s[m])
        z = run[m] // 16  # ZRL symbols before this one
        zb = np.repeat(np.flatnonzero(m), z)
        if zb.size:
            j = np.arange(zb.size) - np.repeat(np.cumsum(z) - z, z)
            keys.append(b[zb] * 4096 + kk[zb] * 32 + j)
            vals.append(np.full(zb.size, ctab[0xF0]))
            lens.append(np.full(zb.size, ltab[0xF0]))
    last = np.zeros(len(seq), np.int64)
    np.maximum.at(last, b, kk)
    eob = np.flatnonzero(last < 63)
    for t in (0, 1):
        m = slot[eob] == t
        ctab, ltab = tabs[(1, t)]
        keys.append(eob[m] * 4096 + 64 * 32)
        vals.append(np.full(m.sum(), ctab[0]))
        lens.append(np.full(m.sum(), ltab[0]))
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    bits = np.ones(-(-total // 8) * 8, np.uint8)  # the last byte padded with 1s
    step = 1 << 18
    for a in range(0, len(vals), step):
        vv, ll, ee = vals[a:a + step, None], lens[a:a + step, None], ends[a:a + step, None]
        j = np.arange(27)[None, :]
        ok = j < ll
        bits[(ee - ll + j)[ok]] = ((vv >> np.maximum(ll - 1 - j, 0)) & 1)[ok]
    data = np.packbits(bits)
    data = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(qts):
        out += seg(0xDB, bytes([t]) + bytes(q[_ZIGZAG].astype(np.uint8)))
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for (cls, sl), (counts, syms) in sorted(_STD_HUFFMAN.items()):
        out += seg(0xC4, bytes([cls << 4 | sl]) + bytes.fromhex(counts) + bytes.fromhex(syms))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + data + b"\xff\xd9"


def _archive(kind: str, files: list) -> bytes:
    import io
    import tarfile
    import zipfile

    buf = io.BytesIO()
    if kind == "zip":
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for name, data in files:
                z.writestr(name, data)
    else:
        with tarfile.open(fileobj=buf, mode="w:gz") as t:
            for name, data in files:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _raw(port: int, token: str, method: str, path: str, body: bytes = None,
         headers: dict = None):
    """One request with a raw body; returns (status, headers, bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        hdrs = {"Authorization": f"Bearer {token}", **(headers or {})}
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _post_files(port: int, token: str, path: str, files: list):
    boundary = "smokeB0undary7"
    raw = b"".join((f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                    f"filename=\"{name}\"\r\nContent-Type: application/octet-stream"
                    "\r\n\r\n").encode() + data + b"\r\n" for name, data in files)
    raw += f"--{boundary}--\r\n".encode()
    st, _, out = _raw(port, token, "POST", path, raw,
                      {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    return st, json.loads(out)


def _wait_complete(c, cid: str, count: int, what: str, t_first: float) -> float:
    while True:
        listing = _expect(*c.call("GET", f"/api/v1/collections/{cid}/documents?limit=1000"), 200,
                          "list documents")
        status = [d["status"] for d in listing]
        if "FAILED" in status:
            bad = [d for d in listing if d["status"] == "FAILED"][:1]
            raise AssertionError(f"a document of {what} FAILED: {bad}")
        if len(status) == count and set(status) == {"COMPLETE"}:
            return time.perf_counter() - t_first
        if time.perf_counter() - t_first > HTTP_INGEST_TIMEOUT_S:
            raise AssertionError(f"ingest of {what} not complete after "
                                 f"{HTTP_INGEST_TIMEOUT_S} s: {status.count('COMPLETE')} "
                                 f"of {count}")
        time.sleep(0.05)


def _upload_text(port: int, token: str, cid: str, docs: list) -> None:
    """Half the documents through documents/upload + documents/confirm,
    half in one .zip through POST documents."""
    half = len(docs) // 2
    staged = _expect(*_post_files(port, token, f"/api/v1/collections/{cid}/documents/upload",
                                  [(n, t.encode()) for n, t in docs[:half]]), 201, "stage")
    c = _Client(port, token)
    try:
        _expect(*c.call("POST", f"/api/v1/collections/{cid}/documents/confirm", staged),
                201, "confirm")
    finally:
        c.close()
    _expect(*_post_files(port, token, f"/api/v1/collections/{cid}/documents",
                         [("text.zip", _archive("zip", [(n, t.encode())
                                                        for n, t in docs[half:]]))]),
            201, "zip upload")


def phase_docs(results: dict) -> None:
    """The rest of the search and document routes on the port's own App,
    with the process ingest backend (DOCS_WORKERS worker subprocesses, the
    device commit in the App's process) and a local object store: text
    documents through the two-phase upload and a .zip, images through the
    two-phase upload, a .zip and a .tar.gz into a collection with the
    vision index; the same text under the thread backend for gate a;
    image searches on the card (dense_topk); gates a-f."""
    import base64
    import dataclasses
    import hashlib
    import shutil
    import tempfile

    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.models.encoder import flax_params
    from super_rag_tpu_torch.models.encoder_service import EncoderService, save_params
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.tasks.scheduler import ProcessScheduler, ThreadScheduler

    card = results["card"]

    def dlog(msg: str) -> None:
        log(f"[docs] {msg} (on {card})")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_docs_")
    apps: list = []
    c = None
    try:
        t0 = time.perf_counter()
        cfg = semantic_config(torch.bfloat16)
        enc = EncoderService(cfg, max_len=cfg.max_len, seed=SEED, device=DEVICE)
        save_params(flax_params(enc.model), os.path.join(tmp, "enc"), cfg)
        del enc
        base = dataclasses.replace(
            Settings(), port=0, batch_max=64, default_top_k=HTTP_TOP_K,
            rerank_candidates=HTTP_CANDIDATES, chunk_size=400, encoder_checkpoint="",
            reranker_checkpoint="", ingest_host_workers=DOCS_WORKERS)
        embedding = {"provider": "onboard", "model": os.path.join(tmp, "enc")}
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
        docs, queries = http_corpus(gen, DOCS_TEXT_DOCS, DOCS_TEXT_SECTIONS)
        imgs = smooth_images(DOCS_IMAGES, DOCS_IMAGE_SIZE, SEED + 12)
        n_png = DOCS_IMAGES * 3 // 4
        files = ([(f"img{i:03d}.png", png_file(im)) for i, im in enumerate(imgs[:n_png])]
                 + [(f"img{i:03d}.bmp", bmp_file(im))
                    for i, im in enumerate(imgs[n_png:], n_png)])
        del imgs
        asset_of = {name: hashlib.sha256(data).hexdigest()[:16] for name, data in files}
        if len(set(asset_of.values())) != len(files):
            raise AssertionError("two images share their bytes")
        dlog(f"set-up: encoder checkpoint ({cfg.num_layers} x {cfg.hidden_dim}, bf16), "
             f"{len(docs)} markdown documents x {DOCS_TEXT_SECTIONS} sections, "
             f"{n_png} PNG + {len(files) - n_png} BMP images of {DOCS_IMAGE_SIZE} x "
             f"{DOCS_IMAGE_SIZE} ({sum(len(d) for _, d in files) / 2**20:.1f} MiB) in "
             f"{time.perf_counter() - t0:.2f} s")

        # -- the thread backend: the same text documents, for gate a
        chunks_by_backend: dict = {}
        ingest: dict = {}
        for backend in ("thread", "process"):
            settings = dataclasses.replace(base, data_dir=os.path.join(tmp, backend),
                                           ingest_backend=backend)
            srv = _AppThread(settings)
            apps.append(srv)
            port = srv.app.port
            want = ProcessScheduler if backend == "process" else ThreadScheduler
            if type(srv.app.ctx.scheduler) is not want:
                raise AssertionError(f"the {backend} backend runs "
                                     f"{type(srv.app.ctx.scheduler).__name__}")
            c = _Client(port)
            _expect(*c.call("POST", "/api/v1/auth/register",
                            {"username": "smoke", "password": "smoke-password"}), 201,
                    "register")
            c.close()
            token = _login(port)
            c = _Client(port, token)
            tcid = _expect(*c.call("POST", "/api/v1/collections",
                                   {"title": "text", "config": {"embedding": embedding}}),
                           201, "create collection")["id"]
            t_first = time.perf_counter()
            _upload_text(port, token, tcid, docs)
            wall = _wait_complete(c, tcid, len(docs), f"text ({backend})", t_first)
            listing = _expect(*c.call("GET", f"/api/v1/collections/{tcid}/documents?limit=1000"), 200,
                              "list")
            chunks_by_backend[backend] = {
                d["name"]: [ch["text"] for ch in _expect(*c.call(
                    "GET", f"/api/v1/documents/{d['id']}/chunks"), 200, "chunks")]
                for d in listing}
            n_chunks = sum(len(v) for v in chunks_by_backend[backend].values())
            ingest[backend] = {"chunks": n_chunks, "s": wall, "chunks_per_s": n_chunks / wall}
            dlog(f"ingest, {backend} backend ({DOCS_WORKERS} host workers): {len(docs)} "
                 f"documents (half staged + confirmed, half in one .zip), {n_chunks} chunks, "
                 f"every document COMPLETE after {wall:.3f} s: {n_chunks / wall:.0f} chunks/s")
            if backend == "thread":
                c.close()
                c = None
                srv.stop()
                apps.remove(srv)

        # gate a: the same chunk texts under both backends
        if chunks_by_backend["process"] != chunks_by_backend["thread"]:
            bad = [n for n in chunks_by_backend["thread"]
                   if chunks_by_backend["process"].get(n) != chunks_by_backend["thread"][n]]
            raise AssertionError(f"gate a: chunk texts differ between the process and thread "
                                 f"backends for {bad[:3]}")
        dlog(f"gate a: the {len(docs)} documents' chunk texts under the process backend "
             f"equal the thread backend's ({ingest['process']['chunks']} chunks)")

        # -- the image collection (vision index), through the process backend
        icid = _expect(*c.call("POST", "/api/v1/collections",
                               {"title": "images", "config": {"embedding": embedding,
                                                              "enable_vision": True}}),
                       201, "create image collection")["id"]
        pngs, bmps = files[:n_png], files[n_png:]
        t_first = time.perf_counter()
        staged = _expect(*_post_files(port, token,
                                      f"/api/v1/collections/{icid}/documents/upload",
                                      pngs[:32]), 201, "stage images")
        _expect(*c.call("POST", f"/api/v1/collections/{icid}/documents/confirm", staged),
                201, "confirm images")
        _expect(*_post_files(port, token, f"/api/v1/collections/{icid}/documents",
                             [("images.zip", _archive("zip", pngs[32:]))]), 201, "zip")
        _expect(*_post_files(port, token, f"/api/v1/collections/{icid}/documents",
                             [("images.tar.gz", _archive("tar.gz", bmps))]), 201, "tar.gz")
        img_wall = _wait_complete(c, icid, len(files), "images", t_first)
        listing = _expect(*c.call("GET", f"/api/v1/collections/{icid}/documents?limit=1000"), 200, "list")
        did_of = {d["name"]: d["id"] for d in listing}
        eng = srv.app.ctx.engines.get(icid)
        vision_rows = sum(1 for m in eng.index.row_meta if m is not None and m.get("asset_id"))
        if vision_rows != len(files):
            raise AssertionError(f"gate: {vision_rows} vision rows, expected {len(files)}")
        if eng.index.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"the image index lives on {eng.index.device}")
        dlog(f"ingest, process backend: {len(files)} images (32 PNG staged + confirmed, "
             f"{len(pngs) - 32} PNG in one .zip, {len(bmps)} BMP in one .tar.gz), vector + "
             f"vision indexes, every document COMPLETE after {img_wall:.3f} s: "
             f"{len(files) / img_wall:.1f} images/s; {vision_rows} vision rows "
             f"({eng.index.live_count} live rows, {str(eng.index.spec.dtype)[6:]} index, "
             f"D = {eng.index.spec.dim})")

        # -- gate b: image searches over HTTP, each equal to a direct call
        blob = dict(files)
        n_png = DOCS_IMAGE_QUERIES * 3 // 4  # three PNG to one BMP
        n_bmp = DOCS_IMAGE_QUERIES - n_png
        picks = (pngs[:: max(1, len(pngs) // n_png)][:n_png]
                 + bmps[:: max(1, len(bmps) // n_bmp)][:n_bmp])
        calls: dict = {}
        real_tile_topk = dt.tile_topk

        def keep(*args):
            calls["last"] = args
            return real_tile_topk(*args)

        lat = []
        served = []
        _reset_counts()
        counts0 = _counts()
        with mock.patch.object(dt, "tile_topk", keep):
            for name, data in picks:
                body = {"image_base64": base64.b64encode(data).decode(),
                        "top_k": HTTP_TOP_K}
                t1 = time.perf_counter()
                out = _expect(*c.call("POST", f"/api/v1/collections/{icid}/searches/image",
                                      body), 201, "image search")
                lat.append((time.perf_counter() - t1) * 1e3)
                served.append((name, out["items"]))
        torch.cuda.synchronize()
        launched = {k: v - counts0[k] for k, v in _counts().items() if v - counts0[k]}
        mode = dt._mode(calls["last"][0], calls["last"][2])
        key = TC_MODE_KEYS[mode]
        if launched.get(key, 0) != len(picks) or launched.get("dense_topk_tc", 0) != len(picks):
            raise AssertionError(f"gate b: {len(picks)} image searches launched {launched}")
        for name, items in served:
            if not items or items[0]["asset_id"] != asset_of[name] \
                    or items[0]["document_id"] != did_of[name]:
                raise AssertionError(f"gate b: the image search for {name} answered "
                                     f"{items[:1]}, expected asset {asset_of[name]}")
            direct = eng.search_by_image(blob[name], top_k=HTTP_TOP_K)
            want = [(h.metadata.get("asset_id"), h.metadata.get("document_id"), h.score)
                    for h in direct]
            got = [(it["asset_id"], it["document_id"], it["score"]) for it in items]
            if got != want:
                raise AssertionError(f"gate b: served {got} != direct {want} for {name}")
        row = _served_kernel_row(calls["last"], launched[key], len(picks), dlog)
        results["dense_topk"]["http_image"] = {
            k: row[k] for k in ("variant", "ms", "launches", "bound_ms", "bound_by",
                                "plain_ms", "library_ms", "max_abs_err")}
        results["dense_topk_http_image"] = row
        dlog(f"gate b: {len(picks)} POST searches/image ({sum(n.endswith('.png') for n, _ in picks)}"
             f" PNG, {sum(n.endswith('.bmp') for n, _ in picks)} BMP), each 201 with its own "
             f"asset first and the items of a direct search_by_image (ids, scores to the bit); "
             f"{launched[key]} {row['variant']} dense_topk launches ({key}); one client p50 "
             f"{_pctl(lat, 50):.3f} ms, p99 {_pctl(lat, 99):.3f} ms")

        # -- gate c: assets, preview, object, ranges, scope
        for name, data in picks[:8]:
            st, hdrs, out = _raw(port, token, "GET",
                                 f"/api/v1/collections/{icid}/assets/{asset_of[name]}")
            if st != 200 or out != data:
                raise AssertionError(f"gate c: asset of {name}: HTTP {st}, "
                                     f"{len(out)} of {len(data)} bytes")
            did = did_of[name]
            for path in (f"/api/v1/documents/{did}/preview",
                         f"/api/v1/collections/{icid}/documents/{did}/preview",
                         f"/api/v1/collections/{icid}/documents/{did}/object"):
                for rng, want_st, want in ((None, 200, data), ("bytes=10-99", 206, data[10:100]),
                                           ("bytes=-50", 206, data[-50:]),
                                           ("bytes=x-y", 200, data)):
                    st, hdrs, out = _raw(port, token, "GET", path, None,
                                         {"Range": rng} if rng else None)
                    if st != want_st or out != want:
                        raise AssertionError(f"gate c: {path} Range {rng}: HTTP {st}, "
                                             f"{len(out)} bytes")
                    if st == 206:
                        lo = 10 if rng == "bytes=10-99" else len(data) - 50
                        hi = 99 if rng == "bytes=10-99" else len(data) - 1
                        if hdrs.get("content-range") != f"bytes {lo}-{hi}/{len(data)}":
                            raise AssertionError(f"gate c: Content-Range "
                                                 f"{hdrs.get('content-range')}")
            st, _, _ = _raw(port, token, "GET", f"/api/v1/collections/{icid}/documents/"
                            f"{did}/object?path=../../x")
            if st != 403:
                raise AssertionError(f"gate c: ?path=../../x answered {st}")
        dlog("gate c: 8 assets return their uploaded bytes; preview (flat, nested) and "
             "object answer 200 with the whole body, 206 with the slice and Content-Range "
             "for bytes=10-99 and bytes=-50, 200 for a malformed range; ?path=../../x 403")

        # -- gate d: rebuild four image documents
        rebuilt = picks[:4]
        for name, _ in rebuilt:
            out = _expect(*c.call("POST", f"/api/v1/documents/{did_of[name]}/rebuild_indexes"),
                          200, "rebuild")
            if out != {"rebuilt": 2}:
                raise AssertionError(f"gate d: rebuild of {name} answered {out}")
        t1 = time.perf_counter()
        _wait_complete(c, icid, len(files), "rebuilt images", t1)
        srv.app.ctx.scheduler.wait_idle(120)
        _wait_complete(c, icid, len(files), "rebuilt images", t1)
        rebuild_s = time.perf_counter() - t1
        for name, data in rebuilt:
            out = _expect(*c.call("POST", f"/api/v1/collections/{icid}/searches/image",
                                  {"image_base64": base64.b64encode(data)
                                   .decode()}), 201, "image search")
            if out["items"][0]["asset_id"] != asset_of[name]:
                raise AssertionError(f"gate d: after the rebuild {name} answers "
                                     f"{out['items'][:1]}")
        out = _expect(*c.call("POST", f"/api/v1/collections/{icid}/rebuild_failed_indexes"),
                      200, "rebuild failed")
        if out != {"rebuilt": 0}:
            raise AssertionError(f"gate d: rebuild_failed_indexes answered {out}")
        dlog(f"gate d: rebuild_indexes on 4 image documents: COMPLETE again after "
             f"{rebuild_s:.3f} s, each still its own top-1; rebuild_failed_indexes "
             f"{{\"rebuilt\": 0}}")

        # -- gate e: bulk delete
        victims = [n for n, _ in picks[8:16]]
        n_docs = len(did_of)
        st, out = c.call("DELETE", f"/api/v1/collections/{icid}/documents",
                         {"document_ids": [did_of[victims[0]], "no-such-document"]})
        _expect(st, out, 404, "bulk delete with an unknown id")
        left = _expect(*c.call("GET", f"/api/v1/collections/{icid}/documents?limit=1000"), 200, "list")
        if len(left) != n_docs:
            raise AssertionError(f"gate e: a refused batch deleted {n_docs - len(left)}")
        out = _expect(*c.call("DELETE", f"/api/v1/collections/{icid}/documents",
                              {"document_ids": [did_of[n] for n in victims]}), 200,
                      "bulk delete")
        if sorted(out["deleted"]) != sorted(did_of[n] for n in victims):
            raise AssertionError(f"gate e: bulk delete answered {out}")
        if not srv.app.ctx.scheduler.wait_idle(120):
            raise AssertionError("gate e: the delete tasks did not drain")
        gone = {asset_of[n] for n in victims}
        for name, data in picks[:24]:
            out = _expect(*c.call("POST", f"/api/v1/collections/{icid}/searches/image",
                                  {"image_base64": base64.b64encode(data)
                                   .decode(), "top_k": 20}), 201, "image search")
            if gone & {it["asset_id"] for it in out["items"]}:
                raise AssertionError(f"gate e: a deleted asset answers for {name}")
        dlog(f"gate e: a batch with one unknown id answered 404 and deleted nothing; "
             f"{len(victims)} image documents deleted in one batch leave every later "
             f"image search (24 queries, top 20)")

        # -- JPEG decode on the host, on photo-like images (printed, not gated)
        from super_rag_tpu_torch.models.image_decode import gray64

        photos = {}
        for i, (h, w) in enumerate(DOCS_PHOTOS):
            data = jpeg_file(photo_image(h, w, SEED + 13))
            if i >= DOCS_TIMED_PHOTOS:
                continue
            t1 = time.perf_counter()
            px = gray64(data)
            dec_s = time.perf_counter() - t1
            if px.shape != (64, 64) or not 0 < float(px.std()):
                raise AssertionError(f"the {w} x {h} photo decoded to {px.shape}, flat")
            photos[f"{w}x{h}"] = {"bytes": len(data), "decode_s": dec_s,
                                  "mpix_per_s": h * w / 1e6 / dec_s}
            dlog(f"JPEG decode (baseline, q90, 4:2:0, {len(data) * 8 / (h * w):.2f} bits a "
                 f"pixel) of a {w} x {h} photo-like image on the host: {dec_s:.3f} s, "
                 f"{h * w / 1e6 / dec_s:.2f} Mpixel/s")
        # one image search with the largest photo, and text searches meanwhile
        body = {"image_base64": base64.b64encode(data).decode(), "top_k": HTTP_TOP_K}
        text = {"query": queries[1], "use_rerank": False}
        quiet = []
        for _ in range(8):
            t1 = time.perf_counter()
            _expect(*c.call("POST", f"/api/v1/collections/{tcid}/searches", text), 201,
                    "text search")
            quiet.append((time.perf_counter() - t1) * 1e3)
        box: dict = {}

        def photo_search() -> None:
            pc = _Client(port, token)
            try:
                t2 = time.perf_counter()
                box["status"] = pc.call("POST", f"/api/v1/collections/{icid}/searches/image",
                                        body)[0]
                box["ms"] = (time.perf_counter() - t2) * 1e3
            finally:
                pc.close()

        worker = threading.Thread(target=photo_search)
        worker.start()
        during = []
        while worker.is_alive():
            t1 = time.perf_counter()
            _expect(*c.call("POST", f"/api/v1/collections/{tcid}/searches", text), 201,
                    "text search during the photo search")
            during.append((time.perf_counter() - t1) * 1e3)
        worker.join()
        if box.get("status") != 201:
            raise AssertionError(f"the photo's image search answered {box.get('status')}")
        photos["search_ms"] = box["ms"]
        photos["text_ms_alone_p50"] = _pctl(quiet, 50)
        photos["text_ms_during_p50"] = _pctl(during, 50) if during else None
        photos["text_ms_during_max"] = max(during) if during else None
        dlog(f"POST searches/image with the {w} x {h} photo: {box['ms']:.1f} ms; text "
             f"searches from another client meanwhile: {len(during)} answered, p50 "
             f"{photos['text_ms_during_p50'] or 0:.1f} ms, max "
             f"{photos['text_ms_during_max'] or 0:.1f} ms (alone p50 "
             f"{photos['text_ms_alone_p50']:.1f} ms)")

        # -- gate f: accounts
        key = _expect(*c.call("POST", "/api/v1/apikeys", {"description": "smoke"}), 201,
                      "create API key")
        kc = _Client(port, key["key"])
        try:
            _expect(*kc.call("POST", f"/api/v1/collections/{tcid}/searches",
                             {"query": queries[0], "use_rerank": False}), 201,
                    "search with an API key")
            _expect(*c.call("DELETE", f"/api/v1/apikeys/{key['id']}"), 204, "delete key")
            _expect(*kc.call("POST", f"/api/v1/collections/{tcid}/searches",
                             {"query": queries[0]}), 401, "search with a deleted key")
        finally:
            kc.close()
        _expect(*c.call("POST", "/api/v1/change-password",
                        {"old_password": "smoke-password", "new_password": "smoke-new-pw"}),
                200, "change-password")
        lc = _Client(port)
        try:
            _expect(*lc.call("POST", "/api/v1/auth/login",
                             {"username": "smoke", "password": "smoke-new-pw"}), 200,
                    "login with the new password")
            _expect(*lc.call("POST", "/api/v1/auth/login",
                             {"username": "smoke", "password": "smoke-password"}), 401,
                    "login with the old password")
        finally:
            lc.close()
        dlog("gate f: a search with a new API key answered 201 and 401 once the key was "
             "deleted; after change-password the new password logs in and the old does not")
        results["docs"] = {"ingest": ingest, "images": len(files), "images_s": img_wall,
                           "images_per_s": len(files) / img_wall,
                           "image_search_p50": _pctl(lat, 50),
                           "image_search_p99": _pctl(lat, 99), "photos": photos}
        dlog("gates a-f passed")
    finally:
        if c is not None:
            c.close()
        for app in apps:
            app.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# -- [graph]: the stdlib document parsers and the knowledge graph -------------

_G_STEMS = ("Northwind", "Contoso", "Fabrikam", "Adatum", "Litware", "Proseware",
            "Tailspin", "Wingtip", "Woodgrove", "Lucerne", "Alpine", "Coho", "Blue Yonder",
            "Consolidated", "Fourth Coffee", "Graphic Design", "Humongous", "Margie",
            "Nod", "Relecloud", "Southridge", "Trey", "VanArsdel", "Wide World", "Bellows",
            "Datum", "Fineart", "Kestrel", "Lamna", "Mistral", "Norrland", "Orchid",
            "Pinnacle", "Quillon", "Rainier", "Sable", "Tamarack", "Umber", "Vireo", "Zephyr")
_G_SUFFIXES = ("Labs", "Inc", "Systems", "Group", "Foundation", "Bank")
_G_FIRST = ("Alice", "Bruno", "Chen", "Dalia", "Emeka", "Freya", "Goran", "Hana", "Ivan",
            "Jonas", "Keiko", "Lucia", "Mateo", "Nadia", "Omar", "Priya")
_G_LAST = ("Okafor", "Lindqvist", "Moreau", "Tanaka", "Varga", "Quispe", "Haddad",
           "Novak", "Reyes", "Sato", "Fischer", "Mbeki", "Kowalski", "Dubois")
_G_PLACES = ("Silicon Valley", "Hudson Bay", "Rocky Mountains", "Kent County",
             "Jade Island", "Napa Valley", "Orange County", "Monterey Bay")
_G_PRODUCTS = ("Warehouse Robots", "Tensor Engines", "Cloud Ledgers", "Solar Arrays",
               "Medical Scanners", "Quantum Sensors", "Freight Drones", "Battery Packs")


def graph_sentences(rng, count: int, orgs: list, people: list) -> list:
    """``count`` sentences that the knowledge graph's heuristic extractor
    turns into one or two facts each: acquisitions, leadership (a
    functional relation: a person's later post invalidates the earlier),
    foundings in the passive, products, offices and support."""
    out = []
    for _ in range(count):
        kind = int(rng.integers(6))
        a, b = (orgs[int(i)] for i in rng.choice(len(orgs), 2, replace=False))
        p = people[int(rng.integers(len(people)))]
        year = int(rng.integers(1990, 2025))
        if kind == 0:
            out.append(f"{a} acquired {b} in {year}.")
        elif kind == 1:
            out.append(f"{p} leads {a} since {year}.")
        elif kind == 2:
            out.append(f"{a} was founded by {p} in {year}.")
        elif kind == 3:
            out.append(f"{a} develops {_G_PRODUCTS[int(rng.integers(len(_G_PRODUCTS)))]} "
                       f"for {b}.")
        elif kind == 4:
            out.append(f"{a} owns offices in {_G_PLACES[int(rng.integers(len(_G_PLACES)))]} "
                       f"since {year}.")
        else:
            out.append(f"{p} supports {a} and {b}.")
    return out


def _zip(files: dict) -> bytes:
    import io
    import zipfile

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for name, text in files.items():
            z.writestr(name, text)
    return buf.getvalue()


def _xml(text: str) -> str:
    return text.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


_OOXML_W = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
_OOXML_S = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
_OOXML_A = "http://schemas.openxmlformats.org/drawingml/2006/main"
_OOXML_P = "http://schemas.openxmlformats.org/presentationml/2006/main"


def docx_file(title: str, sentences: list) -> bytes:
    """word/document.xml: a heading, a paragraph per sentence, the last
    four sentences in a two-column table."""
    body, rest = sentences[:-4], sentences[-4:]
    paras = "".join(f"<w:p><w:r><w:t>{_xml(s)}</w:t></w:r></w:p>" for s in body)
    rows = "".join("<w:tr>" + "".join(f"<w:tc><w:p><w:r><w:t>{_xml(s)}</w:t></w:r></w:p></w:tc>"
                                      for s in rest[i:i + 2]) + "</w:tr>"
                   for i in range(0, len(rest), 2))
    doc = (f'<?xml version="1.0"?><w:document xmlns:w="{_OOXML_W}"><w:body>'
           f'<w:p><w:pPr><w:pStyle w:val="Heading1"/></w:pPr><w:r><w:t>{_xml(title)}'
           f"</w:t></w:r></w:p>{paras}<w:tbl>{rows}</w:tbl></w:body></w:document>")
    return _zip({"word/document.xml": doc})


def xlsx_file(sentences: list) -> bytes:
    """Two sheets, one sentence a row, through the shared-string table
    (first sheet) and inline strings (second)."""
    half = len(sentences) // 2
    shared = (f'<?xml version="1.0"?><sst xmlns="{_OOXML_S}">'
              + "".join(f"<si><t>{_xml(s)}</t></si>" for s in sentences[:half]) + "</sst>")
    sheet1 = "".join(f'<row r="{i + 1}"><c r="A{i + 1}" t="s"><v>{i}</v></c></row>'
                     for i in range(half))
    sheet2 = "".join(f'<row r="{i + 1}"><c r="B{i + 1}" t="inlineStr"><is><t>{_xml(s)}'
                     f"</t></is></c></row>" for i, s in enumerate(sentences[half:]))
    wrap = f'<?xml version="1.0"?><worksheet xmlns="{_OOXML_S}"><sheetData>{{}}</sheetData></worksheet>'
    return _zip({"xl/sharedStrings.xml": shared, "xl/worksheets/sheet1.xml": wrap.format(sheet1),
                 "xl/worksheets/sheet2.xml": wrap.format(sheet2)})


def pptx_file(sentences: list, per_slide: int = 6) -> bytes:
    slides = {}
    for j in range(0, len(sentences), per_slide):
        texts = "".join(f"<a:t>{_xml(s)}</a:t>" for s in sentences[j:j + per_slide])
        slides[f"ppt/slides/slide{j // per_slide + 1}.xml"] = (
            f'<?xml version="1.0"?><p:sld xmlns:p="{_OOXML_P}" xmlns:a="{_OOXML_A}">'
            f"<p:cSld>{texts}</p:cSld></p:sld>")
    return _zip(slides)


def cfb_file(streams: dict) -> bytes:
    """A version 3 OLE compound file ([MS-CFB]: 512-byte sectors, header
    DIFAT, FAT chains; streams under 4096 bytes in the mini stream)."""
    import struct

    sect, end, free = 512, 0xFFFFFFFE, 0xFFFFFFFF
    big = {n: d for n, d in streams.items() if len(d) >= 4096}
    small = {n: d for n, d in streams.items() if len(d) < 4096}
    mini, mini_fat, mini_start = bytearray(), [], {}
    for name, d in small.items():
        mini_start[name] = len(mini_fat)
        n = -(-len(d) // 64) or 1
        mini_fat += [len(mini_fat) + i + 1 for i in range(n - 1)] + [end]
        mini += d + b"\0" * ((-len(d)) % 64)
    sectors: list = []
    fat: list = []

    def add(data: bytes) -> int:
        start = len(sectors)
        n = -(-len(data) // sect) or 1
        for i in range(n):
            sectors.append(data[i * sect:(i + 1) * sect].ljust(sect, b"\0"))
            fat.append(start + i + 1)
        fat[-1] = end
        return start

    big_start = {name: add(d) for name, d in big.items()}
    mini_sec = add(bytes(mini)) if mini else end
    minifat_sec, n_minifat = end, 0
    if mini_fat:
        raw = struct.pack(f"<{len(mini_fat)}I", *mini_fat)
        minifat_sec, n_minifat = add(raw), -(-len(raw) // sect)

    def dirent(name: str, etype: int, start: int, size: int, child: int = free) -> bytes:
        raw = bytearray(128)
        enc = name.encode("utf-16-le")
        raw[:len(enc)] = enc
        struct.pack_into("<H", raw, 0x40, len(enc) + 2)
        raw[0x42], raw[0x43] = etype, 1
        struct.pack_into("<III", raw, 0x44, free, free, child)
        struct.pack_into("<IQ", raw, 0x74, start, size)
        return bytes(raw)

    entries = [dirent("Root Entry", 5, mini_sec, len(mini), child=1)]
    entries += [dirent(n, 2, big_start[n], len(d)) for n, d in big.items()]
    entries += [dirent(n, 2, mini_start[n], len(d)) for n, d in small.items()]
    dir_sec = add(b"".join(entries))
    n_fat = 1
    while (len(sectors) + n_fat) * 4 > n_fat * sect:
        n_fat += 1
    fat_sec = len(sectors)
    table = fat + [0xFFFFFFFD] * n_fat
    table += [free] * (n_fat * sect // 4 - len(table))
    raw = struct.pack(f"<{len(table)}I", *table)
    sectors += [raw[i * sect:(i + 1) * sect] for i in range(n_fat)]
    header = bytearray(512)
    header[:8] = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
    struct.pack_into("<HHHHH", header, 0x18, 0x3E, 3, 0xFFFE, 9, 6)
    struct.pack_into("<IIIIIIII", header, 0x2C, n_fat, dir_sec, 0, 4096, minifat_sec,
                     n_minifat, end, 0)
    difat = [fat_sec + i for i in range(n_fat)] + [free] * (109 - n_fat)
    struct.pack_into("<109I", header, 0x4C, *difat)
    return bytes(header) + b"".join(sectors)


def doc_file(sentences: list) -> bytes:
    """A Word 97 .doc: the FIB, one cp1252 piece (a paragraph per
    sentence) in the WordDocument stream, its piece table in 0Table."""
    import struct

    text = "\r".join(sentences) + "\r"
    raw = text.encode("cp1252")
    fc = 1024
    word = bytearray(max(2048, fc + len(raw)))
    struct.pack_into("<H", word, 0, 0xA5EC)
    word[fc:fc + len(raw)] = raw
    struct.pack_into("<I", word, 0x4C, len(text))
    plc = struct.pack("<II", 0, len(text)) + struct.pack("<HIH", 0, (fc * 2) | (1 << 30), 0)
    clx = bytes([2]) + struct.pack("<I", len(plc)) + plc
    table = bytes(64) + clx
    struct.pack_into("<II", word, 0x1A2, 64, len(clx))
    return cfb_file({"WordDocument": bytes(word), "0Table": table})


def ppt_file(sentences: list) -> bytes:
    """A PowerPoint 97 .ppt: one container record of text atoms, UTF-16
    (TextCharsAtom) and cp1252 (TextBytesAtom) in turn."""
    import struct

    atoms = b""
    for i, t in enumerate(sentences):
        body = t.encode("utf-16-le" if i % 2 == 0 else "cp1252")
        atoms += struct.pack("<HHI", 0, 0x0FA0 if i % 2 == 0 else 0x0FA8, len(body)) + body
    container = struct.pack("<HHI", 0xF, 0x03EE, len(atoms)) + atoms
    return cfb_file({"PowerPoint Document": container, "Current User": bytes(24)})


def pdf_file(sentences: list, image: np.ndarray) -> bytes:
    """A one-page PDF: a FlateDecode content stream with a line per
    sentence, and one FlateDecode RGB image XObject."""
    import zlib

    lines = " T* ".join(f"({s}) Tj" for s in sentences)
    content = zlib.compress(f"BT /F1 11 Tf 14 TL 72 780 Td {lines} ET".encode("latin-1"))
    h, w, _ = image.shape
    pixels = zlib.compress(np.ascontiguousarray(image, np.uint8).tobytes())
    objs = [
        b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj",
        b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj",
        b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R "
        b"/Resources << /XObject << /Im1 5 0 R >> >> >> endobj",
        b"4 0 obj << /Filter /FlateDecode /Length " + str(len(content)).encode()
        + b" >>\nstream\n" + content + b"\nendstream\nendobj",
        b"5 0 obj << /Type /XObject /Subtype /Image /Width " + str(w).encode()
        + b" /Height " + str(h).encode() + b" /ColorSpace /DeviceRGB /BitsPerComponent 8"
        b" /Filter /FlateDecode /Length " + str(len(pixels)).encode()
        + b" >>\nstream\n" + pixels + b"\nendstream\nendobj",
    ]
    return b"%PDF-1.4\n" + b"\n".join(objs) + b"\ntrailer\n%%EOF"


def graph_corpus(seed: int, per_format: int = None, sentences: int = None):
    """``per_format`` documents of each format (pdf, docx, xlsx, pptx,
    doc, ppt), each ``sentences`` seeded sentences over GRAPH_ORGS
    organisations and GRAPH_PEOPLE people; returns
    ``[(name, bytes, sentences)]`` and the organisations."""
    per_format = GRAPH_DOCS_PER_FORMAT if per_format is None else per_format
    sentences = GRAPH_SENTENCES if sentences is None else sentences
    rng = np.random.default_rng(seed)
    orgs = [f"{s} {x}" for s in _G_STEMS for x in _G_SUFFIXES]
    orgs = [orgs[int(i)] for i in rng.permutation(len(orgs))[:GRAPH_ORGS]]
    people = [f"{f} {l}" for f in _G_FIRST for l in _G_LAST]
    people = [people[int(i)] for i in rng.permutation(len(people))[:GRAPH_PEOPLE]]
    images = smooth_images(per_format, GRAPH_IMAGE, seed + 1)
    docs = []
    for k in range(per_format):
        for ext in ("pdf", "docx", "xlsx", "pptx", "doc", "ppt"):
            sents = graph_sentences(rng, sentences, orgs, people)
            name = f"report{k:02d}.{ext}"
            if ext == "pdf":
                data = pdf_file(sents, images[k])
            elif ext == "docx":
                data = docx_file(f"Report {k}", sents)
            elif ext == "xlsx":
                data = xlsx_file(sents)
            elif ext == "pptx":
                data = pptx_file(sents)
            elif ext == "doc":
                data = doc_file(sents)
            else:
                data = ppt_file(sents)
            docs.append((name, data, sents))
    return docs, orgs


def _graph_edge_key(r: dict) -> tuple:
    return (r["fact"], r["source"], r["target"], r["relation"])


def _graph_node_key(r: dict) -> tuple:
    return (r["name"], r["label"], tuple(r["facts"]))


def _graph_episode_key(r: dict) -> tuple:
    return (r["preview"], r["source"])


def _same_up_to_ties(want: list, got: list, key, rtol: float, what: str) -> float:
    """``got`` equals ``want`` up to ties: the same length, scores within
    ``rtol`` (relative, on 1 + |s|) slot by slot, and each run of tied
    scores (the last, which top-k may cut, aside) the same items.
    Returns the largest score difference."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} items, the CPU graph {len(want)}: "
                             f"{[key(r) for r in got][:3]} / {[key(r) for r in want][:3]}")
    ws = [float(r["score"]) for r in want]
    gs = [float(r["score"]) for r in got]
    worst = 0.0
    for w, g in zip(ws, gs):
        worst = max(worst, abs(w - g))
        if abs(w - g) > rtol * (1 + abs(w)):
            raise AssertionError(f"{what}: scores {gs} against the CPU graph's {ws}")
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and abs(ws[j] - ws[i]) <= rtol * (1 + abs(ws[i])):
            j += 1
        if j < len(want) and sorted(map(key, want[i:j])) != sorted(map(key, got[i:j])):
            raise AssertionError(f"{what}: items {[key(r) for r in got[i:j]]} where the CPU "
                                 f"graph has {[key(r) for r in want[i:j]]}")
        i = j
    return worst


def phase_graph(results: dict) -> None:
    """The stdlib document parsers and the knowledge graph on the port's
    own App (thread ingest backend, the [semantic] encoder as the
    collection's embedder): GRAPH_DOCS_PER_FORMAT documents of each of
    .pdf (with a FlateDecode RGB image), .docx, .xlsx, .pptx, .doc and
    .ppt, written here from the seed, into one bf16 collection with
    ``enable_knowledge_graph``; the graph ingest split by stage; graph
    searches and ``use_graph`` searches over HTTP, each held against a
    ``KnowledgeGraphService(device="cpu")`` fed the same chunk texts;
    gates a-f."""
    import dataclasses
    import logging
    import shutil
    import tempfile

    from super_rag_tpu_torch.chunk.chunking import Rechunker
    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.fileparser.parser import DocParser
    from super_rag_tpu_torch.kg import service as kgs
    from super_rag_tpu_torch.kg.extract import Ontology
    from super_rag_tpu_torch.models.encoder import flax_params
    from super_rag_tpu_torch.models.encoder_service import EncoderService, save_params
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.store.db import Database

    card = results["card"]

    def glog(msg: str) -> None:
        log(f"[graph] {msg} (on {card})")

    class _Errors(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(f"{record.name}: {record.getMessage()}")

    errors = _Errors()
    port_logger = logging.getLogger("super_rag_tpu_torch")
    port_logger.addHandler(errors)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graph_")
    srv = None
    c = None
    # on a CPU index too: the kernel route (its plain version) from 2,048 rows
    route = mock.patch.object(DeviceIndex, "_kernel_default",
                              lambda self, min_capacity: self._capacity >= min_capacity)
    try:
        t0 = time.perf_counter()
        cfg = semantic_config(torch.bfloat16)
        enc = EncoderService(cfg, max_len=cfg.max_len, seed=SEED, device=DEVICE)
        save_params(flax_params(enc.model), os.path.join(tmp, "enc"), cfg)
        del enc
        settings = dataclasses.replace(
            Settings(), data_dir=os.path.join(tmp, "data"), port=0, batch_max=64,
            default_top_k=GRAPH_TOP_K, chunk_size=400, encoder_checkpoint="",
            reranker_checkpoint="", ingest_backend="thread")
        embedding = {"provider": "onboard", "model": os.path.join(tmp, "enc")}
        docs, orgs = graph_corpus(SEED + 21)
        n_sent = sum(len(s) for _, _, s in docs)
        glog(f"set-up: encoder checkpoint ({cfg.num_layers} x {cfg.hidden_dim}, bf16), "
             f"{len(docs)} documents ({GRAPH_DOCS_PER_FORMAT} each of .pdf .docx .xlsx .pptx "
             f".doc .ppt, {sum(len(d) for _, d, _ in docs) / 1024:.0f} KiB) of {n_sent} seeded "
             f"sentences in {time.perf_counter() - t0:.2f} s")

        # -- the graph ingest, split by stage (wrapped from outside)
        split = {"bulk": 0.0, "extract": 0.0, "resolve": 0.0, "candidates": 0.0,
                 "resolve_device": 0.0, "resolve_writes": 0.0, "writes": 0.0, "searches": 0,
                 "rows": 0}
        where = threading.local()

        class TimedEngine(kgs.CollectionEngine):
            def ingest(self, texts, *a, **kw):
                t1 = time.perf_counter()
                try:
                    out = super().ingest(texts, *a, **kw)
                    torch.cuda.synchronize()
                    return out
                finally:
                    ms = time.perf_counter() - t1
                    split["writes"] += ms
                    split["rows"] += len(texts)
                    if getattr(where, "upsert", False):
                        split["resolve_writes"] += ms

            def search(self, *a, **kw):
                t1 = time.perf_counter()
                try:
                    return super().search(*a, **kw)
                finally:
                    if getattr(where, "candidates", False):
                        split["resolve_device"] += time.perf_counter() - t1
                        split["searches"] += 1

        def timed(name: str, fn, flag: str = None):
            def wrapped(*a, **kw):
                t1 = time.perf_counter()
                if flag:
                    setattr(where, flag, True)
                try:
                    return fn(*a, **kw)
                finally:
                    if flag:
                        setattr(where, flag, False)
                    split[name] += time.perf_counter() - t1
            return wrapped

        KGS = kgs.KnowledgeGraphService
        patches = [
            mock.patch.object(kgs, "CollectionEngine", TimedEngine),
            mock.patch.object(kgs, "extract", timed("extract", kgs.extract)),
            mock.patch.object(KGS, "add_episode_bulk", timed("bulk", KGS.add_episode_bulk)),
            mock.patch.object(KGS, "_upsert_node", timed("resolve", KGS._upsert_node, "upsert")),
            mock.patch.object(KGS, "_node_candidates",
                              timed("candidates", KGS._node_candidates, "candidates")),
        ]

        for p in patches:
            p.start()
        try:
            srv = _AppThread(settings)
            port = srv.app.port
            c = _Client(port)
            _expect(*c.call("POST", "/api/v1/auth/register",
                            {"username": "smoke", "password": "smoke-password"}), 201, "register")
            c.close()
            token = _login(port)
            c = _Client(port, token)
            cid = _expect(*c.call("POST", "/api/v1/collections", {
                "title": "graph", "config": {"embedding": embedding,
                                             "enable_knowledge_graph": True}}),
                          201, "create collection")["id"]
            t_first = time.perf_counter()
            half = len(docs) // 2
            for batch in (docs[:half], docs[half:]):
                _expect(*_post_files(port, token, f"/api/v1/collections/{cid}/documents",
                                     [(n, d) for n, d, _ in batch]), 201, "upload")
            wall = _wait_complete(c, cid, len(docs), "graph documents", t_first)
            srv.app.ctx.scheduler.wait_idle(120)
        finally:
            for p in reversed(patches):
                p.stop()
        kg = srv.app.ctx.kg
        db = srv.app.ctx.db
        geng = kg._engines[cid]
        if geng.index.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"the graph engine lives on {geng.index.device}")
        listing = _expect(*c.call("GET", f"/api/v1/collections/{cid}/documents?limit=1000"),
                          200, "list")
        did_of = {d["name"]: d["id"] for d in listing}
        n_edges = db.query_one("SELECT COUNT(*) AS n FROM kg_edge WHERE group_id=?", (cid,))["n"]
        n_nodes = db.query_one("SELECT COUNT(*) AS n FROM kg_node WHERE group_id=?", (cid,))["n"]
        n_dead = db.query_one("SELECT COUNT(*) AS n FROM kg_edge WHERE group_id=? AND "
                              "invalid_at IS NOT NULL", (cid,))["n"]

        # -- gate a: every document COMPLETE, its chunks hold its sentences
        rechunk = Rechunker(settings.chunk_size, settings.chunk_overlap)
        chunk_texts: dict = {}
        n_chunks = 0
        for name, data, sents in docs:
            did = did_of[name]
            served = [ch["text"] for ch in _expect(*c.call(
                "GET", f"/api/v1/documents/{did}/chunks"), 200, "chunks")]
            local = rechunk.rechunk(DocParser().parse_file(name, data),
                                    metadata={"document_id": did})
            if served != [ch.padded_text for ch in local]:
                raise AssertionError(f"gate a: {name}'s served chunks differ from a parse here")
            joined = " ".join(" ".join(served).split())
            missing = [s for s in sents if s not in joined]
            if missing:
                raise AssertionError(f"gate a: {name} lacks {len(missing)} of its sentences, "
                                     f"e.g. {missing[0]!r}")
            chunk_texts[name] = [ch.text for ch in local]
            n_chunks += len(served)
        if n_edges < GRAPH_MIN_FACTS or n_nodes < GRAPH_MIN_ENTITIES:
            raise AssertionError(f"gate a: {n_edges} facts and {n_nodes} entities; the phase "
                                 f"needs >= {GRAPH_MIN_FACTS} and >= {GRAPH_MIN_ENTITIES}")
        bulk = split["bulk"]
        host_resolve = split["resolve"] - split["resolve_device"] - split["resolve_writes"]
        glog(f"ingest: {len(docs)} documents (6 formats), {n_chunks} chunks, every document "
             f"COMPLETE (vector + graph indexes) after {wall:.3f} s: {n_chunks / wall:.1f} "
             f"chunks/s, {n_edges / wall:.1f} facts/s ({n_edges} facts, {n_dead} invalidated; "
             f"{n_nodes} entities; {geng.index.live_count} graph rows, "
             f"{str(geng.index.spec.dtype)[6:]}, D = {geng.index.spec.dim})")
        glog(f"gate a: each of the {len(docs)} documents COMPLETE; its served chunk texts equal "
             f"a parse + rechunk here and hold all its seeded sentences, in all 6 formats")
        glog(f"graph ingest split: add_episode_bulk {bulk:.3f} s in all = extraction "
             f"{split['extract']:.3f} s + node resolution {split['resolve']:.3f} s (host "
             f"{host_resolve:.3f} s, of it {split['candidates'] - split['resolve_device']:.3f} s "
             f"in the candidates' trigram screen; device candidate searches "
             f"{split['resolve_device']:.3f} s in {split['searches']} searches; node-row writes "
             f"{split['resolve_writes']:.3f} s)"
             f" + other device writes {split['writes'] - split['resolve_writes']:.3f} s "
             f"({split['rows']} rows written in all) + the rest "
             f"{bulk - split['extract'] - split['resolve'] - split['writes'] + split['resolve_writes']:.3f} s")

        # -- gate b: a CPU twin fed the same chunk texts in the served order
        t1 = time.perf_counter()
        order = [r["source"] for r in db.query(
            "SELECT source, MIN(created) AS t FROM kg_episode WHERE group_id=? "
            "GROUP BY source ORDER BY t", (cid,))]
        name_of = {v: k for k, v in did_of.items()}
        if sorted(order) != sorted(did_of.values()):
            raise AssertionError("gate b: the served graph lacks some documents' episodes")
        # the twin takes the card's route on the CPU: the dense branch on
        # dense_topk (queries rounded to bf16, the calibrated per-tile cap)
        # with the kernel's plain version in the kernel's place; the CPU's
        # own route scores f32 queries
        route.start()
        twin = KGS(Database(":memory:"), device="cpu")
        for did in order:
            twin.add_episode_bulk(cid, chunk_texts[name_of[did]], source=did,
                                  ontology=Ontology.from_config([]))
        twin_s = time.perf_counter() - t1
        teng = twin._engines[cid]
        if teng.index._per_tile_k != geng.index._per_tile_k:
            raise AssertionError(f"gate b: the twin calibrated a per-tile cap of "
                                 f"{teng.index._per_tile_k}, the served graph "
                                 f"{geng.index._per_tile_k}")

        def graph_state(g: KGS) -> dict:
            names = {r["id"]: r["name"] for r in g.db.query(
                "SELECT id, name FROM kg_node WHERE group_id=?", (cid,))}
            return {
                "nodes": sorted((r["name"], r["label"], r["summary"]) for r in g.db.query(
                    "SELECT name, label, summary FROM kg_node WHERE group_id=?", (cid,))),
                "edges": sorted((names[r["source_id"]], r["relation"], names[r["target_id"]],
                                 r["fact"], r["invalid_at"] is not None) for r in g.db.query(
                    "SELECT * FROM kg_edge WHERE group_id=?", (cid,))),
                "aliases": sorted((r["norm"], names[r["node_id"]]) for r in g.db.query(
                    "SELECT norm, node_id FROM kg_node_alias WHERE group_id=?", (cid,))),
            }

        served_state, twin_state = graph_state(kg), graph_state(twin)
        for part in ("nodes", "edges", "aliases"):
            if served_state[part] != twin_state[part]:
                bad = sorted(set(served_state[part]) ^ set(twin_state[part]))[:3]
                raise AssertionError(f"gate b: the served graph's {part} differ from the CPU "
                                     f"twin's: {bad}")
        stats = _expect(*c.call("GET", f"/api/v1/collections/{cid}/graph/stats"), 200, "stats")
        tstats = twin.stats(cid)
        # communities are printed, not compared: label propagation visits
        # nodes in id order, and ids are uuids
        if (stats["nodes"], stats["edges"]) != (tstats["nodes"], tstats["edges"]):
            raise AssertionError(f"gate b: /graph/stats {stats} != the twin's {tstats}")
        sub = _expect(*c.call("GET", f"/api/v1/collections/{cid}/graph?limit=100000"), 200,
                      "subgraph")
        tsub = twin.subgraph(cid, limit=100000)

        def sub_key(g: dict):
            names = {n["id"]: (n["name"], n["label"]) for n in g["nodes"]}
            return (sorted(names.values()),
                    sorted((names[e["source"]], e["relation"], names[e["target"]], e["fact"])
                           for e in g["edges"]))

        if sub_key(sub) != sub_key(tsub):
            raise AssertionError("gate b: /graph differs from the CPU twin's subgraph")
        labels = _expect(*c.call("GET", f"/api/v1/collections/{cid}/graphs/labels"), 200,
                         "labels")
        if sorted(map(str, labels)) != sorted(map(str, twin.labels(cid))):
            raise AssertionError(f"gate b: labels {labels} != {twin.labels(cid)}")
        glog(f"gate b: a KnowledgeGraphService(device=\"cpu\") on the card's route (dense_topk's "
             f"plain version, bf16 queries, per-tile cap {teng.index._per_tile_k} as on the "
             f"card) fed the same chunk texts in the served order ({twin_s:.3f} s) holds the same {len(twin_state['nodes'])} nodes "
             f"(names, labels, summaries), {len(twin_state['edges'])} facts with the same "
             f"{n_dead} invalidations, {len(twin_state['aliases'])} aliases; /graph/stats, "
             f"/graph ({len(sub['edges'])} live facts) and /graphs/labels agree "
             f"({stats['communities']} communities served, {tstats['communities']} in the "
             f"twin: their label propagation visits nodes in the order of their uuids)")

        # -- gates c, d: graph searches and use_graph searches from one client
        rng = np.random.default_rng(SEED + 22)
        queries = []
        for k in range(GRAPH_QUERIES):
            _, _, sents = docs[int(rng.integers(len(docs)))]
            words = sents[int(rng.integers(len(sents)))].rstrip(".").split()
            start = int(rng.integers(max(1, len(words) - 3)))
            queries.append(" ".join(words[start:start + 4]))
        people = [r["name"] for r in twin.db.query(
            "SELECT name FROM kg_node WHERE group_id=? ORDER BY name", (cid,))]

        def graph_body(k: int) -> dict:
            body = {"query": queries[k], "limit": GRAPH_TOP_K,
                    "scopes": ["edges", "nodes", "episodes"]}
            if k % 4 == 1:
                body.update(center_node=people[k % len(people)], rerank="node_distance")
            elif k % 4 == 2:
                body["bfs_origin_nodes"] = [people[(3 * k) % len(people)]]
            return body

        calls: list = []
        real_tile_topk = dt.tile_topk

        def record(*args):
            q, values, mask, n, tile, kt = args[0], args[2], args[5], args[6], args[7], args[8]
            calls.append({"args": args, "masked": mask is not None, "d": q.shape[1],
                          "variant": dt.kernel_variant(
                              dt._mode(q, values), kt, q.shape[1], q.shape[0], -(-n // tile),
                              dt._sm_count(torch.cuda.current_device()))})
            return real_tile_topk(*args)

        lat_g, lat_s, per_request, served_g, served_s = [], [], [], [], []
        _reset_counts()
        counts0 = _counts()
        with mock.patch.object(dt, "tile_topk", record):
            for k in range(GRAPH_QUERIES):
                n0 = len(calls)
                t1 = time.perf_counter()
                out = _expect(*c.call("POST", f"/api/v1/collections/{cid}/graph/search",
                                      graph_body(k)), 200, "graph search")
                lat_g.append((time.perf_counter() - t1) * 1e3)
                per_request.append(("graph/search", calls[n0:]))
                served_g.append(out)
            for k in range(GRAPH_QUERIES):
                n0 = len(calls)
                t1 = time.perf_counter()
                out = _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches", {
                    "query": queries[k], "use_graph": True, "use_rerank": False,
                    "top_k": GRAPH_TOP_K}), 201, "use_graph search")
                lat_s.append((time.perf_counter() - t1) * 1e3)
                per_request.append(("searches", calls[n0:]))
                served_s.append(out)
        torch.cuda.synchronize()
        launched = {k: v - counts0[k] for k, v in _counts().items() if v - counts0[k]}
        if launched.get("dense_topk_tc", 0) != len(calls):
            raise AssertionError(f"gate d: {len(calls)} dense_topk calls launched {launched}")
        graph_launches = 0
        for what, rc in per_request:
            g = [r for r in rc if r["d"] == geng.index.spec.dim]
            want = 3 if what == "graph/search" else 1
            if len(g) != want or not all(r["masked"] and r["variant"] == "tcs" for r in g):
                raise AssertionError(f"gate d: a {what} request made {len(g)} graph "
                                     f"dispatches {[(r['masked'], r['variant']) for r in g]}, "
                                     f"expected {want} masked tcs launches")
            graph_launches += len(g)
        last_graph = [r for _, rc in per_request for r in rc
                      if r["d"] == geng.index.spec.dim][-1]["args"]

        dense_tol = geng.index.spec.dim * 2.0 ** -23 * 2  # cosine scores: max |s| <= 1

        def branches_agree(q: str, what: str) -> None:
            """Each branch the hybrid fuses -- dense and BM25, over every
            scope a graph search masks to -- equals the twin's up to ties
            within its tolerance (dense: the kernel's summation bound;
            BM25: the card's and the CPU's float sums, a few ulps)."""
            scopes = [dict(index_types=["graph"]), dict(index_types=["vector"]),
                      dict(doc_rows=kg._edge_doc_rows(cid, None) or None)]
            for kw in scopes:
                for mode, tol in (("dense", dense_tol), ("fulltext", 1e-6)):
                    a = geng.search(q, top_k=100, mode=mode, **kw)
                    b = teng.search(q, top_k=100, mode=mode, **kw)
                    _same_up_to_ties([{"score": h.score, "row": h.row} for h in b],
                                     [{"score": h.score, "row": h.row} for h in a],
                                     lambda r: r["row"], tol, f"{what}: {mode} branch {kw}")

        tie_explained: list = []

        def check(want, got, key, q: str, what: str) -> float:
            """Served = twin up to ties; where the fused lists differ, the
            branches they fuse must agree up to ties (a branch's tie
            broken the other way on the card moves its RRF ranks)."""
            try:
                return _same_up_to_ties(want, got, key, 1e-3, what)
            except AssertionError as e:
                try:
                    branches_agree(q, what)
                except AssertionError as b:
                    raise AssertionError(f"{e}; and a branch differs: {b}") from None
                tie_explained.append(what)
                return 0.0

        worst = 0.0
        for k, out in enumerate(served_g):
            b = graph_body(k)
            want = twin.search_combined(cid, b["query"], limit=b["limit"],
                                        center_node=b.get("center_node"),
                                        rerank=b.get("rerank"),
                                        bfs_origin_nodes=b.get("bfs_origin_nodes"),
                                        scopes=b["scopes"])
            for scope, key in (("edges", _graph_edge_key), ("nodes", _graph_node_key),
                               ("episodes", _graph_episode_key)):
                worst = max(worst, check(want[scope], out[scope], key, b["query"],
                                         f"gate c: graph/search {k} {scope}"))
        for k, out in enumerate(served_s):
            graph_items = [it for it in out["items"] if it["recall_type"] == "graph_search"]
            want = twin.search(cid, queries[k], top_k=GRAPH_TOP_K)
            if not want:
                if graph_items:
                    raise AssertionError(f"gate c: searches {k} has a graph item, the twin none")
                continue
            if len(graph_items) != 1:
                raise AssertionError(f"gate c: searches {k} answered {len(graph_items)} "
                                     f"graph items: {out['items'][:2]}")
            direct = kg.search(cid, queries[k], top_k=GRAPH_TOP_K)
            if graph_items[0]["text"] != "\n".join(r["fact"] for r in direct):
                raise AssertionError(f"gate c: searches {k}'s graph item is not the graph's "
                                     f"direct answer")
            worst = max(worst, check(want, direct, _graph_edge_key, queries[k],
                                     f"gate c: searches {k} graph facts"))
        n_lists = 3 * len(served_g) + len(served_s)
        glog(f"gate c: {GRAPH_QUERIES} POST graph/search (edges, nodes, episodes; a quarter "
             f"with node_distance from a centre, a quarter with BFS origins) and "
             f"{GRAPH_QUERIES} POST searches with use_graph (each graph item the graph's own "
             f"answer) equal the CPU graph's answers: {n_lists - len(tie_explained)} of "
             f"{n_lists} lists up to ties of the fused scores (within {worst:.3g}), the other "
             f"{len(tie_explained)} where a branch's near-tie (dense within {dense_tol:.3g}, "
             f"BM25 within 1e-6 relative) fell the other way on the card, each branch equal "
             f"to the twin's up to those ties ({', '.join(tie_explained[:4])}"
             f"{' ...' if len(tie_explained) > 4 else ''}); graph/search one client p50 "
             f"{_pctl(lat_g, 50):.3f} ms, p99 {_pctl(lat_g, 99):.3f} ms; use_graph searches "
             f"p50 {_pctl(lat_s, 50):.3f} ms, p99 {_pctl(lat_s, 99):.3f} ms")
        row = _served_kernel_row(last_graph, graph_launches, len(per_request), glog)
        results["dense_topk"]["http_graph"] = {
            k: row[k] for k in ("variant", "ms", "launches", "bound_ms", "bound_by",
                                "plain_ms", "library_ms", "max_abs_err")}
        results["dense_topk_http_graph"] = row
        glog(f"gate d: every graph dispatch launched dense_topk_tcs_kernel with a mask: "
             f"{graph_launches} launches at D = {geng.index.spec.dim} over {len(per_request)} "
             f"requests (3 each graph/search, 1 each use_graph search; {launched} in all)")

        # -- what a graph search costs the requests beside it (printed)
        text = {"query": queries[0], "use_rerank": False}
        quiet = []
        for _ in range(16):
            t1 = time.perf_counter()
            _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches", text), 201, "search")
            quiet.append((time.perf_counter() - t1) * 1e3)
        box: dict = {"n": 0}

        def graph_load() -> None:
            gc = _Client(port, token)
            try:
                for k in range(GRAPH_QUERIES // 2):
                    _expect(*gc.call("POST", f"/api/v1/collections/{cid}/graph/search",
                                     graph_body(k)), 200, "graph search")
                    box["n"] += 1
            except Exception as e:  # noqa: BLE001 — raised below
                box["error"] = e
            finally:
                gc.close()

        worker = threading.Thread(target=graph_load)
        worker.start()
        during = []
        while worker.is_alive():
            t1 = time.perf_counter()
            _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches", text), 201, "search")
            during.append((time.perf_counter() - t1) * 1e3)
        worker.join()
        if "error" in box:
            raise box["error"]
        glog(f"searches beside graph searches: alone p50 {_pctl(quiet, 50):.3f} ms; while "
             f"another client sends {box['n']} graph/search, {len(during)} searches p50 "
             f"{_pctl(during, 50) if during else 0:.3f} ms, max {max(during or [0]):.3f} ms")

        # -- gate e: delete a document: its facts leave both graphs
        victim = docs[0][0]
        vdid = did_of[victim]
        gone = {r["fact"] for r in db.query(
            "SELECT fact FROM kg_edge WHERE group_id=? AND episode_id IN (SELECT id FROM "
            "kg_episode WHERE source=?)", (cid, vdid))}
        if not gone:
            raise AssertionError(f"gate e: {victim} has no facts")
        st, body = c.call("DELETE", f"/api/v1/documents/{vdid}")
        _expect(st, body, 204, "delete document")
        if not srv.app.ctx.scheduler.wait_idle(120):
            raise AssertionError("gate e: the delete did not drain")
        for r in twin.db.query("SELECT id FROM kg_episode WHERE group_id=? AND source=?",
                               (cid, vdid)):
            twin.delete_episode(cid, r["id"])
        left = db.query_one("SELECT COUNT(*) AS n FROM kg_episode WHERE source=?", (vdid,))["n"]
        if left:
            raise AssertionError(f"gate e: {left} episodes of {victim} stay")
        live = {r["fact"] for r in db.query("SELECT fact FROM kg_edge WHERE group_id=?", (cid,))}
        probe = sorted(gone)[:8]
        for q in probe:
            out = _expect(*c.call("POST", f"/api/v1/collections/{cid}/graph/search",
                                  {"query": q, "limit": 10, "scopes": ["edges"]}), 200, "search")
            want = twin.search_combined(cid, q, limit=10, scopes=["edges"])["edges"]
            stale = {r["fact"] for r in out["edges"]} & (gone - live)
            if stale or {r["fact"] for r in want} & (gone - live):
                raise AssertionError(f"gate e: deleted facts {sorted(stale)[:2]} still answer")
            check(want, out["edges"], _graph_edge_key, q, "gate e: search")
        glog(f"gate e: DELETE of {victim} removed its episodes; its {len(gone)} facts leave "
             f"graph/search in the served graph and its CPU twin ({len(probe)} probes, answers "
             f"equal up to ties)")

        # -- gate f
        if errors.records:
            raise AssertionError(f"gate f: {len(errors.records)} ERROR records: "
                                 f"{errors.records[:3]}")
        results["graph"] = {"ingest_s": wall, "chunks_per_s": n_chunks / wall,
                            "facts_per_s": n_edges / wall, "facts": n_edges,
                            "entities": n_nodes, "invalidated": n_dead,
                            "split_s": {k: v for k, v in split.items()},
                            "graph_search_p50": _pctl(lat_g, 50),
                            "graph_search_p99": _pctl(lat_g, 99),
                            "use_graph_p50": _pctl(lat_s, 50), "use_graph_p99": _pctl(lat_s, 99)}
        glog("gate f: no ERROR record from the port's loggers; gates a-f passed")
    finally:
        route.stop()
        if c is not None:
            c.close()
        if srv is not None:
            srv.stop()
        port_logger.removeHandler(errors)
        shutil.rmtree(tmp, ignore_errors=True)


def _provider_stub():
    """The OpenAI-compatible model provider of the provider tests
    (``tests/llm_stub.py``), in this process on the standard library's
    ThreadingHTTPServer: ``/v1/embeddings`` answers the port's
    ``HashEmbedder(dim=PROV_DIM, device="cpu")`` vectors of the texts,
    ``/v1/rerank`` scores query-term overlap (a document's hash breaks
    ties), ``/v1/chat/completions`` answers the summary map with the lead
    words of each chunk of its passage and the reduce with the partial
    summaries joined; a call without the key STUB_KEY is refused (401).
    It counts its calls and the texts it embedded."""
    sys.path.append(os.path.join(HERE, "tests"))
    from llm_stub import StubProvider

    from super_rag_tpu_torch.models.hash_embedder import HashEmbedder

    embedder = HashEmbedder(dim=PROV_DIM, device="cpu")
    return StubProvider(dim=PROV_DIM, embed_fn=lambda texts: embedder.embed(texts).numpy(),
                        api_key=STUB_KEY)


def _items_key(items: list, name_of: dict) -> list:
    """Search items as dicts for ``_same_up_to_ties``: each keyed by its
    document's name, chunk index and recall type, not by ids."""
    return [{"score": it["score"],
             "key": (name_of.get(it["metadata"].get("document_id")),
                     it["metadata"].get("chunk_index"), it["recall_type"], it["text"])}
            for it in items]


def phase_providers(results: dict) -> None:
    """A collection embedded and reranked by a remote OpenAI-compatible
    provider at text-embedding-3-small's 1,536 dimensions, on the port's
    own App: the stub provider of ``_provider_stub`` in this process; the
    provider, its key, its three models and the default-model tags
    registered through the App's routes, then a restart (the completion
    client is resolved at boot); collection P (bf16, the stub's embedding
    model, its rerank model as the tagged default, the summary index
    through its chat model) with PROV_DOCS documents x PROV_SECTIONS
    sections; PROV_QUERIES unreranked and as many reranked searches of
    other queries from one client; collection O (the
    [semantic] encoder) and, in a second App, collection S embedded by
    the first App's ``POST /v1/embeddings`` serving O's encoder; gates
    a-e."""
    import dataclasses
    import logging
    import shutil
    import tempfile

    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.llm.client import OpenAICompatClient
    from super_rag_tpu_torch.llm.resolver import RemoteEmbedder
    from super_rag_tpu_torch.models.encoder import flax_params
    from super_rag_tpu_torch.models.encoder_service import EncoderService, save_params
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.dense import build_corpus

    card = results["card"]

    def plog(msg: str) -> None:
        log(f"[providers] {msg} (on {card})")

    class _Records(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.WARNING)
            self.errors, self.fallbacks = [], []

        def emit(self, record):
            msg = f"{record.name}: {record.getMessage()}"
            if record.levelno >= logging.ERROR:
                self.errors.append(msg)
            if ("unreachable" in msg or "default embedder" in msg or "hash embedder" in msg
                    or "extractive summary instead" in msg):
                self.fallbacks.append(msg)

    records = _Records()
    port_logger = logging.getLogger("super_rag_tpu_torch")
    port_logger.addHandler(records)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_providers_")
    stub = _provider_stub()
    apps: list = []
    clients: list = []
    # the CPU twin takes the card's route: dense_topk's plain version in the
    # kernel's place (bf16 queries, the calibrated per-tile cap)
    route = mock.patch.object(DeviceIndex, "_kernel_default",
                              lambda self, min_capacity: self._capacity >= min_capacity)
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        cfg = semantic_config(torch.bfloat16)
        enc = EncoderService(cfg, max_len=cfg.max_len, seed=SEED, device=DEVICE)
        save_params(flax_params(enc.model), os.path.join(tmp, "enc"), cfg)
        del enc

        def settings_for(name: str):
            return dataclasses.replace(
                Settings(), data_dir=os.path.join(tmp, name), port=0, batch_max=64,
                default_top_k=PROV_TOP_K, rerank_candidates=PROV_CANDIDATES,
                chunk_size=400, encoder_checkpoint="", reranker_checkpoint="",
                ingest_backend="thread", ingest_host_workers=1)

        def boot(name: str, device: str = None):
            srv = _AppThread(settings_for(name), device=device)
            apps.append(srv)
            return srv

        def client(srv, token: str = ""):
            c = _Client(srv.app.port, token)
            clients.append((srv, c))
            return c

        def stop(srv) -> None:
            """Close the App's keep-alive clients (its server waits for
            them), then stop it."""
            for owner, c in [x for x in clients if x[0] is srv]:
                c.close()
                clients.remove((owner, c))
            srv.stop()
            apps.remove(srv)

        def public_key(srv, provider: str, key: str) -> None:
            """A key the App uses for every collection: the resolver looks
            up the caller's key, then the user ``public``'s (as the
            reference's does), so it is set by a ``public`` account."""
            c = client(srv)
            _expect(*c.call("POST", "/api/v1/auth/register",
                            {"username": "public", "password": "public-password"}), 201,
                    "register public")
            st, body = c.call("POST", "/api/v1/auth/login",
                              {"username": "public", "password": "public-password"})
            c = client(srv, _expect(st, body, 200, "login public")["token"])
            _expect(*c.call("POST", f"/api/v1/llm_providers/{provider}/key",
                            {"api_key": key}), 200, "provider key")

        def register(srv) -> tuple:
            """The user, the stub provider, its key, its three models and
            the default-model tags, all through the App's routes."""
            c = client(srv)
            _expect(*c.call("POST", "/api/v1/auth/register",
                            {"username": "smoke", "password": "smoke-password"}), 201,
                    "register")
            token = _login(srv.app.port)
            c = client(srv, token)
            _expect(*c.call("POST", "/api/v1/llm_providers",
                            {"name": "stub", "label": "Stub (OpenAI-compatible)",
                             "base_url": stub.url}), 201, "register provider")
            public_key(srv, "stub", STUB_KEY)
            for api, model in (("embedding", "text-embedding-3-small"),
                               ("rerank", "rerank-smoke"), ("completion", "chat-smoke")):
                _expect(*c.call("POST", "/api/v1/llm_providers/stub/models",
                                {"api": api, "model": model, "context_window": 8192}), 201,
                        f"register {api} model")
            defaults = _expect(*c.call("PUT", "/api/v1/default_models", {"defaults": [
                {"scenario": "default_for_rerank", "provider_name": "stub",
                 "model": "rerank-smoke"},
                {"scenario": "default_for_collection_completion", "provider_name": "stub",
                 "model": "chat-smoke"}]}), 200, "default models")
            conf = _expect(*c.call("GET", "/api/v1/llm_configuration"), 200, "configuration")
            masked = {p["name"]: p["api_key"] for p in conf["providers"]}["stub"]
            if masked is not None:
                raise AssertionError(f"llm_configuration shows smoke a key {masked!r}")
            return token, defaults

        p_config = {"index_dtype": "bfloat16", "enable_summary": True,
                    "embedding": {"provider": "stub", "model": "text-embedding-3-small"},
                    "rerank": {"provider": "stub"}}
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
        docs, queries = http_corpus(gen, PROV_DOCS, PROV_SECTIONS, 2 * PROV_QUERIES)
        # the reranked searches ask other queries, so that each of them too
        # embeds its query through the stub (none is a response-cache hit)
        queries, rr_queries = queries[:PROV_QUERIES], queries[PROV_QUERIES:2 * PROV_QUERIES]

        # -- App A: registered through its routes, then restarted
        a = boot("a")
        token, defaults = register(a)
        stop(a)
        a = boot("a")
        if a.app.ctx.completion is None:
            raise AssertionError("gate a: the restarted App resolved no completion client")
        ca = client(a, token)
        c0 = stub.snapshot()
        pid = _expect(*ca.call("POST", "/api/v1/collections",
                               {"title": "remote", "config": p_config}), 201,
                      "create collection P")["id"]
        eng = a.app.ctx.engines.get(pid)
        if not (isinstance(eng.embedder, RemoteEmbedder) and eng.embedder.dim == PROV_DIM
                and eng.index.spec.dim == PROV_DIM
                and eng.index.spec.dtype == torch.bfloat16
                and eng.index.device.type == torch.device(DEVICE).type):
            raise AssertionError(f"gate a: collection P embeds with {type(eng.embedder).__name__}"
                                 f" (dim {getattr(eng.embedder, 'dim', None)}), index D "
                                 f"{eng.index.spec.dim} {eng.index.spec.dtype} on "
                                 f"{eng.index.device}")
        plog(f"set-up: stub provider at {stub.url}; registered through the routes (provider, "
             f"key, 3 models, default tags {[(d['scenario'], d['model']) for d in defaults['items'] if d['model']]}), "
             f"App restarted (completion client resolved at boot); collection P: "
             f"{type(eng.embedder).__name__} dim {eng.embedder.dim} (probed), bf16 index on "
             f"{eng.index.device}; {len(docs)} documents x {PROV_SECTIONS} sections; "
             f"{time.perf_counter() - t0:.2f} s")

        # -- ingest P (one uploader, documents in order)
        def ingest(srv, c, cid: str, batch: list, what: str) -> tuple:
            t_first = time.perf_counter()
            for name, text in batch:
                _expect(*c.call("POST", f"/api/v1/collections/{cid}/documents",
                                {"name": name, "content": text}), 201, f"upload {what}")
            wall = _wait_complete(c, cid, len(batch), what, t_first)
            if not srv.app.ctx.scheduler.wait_idle(120):
                raise AssertionError(f"{what}: the scheduler did not drain")
            listing = _expect(*c.call("GET", f"/api/v1/collections/{cid}/documents?limit=1000"),
                              200, "list")
            return wall, listing

        wall, listing = ingest(a, ca, pid, docs, "collection P")
        ingest_calls = stub.since(c0)
        name_of = {d["id"]: d["name"] for d in listing}
        chunks = {}
        for d in listing:
            idx = {i["index_type"]: i["status"] for i in d["indexes"]}
            if idx != {"vector": "ACTIVE", "summary": "ACTIVE"}:
                raise AssertionError(f"gate a: {d['name']} indexes {idx}")
            # the document's rows: its chunks and its one summary row
            chunks[d["name"]] = len(_expect(*ca.call(
                "GET", f"/api/v1/documents/{d['id']}/chunks"), 200, "chunks")) - 1
        n_chunks = sum(chunks.values())
        summary_code = 1  # engine/index.py INDEXER_CODES["summary"]
        codes = eng.index.indexer_code[: eng.index.size].cpu()
        n_summary = int((codes == summary_code).sum())
        blocks = {n: -(-c // PROV_MAP_BATCH) for n, c in chunks.items()}
        want = {"embedding": 1 + sum(-(-c // PROV_EMBED_BATCH) for c in chunks.values())
                + len(docs),
                "texts": 1 + n_chunks + len(docs), "rerank": 0,
                "completion": sum(b + (b > 1) for b in blocks.values()), "token": 0,
                "refused": 0}
        if ingest_calls != want or eng.index.live_count != n_chunks + len(docs) \
                or n_summary != len(docs):
            raise AssertionError(f"gate a: the stub counted {ingest_calls}, expected {want}; "
                                 f"{eng.index.live_count} rows ({n_summary} summary rows) for "
                                 f"{n_chunks} chunks and {len(docs)} documents")
        plog(f"ingest P: {len(docs)} documents, {n_chunks} chunks + {n_summary} summaries "
             f"({eng.index.live_count} rows, {eng.index.live_count * PROV_DIM * 2 / 1e6:.1f} MB "
             f"of bf16 rows) COMPLETE after {wall:.3f} s: {n_chunks / wall:.1f} chunks/s; the "
             f"stub answered {ingest_calls['embedding']} embedding calls ({ingest_calls['texts']}"
             f" texts: the probe, the chunks in batches of {PROV_EMBED_BATCH}, one summary a "
             f"document) and {ingest_calls['completion']} completions (the summary map over "
             f"blocks of {PROV_MAP_BATCH} chunks, then the reduce), as expected")

        # -- searches from one client, each dispatch's dense_topk recorded
        def searches(c, cid: str, rerank: bool, qs: list, record: list = None):
            lat, out = [], []
            for q in qs:
                n0 = len(record) if record is not None else 0
                t1 = time.perf_counter()
                body = _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                                       {"query": q, "use_rerank": rerank,
                                        "top_k": PROV_TOP_K}), 201, "search")
                lat.append((time.perf_counter() - t1) * 1e3)
                out.append(body["items"])
                if record is not None and len(record) == n0:
                    raise AssertionError(f"gate c: a search launched no dense_topk: {q!r}")
            return lat, out

        calls: list = []
        real_tile_topk = dt.tile_topk

        def recording_into(record: list):
            def recording(*args):
                q, values, n, tile, kt = args[0], args[2], args[6], args[7], args[8]
                record.append({"args": args, "d": q.shape[1], "mode": dt._mode(q, values),
                               "variant": dt.kernel_variant(
                                   dt._mode(q, values), kt, q.shape[1], q.shape[0],
                                   -(-n // tile), dt._sm_count(torch.cuda.current_device()))})
                return real_tile_topk(*args)
            return recording

        def on_the_tensor_cores(record: list, launched: dict, d: int) -> list:
            """Dispatches of ``record`` off dense_topk's bf16 tensor-core
            route at ``d``, or counts other than one launch of it a
            dispatch."""
            bad = [(r["d"], r["variant"], r["mode"]) for r in record
                   if (r["d"], r["variant"], r["mode"]) != (d, "tcs", dt.MODE_BF16)]
            if launched.get("dense_topk_tc", 0) != len(record) or launched.get(
                    TC_MODE_KEYS[dt.MODE_BF16], 0) != len(record):
                bad.append(launched)
            return bad

        searches(ca, pid, False, queries[:1])  # compacts and calibrates: not timed
        c1 = stub.snapshot()
        _reset_counts()
        counts0 = _counts()
        with mock.patch.object(dt, "tile_topk", recording_into(calls)):
            lat_plain, served_plain = searches(ca, pid, False, queries, calls)
            n_plain = len(calls)
            lat_rr, served_rr = searches(ca, pid, True, rr_queries, calls)
        torch.cuda.synchronize()
        launched = {k: v - counts0[k] for k, v in _counts().items() if v - counts0[k]}
        search_calls = stub.since(c1)
        distinct = len(set(queries) - {queries[0]}) + len(set(rr_queries))
        want_calls = {"embedding": distinct, "texts": distinct, "rerank": len(rr_queries),
                      "completion": 0, "token": 0, "refused": 0}
        if search_calls != want_calls:
            raise AssertionError(f"gate a: the searches made {search_calls} stub calls, "
                                 f"expected {want_calls}")
        if any(it["recall_type"] != "reranked" for its in served_rr for it in its) or \
                any(it["recall_type"] == "reranked" for its in served_plain for it in its):
            raise AssertionError("gate a: recall types of the reranked / unreranked searches")

        # gate c: every dispatch launched dense_topk on the tensor cores,
        # bf16 x bf16
        bad = on_the_tensor_cores(calls, launched, PROV_DIM)
        if bad:
            raise AssertionError(f"gate c: {len(calls)} dispatches launched {launched}; "
                                 f"off the expected route: {bad[:3]}")
        kts = sorted({r["args"][8] for r in calls})
        plog(f"searches of P, one client: {len(queries)} unreranked p50 "
             f"{_pctl(lat_plain, 50):.3f} ms, p99 {_pctl(lat_plain, 99):.3f} ms; "
             f"{len(rr_queries)} reranked of other queries (stub rerank of the hybrid top "
             f"{PROV_CANDIDATES}) p50 {_pctl(lat_rr, 50):.3f} ms, p99 {_pctl(lat_rr, 99):.3f} "
             f"ms; each search embedded its query through the stub: stub calls {search_calls}")
        plog(f"gate c: every one of the {len(calls)} dispatches ({n_plain} unreranked, "
             f"{len(calls) - n_plain} reranked) launched dense_topk's sorted-selection "
             f"tensor-core kernel in mode bf16 x bf16 at D = {PROV_DIM} (kt {kts}); "
             f"counters {launched}")

        # -- stub round trip through the port's client (no cache)
        rt_client = OpenAICompatClient(stub.url, api_key=STUB_KEY,
                                       model="text-embedding-3-small", cache_enabled=False)
        rt = []
        c2 = stub.snapshot()
        for k in range(PROV_ROUND_TRIPS):
            t1 = time.perf_counter()
            rt_client.embed([queries[k % len(queries)]])
            rt.append((time.perf_counter() - t1) * 1e3)
        rt_client.close()
        rt_calls = stub.since(c2)

        # -- gate b: the port's App(device="cpu") fed the same documents
        # by the same stub answers the same searches up to ties
        t1 = time.perf_counter()
        route.start()
        cpu = boot("cpu", device="cpu")
        ctoken, _ = register(cpu)
        stop(cpu)
        cpu = boot("cpu", device="cpu")
        cc = client(cpu, ctoken)
        c3 = stub.snapshot()
        cpid = _expect(*cc.call("POST", "/api/v1/collections",
                                {"title": "remote", "config": p_config}), 201,
                       "create the CPU twin's P")["id"]
        twin_wall, twin_listing = ingest(cpu, cc, cpid, docs, "the CPU twin's P")
        twin_calls = stub.since(c3)
        if twin_calls != want:
            raise AssertionError(f"gate a: the CPU twin's ingest made {twin_calls} stub "
                                 f"calls, expected {want}")
        teng = cpu.app.ctx.engines.get(cpid)
        searches(cc, cpid, False, queries[:1])
        if teng.index._per_tile_k != eng.index._per_tile_k:
            raise AssertionError(f"gate b: the CPU twin calibrated a per-tile cap of "
                                 f"{teng.index._per_tile_k}, the card "
                                 f"{eng.index._per_tile_k}")
        _, twin_plain = searches(cc, cpid, False, queries)
        _, twin_rr = searches(cc, cpid, True, rr_queries)
        twin_s = time.perf_counter() - t1
        tname_of = {d["id"]: d["name"] for d in twin_listing}
        worst = 0.0
        for what, qs, mine, theirs, tol in (
                ("unreranked", queries, served_plain, twin_plain, 1e-3),
                ("reranked", rr_queries, served_rr, twin_rr, 1e-6)):
            for q, got, want_items in zip(qs, mine, theirs):
                worst = max(worst, _same_up_to_ties(
                    _items_key(want_items, tname_of), _items_key(got, name_of),
                    lambda r: r["key"], tol, f"gate b: {what} search {q!r}"))
        plog(f"gate b: App(device=\"cpu\") (dense_topk's plain version on the card's route, "
             f"per-tile cap {teng.index._per_tile_k} as on the card) fed the same "
             f"{len(docs)} documents by the same stub ({twin_calls['embedding']} embedding "
             f"calls, {twin_calls['completion']} completions; ingest {twin_wall:.3f} s, all "
             f"{twin_s:.3f} s) answers each of the {len(queries)} unreranked and "
             f"{len(rr_queries)} reranked searches as the card, up to ties (largest score "
             f"difference {worst:.3g})")
        route.stop()

        # -- the kernel at the served shapes, against its plain version
        rows = {}
        for key, sel in (("remote", calls[n_plain - 1]), ("remote_rerank", calls[-1])):
            row = _served_kernel_row(sel["args"], n_plain if key == "remote"
                                     else len(calls) - n_plain, len(queries), plog)
            rows[key] = row
            results[f"dense_topk_http_{key}"] = row
            results["dense_topk"][f"http_{key}"] = {
                k: row[k] for k in ("variant", "ms", "launches", "bound_ms", "bound_by",
                                    "plain_ms", "library_ms", "max_abs_err")}

        # -- the same kernel at text-embedding-3-large's width, over seeded
        # rows of P's shape (rows, tiles, mask, kt): no served collection is
        # that wide here, so one query a call through dense_topk, counted
        wide_gen = torch.Generator(device=DEVICE).manual_seed(SEED + 33)
        for key, sel in (("remote", calls[n_plain - 1]), ("remote_rerank", calls[-1])):
            _, _, _, _, _, mask, n, tile, kt = sel["args"]
            corpus = build_corpus(torch.randn(n, PROV_WIDE_DIM, device=DEVICE,
                                              generator=wide_gen), dtype=torch.bfloat16)
            wide_q = torch.randn(PROV_QUERIES, PROV_WIDE_DIM, device=DEVICE, generator=wide_gen)
            wide: list = []
            counts0 = _counts()
            with mock.patch.object(dt, "tile_topk", recording_into(wide)):
                for i in range(PROV_QUERIES):
                    dt.dense_topk(wide_q[i:i + 1], corpus, k=kt, mask=mask, tile=tile,
                                  per_tile_k=kt, device=DEVICE)
            torch.cuda.synchronize()
            wide_launched = {k: v - counts0[k] for k, v in _counts().items() if v - counts0[k]}
            bad = on_the_tensor_cores(wide, wide_launched, PROV_WIDE_DIM)
            if bad or len(wide) != PROV_QUERIES:
                raise AssertionError(f"gate c: {PROV_QUERIES} calls at D = {PROV_WIDE_DIM} "
                                     f"launched {wide_launched}: {bad[:3]}")
            row = _served_kernel_row(wide[-1]["args"], len(wide), PROV_QUERIES, plog)
            results[f"dense_topk_http_{key}_{PROV_WIDE_DIM}"] = row
            results["dense_topk"][f"http_{key}_{PROV_WIDE_DIM}"] = {
                k: row[k] for k in ("variant", "ms", "launches", "bound_ms", "bound_by",
                                    "plain_ms", "library_ms", "max_abs_err")}

        # -- gate d: /v1/embeddings serves collection O's encoder; App B's
        # collection S, embedded through it, answers as O
        t1 = time.perf_counter()
        s_docs, s_queries = http_corpus(torch.Generator(device=DEVICE).manual_seed(SEED + 32),
                                        PROV_S_DOCS, PROV_S_SECTIONS)
        s_queries = s_queries[:PROV_S_QUERIES]
        oid = _expect(*ca.call("POST", "/api/v1/collections", {"title": "onboard", "config": {
            "index_dtype": "bfloat16",
            "embedding": {"provider": "onboard", "model": os.path.join(tmp, "enc")}}}), 201,
            "create collection O")["id"]
        oeng = a.app.ctx.engines.get(oid)
        _, o_listing = ingest(a, ca, oid, s_docs, "collection O")
        key = _expect(*ca.call("POST", "/api/v1/apikeys", {"description": "collection S"}),
                      201, "api key")["key"]
        texts = [t for _, t in s_docs[:2]] + s_queries[:4]
        served = _expect(*ca.call("POST", "/v1/embeddings", {"input": texts, "model": oid}),
                         200, "/v1/embeddings")
        got = np.asarray([d["embedding"] for d in served["data"]], np.float32)
        own = oeng.embedder.embed(texts)
        if got.shape != own.shape or not np.array_equal(got, own):
            raise AssertionError(f"gate d: /v1/embeddings differs from collection O's encoder "
                                 f"(max |diff| {np.abs(got - own).max():.3g})")
        b = boot("b")
        cb = client(b)
        _expect(*cb.call("POST", "/api/v1/auth/register",
                         {"username": "smoke", "password": "smoke-password"}), 201, "register")
        cb = client(b, _login(b.app.port))
        _expect(*cb.call("POST", "/api/v1/llm_providers", {
            "name": "super-rag-a", "base_url": f"http://127.0.0.1:{a.app.port}/v1"}), 201,
            "register App A as a provider")
        public_key(b, "super-rag-a", key)
        _expect(*cb.call("POST", "/api/v1/llm_providers/super-rag-a/models",
                         {"api": "embedding", "model": oid}), 201, "O as a model")
        sid = _expect(*cb.call("POST", "/api/v1/collections", {"title": "via-a", "config": {
            "index_dtype": "bfloat16",
            "embedding": {"provider": "super-rag-a", "model": oid}}}), 201,
            "create collection S")["id"]
        seng = b.app.ctx.engines.get(sid)
        if not (isinstance(seng.embedder, RemoteEmbedder)
                and seng.index.spec.dim == oeng.index.spec.dim):
            raise AssertionError(f"gate d: collection S embeds with "
                                 f"{type(seng.embedder).__name__}, D {seng.index.spec.dim}")
        _, s_listing = ingest(b, cb, sid, s_docs, "collection S")
        o_name = {d["id"]: d["name"] for d in o_listing}
        s_name = {d["id"]: d["name"] for d in s_listing}
        searches(ca, oid, False, s_queries[:1])
        searches(cb, sid, False, s_queries[:1])
        s_calls: list = []
        _reset_counts()
        counts0 = _counts()
        with mock.patch.object(dt, "tile_topk", recording_into(calls)):
            n0 = len(calls)
            _, o_items = searches(ca, oid, False, s_queries, calls)
            n1 = len(calls)
            _, s_items = searches(cb, sid, False, s_queries, calls)
            s_calls = calls[n1:]
        torch.cuda.synchronize()
        s_launched = {k: v - counts0[k] for k, v in _counts().items() if v - counts0[k]}
        worst_s = 0.0
        for q, want_items, got_items in zip(s_queries, o_items, s_items):
            worst_s = max(worst_s, _same_up_to_ties(
                _items_key(want_items, o_name), _items_key(got_items, s_name),
                lambda r: r["key"], 1e-3, f"gate d: S against O, {q!r}"))
        n_rows = min(seng.index.size, oeng.index.size)
        same_rows = int((seng.index.emb[:n_rows] == oeng.index.emb[:n_rows]).all(dim=1).sum())
        if any((r["variant"], r["mode"]) != ("tcs", dt.MODE_BF16) for r in calls[n0:]):
            raise AssertionError(f"gate d: O and S dispatches took "
                                 f"{[(r['variant'], r['mode']) for r in calls[n0:]][:4]}")
        plog(f"gate d: POST /v1/embeddings of App A returns collection O's encoder vectors "
             f"bit for bit ({len(texts)} texts, D = {got.shape[1]}); App B's collection S, "
             f"embedded through it ({PROV_S_DOCS} documents, {seng.index.live_count} rows), "
             f"answers each of {len(s_queries)} searches as O does up to ties (largest "
             f"score difference {worst_s:.3g}; {same_rows} of {n_rows} stored rows bit-equal "
             f"to O's) ({len(s_calls)} of {len(calls) - n0} dispatches S's, every one "
             f"dense_topk_tcs_kernel bf16 at D = {seng.index.spec.dim}; counters "
             f"{s_launched}); {time.perf_counter() - t1:.3f} s")

        # -- gates a (the remote path was taken) and e
        if records.fallbacks:
            raise AssertionError(f"gate a: fallbacks were logged: {records.fallbacks[:3]}")
        if records.errors:
            raise AssertionError(f"gate e: {len(records.errors)} ERROR records: "
                                 f"{records.errors[:3]}")
        plog(f"gate a: every document of P COMPLETE with its vector and summary index, P's "
             f"engine holds a RemoteEmbedder of dim {PROV_DIM}, the stub counted the expected "
             f"embedding, rerank and completion calls, no fallback logged; gate e: no ERROR "
             f"record from the port's loggers; gates a-e passed")
        results["providers"] = {
            "ingest_s": wall, "chunks_per_s": n_chunks / wall, "rows": eng.index.live_count,
            "search_p50": _pctl(lat_plain, 50), "search_p99": _pctl(lat_plain, 99),
            "rerank_p50": _pctl(lat_rr, 50), "rerank_p99": _pctl(lat_rr, 99),
            "stub_round_trip_p50": _pctl(rt, 50), "stub_calls": ingest_calls,
            "phase_s": time.perf_counter() - t_phase}
        plog(f"p50s: search {_pctl(lat_plain, 50):.3f} ms, reranked search "
             f"{_pctl(lat_rr, 50):.3f} ms, ingest {n_chunks / wall:.1f} chunks/s, stub round "
             f"trip {_pctl(rt, 50):.3f} ms (one text embedded, {rt_calls['embedding']} calls "
             f"through the port's OpenAICompatClient)")
    finally:
        route.stop()
        for _, c in clients:
            c.close()
        t1 = time.perf_counter()
        for srv in reversed(apps):
            srv.stop()
        log(f"[providers] teardown: {len(apps)} Apps stopped (each snapshots its engines "
            f"to its data dir) in {time.perf_counter() - t1:.2f} s")
        stub.stop()
        port_logger.removeHandler(records)
        shutil.rmtree(tmp, ignore_errors=True)

# -- [workflows]: a saved RAG workflow through the workflow routes ------------


def workflow_definition(cids: list, strategy: str = "rrf",
                        rerank_top_k: int = None) -> dict:
    """The reference's RAG shape over collections ``cids``: start ->
    vector_search + fulltext_search (WF_TOP_K each, over every collection)
    -> merge -> rerank (the App's default reranker) -> llm (no completion
    model: it echoes the top document, as an offline deployment does)."""
    return {
        "name": "rag",
        "input_schema": {"query": {"type": "string", "default": ""}},
        "graph": {
            "nodes": [
                {"id": "start", "type": "start", "data": {}},
                {"id": "vs", "type": "vector_search",
                 "data": {"input_values": {"top_k": WF_TOP_K, "similarity_threshold": 0.0,
                                           "collection_ids": list(cids)}}},
                {"id": "fs", "type": "fulltext_search",
                 "data": {"input_values": {"top_k": WF_TOP_K,
                                           "collection_ids": list(cids)}}},
                {"id": "merge", "type": "merge",
                 "data": {"input_values": {
                     "vector_docs": "{{ nodes.vs.output.docs }}",
                     "fulltext_docs": "{{ nodes.fs.output.docs }}",
                     "strategy": strategy}}},
                {"id": "rerank", "type": "rerank",
                 "data": {"input_values": {
                     "docs": "{{ nodes.merge.output.docs }}",
                     "top_k": WF_RERANK_TOP_K if rerank_top_k is None else rerank_top_k}}},
                {"id": "llm", "type": "llm",
                 "data": {"input_values": {"docs": "{{ nodes.rerank.output.docs }}"}}},
            ],
            "edges": [
                {"source": "start", "target": "vs", "targetHandle": "query"},
                {"source": "start", "target": "fs", "targetHandle": "query"},
                {"source": "vs", "target": "merge", "targetHandle": "vector_docs"},
                {"source": "fs", "target": "merge", "targetHandle": "fulltext_docs"},
                {"source": "merge", "target": "rerank", "targetHandle": "docs"},
                {"source": "rerank", "target": "llm", "targetHandle": "docs"},
            ],
        },
    }


def workflow_yaml(defn: dict) -> str:
    """``defn`` written as a user writes YAML by hand: block mappings, an
    indentless edge list, flow lists and mappings, quoted templates and
    comments."""
    lines = ["# the saved RAG workflow", f"name: {defn['name']}", "input_schema:",
             "  query: {type: string, default: ''}", "graph:", "  nodes:"]
    for n in defn["graph"]["nodes"]:
        lines += [f"    - id: {n['id']}", f"      type: {n['type']}"]
        values = n["data"].get("input_values")
        if not values:
            lines.append("      data: {}")
            continue
        lines += ["      data:", "        input_values:"]
        for k, v in values.items():
            text = (f"[{', '.join(v)}]" if isinstance(v, list)
                    else f'"{v}"' if isinstance(v, str) else str(v))
            lines.append(f"          {k}: {text}")
    lines.append("  edges:  # each into a port of its target")
    for e in defn["graph"]["edges"]:
        lines += [f"  - source: {e['source']}", f"    target: {e['target']}",
                  f"    targetHandle: '{e['targetHandle']}'"]
    return "\n".join(lines) + "\n"


def _sse_events(text: str) -> list:
    out = []
    for frame in text.strip().split("\n\n"):
        name, data = None, []
        for line in frame.splitlines():
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                data.append(line[len("data: "):])
        out.append((name, json.loads("\n".join(data))))
    return out


def phase_workflows(results: dict) -> None:
    """A saved workflow of the reference's RAG shape on the port's own App
    at the deployment's defaults, as [http] sets it up (ThreadScheduler
    ingest, the [semantic] encoder and cross-encoder as checkpoints the
    port writes, the QueryBatcher): collection A (bf16, the default) of
    WF_DOCS_A documents and B (int8) of WF_DOCS_B, both of [http]'s
    recipe; the workflow created by ``POST /api/v1/workflows``, edited into
    a second version by ``POST .../versions``, and its definition also
    written as YAML and parsed by the port's parser; WF_SINGLE runs of it
    from one client, WF_CONCURRENT from WF_CLIENTS clients, WF_ONE_SHOT
    one-shot runs of the YAML text and WF_STREAM streamed ones; one run
    split into stages; gates a-f."""
    import dataclasses
    import logging
    import shutil
    import tempfile
    import threading

    from super_rag_tpu_torch.api.http import HttpServer
    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.models.encoder import flax_params
    from super_rag_tpu_torch.models.encoder_service import EncoderService, save_params
    from super_rag_tpu_torch.nodeflow.engine import NodeflowEngine
    from super_rag_tpu_torch.nodeflow.models import SystemInput
    from super_rag_tpu_torch.nodeflow.parser import NodeflowParser
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.service.rerank_service import RerankService
    from super_rag_tpu_torch.service.workflow_service import WorkflowService
    from super_rag_tpu_torch.store.db import Database

    card = results["card"]
    t_phase = time.perf_counter()

    def wlog(msg: str) -> None:
        log(f"[workflows] {msg} (on {card})")

    class _Errors(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(f"{record.name}: {record.getMessage()}")

    errors = _Errors()
    port_logger = logging.getLogger("super_rag_tpu_torch")
    port_logger.addHandler(errors)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_workflows_")
    srv = None
    c = None
    try:
        # -- the deployment, as [http] sets it up
        t0 = time.perf_counter()
        cfg = semantic_config(torch.bfloat16)
        enc = EncoderService(cfg, max_len=cfg.max_len, seed=SEED, device=DEVICE)
        rr = RerankService(cfg, max_len=cfg.max_len, seed=SEED + 1, device=DEVICE)
        save_params(flax_params(enc.model), os.path.join(tmp, "enc"), cfg)
        save_params(flax_params(rr.model), os.path.join(tmp, "ce"), cfg)
        del enc, rr
        settings = dataclasses.replace(
            Settings(), data_dir=os.path.join(tmp, "data"), port=0,
            reranker_checkpoint=os.path.join(tmp, "ce"), ingest_backend="thread",
            batch_max=64, chunk_size=400, encoder_checkpoint="")
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
        n_queries = WF_SINGLE + WF_CONCURRENT + WF_ONE_SHOT + WF_STREAM
        docs, queries = http_corpus(gen, WF_DOCS_A + WF_DOCS_B, HTTP_SECTIONS, n_queries)
        q_single = queries[:WF_SINGLE]
        q_conc = queries[WF_SINGLE:WF_SINGLE + WF_CONCURRENT]
        q_once = queries[WF_SINGLE + WF_CONCURRENT:n_queries - WF_STREAM]
        q_stream = queries[n_queries - WF_STREAM:]
        srv = _AppThread(settings)
        port = srv.app.port
        c = _Client(port)
        _expect(*c.call("POST", "/api/v1/auth/register",
                        {"username": "smoke", "password": "smoke-password"}), 201,
                "register")
        c.close()
        token = _login(port)
        c = _Client(port, token)
        colls = {}
        for name, extra in (("A", {}), ("B", {"index_dtype": "int8"})):
            config = {"embedding": {"provider": "onboard",
                                    "model": os.path.join(tmp, "enc")}, **extra}
            colls[name] = _expect(*c.call("POST", "/api/v1/collections",
                                          {"title": name, "config": config}), 201,
                                  f"create collection {name}")["id"]
        engines = {name: srv.app.ctx.engines.get(cid) for name, cid in colls.items()}
        for name, want in (("A", torch.bfloat16), ("B", torch.int8)):
            if engines[name].index.spec.dtype != want:
                raise AssertionError(f"collection {name} stores "
                                     f"{engines[name].index.spec.dtype}")
        reranker = srv.app.ctx.services_for_nodeflow()["reranker"]
        if not (isinstance(reranker, RerankService)
                and reranker.device.type == torch.device(DEVICE).type):
            raise AssertionError(f"gate d: the workflows' reranker is "
                                 f"{type(reranker).__name__}")
        wlog(f"App on port {port} (ThreadScheduler ingest, batch_max {settings.batch_max}); "
             f"encoder and cross-encoder {cfg.num_layers} x {cfg.hidden_dim} bf16 from "
             f"checkpoints the port wrote; collections A (bf16) and B (int8); set-up "
             f"{time.perf_counter() - t0:.2f} s")

        # -- ingest: A and B, every document COMPLETE
        t1 = time.perf_counter()
        for name, mine in (("A", docs[:WF_DOCS_A]), ("B", docs[WF_DOCS_A:])):
            cid = colls[name]
            for dname, text in mine:
                _expect(*c.call("POST", f"/api/v1/collections/{cid}/documents",
                                {"name": dname, "content": text}), 201, "upload")
        for name, count in (("A", WF_DOCS_A), ("B", WF_DOCS_B)):
            while True:
                listing = _expect(*c.call("GET", f"/api/v1/collections/{colls[name]}"
                                                 f"/documents"), 200, "list documents")
                status = [d["status"] for d in listing]
                if "FAILED" in status:
                    raise AssertionError(f"a document of {name} FAILED")
                if len(status) == count and set(status) == {"COMPLETE"}:
                    break
                if time.perf_counter() - t1 > HTTP_INGEST_TIMEOUT_S:
                    raise AssertionError(f"ingest of {name} not complete")
                time.sleep(0.1)
            want = count * HTTP_SECTIONS
            if engines[name].index.live_count != want:
                raise AssertionError(f"{name} holds {engines[name].index.live_count} chunks, "
                                     f"expected {want}")
        wlog(f"ingest: A {WF_DOCS_A} documents ({WF_DOCS_A * HTTP_SECTIONS} chunks), B "
             f"{WF_DOCS_B} ({WF_DOCS_B * HTTP_SECTIONS} chunks), every document COMPLETE "
             f"after {time.perf_counter() - t1:.3f} s")
        # warm each collection once: its first search compacts the lexical
        # index and calibrates the per-tile cap (not part of the timed runs)
        for cid in colls.values():
            _expect(*c.call("POST", f"/api/v1/collections/{cid}/searches",
                            {"query": queries[0], "use_rerank": False}), 201, "warm-up")

        # -- the saved workflow: version 1, then version 2 by POST .../versions;
        # its YAML text parses to the same flow as its JSON
        cids = [colls["A"], colls["B"]]
        defn = workflow_definition(cids)
        first = _expect(*c.call("POST", "/api/v1/workflows", {
            "title": "rag", "definition": workflow_definition(cids, "union", 3)}), 201,
            "create workflow")
        wid = first["id"]
        v2 = _expect(*c.call("POST", f"/api/v1/workflows/{wid}/versions",
                             {"definition": defn}), 201, "new version")
        got = _expect(*c.call("GET", f"/api/v1/workflows/{wid}"), 200, "get workflow")
        if (first["version"], v2["version"], got["version"]) != (1, 2, 2) or \
                got["definition"] != defn:
            raise AssertionError(f"gate a: versions {first['version']}, {v2['version']}, "
                                 f"{got['version']}")
        versions = _expect(*c.call("GET", f"/api/v1/workflows/{wid}/versions"), 200,
                           "versions")
        if [v["version"] for v in versions] != [1, 2]:
            raise AssertionError(f"gate a: versions {[v['version'] for v in versions]}")
        yaml_text = workflow_yaml(defn)
        parser = NodeflowParser()
        from_json, from_yaml = parser.parse(defn), parser.parse(yaml_text)
        if (dataclasses.asdict(from_json[0]), from_json[1]) != \
                (dataclasses.asdict(from_yaml[0]), from_yaml[1]):
            raise AssertionError("the YAML text parses to another flow than the JSON")
        wlog(f"workflow {wid}: version 1 by POST /api/v1/workflows, version 2 by POST "
             f".../versions (the runs use it); its {len(yaml_text.splitlines())}-line YAML "
             f"text parses to the JSON's flow ({len(from_json[0].nodes)} nodes, "
             f"{len(from_json[0].edges)} edges)")

        # -- the traffic, with the dense dispatches and the cross-encoder counted
        real_tile_topk = dt.tile_topk
        real_search_batch = CollectionEngine.search_batch
        real_rerank = RerankService.__call__
        name_of = {id(eng): name for name, eng in engines.items()}
        local = threading.local()
        dense: dict = {"A": 0, "B": 0}
        biggest: dict = {}
        ce_calls = [0]

        def search_batch(self, queries_, *a, **kw):
            local.name = name_of.get(id(self)) if kw.get("mode") == "dense" else None
            if local.name is not None:
                dense[local.name] += 1
            try:
                return real_search_batch(self, queries_, *a, **kw)
            finally:
                local.name = None

        def tile_topk(*args):
            name = getattr(local, "name", None)
            if name is not None and args[0].shape[0] >= biggest.get(
                    name, (torch.empty(0),))[0].shape[0]:
                biggest[name] = args
            return real_tile_topk(*args)

        def rerank(self, *a, **kw):
            ce_calls[0] += 1
            return real_rerank(self, *a, **kw)

        runs: dict = {}
        served: list = []
        run_ids: list = []
        _reset_counts()
        with mock.patch.object(dt, "tile_topk", tile_topk), \
                mock.patch.object(CollectionEngine, "search_batch", search_batch), \
                mock.patch.object(RerankService, "__call__", rerank):
            m0 = _metrics(port, token)
            lat = []
            for q in q_single:
                t1 = time.perf_counter()
                out = _expect(*c.call("POST", f"/api/v1/workflows/{wid}/run",
                                      {"inputs": {"query": q}}), 200, "run")
                lat.append((time.perf_counter() - t1) * 1e3)
                served.append(out)
                run_ids.append(out["run_id"])
            m1 = _metrics(port, token)
            runs["saved, 1 client"] = {"p50": _pctl(lat, 50), "p99": _pctl(lat, 99),
                                       "runs_s": len(lat) / (sum(lat) / 1e3),
                                       "dispatches": m1["dispatches"] - m0["dispatches"]}

            per = WF_CONCURRENT // WF_CLIENTS
            clat: list = []
            cfail: list = []
            barrier = threading.Barrier(WF_CLIENTS + 1)

            def client(k):
                cc = _Client(port, token)
                try:
                    barrier.wait()
                    for q in q_conc[k * per:(k + 1) * per]:
                        t2 = time.perf_counter()
                        st, body = cc.call("POST", f"/api/v1/workflows/{wid}/run",
                                           {"inputs": {"query": q}})
                        clat.append((time.perf_counter() - t2) * 1e3)
                        if st != 200 or body.get("status") != "SUCCESS":
                            cfail.append((st, str(body)[:200]))
                        else:
                            run_ids.append(body["run_id"])
                finally:
                    cc.close()

            threads = [threading.Thread(target=client, args=(k,)) for k in range(WF_CLIENTS)]
            for th in threads:
                th.start()
            barrier.wait()
            t1 = time.perf_counter()
            for th in threads:
                th.join(600)
            cwall = time.perf_counter() - t1
            if cfail or any(th.is_alive() for th in threads):
                raise AssertionError(f"gate a: concurrent runs failed: {cfail[:3]}")
            m2 = _metrics(port, token)
            runs[f"saved, {WF_CLIENTS} clients"] = {
                "p50": _pctl(clat, 50), "p99": _pctl(clat, 99), "runs_s": len(clat) / cwall,
                "dispatches": m2["dispatches"] - m1["dispatches"]}

            lat = []
            once = []
            for q in q_once:
                t1 = time.perf_counter()
                out = _expect(*c.call("POST", "/api/v1/workflows/run",
                                      {"definition": yaml_text, "inputs": {"query": q}}),
                              200, "one-shot run")
                lat.append((time.perf_counter() - t1) * 1e3)
                once.append(out)
                run_ids.append(out["run_id"])
            m3 = _metrics(port, token)
            runs["one-shot (YAML), 1 client"] = {
                "p50": _pctl(lat, 50), "p99": _pctl(lat, 99),
                "runs_s": len(lat) / (sum(lat) / 1e3),
                "dispatches": m3["dispatches"] - m2["dispatches"]}

            lat = []
            streams = []
            for q in q_stream:
                t1 = time.perf_counter()
                st, text = c.call("POST", "/api/v1/workflows/run/stream",
                                  {"definition": defn, "inputs": {"query": q}})
                lat.append((time.perf_counter() - t1) * 1e3)
                _expect(st, text, 200, "streamed run")
                streams.append(_sse_events(text))
                run_ids.append(streams[-1][-1][1]["run_id"])
            m4 = _metrics(port, token)
            runs["streamed, 1 client"] = {
                "p50": _pctl(lat, 50), "p99": _pctl(lat, 99),
                "runs_s": len(lat) / (sum(lat) / 1e3),
                "dispatches": m4["dispatches"] - m3["dispatches"]}
            launched = _counts()
        torch.cuda.synchronize()
        n_runs = len(run_ids)
        for what, r in runs.items():
            wlog(f"{what}: p50 {r['p50']:.3f} ms, p99 {r['p99']:.3f} ms, "
                 f"{r['runs_s']:.2f} runs/s; batcher {r['dispatches']:.0f} dispatches")

        # -- gate a: statuses, the stored rows, the streamed events
        node_ids = [n["id"] for n in defn["graph"]["nodes"]]
        for out in served + once:
            if out["status"] != "SUCCESS" or sorted(out["outputs"]) != sorted(node_ids):
                raise AssertionError(f"gate a: run {out['run_id']} answered "
                                     f"{out['status']} with nodes {list(out['outputs'])}")
        for rid in run_ids:
            row = _expect(*c.call("GET", f"/api/v1/workflow-runs/{rid}"), 200, "run row")
            kinds = sorted((nr["node_id"], nr["status"]) for nr in row["node_runs"])
            if row["status"] != "SUCCESS" or kinds != sorted((n, "SUCCESS")
                                                             for n in node_ids):
                raise AssertionError(f"gate a: run {rid} row {row['status']}, node rows "
                                     f"{kinds}")
        listed = _expect(*c.call("GET", f"/api/v1/workflows/{wid}/runs"), 200, "runs")
        if len(listed) != WF_SINGLE + WF_CONCURRENT or any(r["version"] != 2 for r in listed):
            raise AssertionError(f"gate a: the workflow lists {len(listed)} runs")
        levels = {"start": 0, "vs": 1, "fs": 1, "merge": 2, "rerank": 3, "llm": 4}
        for events in streams:
            names = [n for n, _ in events]
            per_node = sorted((n, d.get("node_id")) for n, d in events
                              if n in ("NODE_START", "NODE_END"))
            order = [levels[d["node_id"]] for n, d in events
                     if n in ("NODE_START", "NODE_END")]
            if (names[0] != "FLOW_START" or names[-2:] != ["FLOW_END", "RESULT"]
                    or per_node != sorted([("NODE_START", n) for n in node_ids]
                                          + [("NODE_END", n) for n in node_ids])
                    or order != sorted(order) or events[-1][1]["status"] != "SUCCESS"):
                raise AssertionError(f"gate a: streamed events {names}")
        wlog(f"gate a: {n_runs} runs answered SUCCESS; each has a workflow_run row SUCCESS "
             f"and one node_run row SUCCESS per node ({len(node_ids)}); the workflow lists "
             f"its {len(listed)} runs at version 2; each of {WF_STREAM} streams is FLOW_START, "
             f"NODE_START / NODE_END per node level by level, FLOW_END, RESULT")

        # -- gate b: each single-client run against an in-process run of the
        # same definition on the same App with no batcher
        flow, defaults = from_json
        services = {**srv.app.ctx.services_for_nodeflow(), "batcher": None}
        loop = asyncio.new_event_loop()
        worst = 0.0
        sizes = {"vs": 0, "fs": 0, "merge": 0}
        try:
            for q, out in zip(q_single, served):
                ctx = loop.run_until_complete(NodeflowEngine().execute_nodeflow(
                    flow, SystemInput(query=q, user="smoke"),
                    globals_={**defaults, "query": q}, services=services))
                want = {nid: o.model_dump() for nid, o in ctx.outputs.items()}
                got = out["outputs"]
                for nid in ("vs", "fs", "merge"):
                    if not got[nid]["docs"] and nid != "merge":
                        raise AssertionError(f"gate b: {nid} answered no document for {q!r}")
                    if got[nid] != want[nid]:
                        raise AssertionError(f"gate b: {nid} served != in-process for {q!r}")
                    sizes[nid] += len(got[nid]["docs"])
                key = lambda d: (d["text"], d["metadata"], d["recall_type"])  # noqa: E731
                g, w = got["rerank"]["docs"], want["rerank"]["docs"]
                if [key(d) for d in g] != [key(d) for d in w] or len(g) != WF_RERANK_TOP_K:
                    raise AssertionError(f"gate b: rerank served != in-process for {q!r}")
                worst = max(worst, _close(torch.tensor([d["score"] for d in g]),
                                          torch.tensor([d["score"] for d in w]), 2e-2))
                if got["llm"]["text"] != g[0]["text"]:
                    raise AssertionError(f"gate b: llm answered another text for {q!r}")
        finally:
            loop.close()
        wlog(f"gate b: each of {WF_SINGLE} single-client runs equals an in-process run of the "
             f"same definition on the same App with no batcher: vector_search (mean "
             f"{sizes['vs'] / WF_SINGLE:.1f} documents), fulltext_search "
             f"({sizes['fs'] / WF_SINGLE:.1f}) and merge ({sizes['merge'] / WF_SINGLE:.1f}) "
             f"to the bit; rerank items equal, CE scores within {worst:.3g} (1 + |s|) "
             f"(limit 2e-2); the llm text the top reranked text")

        # -- gate c: each dense dispatch launched the tensor-core kernel in
        # the collection's mode; the kernel at the largest served batch
        sms = dt._sm_count(torch.cuda.current_device())
        # the dense route quantizes no query: bf16 queries over A's bf16
        # rows and over B's int8 rows
        want_keys = {"A": TC_MODE_KEYS[dt.MODE_BF16], "B": TC_MODE_KEYS[dt.MODE_INT8_BF16]}
        got_launched = {k: v for k, v in launched.items() if v}
        if any(launched[want_keys[n]] != dense[n] or dense[n] < 1 for n in dense):
            raise AssertionError(f"gate c: dense dispatches {dense}, launches {got_launched}")
        for name in ("A", "B"):
            q, _, values, *_, n_scan, tile, kt = biggest[name]
            mode = dt._mode(q, values)
            variant = dt.kernel_variant(mode, kt, q.shape[1], q.shape[0],
                                        -(-n_scan // tile), sms)
            if variant != "tcs" or TC_MODE_KEYS[mode] != want_keys[name]:
                raise AssertionError(f"gate c: {name} took {variant} in mode {mode}")
            row = _served_kernel_row(biggest[name], launched[want_keys[name]], dense[name],
                                     wlog)
            results[f"dense_topk_workflow_{'bf16' if name == 'A' else 'int8'}"] = row
        wlog(f"gate c: every vector_search dispatch launched dense_topk's tensor-core kernel "
             f"in its collection's mode (A {dense['A']} dispatches, bf16 x bf16; B "
             f"{dense['B']}, bf16 queries x int8 rows); counters "
             f"{got_launched}")

        # -- gate d: the cross-encoder ran on the card, once a run
        if ce_calls[0] != n_runs:
            raise AssertionError(f"gate d: {ce_calls[0]} cross-encoder calls over {n_runs} "
                                 f"runs")
        wlog(f"gate d: the cross-encoder ({reranker.device}) ran {ce_calls[0]} times, once "
             f"for each run's rerank node")

        # -- one saved run split into stages, by wrapped methods
        st_ = _Stages()
        st_.wrap_async(HttpServer, "_dispatch", "dispatch")
        st_.wrap_async(WorkflowService, "run_definition", "service")
        st_.wrap_sync(NodeflowParser, "parse", "parse")
        for attr in ("create_workflow_run", "add_node_run", "finish_workflow_run"):
            st_.wrap_sync(Database, attr, "db")
        st_.wrap_async(QueryBatcher, "search", "batcher")
        st_.wrap_sync(CollectionEngine, "search_batch", "search_batch", sync=True)
        st_.wrap_sync(RerankService, "__call__", "rerank", sync=True)
        real_node = NodeflowEngine._execute_node

        async def node(self, n, *a, **kw):
            t2 = time.perf_counter()
            try:
                return await real_node(self, n, *a, **kw)
            finally:
                st_._add(f"node {n.id}", t2)
        st_.patches.append(mock.patch.object(NodeflowEngine, "_execute_node", node))
        client_ms = []
        with st_:
            for q in q_single[:WF_STAGE_RUNS]:
                t1 = time.perf_counter()
                _expect(*c.call("POST", f"/api/v1/workflows/{wid}/run",
                                {"inputs": {"query": q}}), 200, "staged run")
                client_ms.append((time.perf_counter() - t1) * 1e3)
            deadline = time.perf_counter() + 5.0
            while (len(st_.ms.get("dispatch", ())) < WF_STAGE_RUNS
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
        per_run = {k: np.asarray(v).reshape(WF_STAGE_RUNS, -1).sum(axis=1)
                   for k, v in st_.ms.items()}
        per_run["client"] = np.asarray(client_ms)
        split = {
            "client total": per_run["client"],
            "HTTP + client (outside the handler)": per_run["client"] - per_run["dispatch"],
            "route + auth + audit": per_run["dispatch"] - per_run["service"],
            "parse": per_run["parse"],
            "db writes (run row, node rows, finish)": per_run["db"],
            **{f"node {n} (with its node_run row)": per_run[f"node {n}"]
               for n in node_ids},
            "  batcher wait (4 searches, summed; vs and fs overlap)":
                per_run["batcher"] - per_run["search_batch"],
            "  device searches (4 search_batch calls, summed)": per_run["search_batch"],
            "  rerank (CrossEncoder)": per_run["rerank"],
        }
        stages = {k: float(np.median(v)) for k, v in split.items()}
        wlog(f"stages of one saved run (median of {WF_STAGE_RUNS}; vs and fs run together): "
             + "; ".join(f"{k.strip()} {v:.3f} ms" for k, v in stages.items()))

        # -- gate e: the delete takes the versions and runs with it
        _expect(*c.call("DELETE", f"/api/v1/workflows/{wid}"), 204, "delete workflow")
        _expect(*c.call("GET", f"/api/v1/workflows/{wid}"), 404, "deleted workflow")
        _expect(*c.call("GET", f"/api/v1/workflows/{wid}/versions"), 404, "its versions")
        _expect(*c.call("GET", f"/api/v1/workflow-runs/{run_ids[0]}"), 404, "its run")
        left = srv.app.ctx.db.query_one(
            "SELECT (SELECT COUNT(*) FROM workflow_version WHERE workflow_id=?) AS v,"
            " (SELECT COUNT(*) FROM workflow_run WHERE workflow_id=?) AS r", (wid, wid))
        if left["v"] or left["r"]:
            raise AssertionError(f"gate e: {left} rows left")
        wlog("gate e: DELETE /api/v1/workflows/{wid} answered 204; the workflow, its "
             "versions and its runs answer 404 and no row of them is left")

        # -- gate f: no ERROR record
        if errors.records:
            raise AssertionError(f"gate f: {len(errors.records)} ERROR records: "
                                 f"{errors.records[:3]}")
        results["workflows"] = {"runs": runs, "stages": stages,
                                "phase_s": time.perf_counter() - t_phase}
        wlog("gates a-f passed; no ERROR record from the port's loggers")
    finally:
        if c is not None:
            c.close()  # the server's stop waits for its open connections
        if srv is not None:
            srv.stop()
        port_logger.removeHandler(errors)
        shutil.rmtree(tmp, ignore_errors=True)


def chat_completion(prompt: str) -> str:
    """The [chat] phase's completion model (the stub provider's
    ``complete_fn``): an agent prompt without a tool result gets one
    search_collections call for the user's query, with one an answer; a
    title prompt a title of the message's first words; a chat prompt an
    answer quoting its first passage."""
    import re

    if prompt.startswith("You are a retrieval assistant with tools."):
        query = prompt.rsplit("\nUser: ", 1)[-1].strip()
        if "[tool search_collections(" not in prompt:
            return json.dumps({"tool": "search_collections", "arguments": {"query": query}})
        return f"From the collection, on {query}: see the retrieved passages."
    if prompt.startswith("Give a 3-6 word title"):
        first = prompt.split("starts with: ", 1)[1].rsplit("\nTitle:", 1)[0]
        return " ".join(first.split()[:4])
    m = re.search(r"\[1\] (.{1,160})", prompt)
    return "Answer [1]: " + (m.group(1) if m else "no passage matched the question.")


def phase_chat(results: dict) -> None:
    """Chats, agents, sharing and the audit log on the port's own App, as
    [workflows] sets it up (ThreadScheduler ingest, the [semantic] encoder
    and cross-encoder as checkpoints the port writes, the QueryBatcher),
    with the stub provider of ``_provider_stub`` in this process as the
    collection completion model (registered through the routes, then a
    restart: the completion client is resolved at boot) answering with
    ``chat_completion``.  User A owns collection K (bf16) of CHAT_DOCS
    documents; user B is a second account.  Traffic: CHAT_SINGLE SSE
    turns from one client, CHAT_CONCURRENT from CHAT_CLIENTS clients,
    CHAT_FRONTEND frontend completions, CHAT_WS chat WebSocket turns
    (CHAT_WS_STOPS stopped mid-stream), a chat-file upload and
    CHAT_FILE_SEARCHES files/search, CHAT_AGENT_WS agent WebSocket turns
    and CHAT_AGENT_AG_UI AG-UI turns; K shared with B, published and
    subscribed, B's CHAT_SHARED_SEARCHES searches, then the unshare and
    unpublish; one offline web search; the audit log as A and as the
    admin.  Gates a-g."""
    import dataclasses
    import logging
    import shutil
    import tempfile

    from super_rag_tpu_torch.api.http import HttpServer
    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.llm.client import OpenAICompatClient
    from super_rag_tpu_torch.models.encoder import flax_params
    from super_rag_tpu_torch.models.encoder_service import EncoderService, save_params
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.service.collection_service import CollectionService
    from super_rag_tpu_torch.service.rerank_service import RerankService
    from super_rag_tpu_torch.store.db import Database
    from super_rag_tpu_torch.websearch.service import WebSearchService

    card = results["card"]
    t_phase = time.perf_counter()

    def clog(msg: str) -> None:
        log(f"[chat] {msg} (on {card})")

    class _Errors(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(f"{record.name}: {record.getMessage()}")

    errors = _Errors()
    port_logger = logging.getLogger("super_rag_tpu_torch")
    port_logger.addHandler(errors)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chat_")
    sys.path.append(os.path.join(HERE, "tests"))
    from llm_stub import StubProvider

    stub = StubProvider(complete_fn=chat_completion, api_key=STUB_KEY)
    srv = None
    open_clients: list = []

    def client(token: str = ""):
        c = _Client(srv.app.port, token)
        open_clients.append(c)
        return c

    def close_clients() -> None:
        while open_clients:
            open_clients.pop().close()

    def login(name: str) -> str:
        c = client()
        st, body = c.call("POST", "/api/v1/auth/login",
                          {"username": name, "password": f"{name}-password"})
        return _expect(st, body, 200, f"login {name}")["token"]

    def register(name: str) -> str:
        _expect(*client().call("POST", "/api/v1/auth/register",
                               {"username": name, "password": f"{name}-password"}), 201,
                f"register {name}")
        return login(name)

    try:
        # -- the deployment: checkpoints, the App, the stub as the completion
        # model (through the routes), a restart
        t0 = time.perf_counter()
        cfg = semantic_config(torch.bfloat16)
        enc = EncoderService(cfg, max_len=cfg.max_len, seed=SEED, device=DEVICE)
        rr = RerankService(cfg, max_len=cfg.max_len, seed=SEED + 1, device=DEVICE)
        save_params(flax_params(enc.model), os.path.join(tmp, "enc"), cfg)
        save_params(flax_params(rr.model), os.path.join(tmp, "ce"), cfg)
        del enc, rr
        settings = dataclasses.replace(
            Settings(), data_dir=os.path.join(tmp, "data"), port=0,
            reranker_checkpoint=os.path.join(tmp, "ce"), ingest_backend="thread",
            batch_max=64, chunk_size=400, encoder_checkpoint="")
        srv = _AppThread(settings)
        admin_token = register("admin")  # the first account is the admin
        a_token = register("smoke")
        b_token = register("smoke-b")
        p_token = register("public")  # the key every collection's model uses
        admin = client(admin_token)
        _expect(*admin.call("POST", "/api/v1/llm_providers",
                            {"name": "stub", "base_url": stub.url}), 201, "provider")
        _expect(*client(p_token).call("POST", "/api/v1/llm_providers/stub/key",
                                      {"api_key": STUB_KEY}), 200, "provider key")
        _expect(*admin.call("POST", "/api/v1/llm_providers/stub/models",
                            {"api": "completion", "model": "chat-smoke",
                             "tags": ["default_for_collection_completion"]}), 201, "model")
        close_clients()
        srv.stop()
        srv = _AppThread(settings)
        if srv.app.ctx.completion is None:
            raise AssertionError("the restarted App resolved no completion client")
        port = srv.app.port
        a, admin = client(a_token), client(admin_token)
        config = {"embedding": {"provider": "onboard", "model": os.path.join(tmp, "enc")}}
        kid = _expect(*a.call("POST", "/api/v1/collections",
                              {"title": "K", "config": config}), 201, "collection K")["id"]
        engine = srv.app.ctx.engines.get(kid)
        if engine.index.spec.dtype != torch.bfloat16:
            raise AssertionError(f"K stores {engine.index.spec.dtype}")
        n_queries = (CHAT_SINGLE + CHAT_CONCURRENT + CHAT_FRONTEND + CHAT_WS
                     + CHAT_AGENT_WS + CHAT_AGENT_AG_UI + CHAT_SHARED_SEARCHES)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 51)
        docs, queries = http_corpus(gen, CHAT_DOCS, HTTP_SECTIONS, n_queries)
        pool = iter(queries)
        take = lambda n: [next(pool) for _ in range(n)]  # noqa: E731
        clog(f"App on port {port}, restarted so that its boot resolves the stub provider "
             f"(port {stub.port}) as the completion model; encoder and cross-encoder "
             f"{cfg.num_layers} x {cfg.hidden_dim} bf16; users admin, A (smoke), B "
             f"(smoke-b); set-up {time.perf_counter() - t0:.2f} s")

        t1 = time.perf_counter()
        for dname, text in docs:
            _expect(*a.call("POST", f"/api/v1/collections/{kid}/documents",
                            {"name": dname, "content": text}), 201, "upload")
        while True:
            listing = _expect(*a.call("GET", f"/api/v1/collections/{kid}/documents"), 200,
                              "list documents")
            status = [d["status"] for d in listing]
            if "FAILED" in status:
                raise AssertionError("a document of K FAILED")
            if len(status) == CHAT_DOCS and set(status) == {"COMPLETE"}:
                break
            if time.perf_counter() - t1 > HTTP_INGEST_TIMEOUT_S:
                raise AssertionError("ingest of K not complete")
            time.sleep(0.1)
        if engine.index.live_count != CHAT_DOCS * HTTP_SECTIONS:
            raise AssertionError(f"K holds {engine.index.live_count} chunks")
        _expect(*a.call("POST", f"/api/v1/collections/{kid}/searches",
                        {"query": queries[0]}), 201, "warm-up")
        clog(f"ingest: K {CHAT_DOCS} documents ({CHAT_DOCS * HTTP_SECTIONS} chunks, D "
             f"{engine.index.spec.dim}) COMPLETE after {time.perf_counter() - t1:.3f} s")

        # -- the traffic, with dense dispatches and completions counted
        real_tile_topk = dt.tile_topk
        real_search_batch = CollectionEngine.search_batch
        local = threading.local()
        dense = {"K": 0, "files": 0}
        variants: dict = {}
        biggest: list = []

        def search_batch(self, queries_, *args, **kw):
            local.name = "K" if self is engine else "files"
            dense[local.name] += 1
            try:
                return real_search_batch(self, queries_, *args, **kw)
            finally:
                local.name = None

        def tile_topk(*args):
            name = getattr(local, "name", None)
            q, _, values, *_, n_scan, tile, kt = args
            v = dt.kernel_variant(dt._mode(q, values), kt, q.shape[1], q.shape[0],
                                  -(-n_scan // tile), dt._sm_count(torch.cuda.current_device()))
            variants[(name, v)] = variants.get((name, v), 0) + 1
            if name == "K" and (not biggest or q.shape[0] >= biggest[0][0].shape[0]):
                biggest[:] = [args]
            return real_tile_topk(*args)

        def sse_turn(c, path, body):
            st, text = c.call("POST", path, body)
            _expect(st, text, 200, f"POST {path}")
            return _sse_events(text)

        turns: list = []  # (query, events) of every SSE chat turn
        lat: dict = {}
        before = stub.snapshot()
        _reset_counts()
        with mock.patch.object(dt, "tile_topk", tile_topk), \
                mock.patch.object(CollectionEngine, "search_batch", search_batch):
            # SSE from one client, CHAT_SINGLE_CHATS chats (each titled by its
            # first turn)
            chats = [_expect(*a.call("POST", "/api/v1/chats", {"collection_ids": [kid]}),
                             201, "chat")["id"] for _ in range(CHAT_SINGLE_CHATS)]
            ms = []
            for j, q in enumerate(take(CHAT_SINGLE)):
                t2 = time.perf_counter()
                turns.append((q, sse_turn(a, f"/api/v1/chats/{chats[j % len(chats)]}"
                                             f"/completions", {"message": q})))
                ms.append((time.perf_counter() - t2) * 1e3)
            lat["SSE, 1 client"] = ms
            titled = CHAT_SINGLE_CHATS

            # SSE from CHAT_CLIENTS clients, one chat each
            per = CHAT_CONCURRENT // CHAT_CLIENTS
            mine = take(CHAT_CONCURRENT)
            cms: list = []
            fails: list = []
            barrier = threading.Barrier(CHAT_CLIENTS + 1)

            def chatter(k):
                cc = _Client(port, a_token)
                try:
                    cid = _expect(*cc.call("POST", "/api/v1/chats",
                                           {"collection_ids": [kid]}), 201, "chat")["id"]
                    barrier.wait()
                    for q in mine[k * per:(k + 1) * per]:
                        t2 = time.perf_counter()
                        st, text = cc.call("POST", f"/api/v1/chats/{cid}/completions",
                                           {"message": q})
                        cms.append((time.perf_counter() - t2) * 1e3)
                        if st != 200:
                            fails.append((st, text[:200]))
                        else:
                            turns.append((q, _sse_events(text)))
                except Exception as e:  # noqa: BLE001 — reported below
                    fails.append(repr(e))
                finally:
                    cc.close()

            threads = [threading.Thread(target=chatter, args=(k,)) for k in range(CHAT_CLIENTS)]
            for th in threads:
                th.start()
            barrier.wait()
            t2 = time.perf_counter()
            for th in threads:
                th.join(600)
            cwall = time.perf_counter() - t2
            if fails or any(th.is_alive() for th in threads):
                raise AssertionError(f"concurrent turns failed: {fails[:3]}")
            lat[f"SSE, {CHAT_CLIENTS} clients"] = cms
            titled += CHAT_CLIENTS

            # frontend completions, each in a chat of its own over K (titled by
            # its turn), half JSON, half SSE
            ms = []
            frontend = []
            for j, q in enumerate(take(CHAT_FRONTEND)):
                cid = _expect(*a.call("POST", "/api/v1/chats", {"collection_ids": [kid]}),
                              201, "chat")["id"]
                path = f"/api/v1/chat/completions/frontend?chat_id={cid}"
                t2 = time.perf_counter()
                if j % 2:
                    frontend.append(("sse", q, sse_turn(a, path + "&stream=true",
                                                        {"message": q})))
                else:
                    frontend.append(("json", q, _expect(*a.call("POST", path, {"message": q}),
                                                        200, "frontend")))
                ms.append((time.perf_counter() - t2) * 1e3)
            lat["frontend"] = ms
            titled += CHAT_FRONTEND

            # the chat WebSocket: a titled chat; CHAT_WS_STOPS turns get a stop
            # frame once their start event is out
            ws_chat = _expect(*a.call("POST", "/api/v1/chats",
                                      {"title": "ws", "collection_ids": [kid]}), 201,
                              "ws chat")["id"]
            stops = {j for j in range(CHAT_WS) if j % (CHAT_WS // CHAT_WS_STOPS) == 2}
            ws_turns = []
            ws = WSClient(port, f"/api/v1/chats/{ws_chat}/connect", a_token)
            try:
                for j, q in enumerate(take(CHAT_WS)):
                    ws.send_json({"message": q})
                    events = [ws.recv_json()]
                    if j in stops:
                        ws.send_json({"type": "stop"})
                    while events[-1]["event"] not in ("done", "stopped", "error"):
                        events.append(ws.recv_json())
                    ws_turns.append((j in stops, q, events))
            finally:
                ws.close()

            # chat files: one upload, then searches scoped to the chat
            f_chat = _expect(*a.call("POST", "/api/v1/chats", {"title": "files"}), 201,
                             "files chat")["id"]
            note = docs[0][1][:4000].encode()
            boundary = "chatsmokeboundary"
            raw = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                   f"filename=\"note.md\"\r\nContent-Type: text/markdown\r\n\r\n").encode() \
                + note + f"\r\n--{boundary}--\r\n".encode()
            conn = a.conn
            conn.request("POST", f"/api/v1/chats/{f_chat}/documents", body=raw, headers={
                "Authorization": f"Bearer {a_token}",
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
            resp = conn.getresponse()
            upload = json.loads(resp.read())
            _expect(resp.status, upload, 201, "chat file upload")
            t2 = time.perf_counter()
            while _expect(*a.call("GET", f"/api/v1/chats/{f_chat}/documents/"
                                         f"{upload[0]['id']}"), 200,
                          "chat file")["status"] != "COMPLETE":
                if time.perf_counter() - t2 > HTTP_INGEST_TIMEOUT_S:
                    raise AssertionError("the chat file was not indexed")
                time.sleep(0.05)
            file_hits = []
            for q in queries[:CHAT_FILE_SEARCHES]:
                file_hits.append(_expect(*a.call(
                    "POST", f"/api/v1/chats/{f_chat}/files/search", {"query": q, "top_k": 3}),
                    200, "files/search")["items"])

            # agents: K as the agent's collection; WebSocket and AG-UI turns
            aid = _expect(*a.call("POST", "/api/v1/agents", {
                "title": "helper", "config": {"collection_ids": [kid]}}), 201, "agent")["id"]
            a_chat = _expect(*a.call("POST", f"/api/v1/agents/{aid}/chats",
                                     {"title": "agent"}), 201, "agent chat")["id"]
            agent_turns = []
            ms = []
            ws = WSClient(port, f"/api/v1/agents/{aid}/chats/{a_chat}/connect", a_token)
            try:
                for q in take(CHAT_AGENT_WS):
                    t2 = time.perf_counter()
                    ws.send_json({"message": q})
                    events = [ws.recv_json()]
                    while events[-1]["event"] not in ("done", "error"):
                        events.append(ws.recv_json())
                    ms.append((time.perf_counter() - t2) * 1e3)
                    agent_turns.append((q, events))
            finally:
                ws.close()
            lat["agent, WebSocket"] = ms
            ms = []
            ag_ui = []
            for j, q in enumerate(take(CHAT_AGENT_AG_UI)):
                t2 = time.perf_counter()
                ag_ui.append((q, sse_turn(a, f"/api/v1/agents/{aid}/chats/ag-ui-{j % 4}/ag-ui",
                                          {"message": q})))
                ms.append((time.perf_counter() - t2) * 1e3)
            lat["agent, AG-UI"] = ms

            # sharing: B while K is shared, published and subscribed
            b = client(b_token)
            _expect(*a.call("POST", f"/api/v1/collections/{kid}/shares",
                            {"username": "smoke-b"}), 201, "share")
            _expect(*a.call("POST", f"/api/v1/collections/{kid}/publish"), 200, "publish")
            _expect(*b.call("POST", f"/api/v1/marketplace/collections/{kid}/subscribe"), 200,
                    "subscribe")
            shared = []
            for q in take(CHAT_SHARED_SEARCHES):
                shared.append((q, _expect(*b.call("POST", f"/api/v1/collections/{kid}/searches",
                                                  {"query": q}), 201, "B's search")))
            market = _expect(*b.call("GET", "/api/v1/marketplace/collections"), 200, "market")
            detail = _expect(*b.call("GET", f"/api/v1/marketplace/collections/{kid}"), 200,
                             "market detail")
            mdocs = _expect(*b.call("GET", f"/api/v1/marketplace/collections/{kid}/documents"),
                            200, "market documents")
            launched = _counts()
        torch.cuda.synchronize()
        completions = stub.since(before)["completion"]
        for what, ms in lat.items():
            clog(f"{what}: {len(ms)} turns, p50 {_pctl(ms, 50):.3f} ms, p99 "
                 f"{_pctl(ms, 99):.3f} ms")
        clog(f"SSE from {CHAT_CLIENTS} clients: {len(cms) / cwall:.2f} turns/s")

        # -- gate a: a turn's references are the direct search of its query.
        # Held for the turns that dispatched alone (one client), as the direct
        # search does: a query batched with others is embedded at its batch's
        # sequence bucket, which moves its bf16 scores in the last bits
        for q, events in turns[CHAT_SINGLE:]:
            data = dict(events)
            if [n for n, _ in events][0] != "start" or len(data.get("references", ())) != \
                    HTTP_TOP_K or events[-1][0] != "done":
                raise AssertionError(f"gate a: concurrent turn {[n for n, _ in events]}")
        worst = 0.0
        bit_equal = 0
        refs_seen = 0
        for q, events in turns[:CHAT_SINGLE] + \
                [(q, ev) for kind, q, ev in frontend if kind == "sse"] + \
                [(q, ev) for _, q, ev in ws_turns]:
            if isinstance(events[0], tuple):
                names = [n for n, _ in events]
                data = dict(events)
            else:
                names = [e["event"] for e in events]
                data = {e["event"]: e["data"] for e in events}
            if names[0] != "start" or names[-1] not in ("done", "stopped") or \
                    "references" not in names:
                raise AssertionError(f"gate a: turn events {names} for {q!r}")
            items = _expect(*a.call("POST", f"/api/v1/collections/{kid}/searches",
                                    {"query": q}), 201, "direct search")["items"]
            refs = data["references"]
            key = lambda r: (r["rank"], r["text"][:300], r["metadata"])  # noqa: E731
            if [key(r) for r in refs] != [key(it) for it in items] or not refs:
                raise AssertionError(f"gate a: references != the direct search for {q!r}")
            got = torch.tensor([r["score"] for r in refs])
            want = torch.tensor([it["score"] for it in items])
            bit_equal += int(torch.equal(got, want))
            worst = max(worst, _close(got, want, 2e-2))
            refs_seen += 1
        for q, hits in zip(queries, file_hits):
            if not hits or any(h["metadata"].get("document_id") != upload[0]["id"]
                               for h in hits):
                raise AssertionError(f"gate a: files/search of {q!r} answered {hits[:1]}")
        clog(f"gate a: the references of {refs_seen} single-client turns (SSE, frontend "
             f"SSE, WebSocket) equal a direct POST /searches of the same query on K: items "
             f"equal, scores bit-equal in {bit_equal}, all within {worst:.3g} (1 + |s|) "
             f"(limit 2e-2); the {CHAT_CONCURRENT} turns from {CHAT_CLIENTS} clients each "
             f"cite {HTTP_TOP_K}; {len(file_hits)} files/search answer the chat's file")

        # -- gate b: one completion per generated answer and per title, two per
        # agent turn (a tool call, then the answer)
        generated = sum(1 for _, ev in turns) + CHAT_FRONTEND + sum(
            1 for _, _, ev in ws_turns if any(e["event"] == "delta" for e in ev))
        agent_n = len(agent_turns) + len(ag_ui)
        want_calls = generated + titled + 2 * agent_n
        if completions != want_calls:
            raise AssertionError(f"gate b: the stub served {completions} completions, "
                                 f"expected {generated} answers + {titled} titles + 2 x "
                                 f"{agent_n} agent turns")
        for q, events in agent_turns:
            kinds = [e["event"] for e in events]
            if kinds[:2] != ["tool_call", "tool_result"] or kinds[-1] != "done" or \
                    events[0]["data"]["arguments"] != {"query": q}:
                raise AssertionError(f"gate b: agent turn {kinds}")
        for q, events in ag_ui:
            kinds = [n for n, _ in events]
            if kinds[0] != "RunStarted" or kinds[-1] != "RunFinished" or \
                    "ToolCallStart" not in kinds or "TextMessageContent" not in kinds:
                raise AssertionError(f"gate b: AG-UI events {kinds}")
        for kind, q, out in frontend:
            text = out["text"] if kind == "json" else "".join(
                d["text"] for n, d in out if n == "delta")
            if not text.startswith("Answer [1]: "):
                raise AssertionError(f"gate b: frontend answer {text[:80]!r}")
        clog(f"gate b: the stub served {completions} completions = {generated} answers + "
             f"{titled} titles + 2 x {agent_n} agent turns (a search_collections call, then "
             f"the answer); every agent turn called search_collections with its query")

        # -- gate c: each stopped WebSocket turn ended with "stopped", and the
        # next message was answered
        for j, (stopped, q, events) in enumerate(ws_turns):
            last = events[-1]["event"]
            if stopped and last != "stopped":
                raise AssertionError(f"gate c: stopped turn {j} ended {last}")
            if not stopped and last != "done":
                raise AssertionError(f"gate c: turn {j} ended {last}")
        clog(f"gate c: {len(stops)} WebSocket turns sent a stop frame after their start "
             f"event and ended with 'stopped' "
             f"({[[e['event'] for e in ev] for s_, _, ev in ws_turns if s_][0]}); each "
             f"next turn ended 'done'")

        # -- gate d: B's searches while shared are A's; refused after
        for q, body in shared:
            mine = _expect(*a.call("POST", f"/api/v1/collections/{kid}/searches",
                                   {"query": q}), 201, "A's search")
            if body["items"] != mine["items"] or not mine["items"]:
                raise AssertionError(f"gate d: B's search of {q!r} != A's")
        if kid not in [m["collection_id"] for m in market] or detail["owner"] != "smoke" \
                or len(mdocs) != CHAT_DOCS:
            raise AssertionError("gate d: the marketplace listing")
        _expect(*a.call("DELETE", f"/api/v1/collections/{kid}/shares/smoke-b"), 204,
                "unshare")
        _expect(*a.call("POST", f"/api/v1/collections/{kid}/unpublish"), 200, "unpublish")
        st, body = b.call("POST", f"/api/v1/collections/{kid}/searches", {"query": queries[1]})
        _expect(st, body, 403, "B's search after the unshare and unpublish")
        _expect(*b.call("GET", f"/api/v1/marketplace/collections/{kid}"), 404,
                "browse after the unpublish")
        clog(f"gate d: B's {len(shared)} searches of K while shared, published and "
             f"subscribed equal A's, item for item; the marketplace lists K with its "
             f"{len(mdocs)} documents; after the unshare and unpublish B's search answers "
             f"403 and the browse 404")

        # -- one web search, offline: a transport that refuses every host (this
        # machine has no network), behind the route's req.state["web"] seam
        def no_network(req):
            raise OSError(101, "Network is unreachable")

        offline = WebSearchService(transport=no_network)

        async def web_mw(req, nxt):
            req.state["web"] = offline
            return await nxt(req)

        srv.app.router.use(web_mw)
        t2 = time.perf_counter()
        web = _expect(*a.call("POST", "/api/v1/web/search", {"query": queries[2]}), 200,
                      "web search")
        web_ms = (time.perf_counter() - t2) * 1e3
        if web != {"results": [], "offline": True}:
            raise AssertionError(f"web search answered {web}")
        clog(f"web search: offline (every host refused) in {web_ms:.3f} ms")

        # -- gate e: the audit log
        own = _expect(*a.call("GET", "/api/v1/audit_logs?limit=100000"), 200, "A's audit")
        if not own or {r["user"] for r in own} != {"smoke"}:
            raise AssertionError(f"gate e: A sees rows of {sorted({r['user'] for r in own})}")
        everyone = _expect(*admin.call("GET", "/api/v1/audit-logs?limit=100000"), 200,
                           "admin's audit")
        paths = {r["path"] for r in everyone}
        for want in (f"/api/v1/chats/{chats[0]}/completions", "/api/v1/chat/completions/frontend",
                     f"/api/v1/chats/{f_chat}/files/search", f"/api/v1/collections/{kid}/shares",
                     f"/api/v1/agents/{aid}/chats/ag-ui-0/ag-ui", "/api/v1/web/search"):
            if want not in paths:
                raise AssertionError(f"gate e: the admin's audit log lacks {want}")
        if {r["user"] for r in everyone} < {"smoke", "smoke-b", "admin"}:
            raise AssertionError("gate e: the admin's audit log lacks a user")
        clog(f"gate e: A lists {len(own)} audit rows, all A's; the admin lists "
             f"{len(everyone)} rows of users {sorted({r['user'] for r in everyone})}, the "
             f"phase's routes among them")

        # -- gate f: every dense dispatch over K one tcs launch; the
        # kernel at the largest served batch
        tcs_k = variants.get(("K", "tcs"), 0)
        others = {k: v for k, v in variants.items() if k[1] != "tcs"}
        if others or tcs_k != dense["K"] or \
                launched["dense_topk_tc_bf16"] != tcs_k + variants.get(("files", "tcs"), 0):
            raise AssertionError(f"gate f: dispatches {dense}, launches by variant "
                                 f"{variants}, counters {launched}")
        row = _served_kernel_row(biggest[0], tcs_k, dense["K"], clog)
        results["dense_topk_chat"] = row
        clog(f"gate f: each of {dense['K']} dense dispatches over K (chat turns, agent "
             f"tools, B's searches) launched dense_topk's tcs kernel once, "
             f"bf16 x bf16; the {dense['files']} over the chat-file collection too; "
             f"counters {({k: v for k, v in launched.items() if v})}")

        # -- one turn split into stages (a titled chat, single client)
        st_ = _Stages()
        st_.wrap_async(HttpServer, "_dispatch", "dispatch")
        st_.wrap_async(CollectionService, "execute_search", "search")
        st_.wrap_sync(RerankService, "__call__", "rerank", sync=True)
        st_.wrap_sync(OpenAICompatClient, "complete", "completion")
        for attr in ("get_chat", "add_chat_message", "list_chat_messages", "update_chat",
                     "add_audit"):
            st_.wrap_sync(Database, attr, "sqlite")
        stage_chat = _expect(*a.call("POST", "/api/v1/chats",
                                     {"title": "stages", "collection_ids": [kid]}), 201,
                             "stage chat")["id"]
        client_ms = []
        with st_:
            for j in range(CHAT_STAGE_TURNS):
                t2 = time.perf_counter()
                sse_turn(a, f"/api/v1/chats/{stage_chat}/completions",
                         {"message": f"{queries[j]} (staged {j})"})
                client_ms.append((time.perf_counter() - t2) * 1e3)
        total = {k: sum(v) / CHAT_STAGE_TURNS for k, v in st_.ms.items()}
        stages = {"client (median)": float(np.median(client_ms)),
                  "route, auth, audit, SSE framing": total["dispatch"] - total["search"]
                  - total["completion"] - total["sqlite"],
                  "search (hybrid + CE)": total["search"],
                  "  of which CE": total["rerank"],
                  "completion (stub round trip)": total["completion"],
                  "sqlite (chat rows, messages, audit)": total["sqlite"]}
        clog(f"stages of one SSE turn (mean of {CHAT_STAGE_TURNS}, the client's median): "
             + "; ".join(f"{k.strip()} {v:.3f} ms" for k, v in stages.items()))

        # -- gate g: the chats and messages persist across a restart
        def snapshot() -> dict:
            out = {}
            for ch in _expect(*a.call("GET", "/api/v1/chats?limit=1000"), 200, "chats"):
                got = _expect(*a.call("GET", f"/api/v1/chats/{ch['id']}"), 200, "chat")
                out[ch["id"]] = (got["title"], [(m["id"], m["role"], m["parts"])
                                                 for m in got["messages"]])
            return out

        kept = snapshot()
        close_clients()
        srv.stop()
        srv = _AppThread(settings)
        a = client(a_token)
        again = snapshot()
        if again != kept or len(kept) < CHAT_SINGLE_CHATS + CHAT_CLIENTS + CHAT_FRONTEND + 3:
            raise AssertionError(f"gate g: {len(kept)} chats before the restart, "
                                 f"{len(again)} after, equal {again == kept}")
        clog(f"gate g: {len(kept)} chats and their {sum(len(m) for _, m in kept.values())} "
             f"messages read back the same after an App restart")

        if errors.records:
            raise AssertionError(f"{len(errors.records)} ERROR records: {errors.records[:3]}")
        results["chat"] = {"latency": {k: {"p50": _pctl(v, 50), "p99": _pctl(v, 99)}
                                       for k, v in lat.items()},
                           "turns_s": len(cms) / cwall, "stages": stages, "web_ms": web_ms,
                           "phase_s": time.perf_counter() - t_phase}
        clog("gates a-g passed; no ERROR record from the port's loggers")
    finally:
        close_clients()
        if srv is not None:
            srv.stop()
        stub.stop()
        port_logger.removeHandler(errors)
        shutil.rmtree(tmp, ignore_errors=True)


def _mcp_call(mid, name: str, args: dict) -> dict:
    return {"jsonrpc": "2.0", "id": mid, "method": "tools/call",
            "params": {"name": name, "arguments": args}}


def _tool_items(status, body, what: str) -> list:
    """The search items of a tools/call reply, each score a JSON number."""
    _expect(status, body, 200, what)
    if "result" not in body or body["result"].get("isError"):
        raise AssertionError(f"{what}: {str(body)[:300]}")
    items = json.loads(body["result"]["content"][0]["text"])["items"]
    if any(type(it["score"]) is not float for it in items):
        raise AssertionError(f"{what}: a score is not a JSON number")
    return items


def _cli(args: list, data_dir: str) -> str:
    """One command of the port's CLI as a subprocess, its stdout."""
    env = dict(os.environ, SUPER_RAG_DATA_DIR=data_dir)
    env.pop("SUPER_RAG_FORCE_CPU", None)
    if DEVICE == "cpu":  # the CPU rehearsal of this phase
        env["SUPER_RAG_FORCE_CPU"] = "1"
    out = subprocess.run([sys.executable, "-m", "super_rag_tpu_torch.cli", *args], cwd=HERE,
                         env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"cli {args[0]} exited {out.returncode}: {out.stderr[-1500:]}")
    return out.stdout


def phase_mcp(results: dict) -> None:
    """The MCP endpoint, the web console, the CLI and the evals on the
    port's own App, as [chat] sets it up (ThreadScheduler ingest, the
    [semantic] encoder and cross-encoder as checkpoints the port writes,
    the QueryBatcher).  Collection M (bf16) of MCP_DOCS documents; over an
    API key: initialize, tools/list, MCP_QUERIES search_collection calls
    reranked and as many not from one client, MCP_CONCURRENT reranked from
    MCP_CLIENTS clients, MCP_FILE_SEARCHES search_chat_files over a chat's
    file, a batch with a notification, one offline web_search; GET / and
    GET /mcp; the CLI as subprocesses on a data dir of its own (ingest,
    collections, search, snapshot); evaluate_engine over M.  Gates a-f."""
    import dataclasses
    import logging
    import shutil
    import tempfile

    from super_rag_tpu_torch.api.webui import PAGE
    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.evals import LabeledQuery, evaluate_engine
    from super_rag_tpu_torch.models.encoder import flax_params
    from super_rag_tpu_torch.models.encoder_service import EncoderService, save_params
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.service.collection_service import CollectionService
    from super_rag_tpu_torch.service.context import build_context
    from super_rag_tpu_torch.service.rerank_service import RerankService
    from super_rag_tpu_torch.websearch.service import WebSearchService

    card = results["card"]
    t_phase = time.perf_counter()

    def mlog(msg: str) -> None:
        log(f"[mcp] {msg} (on {card})")

    class _Errors(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(f"{record.name}: {record.getMessage()}")

    errors = _Errors()
    port_logger = logging.getLogger("super_rag_tpu_torch")
    port_logger.addHandler(errors)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mcp_")
    srv = None
    open_clients: list = []

    def client(token: str = ""):
        c = _Client(srv.app.port, token)
        open_clients.append(c)
        return c

    try:
        # -- the deployment: checkpoints, the App, an API key, collection M
        t0 = time.perf_counter()
        cfg = semantic_config(torch.bfloat16)
        enc = EncoderService(cfg, max_len=cfg.max_len, seed=SEED, device=DEVICE)
        rr = RerankService(cfg, max_len=cfg.max_len, seed=SEED + 1, device=DEVICE)
        save_params(flax_params(enc.model), os.path.join(tmp, "enc"), cfg)
        save_params(flax_params(rr.model), os.path.join(tmp, "ce"), cfg)
        del enc, rr
        settings = dataclasses.replace(
            Settings(), data_dir=os.path.join(tmp, "data"), port=0,
            reranker_checkpoint=os.path.join(tmp, "ce"), ingest_backend="thread",
            batch_max=64, chunk_size=400, encoder_checkpoint="")
        srv = _AppThread(settings)
        port = srv.app.port
        _expect(*client().call("POST", "/api/v1/auth/register",
                               {"username": "smoke", "password": "smoke-password"}), 201,
                "register")
        a = client(_login(port))
        key = _expect(*a.call("POST", "/api/v1/apikeys", {"description": "mcp"}), 201,
                      "api key")["key"]
        mcp = client(key)
        config = {"embedding": {"provider": "onboard", "model": os.path.join(tmp, "enc")}}
        mid = _expect(*a.call("POST", "/api/v1/collections",
                              {"title": "M", "config": config}), 201, "collection M")["id"]
        engine = srv.app.ctx.engines.get(mid)
        if engine.index.spec.dtype != torch.bfloat16:
            raise AssertionError(f"M stores {engine.index.spec.dtype}")
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 71)
        docs, queries = http_corpus(gen, MCP_DOCS, HTTP_SECTIONS,
                                    2 * MCP_QUERIES + MCP_CONCURRENT)
        t1 = time.perf_counter()
        for dname, text in docs:
            _expect(*a.call("POST", f"/api/v1/collections/{mid}/documents",
                            {"name": dname, "content": text}), 201, "upload")
        while True:
            listing = _expect(*a.call("GET", f"/api/v1/collections/{mid}/documents"), 200,
                              "list documents")
            status = [d["status"] for d in listing]
            if "FAILED" in status:
                raise AssertionError("a document of M FAILED")
            if len(status) == MCP_DOCS and set(status) == {"COMPLETE"}:
                break
            if time.perf_counter() - t1 > HTTP_INGEST_TIMEOUT_S:
                raise AssertionError("ingest of M not complete")
            time.sleep(0.1)
        if engine.index.live_count != MCP_DOCS * HTTP_SECTIONS:
            raise AssertionError(f"M holds {engine.index.live_count} chunks")
        _expect(*a.call("POST", f"/api/v1/collections/{mid}/searches",
                        {"query": queries[0]}), 201, "warm-up")
        mlog(f"App on port {port}; encoder and cross-encoder {cfg.num_layers} x "
             f"{cfg.hidden_dim} bf16; M {MCP_DOCS} documents ({MCP_DOCS * HTTP_SECTIONS} "
             f"chunks, D {engine.index.spec.dim}) COMPLETE after {time.perf_counter() - t1:.3f}"
             f" s; set-up {time.perf_counter() - t0:.2f} s")

        # -- the protocol
        init = _expect(*mcp.call("POST", "/mcp", {"jsonrpc": "2.0", "id": 1,
                                                  "method": "initialize", "params": {}}),
                       200, "initialize")
        tools = _expect(*mcp.call("POST", "/mcp", {"jsonrpc": "2.0", "id": 2,
                                                   "method": "tools/list"}), 200, "tools/list")
        names = [t["name"] for t in tools["result"]["tools"]]
        if init["result"]["serverInfo"]["name"] != "super-rag-tpu" or names != [
                "list_collections", "search_collection", "search_chat_files", "web_search",
                "web_read"]:
            raise AssertionError(f"gate a: initialize {init}, tools {names}")

        # -- the traffic, with dense dispatches counted
        real_tile_topk = dt.tile_topk
        real_search_batch = CollectionEngine.search_batch
        local = threading.local()
        dense = {"M": 0, "files": 0}
        variants: dict = {}
        biggest: list = []

        def search_batch(self, queries_, *args, **kw):
            local.name = "M" if self is engine else "files"
            dense[local.name] += 1
            try:
                return real_search_batch(self, queries_, *args, **kw)
            finally:
                local.name = None

        def tile_topk(*args):
            name = getattr(local, "name", None)
            q, _, values, *_, n_scan, tile, kt = args
            v = dt.kernel_variant(dt._mode(q, values), kt, q.shape[1], q.shape[0],
                                  -(-n_scan // tile), dt._sm_count(torch.cuda.current_device()))
            variants[(name, v)] = variants.get((name, v), 0) + 1
            if name == "M" and (not biggest or q.shape[0] >= biggest[0][0].shape[0]):
                biggest[:] = [args]
            return real_tile_topk(*args)

        pool = iter(queries)
        lat: dict = {}
        single: list = []  # (use_rerank, query, items)
        _reset_counts()
        with mock.patch.object(dt, "tile_topk", tile_topk), \
                mock.patch.object(CollectionEngine, "search_batch", search_batch):
            for rerank in (True, False):
                ms = []
                for j in range(MCP_QUERIES):
                    q = next(pool)
                    t2 = time.perf_counter()
                    items = _tool_items(*mcp.call("POST", "/mcp", _mcp_call(
                        j, "search_collection", {"collection_id": mid, "query": q,
                                                 "use_rerank": rerank})), "search_collection")
                    ms.append((time.perf_counter() - t2) * 1e3)
                    single.append((rerank, q, items))
                lat[f"search_collection{'' if rerank else ', unreranked'}, 1 client"] = ms

            mine = [next(pool) for _ in range(MCP_CONCURRENT)]
            per = MCP_CONCURRENT // MCP_CLIENTS
            cms: list = []
            fails: list = []
            barrier = threading.Barrier(MCP_CLIENTS + 1)

            def caller(k):
                cc = _Client(port, key)
                try:
                    barrier.wait()
                    for j, q in enumerate(mine[k * per:(k + 1) * per]):
                        t2 = time.perf_counter()
                        items = _tool_items(*cc.call("POST", "/mcp", _mcp_call(
                            j, "search_collection", {"collection_id": mid, "query": q})),
                            "concurrent search_collection")
                        cms.append((time.perf_counter() - t2) * 1e3)
                        if len(items) != HTTP_TOP_K:
                            fails.append((q, len(items)))
                except Exception as e:  # noqa: BLE001 — reported below
                    fails.append(repr(e))
                finally:
                    cc.close()

            threads = [threading.Thread(target=caller, args=(k,)) for k in range(MCP_CLIENTS)]
            for th in threads:
                th.start()
            barrier.wait()
            t2 = time.perf_counter()
            for th in threads:
                th.join(600)
            cwall = time.perf_counter() - t2
            if fails or any(th.is_alive() for th in threads):
                raise AssertionError(f"concurrent tool calls failed: {fails[:3]}")
            lat[f"search_collection, {MCP_CLIENTS} clients"] = cms

            # a chat with one uploaded file, searched through search_chat_files
            f_chat = _expect(*a.call("POST", "/api/v1/chats", {"title": "files"}), 201,
                             "files chat")["id"]
            boundary = "mcpsmokeboundary"
            raw = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                   f"filename=\"note.md\"\r\nContent-Type: text/markdown\r\n\r\n").encode() \
                + docs[0][1][:4000].encode() + f"\r\n--{boundary}--\r\n".encode()
            a.conn.request("POST", f"/api/v1/chats/{f_chat}/documents", body=raw, headers={
                "Authorization": f"Bearer {a.token}",
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
            resp = a.conn.getresponse()
            upload = json.loads(resp.read())
            _expect(resp.status, upload, 201, "chat file upload")
            t2 = time.perf_counter()
            while _expect(*a.call("GET", f"/api/v1/chats/{f_chat}/documents/"
                                         f"{upload[0]['id']}"), 200,
                          "chat file")["status"] != "COMPLETE":
                if time.perf_counter() - t2 > HTTP_INGEST_TIMEOUT_S:
                    raise AssertionError("the chat file was not indexed")
                time.sleep(0.05)
            files_cid = next(c["id"] for c in _expect(*a.call("GET", "/api/v1/collections"),
                                                       200, "collections")
                             if c["title"].startswith("__chat_files__"))
            file_hits = []
            for j, q in enumerate(queries[:MCP_FILE_SEARCHES]):
                file_hits.append(_tool_items(*mcp.call("POST", "/mcp", _mcp_call(
                    j, "search_chat_files", {"collection_id": files_cid, "chat_id": f_chat,
                                             "query": q, "top_k": 3})), "search_chat_files"))

            # a batch with a notification, and a notification alone
            batch = _expect(*mcp.call("POST", "/mcp", [
                {"jsonrpc": "2.0", "id": 1, "method": "ping"},
                {"jsonrpc": "2.0", "method": "notifications/initialized"},
                _mcp_call(2, "search_collection", {"collection_id": mid, "query": queries[1]}),
            ]), 200, "batch")
            note = mcp.call("POST", "/mcp", {"jsonrpc": "2.0", "method": "initialized"})
            launched = _counts()
        torch.cuda.synchronize()
        for what, ms in lat.items():
            mlog(f"{what}: {len(ms)} calls, p50 {_pctl(ms, 50):.3f} ms, p99 "
                 f"{_pctl(ms, 99):.3f} ms")
        rps = len(cms) / cwall
        mlog(f"search_collection from {MCP_CLIENTS} clients: {rps:.2f} requests/s")

        # -- gate a: the protocol; each single-client call's items are a direct
        # REST search of the same query
        if [m["id"] for m in batch] != [1, 2] or batch[0]["result"] != {} or \
                note != (202, ""):
            raise AssertionError(f"gate a: batch {str(batch)[:300]}, notification {note}")
        worst, bit_equal = 0.0, 0
        key_of = lambda r: (r["rank"], r["text"], r["metadata"], r["recall_type"])  # noqa: E731
        for rerank, q, items in single:
            direct = _expect(*a.call("POST", f"/api/v1/collections/{mid}/searches",
                                     {"query": q, "use_rerank": rerank}), 201,
                             "direct search")["items"]
            if [key_of(r) for r in items] != [key_of(r) for r in direct] or \
                    len(items) != HTTP_TOP_K:
                raise AssertionError(f"gate a: search_collection of {q!r} (rerank {rerank}) "
                                     f"!= the REST search")
            got = torch.tensor([r["score"] for r in items])
            want = torch.tensor([r["score"] for r in direct])
            bit_equal += int(torch.equal(got, want))
            worst = max(worst, _close(got, want, 2e-2))
        reranked = sum(it["recall_type"] == "reranked" for r, _, its in single if r for it in its)
        if reranked != MCP_QUERIES * HTTP_TOP_K or any(
                it["recall_type"] == "reranked" for r, _, its in single if not r for it in its):
            raise AssertionError(f"gate a: {reranked} reranked items")
        mlog(f"gate a: initialize, tools/list (5 tools), a batch of ping + notification + "
             f"search (2 replies), a notification (202); each of {len(single)} single-client "
             f"search_collection calls equals a direct POST /searches: items equal, scores "
             f"bit-equal in {bit_equal}, all within {worst:.3g} (1 + |s|) (limit 2e-2)")

        # -- gate b: search_chat_files answers from the chat's file
        for q, hits in zip(queries, file_hits):
            if not hits or any(h["metadata"].get("document_id") != upload[0]["id"]
                               for h in hits):
                raise AssertionError(f"gate b: search_chat_files of {q!r}: {hits[:1]}")
        mlog(f"gate b: {len(file_hits)} search_chat_files calls answer from the chat's file")

        # -- gate c: every dense dispatch over M one tcs launch; the
        # kernel at the largest served batch
        tcs_m = variants.get(("M", "tcs"), 0)
        others = {k: v for k, v in variants.items() if k[1] != "tcs"}
        if others or tcs_m != dense["M"] or \
                launched["dense_topk_tc_bf16"] != tcs_m + variants.get(("files", "tcs"), 0):
            raise AssertionError(f"gate c: dispatches {dense}, launches by variant "
                                 f"{variants}, counters {launched}")
        results["dense_topk_mcp"] = _served_kernel_row(biggest[0], tcs_m, dense["M"], mlog)
        mlog(f"gate c: each of {dense['M']} dense dispatches over M launched dense_topk's "
             f"tcs kernel once, bf16 x bf16; the {dense['files']} over the chat files too; "
             f"counters {({k: v for k, v in launched.items() if v})}")

        # -- gate d: the console, GET /mcp, one offline web_search
        st, page = client().call("GET", "/")
        if st != 200 or page != PAGE:
            raise AssertionError(f"gate d: GET / answered {st}")
        st, body = mcp.call("GET", "/mcp")
        _expect(st, body, 405, "GET /mcp")

        def no_network(req):
            raise OSError(101, "Network is unreachable")

        server = next(h.__self__ for m, rx, h, _ in srv.app.router.routes
                      if m == "POST" and rx.pattern == "^/mcp$")
        server.web = WebSearchService(transport=no_network)
        web = _expect(*mcp.call("POST", "/mcp", _mcp_call(9, "web_search", {"query": "x"})),
                      200, "web_search")
        if json.loads(web["result"]["content"][0]["text"]) != {"results": []}:
            raise AssertionError(f"gate d: offline web_search answered {web}")
        mlog("gate d: GET / answered the console page (200), GET /mcp 405, an offline "
             "web_search {'results': []}")

        # -- gate e: the CLI on a data dir of its own: the same hits as an
        # in-process execute_search of the same data
        cli_dir = os.path.join(tmp, "cli")
        paths = []
        for dname, text in docs[:CLI_DOCS]:
            paths.append(os.path.join(tmp, dname))
            with open(paths[-1], "w") as f:
                f.write(text)
        t2 = time.perf_counter()
        out = _cli(["ingest", "cli-notes", *paths], cli_dir)
        cli_ms = {"ingest": (time.perf_counter() - t2) * 1e3}
        cid = out.strip().splitlines()[-1].split("collection: ")[1]
        if len(out.strip().splitlines()) != CLI_DOCS + 1 or \
                "{'vector': 'ACTIVE'}" not in out:
            raise AssertionError(f"gate e: cli ingest printed {out[:300]!r}")
        # collections, search and snapshot run together: the first two only
        # read the data dir, and a snapshot replaces each file whole with the
        # same rows
        outs: dict = {}

        def cli_timed(name, args):
            t3 = time.perf_counter()
            try:
                outs[name] = _cli(args, cli_dir)
            except AssertionError as e:  # raised below, on the phase's thread
                outs[name] = e
            cli_ms[name] = (time.perf_counter() - t3) * 1e3

        readers = [threading.Thread(target=cli_timed, args=a) for a in (
            ("collections", ["collections"]),
            ("search", ["search", cid, queries[3], "--top-k", "5"]),
            ("snapshot", ["snapshot"]))]
        for th in readers:
            th.start()
        for th in readers:
            th.join()
        for value in outs.values():
            if isinstance(value, AssertionError):
                raise value
        if outs["collections"].split() != [cid, "ACTIVE", "cli-notes"]:
            raise AssertionError(f"gate e: cli collections printed {outs['collections']!r}")
        out = outs["search"]
        ctx = build_context(dataclasses.replace(Settings(), data_dir=cli_dir), device=DEVICE)
        try:
            coll = ctx.db.get_collection(cid)
            want = asyncio.run(CollectionService(ctx).execute_search(
                coll["user"], cid, queries[3], top_k=5))
        finally:
            ctx.batcher.close()
            ctx.scheduler.shutdown()
            ctx.close()
            ctx.db.close()
        printed = "".join(f"#{item['rank']} score={item['score']:.4f} "
                          f"[{item['recall_type']}]\n   {item['text'][:200]}\n"
                          for item in want["items"])
        if out != printed or not want["items"]:
            raise AssertionError(f"gate e: cli search printed {out[:300]!r}, in-process "
                                 f"{printed[:300]!r}")
        if outs["snapshot"].strip() != \
                f"snapshots written to {os.path.join(cli_dir, 'snapshots')}":
            raise AssertionError(f"gate e: cli snapshot printed {outs['snapshot']!r}")
        mlog(f"gate e: the CLI as subprocesses on the card: ingest of {CLI_DOCS} documents, "
             f"then collections, search (the same {len(want['items'])} hits and lines as an "
             f"in-process execute_search) and snapshot together; ms per command (process "
             f"start, torch, the card included): "
             + ", ".join(f"{k} {v:.0f}" for k, v in cli_ms.items()))

        # -- gate f: evaluate_engine over M, each query its section's own words,
        # that section (its chunk's title path) relevant
        labeled = []
        step = HTTP_SECTIONS // MCP_EVAL_PER_DOC
        for d, (dname, text) in enumerate(docs):
            sections = text.split("\n## ")[1:]
            for s in range(0, HTTP_SECTIONS, step):
                words = sections[s].split("\n\n", 1)[1].split()[:MCP_EVAL_WORDS]
                labeled.append(LabeledQuery(" ".join(words), {f"doc {d} > section {d}.{s}"}))
        reports = {}
        for mode, floor in MCP_EVAL_FLOOR.items():
            t2 = time.perf_counter()
            report = evaluate_engine(engine, labeled, ks=(1, 5, 10), mode=mode,
                                     doc_id_key="title_path")
            eval_s = time.perf_counter() - t2
            got = {"recall@1": report.recall_at_k[1], "recall@10": report.recall_at_k[10],
                   "mrr": report.mrr}
            if any(got[k] < v for k, v in floor.items()):
                raise AssertionError(f"gate f: {mode} {report.to_dict()} below {floor}")
            reports[mode] = report.to_dict()
            mlog(f"gate f: evaluate_engine({mode}) over M, {report.n_queries} queries (the "
                 f"first {MCP_EVAL_WORDS} words of a section, that section relevant): "
                 f"recall@1 {report.recall_at_k[1]}, @5 {report.recall_at_k[5]}, @10 "
                 f"{report.recall_at_k[10]}, MRR {report.mrr:.4f}, NDCG@10 "
                 f"{report.ndcg_at_10:.4f} (floors {floor}) in {eval_s:.2f} s")

        if errors.records:
            raise AssertionError(f"{len(errors.records)} ERROR records: {errors.records[:3]}")
        results["mcp"] = {"latency": {k: {"p50": _pctl(v, 50), "p99": _pctl(v, 99)}
                                      for k, v in lat.items()},
                          "requests_s": rps, "cli_ms": cli_ms, "eval": reports,
                          "phase_s": time.perf_counter() - t_phase}
        mlog("gates a-f passed; no ERROR record from the port's loggers")
    finally:
        for c in open_clients:
            c.close()
        if srv is not None:
            srv.stop()
        port_logger.removeHandler(errors)
        shutil.rmtree(tmp, ignore_errors=True)


def _timed_steps(step, count: int) -> tuple[float, list]:
    """``count`` calls of ``step()`` between two synchronizes: (ms a call on
    the host clock, the calls' results)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [step() for _ in range(count)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / count, out


def phase_train(results: dict) -> None:
    """One-card training at the checkpoints' full width (6 x 256, 8 heads,
    MLP 1,024, max_len 128, bf16 activations over f32 parameters, flax-init
    weights from a seed): docstrings harvested from the card machine's own
    site-packages, cut to ICT pairs; TRAIN_STEPS contrastive steps at batch
    TRAIN_BATCH with scripts/semantic_eval.py's accelerator settings (lr
    3e-4, warmup max(20, steps / 20), cosine to total_steps); 19 hard
    negatives mined for MINE_PAIRS pairs by the trained encoder; CE_STEPS
    cross-encoder steps at CE_QUERIES x 20 candidates, warm-started from the
    trained backbone.  Gates: a. one f32 step on the card equals the same
    step on the CPU; b. the loss falls, for both models; c. the checkpoints
    serve: a hybrid + rerank search_batch over rows embedded by the trained
    encoder launches one tensor-core dense_topk, held bit for bit against
    its plain version; d. no parameter is non-finite."""
    import itertools
    import shutil
    import tempfile
    import warnings

    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import IndexSpec
    from super_rag_tpu_torch.models.cross_encoder import CrossEncoder
    from super_rag_tpu_torch.models.encoder import (
        TextEncoder, flatten_tree, flax_params, init_params, load_flax_params)
    from super_rag_tpu_torch.models.encoder_service import (
        EncoderService, load_params, save_params)
    from super_rag_tpu_torch.models.tokenization import HashTokenizer
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.service.rerank_service import RerankService
    from super_rag_tpu_torch.train.contrastive import (
        TrainConfig, create_train_state, make_train_step)
    from super_rag_tpu_torch.train.corpus import harvest_docstrings
    from super_rag_tpu_torch.train.pairs import ict_pairs, pairs_to_batches
    from super_rag_tpu_torch.train.rerank import (
        RerankTrainConfig, ce_batches, create_ce_state, make_ce_train_step,
        mine_hard_negatives)

    card = results["card"]
    t_phase = time.perf_counter()

    def tlog(msg: str) -> None:
        log(f"[train] {msg} (on {card})")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # -- the text: docstrings of the card machine's packages, ICT pairs
        t0 = time.perf_counter()
        with warnings.catch_warnings():  # the parsed sources' own SyntaxWarnings
            warnings.simplefilter("ignore")
            docs = harvest_docstrings(packages=None, max_files_per_pkg=TRAIN_FILES_PER_PKG,
                                      max_docs=TRAIN_MAX_DOCS)
        serve_docs, train_docs = docs[:TRAIN_SERVE_ROWS], docs[TRAIN_SERVE_ROWS:]
        rng = np.random.default_rng(SEED)
        pairs = list(ict_pairs(train_docs, rng, samples_per_chunk=2, keep_prob=0.1))
        rng.shuffle(pairs)
        if len(pairs) < max(MINE_PAIRS, TRAIN_BATCH * 8):
            raise AssertionError(f"only {len(pairs)} ICT pairs from {len(docs)} docstrings")
        cfg = semantic_config(torch.bfloat16)
        tok = HashTokenizer(vocab_size=cfg.vocab_size)
        batches = list(pairs_to_batches(pairs, tok, TRAIN_BATCH, max_len=cfg.max_len))
        seq = sorted({b["q_ids"].shape[1] for b in batches})
        tlog(f"{len(docs)} docstrings harvested ({TRAIN_SERVE_ROWS} kept for serving), "
             f"{len(pairs)} ICT pairs, {len(batches)} batches of {TRAIN_BATCH} at sequence "
             f"{seq}, in {time.perf_counter() - t0:.2f} s")

        # the encoder: flax-init weights from a seed, on the card
        model = init_params(TextEncoder(cfg), torch.Generator().manual_seed(SEED + 61))
        params0 = flax_params(model)
        model = model.to(DEVICE)

        # -- gate a: one f32 step on the card equals the same step on the CPU
        cfg32 = semantic_config(torch.float32)
        tc32 = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS)
        check = {k: v[:TRAIN_CHECK_BATCH] for k, v in batches[0].items()}
        metrics = {}
        for dev in (DEVICE, "cpu"):
            m32 = load_flax_params(TextEncoder(cfg32), params0).to(dev)
            st32 = create_train_state(m32, None, tc32)
            _, metrics[dev] = make_train_step(m32, tc32)(st32, check)
            metrics[dev] = {k: float(v) for k, v in metrics[dev].items()}
            del m32, st32
        a_loss = abs(metrics[DEVICE]["loss"] - metrics["cpu"]["loss"]) / abs(metrics["cpu"]["loss"])
        a_norm = (abs(metrics[DEVICE]["grad_norm"] - metrics["cpu"]["grad_norm"])
                  / metrics["cpu"]["grad_norm"])
        if not (a_loss <= 1e-4 and a_norm <= 1e-3):
            raise AssertionError(f"gate a: f32 step card {metrics[DEVICE]} vs CPU "
                                 f"{metrics['cpu']}")
        tlog(f"gate a: one f32 contrastive step (TF32 off) at [{TRAIN_CHECK_BATCH}, "
             f"{check['q_ids'].shape[1]}] from the same weights and batch: loss card "
             f"{metrics[DEVICE]['loss']:.6f} / CPU {metrics['cpu']['loss']:.6f} (rel "
             f"{a_loss:.3g}, limit 1e-4), gradient norm {metrics[DEVICE]['grad_norm']:.6f} / "
             f"{metrics['cpu']['grad_norm']:.6f} (rel {a_norm:.3g}, limit 1e-3)")

        # -- the contrastive steps
        tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=max(20, TRAIN_STEPS // 20),
                           total_steps=TRAIN_STEPS)
        state = [create_train_state(model, None, tcfg)]
        train_step = make_train_step(model, tcfg)
        losses: list = []

        def one_step():
            state[0], m = train_step(state[0], batches[len(losses) % len(batches)])
            losses.append(m["loss"])
            return m

        warm = 5
        _timed_steps(one_step, warm)  # first launches, cuBLAS handles
        ms_step, _ = _timed_steps(one_step, TRAIN_STEPS - warm - 6)
        s = batches[0]["q_ids"].shape[1]
        flops = 3 * 2 * encoder_flops(TRAIN_BATCH, s, cfg)  # q and d, forward + backward
        idle = device_busy(one_step, ms_step, top=6)  # 6 more steps, the last 5 traced
        loss = torch.stack(losses).float().cpu()
        if len(losses) != TRAIN_STEPS or not bool(loss[-10:].mean() < loss[:10].mean()):
            raise AssertionError(f"gate b: contrastive loss {loss[:10].mean():.4f} -> "
                                 f"{loss[-10:].mean():.4f} over {len(losses)} steps")
        pairs_s = TRAIN_BATCH / ms_step * 1e3
        tlog(f"contrastive: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} x [{s}] (q and d), "
             f"lr {TRAIN_LR} warmup {tcfg.warmup_steps} cosine to {TRAIN_STEPS}: {ms_step:.3f} "
             f"ms a step ({pairs_s:.1f} pairs/s, {flops / ms_step / 1e9:.1f} TFLOP/s of "
             f"{flops / 1e12:.3f} TFLOP a step); {idle}; loss {float(loss[0]):.4f} -> "
             f"{float(loss[-1]):.4f} (gate b: mean of the last 10 "
             f"{float(loss[-10:].mean()):.4f} < the first 10 {float(loss[:10].mean()):.4f})")

        # -- mining: the trained encoder's 19 hardest wrong positives
        enc_path = os.path.join(tmp, "enc")
        save_params(flax_params(model), enc_path, cfg)
        svc = EncoderService.from_checkpoint(enc_path, batch_size=TRAIN_BATCH,
                                             max_len=cfg.max_len, device=DEVICE)
        mine_pairs = pairs[:MINE_PAIRS]
        t0 = time.perf_counter()
        hard = mine_hard_negatives(mine_pairs, svc.embed, n_hard=MINE_NEGATIVES,
                                   rng=np.random.default_rng(7), device=DEVICE)
        mine_s = time.perf_counter() - t0
        full = sum(len(h) == MINE_NEGATIVES for h in hard)
        if len(hard) != MINE_PAIRS or full < MINE_PAIRS // 2:
            raise AssertionError(f"mining: {full} of {len(hard)} pairs got "
                                 f"{MINE_NEGATIVES} negatives")
        tlog(f"mining: {MINE_NEGATIVES} negatives for each of {MINE_PAIRS} pairs ({full} "
             f"with all {MINE_NEGATIVES} after the overlap filter) in {mine_s:.2f} s "
             f"(embedding {2 * MINE_PAIRS} texts + an exact f32 dense_search on the card)")

        # -- the cross-encoder, warm-started from the trained backbone
        ce = init_params(CrossEncoder(cfg), torch.Generator().manual_seed(SEED + 62)).to(DEVICE)
        rcfg = RerankTrainConfig(total_steps=CE_STEPS, warmup_steps=max(10, CE_STEPS // 20),
                                 n_negatives=MINE_NEGATIVES, learning_rate=CE_LR)
        ce_state = [create_ce_state(ce, None, rcfg,
                                    backbone_params=flax_params(model)["backbone"])]
        ce_step = make_ce_train_step(ce, rcfg)
        ce_batch = list(itertools.islice(ce_batches(
            mine_pairs, hard, tok, np.random.default_rng(2), rcfg, batch_queries=CE_QUERIES,
            max_len=cfg.max_len), CE_STEPS))
        ce_losses: list = []

        def one_ce_step():
            ce_state[0], m = ce_step(ce_state[0], ce_batch[len(ce_losses) % len(ce_batch)])
            ce_losses.append(m["loss"])
            return m

        _timed_steps(one_ce_step, warm)
        ce_ms, _ = _timed_steps(one_ce_step, CE_STEPS - warm - 6)
        ce_idle = device_busy(one_ce_step, ce_ms, top=6)
        cl = torch.stack(ce_losses).float().cpu()
        if len(ce_losses) != CE_STEPS or not bool(cl[-10:].mean() < cl[:10].mean()):
            raise AssertionError(f"gate b: CE loss {cl[:10].mean():.4f} -> "
                                 f"{cl[-10:].mean():.4f} over {len(ce_losses)} steps")
        ce_s = ce_batch[0]["ids"].shape[1]
        ce_flops = 3 * encoder_flops(CE_QUERIES * (1 + MINE_NEGATIVES), ce_s, cfg, pooler=True)
        tlog(f"cross-encoder: {CE_STEPS} steps at {CE_QUERIES} queries x "
             f"{1 + MINE_NEGATIVES} candidates x [{ce_s}], lr {CE_LR}: {ce_ms:.3f} ms a step "
             f"({CE_QUERIES / ce_ms * 1e3:.1f} queries/s, {ce_flops / ce_ms / 1e9:.1f} "
             f"TFLOP/s); {ce_idle}; loss {float(cl[0]):.4f} -> {float(cl[-1]):.4f} (gate b: "
             f"{float(cl[-10:].mean()):.4f} < {float(cl[:10].mean()):.4f})")

        # -- gate d: every parameter finite
        for name, mod in (("encoder", model), ("cross-encoder", ce)):
            bad = [n for n, p in mod.named_parameters() if not bool(torch.isfinite(p).all())]
            if bad:
                raise AssertionError(f"gate d: non-finite {name} parameters {bad[:3]}")

        # -- gate c: the checkpoints serve through dense_topk
        ce_path = os.path.join(tmp, "ce")
        save_params(flax_params(ce), ce_path, cfg)
        for path, mod in ((enc_path, model), (ce_path, ce)):
            back = flatten_tree(load_params(path)[0])
            mine = flatten_tree(flax_params(mod))
            if set(back) != set(mine) or any(not np.array_equal(back[k], mine[k]) for k in mine):
                raise AssertionError(f"gate c: {path} does not read back")
        rr = RerankService.from_checkpoint(ce_path, max_len=cfg.max_len, device=DEVICE)
        engine = CollectionEngine(
            IndexSpec(dim=cfg.out_dim, dtype=torch.int8, vocab_size=VOCAB, min_capacity=4096),
            embedder=svc, reranker=rr, device=DEVICE)
        engine.ingest(serve_docs, metadata=[{"document_id": f"doc{i}"}
                                            for i in range(len(serve_docs))])
        qrng = np.random.default_rng(3)
        asked = []  # (an ICT query of a serving row, the row's document id)
        for i, d in enumerate(serve_docs):
            asked += [(p.query, f"doc{i}") for p in ict_pairs([d], qrng)][:1]
            if len(asked) == TRAIN_SERVE_QUERIES:
                break
        queries = [q for q, _ in asked]
        engine.search_batch(queries[:1], mode="hybrid")  # compaction, calibration
        calls: dict = {}
        _reset_counts()
        with mock.patch.object(dt, "tile_topk", _recording(calls, "tile", dt.tile_topk)):
            hits = engine.search_batch(queries, mode="hybrid", rerank=True,
                                       candidates=CANDIDATES, top_k=5)
        torch.cuda.synchronize()
        counts = _counts()
        if counts["dense_topk_tc"] != 1:
            raise AssertionError(f"gate c: hybrid + rerank B={len(queries)} launched {counts}")
        if any(len(h) != 5 or not all(np.isfinite(x.score) and x.recall_type == "reranked"
                                      for x in h) for h in hits):
            raise AssertionError("gate c: reranked hits malformed")
        own = sum(h[0].metadata["document_id"] == did for h, (_, did) in zip(hits, asked))
        results["dense_topk_train"] = _served_kernel_row(calls["tile"], 1, 1, tlog)
        tlog(f"gate c: checkpoints read back bit for bit; {len(serve_docs)} rows embedded by "
             f"the trained encoder (int8), hybrid + rerank (the trained CE) B="
             f"{len(queries)}: launches {({k: v for k, v in counts.items() if v})}, the "
             f"kernel bit-equal to its plain version; {own} of {len(queries)} ICT queries "
             f"rank their own docstring first")
        results["train"] = {"ms_step": ms_step, "pairs_s": pairs_s, "idle": idle,
                            "ce_ms_step": ce_ms, "ce_idle": ce_idle, "mine_s": mine_s,
                            "loss": [float(loss[:10].mean()), float(loss[-10:].mean())],
                            "ce_loss": [float(cl[:10].mean()), float(cl[-10:].mean())],
                            "gate_a": metrics, "phase_s": time.perf_counter() - t_phase}
        tlog("gates a-d passed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- [multi]: the row-sharded index and the (dp, tp) trainer over ranks ----------

MULTI_MAX_RANKS = 4  # NCCL: one rank a card, up to four cards
MULTI_ONE_CARD_RANKS = 2  # one card: two gloo ranks share it
MULTI_TIMEOUT_S = 600.0
MULTI_PER_TILE_K = 2  # the calibrated depth of gate a's second search and of gate b
MULTI_TRAIN_BATCH = 16  # gate d: one dp x tp step of the [semantic] encoder in f32
MULTI_TRAIN_LEN = 64
# two steps with one of warmup, the JAX mesh test's schedule: the first
# moves nothing, the second one step size.  One step with no warmup made
# Adam's first update g / (|g| + eps) of the gradients near eps differ by
# up to 4.6e-5 between the mesh and the one-device step on an H100
MULTI_TRAIN_STEPS = 2
MULTI_TRAIN_LR = 3e-4
# gate d's tolerances: tests/test_torch_train.py's for one f32 step
MULTI_LOSS_RTOL = 1e-5
MULTI_GRAD_NORM_RTOL = 1e-4
MULTI_PARAM_ATOL = 2e-5


def multi_backend() -> tuple[str, int]:
    """``(backend, ranks)`` of the [multi] phase: NCCL with a rank a card
    where there are two or more cards, else two gloo ranks on the one."""
    cards = torch.cuda.device_count() if DEVICE != "cpu" else 0
    if cards >= 2:
        return "nccl", min(cards, MULTI_MAX_RANKS)
    return "gloo", MULTI_ONE_CARD_RANKS


def _alone(rank: int, world: int, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier (the
    ranks of one card would otherwise share its SMs while timing)."""
    import torch.distributed as dist

    out = None
    for r in range(world):
        if r == rank:
            out = fn()
        dist.barrier()
    return out


def multi_rank(rank: int, world: int, device, cfg: dict, setup=None) -> dict:
    """One rank of the [multi] phase: gates a, b, d and e over this rank's
    block of the seeded corpus (rank 0 also holds the whole corpus for the
    one-device references).  ``setup`` runs first (the CPU rehearsal's
    stubs); ``cfg`` carries the phase's sizes, since a spawned rank
    imports this module afresh."""
    global DEVICE, N_ROWS, DIM, VOCAB, BATCH, SEMANTIC_CONFIG, MULTI_TRAIN_BATCH, \
        MULTI_TRAIN_LEN
    import tempfile

    import torch.distributed as dist

    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.bm25 import LexicalCorpus
    from super_rag_tpu_torch.ops.bm25_inverted import build_inverted
    from super_rag_tpu_torch.ops.dense import DenseCorpus
    from super_rag_tpu_torch.ops.hybrid import hybrid_search
    from super_rag_tpu_torch.ops.topk import stable_topk
    from super_rag_tpu_torch.parallel.mesh import corpus_mesh, shard_corpus
    from super_rag_tpu_torch.parallel.sharded import (
        gather_candidates, sharded_dense_search)
    from super_rag_tpu_torch.parallel.sharded_hybrid import sharded_hybrid_search
    from super_rag_tpu_torch.tokenize.analyzer import Analyzer, DocFrequency
    from super_rag_tpu_torch.trace import trace_function

    if setup is not None:
        setup()
    (DEVICE, N_ROWS, DIM, VOCAB, BATCH, SEMANTIC_CONFIG, MULTI_TRAIN_BATCH,
     MULTI_TRAIN_LEN) = (str(device), cfg["n_rows"], cfg["dim"], cfg["vocab"], cfg["batch"],
                         cfg["semantic"], cfg["train_batch"], cfg["train_len"])
    torch.backends.cuda.matmul.allow_tf32 = False
    cand, tile = cfg["candidates"], 2048
    out: dict = {"rank": rank}
    mesh = corpus_mesh(device=device)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    arrays, host, ranks, df_host = make_corpus(N_ROWS, gen, dim=DIM, vocab=VOCAB)
    q_emb = torch.randn(BATCH, DIM, device=DEVICE, generator=gen)
    texts = make_query_texts(ranks, df_host, gen, BATCH, vocab=VOCAB)
    del ranks
    codes, scales, terms, tfs, doc_len = shard_corpus(
        mesh, arrays["emb"], arrays["scales"], arrays["terms"], arrays["tfs"],
        arrays["doc_len"])
    keep = shard_corpus(mesh, torch.ones(N_ROWS, dtype=torch.bool, device=DEVICE))
    n_local = codes.shape[0]
    corpus = DenseCorpus(values=codes, scales=scales)
    full = None
    if rank == 0:
        full = DenseCorpus(values=arrays["emb"], scales=arrays["scales"])
        full_mask = torch.ones(N_ROWS, dtype=torch.bool, device=DEVICE)
    else:
        del arrays
    df = DocFrequency.from_state(host["df"])
    analyzer = Analyzer(vocab_size=VOCAB)
    qt = np.full((BATCH, 16), analyzer.pad_id, np.int32)
    qi = np.zeros((BATCH, 16), np.float32)
    for i, t in enumerate(texts):
        qt[i], qi[i] = analyzer.query_entry(t, df, 16)
    qt, qi = torch.from_numpy(qt).to(DEVICE), torch.from_numpy(qi).to(DEVICE)
    t0 = time.perf_counter()
    inv = build_inverted(terms, tfs, doc_len, VOCAB,
                         postings_per_term=max(256, n_local // 500), avgdl=df.avgdl)
    lexical = LexicalCorpus(terms=terms, tfs=tfs.to(torch.bfloat16), doc_len=doc_len)
    torch.cuda.synchronize()
    out["inverted_s"] = time.perf_counter() - t0

    def dense(per_tile_k):
        return sharded_dense_search(q_emb, corpus, cand, mesh, mask=keep, use_kernel=True,
                                    int8_queries=True, per_tile_k=per_tile_k)

    def hybrid():
        return sharded_hybrid_search(
            q_emb, qt, qi, corpus, lexical, keep, df.avgdl, mesh, vocab_size=VOCAB,
            k=TOP_K, candidates=cand, inverted=inv, use_kernel=True,
            per_tile_k=MULTI_PER_TILE_K, int8_queries=True)

    # the main path, counted: gate a's two depths and gate b
    dist.barrier()
    _reset_counts()
    exact_v, exact_i = dense(None)
    cal_v, cal_i = dense(MULTI_PER_TILE_K)
    res = hybrid()
    torch.cuda.synchronize()
    out["counts"] = _counts()

    # gate a, exact depth: bit for bit the one-device dense_topk at that depth
    if rank == 0:
        gv, gi = dt.dense_topk(q_emb, full, cand, mask=full_mask, tile=tile,
                               int8_queries=True, device=DEVICE)
        if not (torch.equal(gv, exact_v) and torch.equal(gi, exact_i)):
            bad = int((gi != exact_i).any(1).sum())
            raise AssertionError(f"gate a: exact-depth sharded search differs from the "
                                 f"one-device dense_topk in {bad} of {BATCH} queries")
        out["recall_calibrated"] = recall_at_k(cal_i[:, :TOP_K], exact_i[:, :TOP_K])
    # gate a, calibrated depth: this rank's kernel bit for bit its plain version
    q, qs, kt, _ = dt.prepare(q_emb, corpus, cand, tile=tile, int8_queries=True,
                              per_tile_k=MULTI_PER_TILE_K)
    args = (q, qs, codes, scales, None, keep, n_local, tile, kt)
    kv, ki = dt.tile_topk(*args)
    pv, pi = dt.tile_topk_plain(*args)
    out["max_abs_err"] = _compare(kv, ki, pv, pi, exact=True, tol=0.0)
    out["kt"], out["num_tiles"] = kt, int(kv.shape[0])
    out["variant"] = dt.kernel_variant(dt.MODE_INT8, kt, DIM, BATCH, kv.shape[0],
                                       dt._sm_count(torch.cuda.current_device()))

    # gate b: the sharded hybrid on the kernels equals itself on the plain version
    with mock.patch.object(dt, "tile_topk", dt.tile_topk_plain):
        res_plain = hybrid()
    if not (torch.equal(res.indices, res_plain.indices)
            and torch.equal(res.scores, res_plain.scores)):
        raise AssertionError("gate b: sharded hybrid differs between kernel and plain version")
    ids = res.indices.cpu().numpy()
    if ids.shape != (BATCH, TOP_K) or not torch.isfinite(res.scores).all() or ids.min() < 0:
        raise AssertionError("gate b: sharded hybrid result malformed")
    if rank == 0:
        full_inv = build_inverted(arrays["terms"], arrays["tfs"], arrays["doc_len"], VOCAB,
                                  postings_per_term=max(256, N_ROWS // 500), avgdl=df.avgdl)
        one = hybrid_search(
            q_emb, qt, qi, full, LexicalCorpus(terms=arrays["terms"],
                                               tfs=arrays["tfs"].to(torch.bfloat16),
                                               doc_len=arrays["doc_len"]),
            df.avgdl, inverted=full_inv, vocab_size=VOCAB, k=TOP_K, candidates=cand,
            mask=full_mask, use_kernel=True, per_tile_k=MULTI_PER_TILE_K,
            int8_queries=True, postings_per_query_term=256, device=DEVICE)
        out["hybrid_overlap"] = float(np.mean([
            len(set(a) & set(b)) / TOP_K
            for a, b in zip(ids.tolist(), one.indices.cpu().tolist())]))
        del full_inv, one

    # times: each rank's kernel alone, then the collective steps together
    def kernel_times():
        return {"ms": cuda_ms(lambda: dt.tile_topk(*args)),
                "plain_ms": cuda_ms(lambda: dt.tile_topk_plain(*args), reps=5),
                "library_ms": cuda_ms(lambda: library_topk(q, qs, codes, scales, keep,
                                                           n_local, tile, kt))}

    out.update(_alone(rank, world, kernel_times))
    nbytes = (n_local * DIM + n_local * 4 + n_local + BATCH * DIM + BATCH * 4
              + out["num_tiles"] * BATCH * kt * 8)
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, 2.0 * BATCH * n_local * DIM,
                                                INT8_OPS_PER_S)
    lv, li = dt.dense_topk(q_emb, corpus, cand, mask=keep, tile=tile, int8_queries=True,
                           per_tile_k=MULTI_PER_TILE_K, device=DEVICE)
    group = mesh.group("corpus")
    out["all_gather_ms"] = host_ms(lambda: gather_candidates(lv, li, group))
    av, ai = gather_candidates(lv, li, group)
    out["merge_ms"] = cuda_ms(lambda: torch.gather(ai, -1, stable_topk(av, cand)[1]))
    out["sharded_ms"] = host_ms(lambda: dense(MULTI_PER_TILE_K))
    out["sharded_hybrid_ms"] = host_ms(hybrid, reps=5)
    if rank == 0:
        one_ms = host_ms(lambda: dt.dense_topk(q_emb, full, cand, mask=full_mask, tile=tile,
                                               int8_queries=True, per_tile_k=MULTI_PER_TILE_K,
                                               device=DEVICE))
    dist.barrier()
    if rank == 0:
        out["one_device_ms"] = one_ms
        del full, arrays

    # gate e: a traced span around one sharded search holds the kernel's events
    tmp = tempfile.mkdtemp(prefix="multi-trace-")
    try:
        traced = trace_function("sharded_dense_search", device_profile_dir=tmp)(
            lambda: dense(MULTI_PER_TILE_K))
        (traced if rank == 0 else (lambda: dense(MULTI_PER_TILE_K)))()
        if rank == 0:
            from super_rag_tpu_torch.trace import get_tracer

            path = get_tracer().recent(1)[-1]["attributes"]["torch_trace"]
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            want = "dense_topk" if DEVICE != "cpu" else "aten::"
            hits = [e["name"] for e in events if want in e.get("name", "")
                    and (DEVICE == "cpu" or e.get("cat") == "kernel")]
            if not hits:
                raise AssertionError(f"gate e: the trace holds no {want} events")
            out["trace_events"], out["trace_kernel"] = len(events), hits[0]
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    out["train"] = _multi_train(rank, world, device)
    return out


def _multi_train(rank: int, world: int, device) -> dict:
    """Gate d: MULTI_TRAIN_STEPS dp x tp steps of the [semantic] encoder in
    f32 (tp 2 where the world allows it), and on rank 0 the one-device
    steps from the same weights; rank 0 compares them."""
    from super_rag_tpu_torch.models.encoder import (
        TextEncoder, flatten_tree, flax_params, init_params)
    from super_rag_tpu_torch.train.contrastive import (
        TrainConfig, create_train_state, gather_params, make_train_step, train_mesh)

    tp = 2 if world % 2 == 0 else 1
    cfg = semantic_config(torch.float32)
    tc = TrainConfig(learning_rate=MULTI_TRAIN_LR, warmup_steps=1)
    rng = np.random.default_rng(SEED + 90)
    b, s = MULTI_TRAIN_BATCH, MULTI_TRAIN_LEN
    batches = [{"q_ids": rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32),
                "q_mask": np.arange(s)[None] < rng.integers(s // 2, s + 1, (b, 1)),
                "d_ids": rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32),
                "d_mask": np.arange(s)[None] < rng.integers(s // 2, s + 1, (b, 1))}
               for _ in range(MULTI_TRAIN_STEPS)]
    mesh = train_mesh(tp=tp, device=device)
    model = init_params(TextEncoder(cfg), torch.Generator().manual_seed(SEED + 91)).to(device)
    state = create_train_state(model, None, tc, mesh=mesh)
    step = make_train_step(model, tc, mesh=mesh)
    t0 = time.perf_counter()
    got = []
    for batch in batches:
        state, m = step(state, batch)
        got.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    mesh_ms = (time.perf_counter() - t0) * 1e3 / MULTI_TRAIN_STEPS
    params = gather_params(model, mesh)
    out = {"tp": tp, "dp": world // tp, "metrics": got, "ms_step": mesh_ms}
    if rank != 0:
        return out
    one = init_params(TextEncoder(cfg), torch.Generator().manual_seed(SEED + 91)).to(device)
    ostate = create_train_state(one, None, tc)
    ostep = make_train_step(one, tc)
    want = []
    for batch in batches:
        ostate, m = ostep(ostate, batch)
        want.append({k: float(v) for k, v in m.items()})
    for g, w in zip(got, want):
        if not (abs(g["loss"] - w["loss"]) <= MULTI_LOSS_RTOL * abs(w["loss"])
                and abs(g["grad_norm"] - w["grad_norm"]) <= MULTI_GRAD_NORM_RTOL * w["grad_norm"]):
            raise AssertionError(f"gate d: mesh step {g} != one-device step {w}")
    # the attention's key biases have a zero gradient in exact arithmetic:
    # Adam moves them by rounding noise, up to a step size an update
    noise = 2 * MULTI_TRAIN_LR * MULTI_TRAIN_STEPS
    mine, ref = flatten_tree(params), flatten_tree(flax_params(one))
    err = {k: float(np.abs(mine[k] - ref[k]).max()) for k in ref}
    bad = [k for k, e in err.items()
           if e > (max(MULTI_PARAM_ATOL, noise) if k.endswith("key/bias") else MULTI_PARAM_ATOL)]
    if set(mine) != set(ref) or bad:
        raise AssertionError(f"gate d: parameters differ: {[(k, err[k]) for k in bad[:3]]}")
    out.update(one_device=want, param_err=max(e for k, e in err.items()
                                              if not k.endswith("key/bias")))
    return out


def phase_multi(results: dict, rank_setup=None) -> None:
    """The multi-device path: gates a, b, d, e on the phase's ranks (one
    spawned group), gate c (``entry.dryrun_multichip``) on as many."""
    from super_rag_tpu_torch import entry
    from super_rag_tpu_torch.parallel.launch import spawn

    backend, world = multi_backend()
    log(f"[multi] backend {backend}, world {world} (cards: "
        f"{torch.cuda.device_count() if DEVICE != 'cpu' else 0}); a seeded {N_ROWS} x "
        f"{DIM} int8 corpus, {N_ROWS // world} rows a rank")
    cfg = {"n_rows": N_ROWS, "dim": DIM, "vocab": VOCAB, "batch": BATCH,
           "candidates": CANDIDATES, "semantic": SEMANTIC_CONFIG,
           "train_batch": MULTI_TRAIN_BATCH, "train_len": MULTI_TRAIN_LEN}
    t0 = time.perf_counter()
    ranks = spawn(multi_rank, world, backend=backend, device=DEVICE,
                  timeout_s=MULTI_TIMEOUT_S, args=(cfg, rank_setup))
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    launches = sum(r["counts"]["dense_topk_tc"] for r in ranks)
    if any(r["counts"]["dense_topk_tc"] < 3 for r in ranks) or any(
            (r["counts"][LIST_KEY] >= 1) != (r["variant"] == "tc") for r in ranks):
        raise AssertionError(f"[multi] a rank's main path missed the tensor-core kernel its "
                             f"shape takes: {[(r['variant'], r['counts']) for r in ranks]}")
    if DEVICE != "cpu" and r0["variant"] != "tc":
        raise AssertionError(f"[multi] a rank's shard took {r0['variant']}, not the "
                             f"register-list kernel")
    tag = f"[multi] ({backend}, {world} ranks)"
    log(f"{tag} gate a: the exact-depth (kt = {CANDIDATES}) sharded search equals the "
        f"one-device dense_topk over the {N_ROWS} rows bit for bit, ids included; at "
        f"per_tile_k {MULTI_PER_TILE_K} (kt {r0['kt']}, the {r0['variant']} kernel) each rank's "
        f"kernel equals its plain version bit for bit; recall@{TOP_K} of the calibrated "
        f"depth against the exact: {r0['recall_calibrated']:.4f}")
    log(f"{tag} gate b: sharded hybrid (per-shard table postings, built in "
        f"{r0['inverted_s']:.2f} s) on the kernels = on the plain versions; top-{TOP_K} "
        f"overlap with the one-device hybrid_search: {r0['hybrid_overlap']:.4f}")
    for r in ranks:
        log(f"{tag} rank {r['rank']}: dense_topk at its shard ({N_ROWS // world} rows, "
            f"B={BATCH}, kt={r['kt']}) {r['ms']:.3f} ms alone (plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms, "
            f"{r['bound_by']}); all_gather of [{BATCH}, {CANDIDATES}] x 2 "
            f"{r['all_gather_ms']:.3f} ms, merge {r['merge_ms']:.3f} ms; launches "
            f"{ {k: v for k, v in r['counts'].items() if v} }")
    log(f"{tag} sharded_dense_search B={BATCH}: {r0['sharded_ms']:.3f} ms against the "
        f"one-device dense_topk {r0['one_device_ms']:.3f} ms; sharded_hybrid_search "
        f"{r0['sharded_hybrid_ms']:.3f} ms"
        + (" (the ranks share one card's SMs: no speedup)" if backend == "gloo" else ""))
    tr = r0["train"]
    log(f"{tag} gate d: dp {tr['dp']} x tp {tr['tp']} steps of the [semantic] encoder "
        f"(f32, [{MULTI_TRAIN_BATCH}, {MULTI_TRAIN_LEN}]) equal the one-device steps: loss "
        f"{[round(m['loss'], 6) for m in tr['metrics']]} vs "
        f"{[round(m['loss'], 6) for m in tr['one_device']]}, grad_norm "
        f"{[round(m['grad_norm'], 5) for m in tr['metrics']]}, max |param diff| "
        f"{tr['param_err']:.3g} (key biases aside); {tr['ms_step']:.1f} ms a mesh step")
    log(f"{tag} gate e: the traced sharded search's Chrome trace holds "
        f"{r0['trace_events']} events, the kernel {r0['trace_kernel']}")
    t0 = time.perf_counter()
    entry.dryrun_multichip(world, device=DEVICE, backend=backend, timeout_s=MULTI_TIMEOUT_S)
    log(f"{tag} gate c: entry.dryrun_multichip({world}) passed in "
        f"{time.perf_counter() - t0:.2f} s (train step, sharded search, the mutable index "
        f"against a one-rank gold, IVF at full probe"
        + (", multislice" if world >= 4 else "") + f"); ranks ran {spawn_s:.2f} s")
    results["dense_topk_sharded"] = {
        "variant": LIST_VARIANT if r0["variant"] == "tc" else r0["variant"],
        "launches": launches, "list_launches": sum(r["counts"][LIST_KEY] for r in ranks),
        "max_abs_err": max(r["max_abs_err"] for r in ranks),
        "ms": r0["ms"], "plain_ms": r0["plain_ms"], "bound_ms": r0["bound_ms"],
        "bound_by": r0["bound_by"], "library_ms": r0["library_ms"], "backend": backend,
        "world": world, "all_gather_ms": r0["all_gather_ms"], "merge_ms": r0["merge_ms"],
        "sharded_ms": r0["sharded_ms"], "one_device_ms": r0["one_device_ms"],
    }
    results["multi"] = {"backend": backend, "world": world, "ranks": ranks}


# the phases after [small], in the order they run; a phase that another
# feeds (its index and texts) pulls that one in
PHASES = ("full", "wide", "serve", "ivf", "ivf-serve", "semantic", "csr", "engine", "http",
          "docs", "graph", "providers", "workflows", "chat", "mcp", "train", "multi")
PHASE_NEEDS = {"serve": ("full",), "ivf-serve": ("ivf",)}
_DT = "super_rag_tpu/ops/pallas_topk.py:36"
# each row of the kernels line: (name, source, replaces, key in results, phase)
KERNEL_ROWS = (
    ("dense_topk", "dense_topk.cu", _DT, "dense_topk", "full"),
    ("dense_topk_10m", "dense_topk.cu", _DT, "dense_topk_10m", "csr"),
    ("ivf_union", "ivf_scan.cu", "super_rag_tpu/ops/pallas_ivf.py:93", "ivf_union", "ivf"),
    ("ivf_probe", "ivf_scan.cu", "super_rag_tpu/ops/pallas_ivf.py:48", "ivf_probe", "ivf"),
    ("ivf_union_f32", "ivf_scan.cu", "super_rag_tpu/ops/pallas_ivf.py:93", "ivf_union_f32",
     "ivf"),
    ("ivf_probe_f32", "ivf_scan.cu", "super_rag_tpu/ops/pallas_ivf.py:48", "ivf_probe_f32",
     "ivf"),
    ("dense_topk_deep", "dense_topk.cu", _DT, "dense_topk_deep", "http"),
    *((f"dense_topk_http_{t}", "dense_topk.cu", _DT, f"dense_topk_http_{t}", phase)
      for t, phase in (("bf16", "http"), ("bf16_rerank", "http"), ("int8", "http"),
                       ("int8_rerank", "http"), ("f32", "http"), ("f32_rerank", "http"),
                       ("image", "docs"), ("graph", "graph"),
                       ("remote", "providers"), ("remote_rerank", "providers"),
                       (f"remote_{PROV_WIDE_DIM}", "providers"),
                       (f"remote_rerank_{PROV_WIDE_DIM}", "providers"))),
    ("dense_topk_1m_wide", "dense_topk.cu", _DT, "dense_topk_1m_wide", "wide"),
    ("dense_topk_1m_bf16", "dense_topk.cu", _DT, "dense_topk_1m_bf16", "wide"),
    ("dense_topk_1m_f32", "dense_topk.cu", _DT, "dense_topk_1m_f32", "wide"),
    ("dense_topk_1m_f32_b64", "dense_topk.cu", _DT, "dense_topk_1m_f32_b64", "wide"),
    ("dense_topk_workflow_bf16", "dense_topk.cu", _DT, "dense_topk_workflow_bf16",
     "workflows"),
    ("dense_topk_workflow_int8", "dense_topk.cu", _DT, "dense_topk_workflow_int8",
     "workflows"),
    ("dense_topk_chat", "dense_topk.cu", _DT, "dense_topk_chat", "chat"),
    ("dense_topk_mcp", "dense_topk.cu", _DT, "dense_topk_mcp", "mcp"),
    ("dense_topk_train", "dense_topk.cu", _DT, "dense_topk_train", "train"),
    ("dense_topk_sharded", "dense_topk.cu", _DT, "dense_topk_sharded", "multi"),
)


def select_phases(argv: list, env: dict) -> list:
    """The phases to run, in their usual order: every one with no
    selection, else those of ``--phases a,b`` (or ``SMOKE_PHASES=a,b``) and
    the phases they need.  An unknown phase or argument raises ValueError."""
    names = None
    args = list(argv)
    while args:
        arg = args.pop(0)
        if arg == "--phases" and args:
            names = args.pop(0)
        elif arg.startswith("--phases="):
            names = arg[len("--phases="):]
        else:
            raise ValueError(f"unknown argument {arg!r} (usage: chip_smoke.py "
                             f"[--phases {','.join(PHASES)}])")
    if names is None:
        names = env.get("SMOKE_PHASES") or ",".join(PHASES)
    wanted = {n.strip() for n in names.split(",") if n.strip()}
    unknown = sorted(wanted - set(PHASES))
    if unknown or not wanted:
        raise ValueError(f"unknown phase(s) {unknown or names!r}; the phases are "
                         f"{', '.join(PHASES)}")
    for name in list(wanted):
        wanted.update(PHASE_NEEDS.get(name, ()))
    return [p for p in PHASES if p in wanted]


def main(argv: list = None) -> int:
    try:
        phases = select_phases(sys.argv[1:] if argv is None else argv, os.environ)
    except ValueError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "super_rag_tpu_torch")):
        print("chip_smoke: super_rag_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 plain version
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)} "
        f"({time.perf_counter() - t0:.2f} s); phases {', '.join(phases)}")

    import threading

    from super_rag_tpu_torch import _build
    from super_rag_tpu_torch.tokenize import native

    t0 = time.perf_counter()
    # the native analyzer (g++) builds while nvcc builds the kernels
    analyzer_build = threading.Thread(target=native.load)
    analyzer_build.start()
    took = _build.build(["dense_topk", "ivf_scan"])  # one nvcc each, together
    analyzer_build.join()
    for name in ("dense_topk", "ivf_scan"):
        for ln in _build.build_logs.get(name, "").splitlines():
            if ("registers" in ln or "spill" in ln or "Compiling entry" in ln
                    or "Performance Loss" in ln):
                log(f"[build] {name} ptxas: {ln.strip()}")
    log(f"[build] nvcc {took}, native analyzer {native.available()}, in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cases = phase_small()
    log(f"[small] dense_topk kernel vs plain version: {cases} cases agree "
        f"(int8 x int8 bit-equal) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cases = phase_small_ivf()
    log(f"[small] IVF kernels vs plain versions: {cases} cases agree in "
        f"{time.perf_counter() - t0:.2f} s")

    # later phases add their extras to the full-size row's entry
    results: dict = {"card": smi, "dense_topk": {}}
    fed: dict = {}

    def run(name: str, fn) -> None:
        if name not in phases:
            return
        t0 = time.perf_counter()
        fn()
        tail = f" (on {smi})" if PHASES.index(name) >= PHASES.index("http") else ""
        log(f"[{name}] phase in {time.perf_counter() - t0:.2f} s{tail}")
        torch.cuda.empty_cache()

    def full():
        out = phase_full(results)
        if "serve" in phases:
            fed["full"] = out

    def serve():
        phase_serve(*fed.pop("full"))

    def ivf():
        out = phase_ivf(results)
        if "ivf-serve" in phases:
            fed["ivf"] = out

    def ivf_serve():
        phase_ivf_serve(*fed.pop("ivf"))

    for name, fn in (("full", full), ("wide", lambda: phase_wide(results)),
                     ("serve", serve), ("ivf", ivf), ("ivf-serve", ivf_serve),
                     ("semantic", lambda: phase_semantic(results)),
                     ("csr", lambda: phase_csr(results)),
                     ("engine", lambda: phase_engine(results)),
                     ("http", lambda: phase_http(results)),
                     ("docs", lambda: phase_docs(results)),
                     ("graph", lambda: phase_graph(results)),
                     ("providers", lambda: phase_providers(results)),
                     ("workflows", lambda: phase_workflows(results)),
                     ("chat", lambda: phase_chat(results)),
                     ("mcp", lambda: phase_mcp(results)),
                     ("train", lambda: phase_train(results)),
                     ("multi", lambda: phase_multi(results))):
        run(name, fn)

    source = "super_rag_tpu_torch/csrc/"
    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": source + src, "replaces": replaces,
         **results[key]}
        for name, src, replaces, key, phase in KERNEL_ROWS if phase in phases]}
    log(f"[done] wall {time.perf_counter() - t_start:.2f} s")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
