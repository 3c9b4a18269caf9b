"""chip_smoke.py on the CPU: its phase selection, and rehearsals of its
[wide], [workflows], [chat], [mcp], [train] and [multi] phases at a small size (the card's
kernels replaced by their plain versions, which move the same launch counters)."""

import pytest
import torch

import chip_smoke as cs


@pytest.mark.parametrize("argv,env,want", [
    ([], {}, list(cs.PHASES)),
    (["--phases", "http,workflows"], {}, ["http", "workflows"]),
    (["--phases=workflows,http"], {}, ["http", "workflows"]),
    ([], {"SMOKE_PHASES": "workflows"}, ["workflows"]),
    (["--phases", "serve"], {}, ["full", "serve"]),
    (["--phases", "ivf-serve,docs"], {"SMOKE_PHASES": "csr"}, ["ivf", "ivf-serve", "docs"]),
    (["--phases", "chat"], {}, ["chat"]),
    (["--phases=chat,workflows,http"], {}, ["http", "workflows", "chat"]),
    (["--phases", "mcp"], {}, ["mcp"]),
    (["--phases", "train"], {}, ["train"]),
    (["--phases", "train,mcp"], {}, ["mcp", "train"]),
    ([], {"SMOKE_PHASES": "train,chat"}, ["chat", "train"]),
    (["--phases", "multi"], {}, ["multi"]),
    (["--phases=multi,train"], {}, ["train", "multi"]),
])
def test_select_phases(argv, env, want):
    assert cs.select_phases(argv, env) == want


@pytest.mark.parametrize("argv,env", [(["--phases", "nope"], {}), (["--phase", "http"], {}),
                                      (["--phases", ","], {}), ([], {"SMOKE_PHASES": "x"})])
def test_unknown_phase_exits_non_zero_before_anything(argv, env, monkeypatch, capsys):
    with pytest.raises(ValueError):
        cs.select_phases(argv, env)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cs.main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "chip_smoke:" in out.err


def test_no_card_exits_non_zero_with_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert cs.main([]) == 2
    assert capsys.readouterr().out == ""


def test_every_kernel_row_belongs_to_a_phase():
    assert {phase for *_, phase in cs.KERNEL_ROWS} <= set(cs.PHASES)
    names = [name for name, *_ in cs.KERNEL_ROWS]
    assert len(names) == len(set(names))
    assert {"dense_topk_workflow_bf16", "dense_topk_workflow_int8",
            "dense_topk_chat", "dense_topk_mcp", "dense_topk_train"} <= set(names)
    assert "dense_topk_sharded" in names
    assert ("dense_topk_1m_bf16", "dense_topk.cu", cs._DT, "dense_topk_1m_bf16",
            "wide") in cs.KERNEL_ROWS
    assert {"dense_topk_1m_f32", "dense_topk_1m_f32_b64", "dense_topk_http_f32",
            "dense_topk_http_f32_rerank"} <= set(names)
    assert cs.PHASES[-3:] == ("mcp", "train", "multi")


def test_workflow_yaml_parses_to_the_definition():
    import yaml

    from super_rag_tpu_torch.nodeflow import yamlsub

    defn = cs.workflow_definition(["col-a1", "col-b2"])
    text = cs.workflow_yaml(defn)
    assert yamlsub.load(text) == yaml.safe_load(text) == defn


def test_workflows_phase_rehearsed_on_the_cpu(monkeypatch):
    """The phase end to end at a small size: every gate runs, and the two
    kernel rows come out with their keys."""
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import dense_topk as dt

    for name, value in (("DEVICE", "cpu"), ("HTTP_SECTIONS", 8), ("WF_DOCS_A", 2),
                        ("WF_DOCS_B", 2), ("WF_SINGLE", 4), ("WF_CONCURRENT", 4),
                        ("WF_CLIENTS", 2), ("WF_ONE_SHOT", 2), ("WF_STREAM", 2),
                        ("WF_STAGE_RUNS", 2),
                        ("SEMANTIC_CONFIG", dict(cs.SEMANTIC_CONFIG, vocab_size=2000,
                                                 hidden_dim=32, num_layers=1, num_heads=4,
                                                 mlp_dim=64, max_len=64))):
        monkeypatch.setattr(cs, name, value)

    def plain_counting(*args):
        q, _, values, *_, n, tile, kt = args
        mode = dt._mode(q, values)
        dt.count_launch(dt.kernel_variant(mode, kt, q.shape[1], q.shape[0], -(-n // tile), 132),
                        mode)
        return dt.tile_topk_plain(*args)

    timed = lambda fn, *a, **kw: (fn(), 1.0)[1]  # noqa: E731
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name in ("cuda_ms", "host_ms", "burst_ms"):
        monkeypatch.setattr(cs, name, timed)
    monkeypatch.setattr(dt, "_sm_count", lambda i: 132)
    monkeypatch.setattr(dt, "tile_topk", plain_counting)
    monkeypatch.setattr(DeviceIndex, "_kernel_default", lambda self, *a: True)
    torch.set_num_threads(2)
    results = {"card": "CPU rehearsal", "dense_topk": {}}
    cs.phase_workflows(results)
    for key in ("dense_topk_workflow_bf16", "dense_topk_workflow_int8"):
        row = results[key]
        assert row["launches"] >= 1 and row["variant"] == "tcs"
        assert {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(row)
    assert set(results["workflows"]["runs"]) == {"saved, 1 client", "saved, 2 clients",
                                                 "one-shot (YAML), 1 client",
                                                 "streamed, 1 client"}


def test_chat_phase_rehearsed_on_the_cpu(monkeypatch):
    """The [chat] phase end to end at a small size: every gate runs (its
    WebSockets through the script's stdlib client), and its kernel row
    comes out with its keys."""
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import dense_topk as dt

    for name, value in (("DEVICE", "cpu"), ("HTTP_SECTIONS", 16), ("CHAT_DOCS", 3),
                        ("CHAT_SINGLE", 4), ("CHAT_SINGLE_CHATS", 2), ("CHAT_CONCURRENT", 4),
                        ("CHAT_CLIENTS", 2), ("CHAT_FRONTEND", 2), ("CHAT_WS", 4),
                        ("CHAT_WS_STOPS", 1), ("CHAT_FILE_SEARCHES", 2), ("CHAT_AGENT_WS", 2),
                        ("CHAT_AGENT_AG_UI", 2), ("CHAT_SHARED_SEARCHES", 2),
                        ("CHAT_STAGE_TURNS", 2),
                        ("SEMANTIC_CONFIG", dict(cs.SEMANTIC_CONFIG, vocab_size=2000,
                                                 hidden_dim=32, num_layers=1, num_heads=4,
                                                 mlp_dim=64, max_len=64))):
        monkeypatch.setattr(cs, name, value)

    def plain_counting(*args):
        q, _, values, *_, n, tile, kt = args
        mode = dt._mode(q, values)
        dt.count_launch(dt.kernel_variant(mode, kt, q.shape[1], q.shape[0], -(-n // tile), 132),
                        mode)
        return dt.tile_topk_plain(*args)

    timed = lambda fn, *a, **kw: (fn(), 1.0)[1]  # noqa: E731
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name in ("cuda_ms", "host_ms", "burst_ms"):
        monkeypatch.setattr(cs, name, timed)
    monkeypatch.setattr(dt, "_sm_count", lambda i: 132)
    monkeypatch.setattr(dt, "tile_topk", plain_counting)
    monkeypatch.setattr(DeviceIndex, "_kernel_default", lambda self, *a: True)
    torch.set_num_threads(2)
    results = {"card": "CPU rehearsal", "dense_topk": {}}
    cs.phase_chat(results)
    row = results["dense_topk_chat"]
    assert row["launches"] >= 1 and row["variant"] == "tcs"
    assert {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(row)
    assert set(results["chat"]["latency"]) == {"SSE, 1 client", "SSE, 2 clients", "frontend",
                                               "agent, WebSocket", "agent, AG-UI"}


NARROW = dict(cs.SEMANTIC_CONFIG, vocab_size=2000, hidden_dim=32, num_layers=1, num_heads=4,
              mlp_dim=64, max_len=64)


def stub_card(monkeypatch, **consts):
    """The smoke on the CPU: ``consts`` set on chip_smoke, the timers and
    the profiler stubbed, dense_topk's plain version in place of the kernel
    (moving the variant's counters), the index's kernel route taken."""
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import dense_topk as dt

    for name, value in {"DEVICE": "cpu", "SEMANTIC_CONFIG": NARROW, **consts}.items():
        monkeypatch.setattr(cs, name, value)

    def plain_counting(*args):
        q, _, values, *_, n, tile, kt = args
        mode = dt._mode(q, values)
        dt.count_launch(dt.kernel_variant(mode, kt, q.shape[1], q.shape[0], -(-n // tile), 132),
                        mode)
        return dt.tile_topk_plain(*args)

    timed = lambda fn, *a, **kw: (fn(), 1.0)[1]  # noqa: E731
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name in ("cuda_ms", "host_ms", "burst_ms"):
        monkeypatch.setattr(cs, name, timed)
    monkeypatch.setattr(cs, "device_busy", lambda fn, wall_ms, reps=5, top=0: (
        [fn() for _ in range(reps + 1)], "device busy not measured (CPU rehearsal)")[1])
    monkeypatch.setattr(dt, "_sm_count", lambda i: 132)
    monkeypatch.setattr(dt, "tile_topk", plain_counting)
    monkeypatch.setattr(DeviceIndex, "_kernel_default", lambda self, *a: True)
    torch.set_num_threads(2)
    return {"card": "CPU rehearsal", "dense_topk": {}}


def test_wide_phase_rehearsed_on_the_cpu(monkeypatch):
    """The [wide] phase at a small size: the int8 call on the register-list
    route (147 tiles of one query block fill the 132 SMs), held bit for bit
    beside the sorted-selection kernel's route, then the default bf16
    collection's call, which must take the sorted-selection route once in
    mode bf16, and the f32 collection's two calls, each of which must take
    it once in mode f32; every kernel row comes out with its keys."""
    results = stub_card(monkeypatch, N_ROWS=300_000, DIM=64, WIDE_DIM=64, BATCH=8,
                        WIDE_F32_SMALL_BATCH=4)
    cs.phase_wide(results)
    wide, bf16 = results["dense_topk_1m_wide"], results["dense_topk_1m_bf16"]
    f32 = [results["dense_topk_1m_f32"], results["dense_topk_1m_f32_b64"]]
    assert wide["variant"] == cs.LIST_VARIANT and "tcs_ms" in wide
    assert bf16["variant"] == cs.TCS_VARIANT and bf16["launches"] == 1
    assert [r["batch"] for r in f32] == [8, 4]
    for row in f32:
        assert row["variant"] == cs.TCS_F32_VARIANT and row["launches"] == 1
        assert row["kt"] == 2 and row["bound_by"] == "bytes"
    for row in (wide, bf16, *f32):
        assert {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(row)
    assert wide["max_abs_err"] == 0 and bf16["kt"] == 2 and bf16["dim"] == 64


def test_mcp_phase_rehearsed_on_the_cpu(monkeypatch):
    """The [mcp] phase end to end at a small size: the protocol, the tools,
    the console, the CLI subprocesses (on the CPU here) and the evals; its
    kernel row comes out with its keys."""
    results = stub_card(monkeypatch, HTTP_SECTIONS=16, MCP_DOCS=3, MCP_QUERIES=4,
                        MCP_CONCURRENT=4, MCP_CLIENTS=2, MCP_FILE_SEARCHES=2,
                        MCP_EVAL_PER_DOC=4, CLI_DOCS=1)
    cs.phase_mcp(results)
    row = results["dense_topk_mcp"]
    assert row["launches"] >= 1 and row["variant"] == "tcs"
    assert {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(row)
    out = results["mcp"]
    assert set(out["latency"]) == {"search_collection, 1 client",
                                   "search_collection, unreranked, 1 client",
                                   "search_collection, 2 clients"}
    assert set(out["cli_ms"]) == {"ingest", "collections", "search", "snapshot"}
    assert set(out["eval"]) == {"hybrid", "fulltext"}
    assert out["eval"]["hybrid"]["n_queries"] == 12


def test_train_phase_rehearsed_on_the_cpu(monkeypatch):
    """The [train] phase end to end at a small size: the harvest of this
    machine's site-packages, gate a (here CPU against CPU), the contrastive
    and CE steps with their loss gates, mining, and the trained checkpoints
    serving through dense_topk (bit for bit, int8)."""
    results = stub_card(monkeypatch, TRAIN_FILES_PER_PKG=8, TRAIN_MAX_DOCS=900,
                        TRAIN_SERVE_ROWS=64, TRAIN_BATCH=16, TRAIN_STEPS=30, TRAIN_LR=2e-3,
                        TRAIN_CHECK_BATCH=2, MINE_PAIRS=32, MINE_NEGATIVES=7, CE_QUERIES=4,
                        CE_STEPS=48, CE_LR=3e-3, TRAIN_SERVE_QUERIES=8)
    cs.phase_train(results)
    row = results["dense_topk_train"]
    assert row["launches"] == 1 and row["max_abs_err"] == 0
    assert {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(row)
    out = results["train"]
    assert out["loss"][1] < out["loss"][0] and out["ce_loss"][1] < out["ce_loss"][0]


def test_multi_phase_rehearsed_on_the_cpu(monkeypatch):
    """The [multi] phase end to end at a small size on two gloo ranks:
    gates a (exact depth bit for bit the one-device search; the calibrated
    kernel = its plain version), b, c (``entry.dryrun_multichip``), d (a
    dp 1 x tp 2 step = the one-device step) and e (the profiler trace);
    its kernel row comes out with its keys."""
    import torch_rank_cases as rc

    results = stub_card(monkeypatch, N_ROWS=20_000, DIM=64, VOCAB=4096, BATCH=8,
                        CANDIDATES=32, MULTI_TRAIN_BATCH=4, MULTI_TRAIN_LEN=16)
    cs.phase_multi(results, rank_setup=rc.stub_card_rank)
    row = results["dense_topk_sharded"]
    assert row["backend"] == "gloo" and row["world"] == 2
    assert row["launches"] == 6 and row["max_abs_err"] == 0
    assert {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "all_gather_ms",
            "merge_ms", "sharded_ms", "one_device_ms"} <= set(row)
    r0 = results["multi"]["ranks"][0]
    assert r0["train"]["tp"] == 2 and r0["train"]["dp"] == 1
    assert 0.0 <= r0["recall_calibrated"] <= 1.0 and 0.0 <= r0["hybrid_overlap"] <= 1.0
