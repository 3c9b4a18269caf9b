"""The port's CLI (``python -m super_rag_tpu_torch.cli``) against the JAX
package's, each as a subprocess on a fresh data directory of its own with
``SUPER_RAG_FORCE_CPU=1`` (and ``JAX_PLATFORMS=cpu`` for the reference):
``ingest``, ``collections``, ``search`` and ``snapshot`` print the same
lines up to ids and paths, ``serve`` answers on the port it prints, and
without the variable the port's CLI exits non-zero naming the missing
card.  Every command runs under a timeout of its own: a process that
outlives it fails the test."""

import http.client
import os
import re
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "demo", "sample.md")
PACKAGES = ("super_rag_tpu", "super_rag_tpu_torch")
TIMEOUT_S = 120
IDS = re.compile(r"\b(doc|col)-[0-9a-f]{20}\b")


def run(package: str, data_dir: str, *args: str, force_cpu: bool = True):
    env = dict(os.environ, SUPER_RAG_DATA_DIR=data_dir, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    env.pop("SUPER_RAG_FORCE_CPU", None)
    if force_cpu:
        env["SUPER_RAG_FORCE_CPU"] = "1"
    return subprocess.run([sys.executable, "-m", f"{package}.cli", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)


def lines(out: str, data_dir: str) -> list:
    """stdout with ids and the data directory masked."""
    return IDS.sub(r"\1-<id>", out.replace(data_dir, "<data>")).splitlines()


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    """Each package's CLI ingests demo/sample.md into collection "notes",
    then two more files (the second run finds the collection by title)."""
    extra = tmp_path_factory.mktemp("files")
    more = []
    for name, text in (("mill.md", "# Mill\n\nthe river runs past the mill, and the mill "
                                   "grinds grain into flour for bread.\n"),
                       ("notes.txt", "plain notes about tensor cores, warps and the "
                                     "systolic arrays of a TPU.")):
        (extra / name).write_text(text)
        more.append(str(extra / name))
    out = {}
    for pkg in PACKAGES:
        data = str(tmp_path_factory.mktemp(pkg))
        first = run(pkg, data, "ingest", "notes", SAMPLE)
        second = run(pkg, data, "ingest", "notes", *more)
        for r in (first, second):
            assert r.returncode == 0, r.stderr[-2000:]
        cid = re.search(r"collection: (col-[0-9a-f]+)", first.stdout).group(1)
        assert f"collection: {cid}" in second.stdout
        out[pkg] = (data, cid, first.stdout, second.stdout)
    return out


def test_ingest_prints_the_same_lines(ingested):
    got = [[lines(o, d) for o in (first, second)]
           for d, _, first, second in (ingested[p] for p in PACKAGES)]
    assert got[0] == got[1]
    assert got[1][0] == ["doc-<id>  sample.md  {'vector': 'ACTIVE'}", "collection: col-<id>"]
    assert len(got[1][1]) == 3


def test_duplicate_ingest_is_refused_alike(ingested):
    got = []
    for pkg in PACKAGES:
        data, *_ = ingested[pkg]
        r = run(pkg, data, "ingest", "notes", SAMPLE)
        got.append((r.returncode, r.stdout, IDS.sub(r"\1-<id>", r.stderr.strip().splitlines()[-1])))
    assert got[0][0] == got[1][0] == 1 and got[0][1] == got[1][1] == ""
    assert got[0][2].split(": ", 1)[1] == got[1][2].split(": ", 1)[1] == \
        "duplicate of document doc-<id>"


def test_collections_prints_the_same_lines(ingested):
    got = []
    for pkg in PACKAGES:
        data, cid, *_ = ingested[pkg]
        r = run(pkg, data, "collections")
        assert r.returncode == 0, r.stderr[-2000:]
        assert cid in r.stdout
        got.append(lines(r.stdout, data))
    assert got[0] == got[1] == ["col-<id>  ACTIVE    notes"]


@pytest.mark.parametrize("query,top_k", [("what is hybrid search", None),
                                         ("tensor cores and TPUs", "2"),
                                         ("zyzzyva", "8")])
def test_search_prints_the_same_lines(ingested, query, top_k):
    got = []
    for pkg in PACKAGES:
        data, cid, *_ = ingested[pkg]
        r = run(pkg, data, "search", cid, query, *(("--top-k", top_k) if top_k else ()))
        assert r.returncode == 0, r.stderr[-2000:]
        got.append(lines(r.stdout, data))
    assert got[0] == got[1] and got[1]
    assert got[1][0].startswith("#1 score=")


def test_search_of_an_unknown_collection_exits_alike(ingested):
    got = []
    for pkg in PACKAGES:
        data, *_ = ingested[pkg]
        r = run(pkg, data, "search", "col-nope", "x")
        got.append((r.returncode, r.stdout, r.stderr.strip().splitlines()[-1]))
    assert got[0] == got[1] == (1, "", "collection col-nope not found")


def test_snapshot_prints_the_same_lines(ingested):
    got = []
    for pkg in PACKAGES:
        data, *_ = ingested[pkg]
        r = run(pkg, data, "snapshot")
        assert r.returncode == 0, r.stderr[-2000:]
        got.append(lines(r.stdout, data))
        assert os.listdir(os.path.join(data, "snapshots"))
    assert got[0] == got[1] == ["snapshots written to <data>/snapshots"]


def test_serve_answers_on_the_port_it_prints(tmp_path):
    """``serve --port 0``: the first line names the port, where the console
    page answers; the server is stopped by a signal."""
    pages = []
    for pkg in PACKAGES:
        env = dict(os.environ, SUPER_RAG_DATA_DIR=str(tmp_path / pkg), JAX_PLATFORMS="cpu",
                   SUPER_RAG_FORCE_CPU="1", OMP_NUM_THREADS="2")
        proc = subprocess.Popen([sys.executable, "-m", f"{pkg}.cli", "serve", "--host",
                                 "127.0.0.1", "--port", "0"], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            t0 = time.monotonic()
            line = proc.stdout.readline()
            assert time.monotonic() - t0 < TIMEOUT_S
            m = re.fullmatch(r"listening on 127\.0\.0\.1:(\d+)\n", line)
            assert m, line
            conn = http.client.HTTPConnection("127.0.0.1", int(m.group(1)), timeout=30)
            conn.request("GET", "/")
            resp = conn.getresponse()
            pages.append((resp.status, resp.read()))
            conn.close()
        finally:
            proc.terminate()
            proc.wait(TIMEOUT_S)
    assert pages[0] == pages[1] and pages[1][0] == 200


def test_port_cli_without_the_cpu_named_refuses(tmp_path):
    """Without a card and without SUPER_RAG_FORCE_CPU the port's CLI exits
    non-zero naming the missing card, and writes no data."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    data = str(tmp_path / "nocard")
    for args in (("collections",), ("ingest", "notes", SAMPLE)):
        r = run("super_rag_tpu_torch", data, *args, force_cpu=False)
        assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-2000:]
        assert r.stdout == ""
    assert not os.path.exists(data)
