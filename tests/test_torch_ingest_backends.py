"""The port's other ingest backends and archives against the JAX package's.

- the worker's wire format (``tasks/worker.py``) equals the reference's
  dicts for the same document;
- rows ingested through ``ProcessScheduler`` (prepare in worker
  subprocesses) equal those ingested through ``ThreadScheduler``, text
  and vision rows alike;
- a worker survives a bad request; ``build_context`` takes ``process``,
  ``ray`` (falling back to ``process`` without ray) and S3; a fake
  ``ray`` module drives ``RayTaskScheduler`` end to end;
- ``iter_archive`` (zip, tar, tar.gz, tar.bz2, 7z) equals the
  reference's member for member, limits and unsafe paths included.

The 7z writer below is a copy of the one in ``tests/test_sevenzip.py``.
"""

import importlib.util
import io
import json
import lzma
import subprocess
import sys
import tarfile
import time
import zipfile
import zlib

import numpy as np
import pytest
import torch

from super_rag_tpu.fileparser import ocr as jocr
from super_rag_tpu.tasks import worker as jworker
from super_rag_tpu.utils.uncompress import iter_archive as j_iter_archive
from super_rag_tpu_torch.config import Settings
from super_rag_tpu_torch.engine.manager import EngineManager
from super_rag_tpu_torch.service.context import build_context
from super_rag_tpu_torch.store.db import Database
from super_rag_tpu_torch.store.models import IndexStatus
from super_rag_tpu_torch.store.objectstore import LocalObjectStore, S3ObjectStore
from super_rag_tpu_torch.tasks import worker as tworker
from super_rag_tpu_torch.tasks.document import DocumentIndexTask
from super_rag_tpu_torch.tasks.reconciler import DocumentIndexReconciler
from super_rag_tpu_torch.tasks.scheduler import (
    ProcessScheduler,
    RayTaskScheduler,
    ThreadScheduler,
)
from super_rag_tpu_torch.utils.sevenzip import SevenZipError
from super_rag_tpu_torch.utils.uncompress import iter_archive, supported_archive
from test_torch_image_codec import bmp_bytes, png_bytes, smooth_image

def _num(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    return b"\xff" + v.to_bytes(8, "little")


def _bits(flags: list[bool]) -> bytes:
    out = bytearray()
    b = 0
    mask = 0x80
    for f in flags:
        if f:
            b |= mask
        mask >>= 1
        if mask == 0:
            out.append(b)
            b, mask = 0, 0x80
    if mask != 0x80:
        out.append(b)
    return bytes(out)


def _lzma2(payload: bytes) -> tuple[bytes, bytes]:
    """(packed bytes, coder props) for one raw LZMA2 stream."""
    spec = {"id": lzma.FILTER_LZMA2, "preset": 6}
    packed = lzma.compress(payload, format=lzma.FORMAT_RAW, filters=[spec])
    props = lzma._encode_filter_properties(spec)  # noqa: SLF001
    return packed, props


def _streams_info(pack_pos: int, packed: bytes, props: bytes,
                  sub_sizes: list[int]) -> bytes:
    total = sum(sub_sizes)
    out = bytearray()
    out += _num(0x06) + _num(pack_pos) + _num(1)          # kPackInfo
    out += _num(0x09) + _num(len(packed)) + _num(0x00)    # kSize, kEnd
    out += _num(0x07)                                     # kUnpackInfo
    out += _num(0x0B) + _num(1) + b"\x00"                 # kFolder x1
    out += _num(1)                                        # numCoders
    out += bytes([0x21]) + b"\x21" + _num(len(props)) + props  # LZMA2
    out += _num(0x0C) + _num(total) + _num(0x00)          # unpack size
    if len(sub_sizes) != 1:
        out += _num(0x08)                                 # kSubStreamsInfo
        out += _num(0x0D) + _num(len(sub_sizes))
        out += _num(0x09)
        for s in sub_sizes[:-1]:
            out += _num(s)
        out += _num(0x00)
    out += _num(0x00)                                     # end StreamsInfo
    return bytes(out)


def write_7z(files: list[tuple[str, bytes | None]],
             encoded_header: bool = False) -> bytes:
    """files: (name, payload) with payload=None meaning a directory and
    payload=b"" an empty file."""
    content_files = [(n, p) for n, p in files if p]
    payload = b"".join(p for _, p in content_files)
    packed, props = _lzma2(payload)
    sub_sizes = [len(p) for _, p in content_files]

    header = bytearray()
    header += _num(0x01)                                  # kHeader
    if content_files:
        header += _num(0x04)                              # kMainStreamsInfo
        header += _streams_info(0, packed, props, sub_sizes)
    header += _num(0x05) + _num(len(files))               # kFilesInfo
    empty_stream = [p is None or p == b"" for _, p in files]
    if any(empty_stream):
        bs = _bits(empty_stream)
        header += _num(0x0E) + _num(len(bs)) + bs
        empty_file = [p == b"" for _, p in files if p is None or p == b""]
        if any(empty_file):
            bf = _bits(empty_file)
            header += _num(0x0F) + _num(len(bf)) + bf
    names = b"".join((n + "\x00").encode("utf-16-le") for n, _ in files)
    header += _num(0x11) + _num(len(names) + 1) + b"\x00" + names
    header += _num(0x00)                                  # end FilesInfo
    header += _num(0x00)                                  # end Header
    header = bytes(header)

    if encoded_header:
        hpacked, hprops = _lzma2(header)
        nh = _num(0x17) + _streams_info(len(packed), hpacked, hprops,
                                        [len(header)])
        body = packed + hpacked
    else:
        nh = header
        body = packed

    start = (len(body)).to_bytes(8, "little") + \
        (len(nh)).to_bytes(8, "little") + \
        zlib.crc32(nh).to_bytes(4, "little")
    sig = b"7z\xbc\xaf\x27\x1c" + b"\x00\x04" + \
        zlib.crc32(start).to_bytes(4, "little") + start
    return sig + body + nh


MD = b"""# Doc

## One

alpha bravo charlie delta echo foxtrot.

## Two

golf hotel india juliet kilo lima.
"""

SETTINGS = dict(embedding_dim=64, index_dtype="float32", vocab_size=1 << 14)


def _docs():
    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(200)]
    out = [("guide.md", MD), ("notes.txt", b"plain notes about mills and rivers")]
    for d in range(4):
        text = "\n\n".join(" ".join(rng.choice(words, 60)) for _ in range(8))
        out.append((f"d{d}.md", f"# d{d}\n\n{text}".encode()))
    out.append(("pic.png", png_bytes(smooth_image(40, 56, seed=2))))
    out.append(("pic.bmp", bmp_bytes(smooth_image(48, 32, seed=3))))
    return out


def _create(db, objects, coll, name, data, types=("vector",)):
    path = f"{coll['id']}/{name}"
    objects.put(path, data)
    import hashlib

    doc = db.create_document(coll["id"], name, size=len(data), object_path=path,
                             content_hash=hashlib.sha256(data).hexdigest())
    for t in types:
        db.upsert_document_index(doc["id"], t)
    return doc


def _wait(db, doc_id, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        rows = db.get_document_indexes(doc_id)
        if rows and all(r["status"] in (IndexStatus.ACTIVE.value, IndexStatus.FAILED.value)
                        for r in rows):
            return rows
        time.sleep(0.05)
    raise AssertionError("index never settled")


def _stack(tmp_path, kind, **kw):
    cfg = Settings(data_dir=str(tmp_path), **SETTINGS)
    db = Database(cfg.resolved_db_path())
    objects = kw.pop("objects", None) or LocalObjectStore(cfg.objects_root())
    engines = EngineManager(cfg, device="cpu")
    task = DocumentIndexTask(db, objects, engines, cfg)
    rec = DocumentIndexReconciler(db)
    sched = kind(task, rec.callbacks, **kw)
    rec.scheduler = sched
    return cfg, db, objects, engines, rec, sched


def test_wire_format_equals_the_reference(tmp_path, monkeypatch):
    """prepare_on_host of both packages on one db file and object root:
    the same JSON-safe dict (parts, chunks, hashes) for every document,
    but for the image part's ``url`` that only the port's carries (a
    kept difference: over the reference's wire an image document loses
    the link to its asset)."""
    monkeypatch.setattr(jocr, "default_ocr", lambda: None)
    cfg = Settings(data_dir=str(tmp_path), **SETTINGS)
    db = Database(cfg.resolved_db_path())
    objects = LocalObjectStore(cfg.objects_root())
    coll = db.create_collection("kb", "alice")
    for name, data in _docs():
        doc = _create(db, objects, coll, name, data)
        for size, overlap in ((400, 20), (64, 8)):
            got = tworker.prepare_on_host(doc["id"], "vector", db.path,
                                          object_store=objects.wire_config(),
                                          chunk_size=size, chunk_overlap=overlap)
            want = jworker.prepare_on_host(doc["id"], "vector", db.path,
                                           object_store=objects.wire_config(),
                                           chunk_size=size, chunk_overlap=overlap)
            images = [p for p in got["parts"] if p["kind"] == "ImagePart"]
            assert [p["url"] for p in images] == (
                [] if not name.startswith("pic") else
                [f"asset://{got['parts'][-2]['asset_id']}"])
            for p in images:
                del p["url"]
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
            got = tworker.prepare_on_host(doc["id"], "vector", db.path,
                                          object_store=objects.wire_config(),
                                          chunk_size=size, chunk_overlap=overlap)
            back = tworker.prepared_from_wire(got)
            assert tworker.prepared_to_wire(back) == got
            assert [tworker.chunk_to_wire(c) for c in back["chunks"]] == [
                jworker.chunk_to_wire(c) for c in jworker.prepared_from_wire(want)["chunks"]]


def _rows(engines, coll):
    idx = engines.get(coll["id"], coll["config"]).index
    out = []
    emb = idx._dense_rows_f32(torch.arange(idx.size)).cpu().numpy()
    for r, meta in enumerate(idx.row_meta):
        if meta is None:
            continue
        m = {k: v for k, v in meta.items() if k not in ("document_id", "collection_id")}
        out.append((meta.get("document_name"), json.dumps(m, sort_keys=True),
                    emb[r].tobytes()))
    return sorted(out)


def test_process_rows_equal_thread_rows(tmp_path):
    """Ingest the same documents (text and images, vector + vision) under
    both backends: the same rows, texts, metadata and stored vectors."""
    got = {}
    for kind, kw in ((ThreadScheduler, {"host_workers": 2}),
                     (ProcessScheduler, {"process_workers": 2})):
        cfg, db, objects, engines, rec, sched = _stack(tmp_path / kind.__name__, kind, **kw)
        try:
            coll = db.create_collection("kb", "alice", config={"enable_vision": True})
            docs = [_create(db, objects, coll, n, d, ("vector", "vision"))
                    for n, d in _docs()]
            rec.reconcile_all()
            assert sched.wait_idle(60)
            for d in docs:
                rows = _wait(db, d["id"])
                assert {r["status"] for r in rows} == {IndexStatus.ACTIVE.value}, rows
            if kind is ProcessScheduler:
                assert all(w.proc.poll() is None for w in sched._procs)
            got[kind.__name__] = _rows(engines, coll)
        finally:
            sched.shutdown()
    assert got["ThreadScheduler"] == got["ProcessScheduler"]
    assert sum("vision" in r[1] or "asset_id" in r[1] for r in got["ProcessScheduler"]) == 2


def test_worker_survives_bad_request(tmp_path):
    cfg, db, objects, engines, rec, sched = _stack(tmp_path, ProcessScheduler,
                                                   process_workers=1)
    try:
        w = sched._procs[0]
        assert w.call({"op": "nope"})["ok"] is False
        assert w.call({"op": "ping"}) == {"ok": True, "pong": True}
        resp = w.call({"op": "prepare", "document_id": "missing", "index_type": "vector",
                       "db_path": db.path, "object_store": objects.wire_config()})
        assert resp["ok"] is False and "not found" in resp["error"]
        w.proc.stdin.write("{not json\n")
        w.proc.stdin.flush()
        assert w.proc.stdout.readline().startswith('{"ok": false')
        assert w.call({"op": "ping"})["ok"]
        coll = db.create_collection("kb", "alice")
        doc = _create(db, objects, coll, "gone.md", MD)
        objects.delete(doc["object_path"])
        rec.reconcile_all()
        sched.wait_idle(30)
        rows = _wait(db, doc["id"])
        assert rows[0]["status"] == IndexStatus.FAILED.value and rows[0]["error_message"]
    finally:
        sched.shutdown()
    assert all(w.proc.wait(10) is not None for w in sched._procs)


def test_worker_process_imports_no_torch():
    code = ("import sys, super_rag_tpu_torch.tasks.worker\n"
            "print(sorted(m for m in ('torch', 'jax', 'PIL', 'super_rag_tpu')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("backend", ["thread", "process", "ray"])
def test_build_context_backends(tmp_path, backend, caplog):
    from super_rag_tpu.config import Settings as JSettings
    from super_rag_tpu.service.context import build_context as jbuild

    want = {"thread": "ThreadScheduler", "process": "ProcessScheduler",
            "ray": ("RayTaskScheduler" if importlib.util.find_spec("ray")
                    else "ProcessScheduler")}[backend]
    ctx = build_context(Settings(data_dir=str(tmp_path / "t"), ingest_backend=backend,
                                 ingest_host_workers=1, **SETTINGS),
                        background_tasks=True, device="cpu")
    jctx = jbuild(JSettings(data_dir=str(tmp_path / "j"), ingest_backend=backend,
                            ingest_host_workers=1, **SETTINGS), background_tasks=True)
    try:
        assert type(ctx.scheduler).__name__ == type(jctx.scheduler).__name__ == want
        if backend == "ray" and want == "ProcessScheduler":
            assert "ray is not installed" in caplog.text
    finally:
        ctx.scheduler.shutdown()
        jctx.scheduler.shutdown()
    ctx = build_context(Settings(data_dir=str(tmp_path / "t2"), ingest_backend=backend,
                                 **SETTINGS), background_tasks=False, device="cpu")
    assert type(ctx.scheduler).__name__ == "InProcessScheduler"


def test_build_context_takes_s3(tmp_path):
    from super_rag_tpu.config import Settings as JSettings
    from super_rag_tpu.service.context import build_context as jbuild

    kw = dict(object_store_type="s3", s3_bucket="bkt", s3_endpoint="http://127.0.0.1:9",
              s3_region="r1", **SETTINGS)
    ctx = build_context(Settings(data_dir=str(tmp_path / "t"), **kw), device="cpu")
    jctx = jbuild(JSettings(data_dir=str(tmp_path / "j"), **kw))
    assert isinstance(ctx.objects, S3ObjectStore)
    want = jctx.objects.wire_config()
    assert ctx.objects.wire_config() == want


class _FakeRay:
    """The ray API surface the scheduler uses; arguments and results
    cross by value (JSON), as with Ray."""

    def __init__(self):
        self._inited = False
        self.remote_calls = 0

    def is_initialized(self):
        return self._inited

    def init(self, address=None, ignore_reinit_error=False, include_dashboard=False):
        self._inited = True

    def remote(self, fn):
        fake = self

        class _Remote:
            def remote(self, *args, **kwargs):
                fake.remote_calls += 1
                return ("ref", fn, json.loads(json.dumps(args)),
                        json.loads(json.dumps(kwargs)))

        return _Remote()

    def get(self, ref):
        tag, fn, args, kwargs = ref
        assert tag == "ref"
        return json.loads(json.dumps(fn(*args, **kwargs)))


def test_ray_scheduler_end_to_end_with_fake_ray(tmp_path, monkeypatch):
    fake = _FakeRay()
    monkeypatch.setitem(sys.modules, "ray", fake)
    cfg, db, objects, engines, rec, sched = _stack(tmp_path, RayTaskScheduler,
                                                   ray_workers=2)
    try:
        assert fake.is_initialized()
        coll = db.create_collection("kb", "alice")
        doc = _create(db, objects, coll, "guide.md", MD)
        assert rec.reconcile_all() == 1
        assert sched.wait_idle(30)
        assert _wait(db, doc["id"])[0]["status"] == IndexStatus.ACTIVE.value
        assert fake.remote_calls == 1
        hits = engines.get(coll["id"], coll["config"]).search("alpha bravo", top_k=2)
        assert hits and "alpha" in hits[0].text
    finally:
        sched.shutdown()


def test_ray_scheduler_without_ray_raises_import_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "ray", None)
    with pytest.raises(ImportError):
        _stack(tmp_path, RayTaskScheduler, ray_workers=1)


# -- archives -------------------------------------------------------------------------

MEMBERS = [("docs/a.md", b"# alpha\n" * 40), ("docs/b.txt", b"beta beta beta" * 100),
           ("c.bin", bytes(range(256)) * 17), ("../escape.txt", b"no"),
           ("/abs/path.txt", b"no"), ("docs/../ok.txt", b"normalised")]


def _zip(members, big=None):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("dir/", b"")
        for n, d in members:
            z.writestr(n, d)
        if big:
            z.writestr("big.bin", bytes(big))
    return buf.getvalue()


def _tar(members, mode, big=None):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode=mode) as t:
        d = tarfile.TarInfo("dir")
        d.type = tarfile.DIRTYPE
        t.addfile(d)
        for n, data in members + ([("big.bin", bytes(big))] if big else []):
            info = tarfile.TarInfo(n)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


ARCHIVES = {
    "a.zip": lambda big=None: _zip(MEMBERS, big),
    "a.tar": lambda big=None: _tar(MEMBERS, "w", big),
    "a.tar.gz": lambda big=None: _tar(MEMBERS, "w:gz", big),
    "a.tgz": lambda big=None: _tar(MEMBERS, "w:gz", big),
    "a.tar.bz2": lambda big=None: _tar(MEMBERS, "w:bz2", big),
    "a.7z": lambda big=None: write_7z(MEMBERS + [("empty.txt", b""), ("docs", None)]
                                      + ([("big.bin", bytes(big))] if big else [])),
    "b.7z": lambda big=None: write_7z(MEMBERS, encoded_header=True),
}


@pytest.mark.parametrize("name", list(ARCHIVES))
def test_iter_archive_equals_the_reference(name):
    assert supported_archive(name) and supported_archive(name.upper())
    data = ARCHIVES[name]()
    got = list(iter_archive(name, data))
    assert got == list(j_iter_archive(name, data))
    names = [n for n, _ in got]
    assert "../escape.txt" not in names and "/abs/path.txt" not in names
    assert ("docs/a.md", b"# alpha\n" * 40) in got
    for limit in (1, 2):
        assert list(iter_archive(name, data, max_members=limit)) == list(
            j_iter_archive(name, data, max_members=limit))
    if name != "b.7z":
        big = ARCHIVES[name](big=1024 * 1024 + 1)
        got = list(iter_archive(name, big, max_member_mb=1))
        assert got == list(j_iter_archive(name, big, max_member_mb=1))
        assert "big.bin" not in [n for n, _ in got]


def test_archive_errors_match_the_reference():
    for name, data in (("x.rar", b"Rar!"), ("x.gz", b"..."), ("x.7z", b"PK\x03\x04 no"),
                       ("x.zip", b"PK\x03\x04")):
        errs = []
        for fn in (iter_archive, j_iter_archive):
            with pytest.raises(Exception) as e:
                list(fn(name, data))
            errs.append(type(e.value).__name__)
        assert errs[0] == errs[1], (name, errs)
    broken = bytearray(write_7z(MEMBERS))
    broken[20] = 0xFF  # the next header's size
    with pytest.raises(SevenZipError):
        list(iter_archive("x.7z", bytes(broken)))
