"""The port's host layers of the serving seam against the JAX package's:
a Database file written by one package opens and reads the same in the
other, an Auth token signed by one verifies in the other, the Rechunker
gives identical chunks, DocParser parses every format the same way, and
the reconciler
drives the same state machine."""

import os

import pytest

from super_rag_tpu.api import auth as jauth
from super_rag_tpu.chunk import chunking as jchunk
from super_rag_tpu.fileparser import markdown as jmd
from super_rag_tpu.fileparser.parser import DocParser as JDocParser
from super_rag_tpu.store.db import Database as JDatabase
from super_rag_tpu.store import models as jmodels
from super_rag_tpu.tasks.reconciler import DocumentIndexReconciler as JReconciler
from super_rag_tpu_torch.api import auth as tauth
from super_rag_tpu_torch.api.http import Request
from super_rag_tpu_torch.chunk import chunking as tchunk
from super_rag_tpu_torch.fileparser import markdown as tmd
from super_rag_tpu_torch.fileparser.parser import DocParser as TDocParser
from super_rag_tpu_torch.store.db import Database as TDatabase
from super_rag_tpu_torch.store import models as tmodels
from super_rag_tpu_torch.tasks.reconciler import DocumentIndexReconciler as TReconciler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DBS = {"jax": JDatabase, "torch": TDatabase}


def fill(db):
    """The same writes through either package's Database."""
    u = db.create_user("alice", "hash$x", "a@example.com", "admin")
    c = db.create_collection("kb", "alice", "desc", {"metric": "ip", "embedding": {"dim": 8}})
    d = db.create_document(c["id"], "a.md", size=3, content_hash="h1",
                           object_path=f"{c['id']}/h1/a.md", metadata={"k": [1, 2]},
                           chat_id="chat")
    db.upsert_document_index(d["id"], "vector")
    key = db.create_api_key(u["id"], "ci")
    db.add_audit("alice", "/api/v1/collections", "POST", 201, 1.5,
                 request="{}", response="{}")
    return {"user": u["id"], "coll": c["id"], "doc": d["id"], "key": key["key"]}


def read(db, ids):
    """What a reader sees, without wall-clock fields."""
    def strip(row):
        return {k: v for k, v in (row or {}).items()
                if k not in ("created", "updated", "last_used")}

    return {
        "user": strip(db.get_user("alice")),
        "user_by_id": strip(db.get_user_by_id(ids["user"])),
        "coll": strip(db.get_collection(ids["coll"])),
        "colls": [strip(c) for c in db.list_collections("alice")],
        "doc": strip(db.get_document(ids["doc"])),
        "docs": [strip(d) for d in db.list_documents(ids["coll"])],
        "indexes": [strip(r) for r in db.get_document_indexes(ids["doc"])],
        "pending": [strip(r) for r in db.indexes_needing_reconciliation()],
        "key": strip(db.get_api_key(ids["key"])),
        "dup": strip(db.find_document_by_hash(ids["coll"], "h1")),
        "audit": [strip(r) for r in db.query(
            "SELECT user, path, method, status_code FROM audit_log")],
        "versions": db.query("SELECT version, description FROM schema_version"),
        "tables": db.query("SELECT name, sql FROM sqlite_master ORDER BY name"),
    }


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_database_file_opens_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "super_rag.db")
    ids = fill(DBS[writer](path))
    want = read(DBS[writer](path), ids)
    got = read(DBS[reader](path), ids)
    assert got == want
    assert got["doc"]["metadata"] == {"k": [1, 2]}
    assert got["coll"]["config"]["embedding"] == {"dim": 8}


def test_fresh_schemas_are_identical(tmp_path):
    jdb, tdb = JDatabase(str(tmp_path / "j.db")), TDatabase(str(tmp_path / "t.db"))
    q = "SELECT type, name, sql FROM sqlite_master ORDER BY name"
    assert tdb.query(q) == jdb.query(q)
    assert (tdb.query("SELECT version, description FROM schema_version")
            == jdb.query("SELECT version, description FROM schema_version"))
    assert (tdb.query("SELECT name, base_url, api_type FROM llm_provider ORDER BY name")
            == jdb.query("SELECT name, base_url, api_type FROM llm_provider ORDER BY name"))


def _request(token=None, cookie=None):
    headers = {}
    if token:
        headers["authorization"] = f"Bearer {token}"
    if cookie:
        headers["cookie"] = f"{tauth.COOKIE_NAME}={cookie}"
    return Request(method="GET", path="/", query={}, headers=headers, body=b"")


@pytest.mark.parametrize("signer,verifier", [("jax", "torch"), ("torch", "jax")])
def test_tokens_and_passwords_cross_verify(tmp_path, signer, verifier):
    path = str(tmp_path / "auth.db")
    mods = {"jax": jauth, "torch": tauth}
    sign = mods[signer].Auth(DBS[signer](path), "s3cret", 1)
    user = sign.register("alice", "correct horse")
    _, token = sign.login("alice", "correct horse")
    verify = mods[verifier].Auth(DBS[verifier](path), "s3cret", 1)
    # the password hash stored by one package verifies in the other
    assert verify.login("alice", "correct horse")[0] == user
    assert verify.resolve(_request(token=token)) == user
    assert verify.resolve(_request(cookie=token)) == user
    assert mods[verifier].decode_jwt(token, "s3cret")["sub"] == user["id"]
    assert mods[verifier].decode_jwt(token, "other-secret") is None
    other = mods[verifier].Auth(DBS[verifier](path), "other-secret", 1)
    assert other.resolve(_request(token=token)) is None


def test_jwt_and_password_hash_bytes_match():
    salt = b"0123456789abcdef"
    assert (tauth.hash_password("pw", salt) == jauth.hash_password("pw", salt))
    payload = {"sub": "u1", "username": "a", "role": "user"}
    tok_j = jauth.make_jwt(payload, "k", 60)
    tok_t = tauth.make_jwt(payload, "k", 60)
    # the same header and payload encoding (iat/exp may tick between calls)
    assert tok_j.split(".")[0] == tok_t.split(".")[0]
    assert jauth.decode_jwt(tok_t, "k")["sub"] == tauth.decode_jwt(tok_j, "k")["sub"]


def test_api_keys_resolve_in_the_other_package(tmp_path):
    path = str(tmp_path / "keys.db")
    j = jauth.Auth(JDatabase(path), "s", 1)
    user = j.register("bob", "password1")
    key = j.db.create_api_key(user["id"], "k")["key"]
    t = tauth.Auth(TDatabase(path), "s", 1)
    assert t.resolve(_request(token=key)) == user


# -- parsing and chunking ------------------------------------------------------

MD_CASES = [
    "# T\n\npara one\n  continued  line\n\n## Sub ##\ntext right after\n",
    "Setext\n======\n\nfoo\n---\n\nbar\n",
    "- a\n- b\n  more\n\n1. x\n2) y\n\n* nested\n  - inner\n",
    "> quote\n> line2\n\n    indented code\n\n```py\ncode\n```\n\n~~~\nt\n~~~~\n",
    "| a | b |\n|---|:-:|\n| 1 | 2 |\n| 3 |\n\nafter",
    "***\n\n<div>html</div>\n\ntext ![img](data:image/png;base64,iVBORw0KGgo=) end\n",
    "#no space\n#\n# \n\n  # indented h\n",
    "para\n# heading interrupts\npara2\n- list interrupts\n",
    "```\nunclosed\ncode",
    "foo  \nbar\\\nbaz",
    "1. one\n\n   two para\n3. three\n",
    "a\n\n\n\nb\n- \n-\n",
    "text\n    still para\n",
    "> # h in quote\n> - li\n",
    "a | b\n--|--\nc | d\n",
    "Term\n===\n===\n",
    "- a\n\n  b\n- c\nlazy\n",
    "para\n2. not a list\n",
    "- ```\n  code\n  ```\n- x\n",
    "> a\nlazy\n\n> b\n",
    "  ```\n  x\n    y\n  ```\n",
    "# H1\n\nText under.\n\n### H3 #\n\n1. a\n   1. b\n      - c\n",
    "| x |\n|---|\n| y |\nnext para\n",
    "---\n- - -\n___\n",
    "# 标题\n\n中文段落。第二句！\n\n## Ünïcödé ##\n\ncafé\r\nwindows line\r\n",
    "",
]


def _parts(parts):
    return [(type(p).__name__, p.content, getattr(p, "level", None),
             getattr(p, "language", None), getattr(p, "url", None),
             getattr(p, "asset_id", None)) for p in parts]


@pytest.mark.parametrize("i", range(len(MD_CASES)))
def test_markdown_parts_match(i):
    text = MD_CASES[i]
    assert (_parts(tmd.MarkdownParser().parse_text(text))
            == _parts(jmd.MarkdownParser().parse_text(text)))


# the repo's markdown files that predate the port and stay as they are
# (the working documents change with every change of the port)
STATIC_MD = ["ADVICE.md", "BASELINE.md", "PAPER.md", "PAPERS.md", "PARITY.md",
             "SNIPPETS.md", "SURVEY.md", "VERDICT.md", "demo/sample.md",
             "docs/design/kernels.md", "docs/design/kg.md", "docs/design/ocr.md",
             "docs/design/semantic.md"]
# a block quote that opens inside a list item, with lazy lines
QUOTE_IN_LIST = "- item text\n  >quoted start\n  lazy line one\n  lazy line two\n"


def test_quote_in_list_differs_only_in_whitespace():
    """markdown-it keeps the indentation of such a quote's lazy lines; the
    port's parser drops it (ROADMAP section C)."""
    got = _parts(tmd.MarkdownParser().parse_text(QUOTE_IN_LIST))
    want = _parts(jmd.MarkdownParser().parse_text(QUOTE_IN_LIST))
    assert got != want
    assert ([(k, " ".join(c.split()), *r) for k, c, *r in got]
            == [(k, " ".join(c.split()), *r) for k, c, *r in want])


def test_repo_markdown_files_parse_alike():
    """The repo's static markdown files: the same Parts."""
    for name in STATIC_MD:
        with open(os.path.join(ROOT, name), encoding="utf-8", errors="replace") as fh:
            text = fh.read()
        assert (_parts(tmd.MarkdownParser().parse_text(text))
                == _parts(jmd.MarkdownParser().parse_text(text))), name


@pytest.mark.parametrize("name", ["a.md", "b.markdown", "c.txt", "d.log", "e.html",
                                  "f.json", "g.unknownext"])
def test_docparser_matches(name):
    data = ("<html><style>x{}</style><b>Title</b> body text</html>" if name.endswith("html")
            else "# Head\n\nbody line one\nline two\n\n- item\n").encode()
    assert (_parts(TDocParser().parse_file(name, data))
            == _parts(JDocParser().parse_file(name, data)))


@pytest.mark.parametrize("name", ["scan.pdf", "a.docx", "b.xlsx", "c.pptx", "d.doc",
                                  "e.ppt", "f.png", "g.JPG"])
def test_docparser_formats_match_the_reference(name, monkeypatch):
    """Every format of the JAX package's built-in chain: bytes that none of
    the parsers reads give the same parts, or the same error, in both
    (its OCR finds no text in these bytes)."""
    from super_rag_tpu.fileparser import ocr as jocr

    monkeypatch.setattr(jocr, "default_ocr", lambda: None)
    data = b"%PDF-1.4 binary \x00\x01"
    try:
        want = _parts(JDocParser().parse_file(name, data))
    except Exception as e:  # noqa: BLE001 — the port must raise alike
        with pytest.raises(type(e)) as got:
            TDocParser().parse_file(name, data)
        assert str(got.value) == str(e)
        return
    assert _parts(TDocParser().parse_file(name, data)) == want


CHUNK_TEXTS = [
    MD_CASES[0], MD_CASES[2], MD_CASES[21],
    "# Big\n\n" + "\n\n".join(" ".join(f"word{i}_{j}" for j in range(60)) + "."
                              for i in range(30)),
    "# 中文\n\n" + "。".join("这是一个很长的句子用于测试分块" for _ in range(200)),
    "## A\n\n## B\n\n### C\n\ntext c\n\n## D\n",
    "plain " * 2000,
]


@pytest.mark.parametrize("size,overlap", [(400, 20), (64, 8), (32, 0)])
@pytest.mark.parametrize("i", range(len(CHUNK_TEXTS)))
def test_rechunker_matches(i, size, overlap):
    text = CHUNK_TEXTS[i]
    jparts = jmd.MarkdownParser().parse_text(text)
    tparts = tmd.MarkdownParser().parse_text(text)
    want = jchunk.Rechunker(size, overlap).rechunk(jparts, {"document_id": "d"})
    got = tchunk.Rechunker(size, overlap).rechunk(tparts, {"document_id": "d"})
    assert ([(c.text, c.title_path, c.metadata, c.padded_text) for c in got]
            == [(c.text, c.title_path, c.metadata, c.padded_text) for c in want])
    assert tchunk.rechunk(tparts, size, overlap) is not None
    for c in got:
        assert (tchunk.approx_token_count(c.text)
                == jchunk.approx_token_count(c.text))


# -- status model and reconciliation ---------------------------------------------

@pytest.mark.parametrize("statuses", [[], ["ACTIVE"], ["ACTIVE", "FAILED"],
                                      ["PENDING", "ACTIVE"], ["CREATING"],
                                      ["DELETION_IN_PROGRESS", "ACTIVE"], ["DELETED"]])
def test_derive_document_status_matches(statuses):
    assert (tmodels.derive_document_status(statuses)
            == jmodels.derive_document_status(statuses))


class _Recorder:
    def __init__(self):
        self.calls = []

    def schedule_create_index(self, index_id, document_id, index_type, version):
        self.calls.append(("create", index_type, version))

    def schedule_delete_index(self, index_id, document_id, index_type):
        self.calls.append(("delete", index_type))


def _reconcile(db_cls, rec_cls, path):
    db = db_cls(path)
    c = db.create_collection("kb", "alice")
    docs = [db.create_document(c["id"], f"d{i}.md", content_hash=f"h{i}")
            for i in range(3)]
    for d in docs:
        db.upsert_document_index(d["id"], "vector")
    sched = _Recorder()
    rec = rec_cls(db, sched)
    first = rec.reconcile_all()
    again = rec.reconcile_all()  # claimed rows are not scheduled twice
    ix = db.get_document_indexes(docs[0]["id"])[0]
    rec.callbacks.on_index_created(ix["id"], ix["version"], {"rows": [0, 1]})
    ix1 = db.get_document_indexes(docs[1]["id"])[0]
    rec.callbacks.on_index_failed(ix1["id"], ix1["version"], "boom")
    rec.callbacks.on_index_created(ix1["id"], ix1["version"] - 1, {"rows": [5]})  # stale
    db.mark_indexes_deleting(docs[0]["id"])
    third = rec.reconcile_all()
    statuses = [(db.get_document(d["id"])["status"],
                 [(r["status"], r["version"], r["observed_version"], r["error_message"])
                  for r in db.get_document_indexes(d["id"])]) for d in docs]
    return first, again, third, sched.calls, statuses


def test_reconciler_state_machine_matches(tmp_path):
    assert (_reconcile(TDatabase, TReconciler, str(tmp_path / "t.db"))
            == _reconcile(JDatabase, JReconciler, str(tmp_path / "j.db")))
