"""The port's S3 object store (``store/objectstore.py``) against the JAX
package's, over a fake S3 served in this process on a socket.

The signer is held against the AWS SigV4 test-suite vectors and against
the JAX package's ``sigv4_headers`` on the same inputs; the fake server
recomputes every request's signature with the JAX signer from what it
received, so a request the port signs differently is refused.
"""

import hashlib
import http.server
import io
import threading
from urllib.parse import parse_qs, quote, unquote, urlsplit

import numpy as np
import pytest

from super_rag_tpu.engine import snapshot as jsnap
from super_rag_tpu.engine.index import DeviceIndex as JDeviceIndex
from super_rag_tpu.engine.index import IndexSpec as JIndexSpec
from super_rag_tpu.store.objectstore import S3ObjectStore as JS3ObjectStore
from super_rag_tpu.store.objectstore import sigv4_headers as jsigv4
from super_rag_tpu_torch.engine import snapshot as tsnap
from super_rag_tpu_torch.store import sources as tsources
from super_rag_tpu_torch.store.objectstore import (
    S3Error,
    S3ObjectStore,
    get_object_store,
    sigv4_headers,
)

EMPTY_SHA = hashlib.sha256(b"").hexdigest()
AWS = dict(region="us-east-1", service="service", access_key="AKIDEXAMPLE",
           secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
           payload_hash=EMPTY_SHA, amz_date="20150830T123600Z")


def test_sigv4_aws_test_suite_vectors():
    h = sigv4_headers("GET", "https://example.amazonaws.com/", **AWS)
    assert h["Authorization"] == (
        "AWS4-HMAC-SHA256 "
        "Credential=AKIDEXAMPLE/20150830/us-east-1/service/aws4_request, "
        "SignedHeaders=host;x-amz-date, "
        "Signature=5fa00fa31553b73ebf1942676e86291e8372ff2a2260956d9b8aae1d"
        "763fbf31")
    h = sigv4_headers("GET", "https://example.amazonaws.com/?Param2=value2&Param1=value1",
                      **AWS)
    assert h["Authorization"].endswith(
        "Signature=b97d918cfa904a5beff61c982a1b6f458b799221646efd99d3219ec94"
        "cdf2500")


@pytest.mark.parametrize("method,url,service,extra", [
    ("GET", "https://example.amazonaws.com/", "service", None),
    ("GET", "https://example.amazonaws.com/?Param2=value2&Param1=value1", "service", None),
    ("PUT", "http://127.0.0.1:9000/b/a%20b/c%2Bd.txt", "s3", None),
    ("GET", "http://127.0.0.1:9000/b/k", "s3", {"range": "bytes=5-9"}),
    ("GET", "http://127.0.0.1:9000/b/?list-type=2&prefix=a%2Fb&continuation-token=t%3D1",
     "s3", None),
    ("POST", "https://bedrock.us-east-1.amazonaws.com/model/a:b/invoke", "bedrock",
     {"content-type": "application/json"}),
    ("HEAD", "https://s3.us-east-1.amazonaws.com/bucket/%E4%B8%AD.md", "s3", None),
])
def test_sigv4_equals_the_reference(method, url, service, extra):
    kw = dict(region="eu-west-2", access_key="AK", secret_key="SK/+x",
              payload_hash=hashlib.sha256(b"body").hexdigest(),
              amz_date="20260101T000000Z", service=service, extra_headers=extra)
    assert sigv4_headers(method, url, **kw) == jsigv4(method, url, **kw)


class FakeS3(http.server.BaseHTTPRequestHandler):
    """Path-style S3: PUT / GET (ranged) / HEAD / DELETE and
    ListObjectsV2 in pages of ``page`` keys.  Every request's signature
    is recomputed with the JAX package's signer and must match."""

    objects: dict = {}
    page = 3
    requests: list = []
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _reply(self, status, body=b"", headers=None):
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _handle(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        auth = self.headers.get("Authorization", "")
        signed = auth.split("SignedHeaders=")[1].split(",")[0].split(";")
        extra = {k: self.headers[k] for k in signed
                 if k not in ("host", "x-amz-date", "x-amz-content-sha256")}
        url = f"http://{self.headers['Host']}{self.path}"
        want = jsigv4(self.command, url, region="r1", access_key="AK", secret_key="SK",
                      payload_hash=self.headers["x-amz-content-sha256"],
                      amz_date=self.headers["x-amz-date"], extra_headers=extra)
        if want["Authorization"] != auth or \
                hashlib.sha256(body).hexdigest() != self.headers["x-amz-content-sha256"]:
            return self._reply(403, b"<Error>SignatureDoesNotMatch</Error>")
        parts = urlsplit(self.path)
        self.requests.append((self.command, parts.path, parts.query))
        bucket, _, key = parts.path.lstrip("/").partition("/")
        key = unquote(key)
        if bucket != "bkt":
            return self._reply(404, b"<Error>NoSuchBucket</Error>")
        q = parse_qs(parts.query)
        if self.command == "GET" and "list-type" in q:
            prefix = q.get("prefix", [""])[0]
            keys = sorted(k for k in self.objects if k.startswith(prefix))
            start = int(q.get("continuation-token", ["0"])[0])
            page = keys[start:start + self.page]
            more = start + self.page < len(keys)
            xml = ("<?xml version='1.0'?><ListBucketResult "
                   "xmlns='http://s3.amazonaws.com/doc/2006-03-01/'>"
                   + "".join(f"<Contents><Key>{k}</Key></Contents>" for k in page)
                   + (f"<NextContinuationToken>{start + self.page}"
                      "</NextContinuationToken>" if more else "")
                   + "</ListBucketResult>")
            return self._reply(200, xml.encode())
        if self.command == "PUT":
            self.objects[key] = body
            return self._reply(200)
        if self.command == "DELETE":
            self.objects.pop(key, None)
            return self._reply(204)
        if key not in self.objects:
            return self._reply(404, b"<Error>NoSuchKey</Error>")
        data = self.objects[key]
        if self.command == "HEAD":
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            return None
        rng = self.headers.get("Range")
        if rng:
            s, _, e = rng.split("=", 1)[1].partition("-")
            stop = min(int(e) + 1, len(data)) if e else len(data)
            return self._reply(206, data[int(s):stop],
                               {"Content-Range": f"bytes {s}-{stop - 1}/{len(data)}"})
        return self._reply(200, data)

    do_GET = do_PUT = do_HEAD = do_DELETE = _handle


@pytest.fixture
def server():
    FakeS3.objects = {}
    FakeS3.requests = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), FakeS3)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _stores(endpoint):
    kw = dict(endpoint_url=endpoint, region="r1", access_key="AK", secret_key="SK")
    return S3ObjectStore("bkt", **kw), JS3ObjectStore("bkt", **kw)


def test_put_get_size_exists_delete(server):
    port, ref = _stores(server)
    for store in (port, ref):
        store.put("docs/a b+c.md", b"hello world")
        store.put("docs/f.bin", io.BytesIO(bytes(range(256)) * 10))
    assert FakeS3.requests[0][:2] == FakeS3.requests[2][:2]  # same wire path
    assert port.get("docs/a b+c.md") == ref.get("docs/a b+c.md") == b"hello world"
    assert port.obj_size("docs/f.bin") == ref.obj_size("docs/f.bin") == 2560
    assert port.exists("docs/f.bin") and not port.exists("docs/none")
    with pytest.raises(FileNotFoundError):
        port.get("docs/none")
    with pytest.raises(FileNotFoundError):
        port.obj_size("docs/none")
    port.delete("docs/a b+c.md")
    port.delete("docs/none")  # deleting a missing key is no error
    assert not ref.exists("docs/a b+c.md")


def test_stream_range(server):
    port, ref = _stores(server)
    data = bytes(range(256)) * 40
    port.put("big.bin", data)
    for start, end, chunk in ((0, None, 1 << 20), (10, 100, 7), (5000, 10240, 4096),
                              (10239, None, 3)):
        got = b"".join(port.stream_range("big.bin", start, end, chunk))
        want = b"".join(ref.stream_range("big.bin", start, end, chunk))
        assert got == want == data[start:end]
    with pytest.raises(FileNotFoundError):
        list(port.stream_range("nope.bin"))


def test_list_pages_and_delete_prefix(server):
    port, ref = _stores(server)
    for i in range(8):
        port.put(f"p/{i:02d}.txt", b"x")
    port.put("q/keep.txt", b"y")
    assert port.list("p/") == ref.list("p/") == [f"p/{i:02d}.txt" for i in range(8)]
    assert sum(1 for r in FakeS3.requests if "list-type" in r[2]) >= 6  # paged
    port.delete_prefix("p/")
    assert port.list("") == ref.list("") == ["q/keep.txt"]


def test_errors_and_wire_config(server):
    bad = S3ObjectStore("bkt", endpoint_url=server, region="r1", access_key="AK",
                        secret_key="WRONG")
    with pytest.raises(S3Error) as e:
        bad.put("k", b"v")
    assert e.value.status == 403
    port, _ = _stores(server)
    other = get_object_store(**port.wire_config())
    assert isinstance(other, S3ObjectStore) and other.wire_config() == port.wire_config()
    port.put("w.txt", b"wire")
    assert other.get("w.txt") == b"wire"
    missing = S3ObjectStore("nobucket", endpoint_url=server, region="r1",
                            access_key="AK", secret_key="SK")
    with pytest.raises(S3Error):
        missing.put("k", b"v")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_saved_by_one_package_loads_in_the_other(server, writer):
    port, ref = _stores(server)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((5, 16)).astype(np.float32)
    texts = [f"doc {w} text" for w in ("alpha", "beta", "gamma", "delta", "eps")]
    if writer == "jax":
        idx = JDeviceIndex(JIndexSpec(dim=16, vocab_size=1 << 12))
        idx.add(emb, texts, metadata=[{"i": i} for i in range(5)])
        jsnap.save_index_to_store(idx, ref, "snapshots/c1")
        assert tsnap.store_snapshot_exists(port, "snapshots/c1")
        restored = tsnap.load_index_from_store(port, "snapshots/c1", device="cpu")
        assert restored.size == 5 and restored.row_meta[1]["text"] == texts[1]
        import torch

        v, i = restored.search_dense(torch.from_numpy(emb[2:3]), 1, None)
        assert int(i[0, 0]) == 2
    else:
        from super_rag_tpu_torch.engine.index import DeviceIndex, IndexSpec

        idx = DeviceIndex(IndexSpec(dim=16, vocab_size=1 << 12), device="cpu")
        idx.add(emb, texts, metadata=[{"i": i} for i in range(5)])
        tsnap.save_index_to_store(idx, port, "snapshots/c1")
        assert jsnap.store_snapshot_exists(ref, "snapshots/c1")
        restored = jsnap.load_index_from_store(ref, "snapshots/c1")
        assert restored.size == 5 and restored.row_meta[3]["text"] == texts[3]
        v, i = restored.search_dense(emb[4:5], k=1, flt=None)
        assert int(np.asarray(i)[0, 0]) == 4


def test_sources(server, tmp_path):
    port, _ = _stores(server)
    for k in ("in/a.md", "in/b.txt", "out/c.md"):
        port.put(k, k.encode())
    src = tsources.get_source("s3", bucket="bkt", prefix="in/", endpoint_url=server,
                              region="r1", access_key="AK", secret_key="SK")
    docs = list(src.scan())
    assert [(d.name, d.size) for d in docs] == [("in/a.md", 7), ("in/b.txt", 8)]
    assert docs[1].read(src) == b"in/b.txt"
    (tmp_path / "d" / "sub").mkdir(parents=True)
    (tmp_path / "d" / "x.md").write_bytes(b"xx")
    (tmp_path / "d" / "sub" / "y.pdf").write_bytes(b"yyy")
    local = tsources.get_source("local", root=str(tmp_path / "d"), extensions={".md"})
    assert [(d.name, d.read(local)) for d in local.scan()] == [("x.md", b"xx")]
    with pytest.raises(ValueError, match="escapes"):
        local.fetch(str(tmp_path / "outside.md"))
    up = tsources.get_source("upload", objects=port, prefix="in/")
    assert list(up.scan()) == [] and up.fetch("in/a.md") == b"in/a.md"
    with pytest.raises(ValueError, match="unknown"):
        tsources.get_source("ftp")
    assert quote("a b") == "a%20b"
