"""Object store for original documents and index snapshots (port of the
JAX package's store/objectstore.py).

The contract of the reference's ObjectStore (put / get / obj_size /
exists / stream_range / delete / delete_prefix, and a factory by type)
with a local filesystem backend and an S3 backend: an AWS Signature-V4
client over the standard library's ``http.client`` (the JAX package
speaks it through httpx), path-style addressing so MinIO-style endpoints
work unchanged, ranged streaming GETs and ListObjectsV2 paging.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import os
import posixpath
import re
import shutil
import xml.etree.ElementTree as ET
from typing import BinaryIO, Iterator, Optional
from urllib.parse import quote, unquote, urlsplit


_UPLOAD_ID = re.compile(r"[0-9a-f]{32}")


def is_upload_id(upload_id: str) -> bool:
    """Whether ``upload_id`` has the form the two-phase upload hands out
    (``uuid4().hex``), so it can stand as one segment of a staged key."""
    return isinstance(upload_id, str) and _UPLOAD_ID.fullmatch(upload_id) is not None


def safe_object_name(name: str, nested: bool = False) -> bool:
    """Whether a client-supplied document name may end an object key.

    A flat name (a staged file) is one segment: no ``/``, ``\\`` or NUL,
    and not ``.`` or ``..``.  A nested name (a document, which may be an
    archive member with its folders) may hold ``/``, but must not be
    absolute or climb out of the document's own directory with ``..``.
    """
    if not isinstance(name, str) or not name or "\x00" in name:
        return False
    if not nested:
        return "/" not in name and "\\" not in name and name not in (".", "..")
    norm = posixpath.normpath(name)
    return not (norm.startswith("..") or norm.startswith("/") or norm == ".")


class ObjectStore:
    def wire_config(self) -> Optional[dict]:
        """kwargs for :func:`get_object_store` that rebuild this store in
        another process; None when it cannot be rebuilt."""
        return None

    def put(self, path: str, data: bytes | BinaryIO) -> None:
        raise NotImplementedError

    def get(self, path: str) -> bytes:
        raise NotImplementedError

    def obj_size(self, path: str) -> int:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def stream_range(self, path: str, start: int = 0,
                     end: Optional[int] = None,
                     chunk_size: int = 1 << 20) -> Iterator[bytes]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError


class LocalObjectStore(ObjectStore):
    """Objects as files under ``root``; a key that would resolve outside
    ``root`` is refused."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def wire_config(self) -> Optional[dict]:
        return {"store_type": "local", "root": self.root}

    def _fs(self, path: str) -> str:
        full = os.path.abspath(os.path.join(self.root, path.lstrip("/")))
        if not full.startswith(self.root + os.sep) and full != self.root:
            raise ValueError(f"path escapes object store root: {path}")
        return full

    def put(self, path: str, data: bytes | BinaryIO) -> None:
        full = self._fs(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = full + ".tmp"
        with open(tmp, "wb") as f:
            if isinstance(data, bytes):
                f.write(data)
            else:
                shutil.copyfileobj(data, f)
        os.replace(tmp, full)

    def get(self, path: str) -> bytes:
        with open(self._fs(path), "rb") as f:
            return f.read()

    def obj_size(self, path: str) -> int:
        return os.path.getsize(self._fs(path))

    def exists(self, path: str) -> bool:
        return os.path.isfile(self._fs(path))

    def stream_range(self, path: str, start: int = 0,
                     end: Optional[int] = None,
                     chunk_size: int = 1 << 20) -> Iterator[bytes]:
        size = self.obj_size(path)
        stop = size if end is None else min(end, size)
        with open(self._fs(path), "rb") as f:
            f.seek(start)
            remaining = stop - start
            while remaining > 0:
                block = f.read(min(chunk_size, remaining))
                if not block:
                    break
                remaining -= len(block)
                yield block

    def delete(self, path: str) -> None:
        full = self._fs(path)
        if os.path.isfile(full):
            os.remove(full)

    def delete_prefix(self, prefix: str) -> None:
        full = self._fs(prefix)
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)


# -- AWS Signature V4 (the S3 auth scheme) -----------------------------------


def _uri_encode(s: str, is_key: bool = False) -> str:
    # AWS canonical encoding: unreserved chars only; '/' kept in keys
    return quote(s, safe="/-_.~" if is_key else "-_.~")


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    url: str,
    *,
    region: str,
    access_key: str,
    secret_key: str,
    payload_hash: str,
    amz_date: Optional[str] = None,
    service: str = "s3",
    extra_headers: Optional[dict] = None,
) -> dict:
    """The SigV4 ``Authorization`` (+ x-amz-*) headers: the canonical
    request, string to sign and derived key of the AWS SigV4 spec."""
    if amz_date is None:
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ"
        )
    date = amz_date[:8]
    parts = urlsplit(url)
    host = parts.netloc

    headers = {"host": host, "x-amz-date": amz_date}
    if service == "s3":
        headers["x-amz-content-sha256"] = payload_hash
    for k, v in (extra_headers or {}).items():
        headers[k.lower()] = v
    signed_names = sorted(headers)
    canonical_headers = "".join(
        f"{k}:{' '.join(str(headers[k]).split())}\n" for k in signed_names
    )
    signed_headers = ";".join(signed_names)

    # canonical query: decode each name/value, re-encode exactly once,
    # sort by (key, value); the caller's query arrives percent-encoded
    q_pairs = []
    if parts.query:
        for pair in parts.query.split("&"):
            k, _, v = pair.partition("=")
            q_pairs.append((_uri_encode(unquote(k)), _uri_encode(unquote(v))))
    canonical_query = "&".join(f"{k}={v}" for k, v in sorted(q_pairs))

    # canonical URI: S3 signs the (single-encoded) path verbatim; every
    # other service encodes the path segments a second time
    if service == "s3":
        canonical_path = parts.path or "/"
    else:
        canonical_path = "/".join(
            _uri_encode(seg) for seg in (parts.path or "/").split("/")
        ) or "/"
    canonical_request = "\n".join([
        method.upper(),
        canonical_path,
        canonical_query,
        canonical_headers,
        signed_headers,
        payload_hash,
    ])
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256",
        amz_date,
        scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    k_date = _hmac(("AWS4" + secret_key).encode(), date)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    out = {k: v for k, v in headers.items() if k != "host"}
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return out


class S3Error(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"S3 error {status}: {body[:300]}")
        self.status = status


class _Reply:
    """One S3 answer: status, lower-cased headers and, unless streamed,
    the body; a streamed reply keeps its connection until closed."""

    def __init__(self, conn, resp, stream: bool):
        self.status_code = resp.status
        self.headers = {k.lower(): v for k, v in resp.getheaders()}
        self._conn = conn
        self._resp = resp
        self.content = b""
        if not stream:
            self.content = resp.read()
            conn.close()

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def iter_bytes(self, chunk_size: int) -> Iterator[bytes]:
        while True:
            block = self._resp.read(chunk_size)
            if not block:
                return
            yield block

    def read(self) -> None:
        self.content = self._resp.read()

    def close(self) -> None:
        self._conn.close()


class S3ObjectStore(ObjectStore):
    """SigV4 S3 client over ``http.client``, path-style addressing, one
    connection per request (safe from any thread)."""

    def __init__(self, bucket: str, endpoint_url: Optional[str] = None,
                 region: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 timeout: float = 30.0):
        self.bucket = bucket
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        self.access_key = access_key or os.environ.get(
            "AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.endpoint = (endpoint_url
                         or f"https://s3.{self.region}.amazonaws.com"
                         ).rstrip("/")
        self.timeout = timeout

    def wire_config(self) -> Optional[dict]:
        return {"store_type": "s3", "bucket": self.bucket,
                "endpoint_url": self.endpoint, "region": self.region,
                "access_key": self.access_key,
                "secret_key": self.secret_key}

    def _url(self, key: str, query: str = "") -> str:
        path = f"/{self.bucket}/" + _uri_encode(key.lstrip("/"), is_key=True)
        return self.endpoint + path + (f"?{query}" if query else "")

    def _request(self, method: str, key: str, query: str = "",
                 body: bytes = b"", stream: bool = False,
                 extra_headers: Optional[dict] = None) -> _Reply:
        url = self._url(key, query)
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = sigv4_headers(
            method, url, region=self.region, access_key=self.access_key,
            secret_key=self.secret_key, payload_hash=payload_hash,
            extra_headers=extra_headers,
        )
        parts = urlsplit(url)
        headers["Host"] = parts.netloc
        cls = (http.client.HTTPSConnection if parts.scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(parts.netloc, timeout=self.timeout)
        target = parts.path + (f"?{parts.query}" if parts.query else "")
        send = body if (body or method in ("PUT", "POST")) else None
        try:
            conn.request(method, target, body=send, headers=headers)
            resp = conn.getresponse()
            return _Reply(conn, resp, stream and method != "HEAD")
        except BaseException:
            conn.close()
            raise

    def put(self, path: str, data: bytes | BinaryIO) -> None:
        body = data if isinstance(data, bytes) else data.read()
        r = self._request("PUT", path, body=body)
        if r.status_code >= 300:
            raise S3Error(r.status_code, r.text)

    def get(self, path: str) -> bytes:
        r = self._request("GET", path)
        if r.status_code == 404:
            raise FileNotFoundError(path)
        if r.status_code >= 300:
            raise S3Error(r.status_code, r.text)
        return r.content

    def obj_size(self, path: str) -> int:
        r = self._request("HEAD", path)
        if r.status_code == 404:
            raise FileNotFoundError(path)
        if r.status_code >= 300:
            raise S3Error(r.status_code, r.text)
        return int(r.headers.get("content-length", "0"))

    def exists(self, path: str) -> bool:
        return self._request("HEAD", path).status_code == 200

    def stream_range(self, path: str, start: int = 0,
                     end: Optional[int] = None,
                     chunk_size: int = 1 << 20) -> Iterator[bytes]:
        rng = f"bytes={start}-" + ("" if end is None else str(end - 1))
        r = self._request("GET", path, stream=True,
                          extra_headers={"range": rng})
        if r.status_code >= 300:
            r.read()
            r.close()
            if r.status_code == 404:
                raise FileNotFoundError(path)
            raise S3Error(r.status_code, r.text)
        try:
            yield from r.iter_bytes(chunk_size)
        finally:
            r.close()

    def delete(self, path: str) -> None:
        r = self._request("DELETE", path)
        if r.status_code >= 300 and r.status_code != 404:
            raise S3Error(r.status_code, r.text)

    def list(self, prefix: str = "") -> list[str]:
        """All keys under ``prefix`` (ListObjectsV2, paged)."""
        keys: list[str] = []
        token = ""
        while True:
            query = ("list-type=2&prefix="
                     + _uri_encode(prefix.lstrip("/")))
            if token:
                query += "&continuation-token=" + _uri_encode(token)
            r = self._request("GET", "", query=query)
            if r.status_code >= 300:
                raise S3Error(r.status_code, r.text)
            root = ET.fromstring(r.text)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for c in root.findall(f"{ns}Contents"):
                k = c.find(f"{ns}Key")
                if k is not None and k.text:
                    keys.append(k.text)
            nxt = root.find(f"{ns}NextContinuationToken")
            if nxt is None or not nxt.text:
                return keys
            token = nxt.text

    def delete_prefix(self, prefix: str) -> None:
        for key in self.list(prefix):
            self.delete(key)


def get_object_store(store_type: str = "local", **kwargs) -> ObjectStore:
    if store_type == "local":
        return LocalObjectStore(kwargs.get("root", "./data/objects"))
    if store_type == "s3":
        kwargs.pop("root", None)  # local-only argument
        return S3ObjectStore(**kwargs)
    raise ValueError(f"unknown object store type: {store_type}")
