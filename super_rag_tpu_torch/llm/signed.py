"""Signed-auth model providers: AWS Bedrock (SigV4) and GCP Vertex AI
(OAuth2 service-account JWT) (port of the JAX package's llm/signed.py).

The reference reaches these through LiteLLM's provider registry
(super_rag/llm/embed/embedding_service.py:168-175 routes "bedrock/..."
and "vertex_ai/..." model prefixes); here each is one client class in
the same DIALECTS registry as openai/anthropic/dashscope/gemini
(llm/client.py).  The SigV4 signer is shared with the S3 object store
(store/objectstore.py sigv4_headers).  Vertex's RS256 service-account
assertion is signed with the standard library alone (the JAX package
uses ``cryptography``): the PEM's DER is parsed for the RSA key, the
EMSA-PKCS1-v1_5 SHA-256 encoding is built, and the signature is
``pow(m, d, n)``; PKCS#1 v1.5 is deterministic, so the bytes are the
ones ``cryptography`` gives.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import time
from typing import Optional, Sequence
from urllib.parse import quote, urlencode, urlsplit

from super_rag_tpu_torch.llm.client import (
    OpenAICompatClient,
    ResponseCache,
    checked_json,
)
from super_rag_tpu_torch.llm.errors import BadRequestError
from super_rag_tpu_torch.store.objectstore import sigv4_headers


class BedrockClient(OpenAICompatClient):
    """AWS Bedrock runtime dialect (SigV4-signed ``InvokeModel``).

    Credentials ride in ``api_key`` as ``"ACCESS_KEY:SECRET_KEY"``; the
    region is parsed from the endpoint host
    (``bedrock-runtime.us-east-1.amazonaws.com``) or passed explicitly.
    Model families: ``anthropic.*`` messages for completion,
    ``amazon.titan-embed*`` / ``cohere.embed*`` for embeddings.
    """

    ANTHROPIC_VERSION = "bedrock-2023-05-31"
    DEFAULT_MAX_TOKENS = 1024

    def __init__(self, base_url: str, api_key: str = "",
                 region: Optional[str] = None, **kw):
        kw.setdefault("provider", "bedrock")
        super().__init__(base_url, api_key, **kw)
        host = urlsplit(self.base_url).netloc
        m = re.search(r"\.([a-z0-9-]+)\.amazonaws\.com", host)
        self.region = region or (m.group(1) if m else "us-east-1")
        self.access_key, _, self.secret_key = (api_key or "").partition(":")

    def _post(self, path: str, payload: dict) -> dict:
        """SigV4-signed POST with the base client's retry/error policy."""
        body = json.dumps(payload).encode()
        url = f"{self.base_url}{path}"

        def attempt():
            headers = sigv4_headers(
                "POST", url,
                region=self.region,
                access_key=self.access_key,
                secret_key=self.secret_key,
                payload_hash=hashlib.sha256(body).hexdigest(),
                service="bedrock",
                extra_headers={"content-type": "application/json"},
            )
            return checked_json(*self._transport.request(
                "POST", url, body, headers), url)

        return self._retrying(attempt)

    @staticmethod
    def _invoke_path(model: str) -> str:
        # bedrock model ids contain ':' (…-v1:0) — single-encoded on the
        # wire; the signer double-encodes it in the canonical request
        return f"/model/{quote(model, safe='')}/invoke"

    def complete(self, prompt: Optional[str] = None,
                 messages: Optional[list[dict]] = None,
                 temperature: float = 0.1, max_tokens: Optional[int] = None,
                 model: Optional[str] = None, use_cache: bool = True) -> str:
        mdl = model or self.model
        msgs = messages or [{"role": "user", "content": prompt or ""}]
        if mdl.startswith("anthropic."):
            system = "\n".join(m.get("content", "") for m in msgs
                               if m.get("role") == "system")
            payload: dict = {
                "anthropic_version": self.ANTHROPIC_VERSION,
                "max_tokens": max_tokens or self.DEFAULT_MAX_TOKENS,
                "messages": [m for m in msgs if m.get("role") != "system"],
                "temperature": temperature,
            }
            if system:
                payload["system"] = system
        else:  # amazon.titan-text dialect
            text = "\n".join(m.get("content", "") for m in msgs)
            payload = {
                "inputText": text,
                "textGenerationConfig": {
                    "temperature": temperature,
                    **({"maxTokenCount": max_tokens} if max_tokens else {}),
                },
            }
        ck = None
        if self.cache and use_cache and temperature == 0.0:
            ck = ResponseCache.key("completion", {"m": mdl, **payload})
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post(self._invoke_path(mdl), payload)
        if mdl.startswith("anthropic."):
            text_out = "".join(b.get("text", "")
                               for b in data.get("content", [])
                               if b.get("type") == "text")
        else:
            text_out = "".join(r.get("outputText", "")
                               for r in data.get("results", []))
        if ck is not None:
            self.cache.put(ck, text_out)
        return text_out

    def embed(self, texts: Sequence[str], model: Optional[str] = None,
              use_cache: bool = True) -> list[list[float]]:
        mdl = model or self.model
        ck = None
        if self.cache and use_cache:
            ck = ResponseCache.key("embedding", {"m": mdl,
                                                 "t": list(texts)})
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        if mdl.startswith("cohere."):
            data = self._post(self._invoke_path(mdl), {
                "texts": list(texts), "input_type": "search_document",
            })
            out = [list(map(float, e)) for e in data.get("embeddings", [])]
        else:  # amazon.titan-embed dialect: one text per invocation
            out = []
            for t in texts:
                data = self._post(self._invoke_path(mdl), {"inputText": t})
                out.append(list(map(float, data.get("embedding", []))))
        if ck is not None:
            self.cache.put(ck, out)
        return out

    def rerank(self, query: str, documents: Sequence[str],
               top_n: Optional[int] = None,
               model: Optional[str] = None) -> list[dict]:
        raise BadRequestError(
            "the bedrock dialect serves no rerank API", self.provider
        )


# -- RS256 over the standard library --------------------------------------------------

# DER DigestInfo prefix of SHA-256 (RFC 8017 section 9.2, note 1)
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_RSA_ENCRYPTION_OID = bytes.fromhex("2a864886f70d010101")  # 1.2.840.113549.1.1.1


def _der_read(data: bytes, pos: int) -> tuple[int, bytes, int]:
    """One DER TLV at ``pos``: (tag, value, position after it)."""
    tag = data[pos]
    length = data[pos + 1]
    pos += 2
    if length & 0x80:
        n = length & 0x7F
        if not 1 <= n <= 4:
            raise ValueError("unsupported DER length")
        length = int.from_bytes(data[pos:pos + n], "big")
        pos += n
    end = pos + length
    if end > len(data):
        raise ValueError("truncated DER")
    return tag, data[pos:end], end


def _der_items(body: bytes) -> list[tuple[int, bytes]]:
    """The (tag, value) elements of a DER SEQUENCE's body."""
    out, pos = [], 0
    while pos < len(body):
        tag, value, pos = _der_read(body, pos)
        out.append((tag, value))
    return out


def _der_sequence(data: bytes) -> list[tuple[int, bytes]]:
    """The elements of the DER SEQUENCE that ``data`` starts with."""
    tag, body, _ = _der_read(data, 0)
    if tag != 0x30:
        raise ValueError("expected a DER SEQUENCE")
    return _der_items(body)


def rsa_private_key(pem: str) -> tuple[int, int]:
    """(n, d) of an unencrypted RSA private key in PEM: PKCS#8
    (``BEGIN PRIVATE KEY``, as service-account files hold) or PKCS#1
    (``BEGIN RSA PRIVATE KEY``)."""
    m = re.search(r"-----BEGIN ((?:RSA )?PRIVATE KEY)-----(.*?)-----END \1-----",
                  pem, re.S)
    if m is None:
        raise ValueError("no unencrypted RSA private key in the PEM")
    der = base64.b64decode("".join(m.group(2).split()))
    if m.group(1) == "PRIVATE KEY":  # PKCS#8 PrivateKeyInfo
        items = _der_sequence(der)
        algorithm = _der_items(items[1][1])
        if algorithm[0] != (0x06, _RSA_ENCRYPTION_OID) or items[2][0] != 0x04:
            raise ValueError("not an RSA PKCS#8 key")
        der = items[2][1]
    fields = _der_sequence(der)  # RSAPrivateKey: version, n, e, d, p, q, ...
    if len(fields) < 4 or any(tag != 0x02 for tag, _ in fields[:4]):
        raise ValueError("malformed RSAPrivateKey")
    n = int.from_bytes(fields[1][1], "big")
    d = int.from_bytes(fields[3][1], "big")
    return n, d


def rs256_sign(message: bytes, pem: str) -> bytes:
    """RSASSA-PKCS1-v1_5 with SHA-256 (RFC 8017 section 8.2.1)."""
    n, d = rsa_private_key(pem)
    k = (n.bit_length() + 7) // 8
    t = _SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if k < len(t) + 11:
        raise ValueError("RSA modulus too short")
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _sa_assertion(sa: dict, now: Optional[float] = None) -> str:
    """RS256 service-account JWT (grant_type=jwt-bearer assertion)."""
    now = time.time() if now is None else now
    header = _b64url(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    claims = _b64url(json.dumps({
        "iss": sa["client_email"],
        "scope": "https://www.googleapis.com/auth/cloud-platform",
        "aud": sa["token_uri"],
        "iat": int(now), "exp": int(now) + 3600,
    }).encode())
    signing_input = header + b"." + claims
    sig = rs256_sign(signing_input, sa["private_key"])
    return (signing_input + b"." + _b64url(sig)).decode()


class VertexClient(OpenAICompatClient):
    """GCP Vertex AI dialect (OAuth2 service-account auth).

    ``api_key`` is the service-account JSON (the string itself or a path
    to it); an RS256 jwt-bearer assertion is exchanged at the account's
    ``token_uri`` for a cached bearer token.  Completion uses the Gemini
    ``generateContent`` wire shape, embeddings the ``:predict``
    text-embedding shape.
    """

    def __init__(self, base_url: str, api_key: str = "",
                 location: Optional[str] = None,
                 project: Optional[str] = None, **kw):
        kw.setdefault("provider", "vertex")
        super().__init__(base_url, api_key, **kw)
        raw = api_key or "{}"
        if not raw.lstrip().startswith("{"):
            with open(raw) as f:
                raw = f.read()
        self.sa = json.loads(raw)
        self.project = project or self.sa.get("project_id", "")
        host = urlsplit(self.base_url).netloc
        m = re.match(r"([a-z0-9-]+)-aiplatform\.googleapis\.com", host)
        self.location = location or (m.group(1) if m else "us-central1")
        self._token: Optional[str] = None
        self._token_exp = 0.0

    def _bearer(self) -> str:
        if self._token and time.time() < self._token_exp - 60:
            return self._token
        url = self.sa["token_uri"]
        body = urlencode({
            "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
            "assertion": _sa_assertion(self.sa),
        }).encode()
        tok = checked_json(*self._transport.request(
            "POST", url, body,
            {"Content-Type": "application/x-www-form-urlencoded"}), url)
        self._token = tok["access_token"]
        self._token_exp = time.time() + float(tok.get("expires_in", 3600))
        return self._token

    def _headers(self) -> dict:
        return {"Content-Type": "application/json",
                "Authorization": f"Bearer {self._bearer()}"}

    def _model_path(self, model: str, verb: str) -> str:
        return (f"/v1/projects/{self.project}/locations/{self.location}"
                f"/publishers/google/models/{model}:{verb}")

    def complete(self, prompt: Optional[str] = None,
                 messages: Optional[list[dict]] = None,
                 temperature: float = 0.1, max_tokens: Optional[int] = None,
                 model: Optional[str] = None, use_cache: bool = True) -> str:
        mdl = model or self.model
        msgs = messages or [{"role": "user", "content": prompt or ""}]
        system = "\n".join(m.get("content", "") for m in msgs
                           if m.get("role") == "system")
        contents = [{
            "role": "model" if m.get("role") == "assistant" else "user",
            "parts": [{"text": m.get("content", "")}],
        } for m in msgs if m.get("role") != "system"]
        payload: dict = {
            "contents": contents,
            "generationConfig": {
                "temperature": temperature,
                **({"maxOutputTokens": max_tokens} if max_tokens else {}),
            },
        }
        if system:
            payload["systemInstruction"] = {"parts": [{"text": system}]}
        ck = None
        if self.cache and use_cache and temperature == 0.0:
            ck = ResponseCache.key("completion", {"m": mdl, **payload})
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post(self._model_path(mdl, "generateContent"), payload)
        cands = data.get("candidates", [])
        text = "".join(
            p.get("text", "")
            for p in (cands[0].get("content", {}).get("parts", [])
                      if cands else [])
        )
        if ck is not None:
            self.cache.put(ck, text)
        return text

    def embed(self, texts: Sequence[str], model: Optional[str] = None,
              use_cache: bool = True) -> list[list[float]]:
        mdl = model or self.model
        payload = {"instances": [{"content": t} for t in texts]}
        ck = None
        if self.cache and use_cache:
            ck = ResponseCache.key("embedding", {"m": mdl, **payload})
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post(self._model_path(mdl, "predict"), payload)
        out = [list(map(float, p.get("embeddings", {}).get("values", [])))
               for p in data.get("predictions", [])]
        if ck is not None:
            self.cache.put(ck, out)
        return out

    def rerank(self, query: str, documents: Sequence[str],
               top_n: Optional[int] = None,
               model: Optional[str] = None) -> list[dict]:
        raise BadRequestError(
            "the vertex dialect serves no rerank API here", self.provider
        )
