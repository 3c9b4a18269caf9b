"""Web search + page reading with pluggable providers (port of the JAX
package's websearch/service.py).

Counterpart of the reference's websearch subsystem (super_rag/websearch/
+ api/web.py): FIVE search providers behind one ABC — duckduckgo, google,
jina, yep, llms.txt discovery (websearch/search/providers/) — with the
reference's merge/rank semantics (api/web.py:185 _merge_and_rank_results:
dedup by URL keeping first, stable sort by provider rank, re-sequence),
its search fallback ladder (jina -> duckduckgo -> yep, api/web.py:380),
and a reader service with the jina-reader -> local-readability ladder
(api/web.py:311-373; trafilatura's role is played by
websearch/readability.py — paragraph text/link-density extraction).

The JAX package's providers speak httpx; the port's speak the standard
library's ``http.client`` through ``WebClient``, which does what the JAX
package's ``httpx.Client(timeout=..., follow_redirects=True)`` does for
them: ``params=`` encoded as httpx encodes them, URLs normalized as httpx
normalizes them, redirects followed (at most 20, the Authorization header
dropped when one leaves the origin), and ``raise_for_status`` raising
``HTTPStatusError`` with httpx's wording.  A transport fault (no route,
refused connection, timeout) raises as the standard library raises it, so
its text is not httpx's.  Environments without egress get empty results
plus an explicit 'offline' flag rather than exceptions.  ``transport``
(a callable from ``WebRequest`` to ``WebResponse``) replaces the network,
so tests run against an in-process stub.
"""

from __future__ import annotations

import codecs
import html as html_lib
import http
import http.client
import json
import logging
import re
from dataclasses import dataclass
from typing import Callable, Optional
from urllib.parse import quote, urlencode, urljoin, urlsplit

from super_rag_tpu_torch.websearch.readability import extract_readable

logger = logging.getLogger(__name__)

__all__ = ["SearchResult", "Provider", "DuckDuckGoProvider", "JinaProvider",
           "GoogleProvider", "YepProvider", "LlmTxtProvider",
           "WebSearchService", "extract_readable", "merge_and_rank",
           "WebClient", "WebRequest", "WebResponse", "HTTPStatusError",
           "TooManyRedirects"]

MAX_REDIRECTS = 20  # httpx's default

# the characters httpx leaves unescaped in each part of a URL (RFC 3986
# unreserved characters are always left)
_UNRESERVED = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
               "0123456789-._~")
_PATH_SAFE = "".join(chr(i) for i in range(0x20, 0x7F)
                     if i not in (0x20, 0x22, 0x23, 0x3C, 0x3E, 0x3F, 0x60, 0x7B, 0x7D))
_QUERY_SAFE = "".join(chr(i) for i in range(0x20, 0x7F)
                      if i not in (0x20, 0x22, 0x23, 0x3C, 0x3E))
_FRAG_SAFE = "".join(chr(i) for i in range(0x20, 0x7F)
                     if i not in (0x20, 0x22, 0x3C, 0x3E, 0x60))
_ESCAPE = re.compile("%[A-Fa-f0-9]{2}")
_DEFAULT_PORT = {"http": 80, "https": 443}


class HTTPStatusError(Exception):
    """A reply outside 2xx, in httpx's words."""

    def __init__(self, message: str, response: "WebResponse"):
        super().__init__(message)
        self.response = response


class TooManyRedirects(Exception):
    pass


def _quote(text: str, safe: str) -> str:
    """Percent-encode what ``safe`` lacks, leaving ``%xx`` escapes as they
    are (httpx's ``quote``)."""
    keep = _UNRESERVED + safe
    out, pos = [], 0
    for m in _ESCAPE.finditer(text):
        out.append(_percent(text[pos:m.start()], keep))
        out.append(m.group(0))
        pos = m.end()
    out.append(_percent(text[pos:], keep))
    return "".join(out)


def _percent(text: str, keep: str) -> str:
    return "".join(c if c in keep else "".join(f"%{b:02X}" for b in c.encode())
                   for c in text)


def _dot_segments(path: str) -> str:
    parts = path.split("/")
    if "." not in parts and ".." not in parts:
        return path
    out: list[str] = []
    for part in parts:
        if part == ".":
            continue
        if part == "..":
            if out and out != [""]:
                out.pop()
        else:
            out.append(part)
    return "/".join(out)


def _primitive(v) -> str:
    return "true" if v is True else "false" if v is False else "" if v is None else str(v)


def normalize_url(url: str, params: Optional[dict] = None) -> str:
    """``url`` as httpx writes it, with ``params`` as its query."""
    p = urlsplit(url)
    scheme = p.scheme.lower()
    # httpx drops a default port only where the scheme is written in lower case
    default_port = _DEFAULT_PORT.get(url.split(":", 1)[0] if p.scheme else "")
    host = p.hostname or ""
    if host and not host.isascii():
        host = host.encode("idna").decode("ascii")
    netloc = ""
    if p.netloc:
        user = p.netloc.rpartition("@")[0]
        netloc = (user + "@" if user else "") + (f"[{host}]" if ":" in host else host)
        if p.port is not None and p.port != default_port:
            netloc += f":{p.port}"
    query: Optional[str] = p.query if p.query or url.split("#")[0].endswith("?") else None
    if params:  # httpx's params= replace the URL's own query
        query = urlencode([(k, _primitive(v)) for k, v in params.items()])
    out = f"{scheme}://{netloc}" if scheme else (f"//{netloc}" if netloc else "")
    out += _quote(_dot_segments(p.path), _PATH_SAFE)
    if query is not None:
        out += "?" + _quote(query, _QUERY_SAFE)
    if p.fragment:
        out += "#" + _quote(p.fragment, _FRAG_SAFE)
    return out


@dataclass
class WebRequest:
    method: str
    url: str
    headers: dict


class WebResponse:
    """A reply: status, headers (names lower-cased), body and the URL of
    the request that got it."""

    def __init__(self, status_code: int, headers: dict, content: bytes, url: str,
                 reason: Optional[str] = None):
        self.status_code = status_code
        self.headers = {k.lower(): v for k, v in headers.items()}
        self.content = content
        self.url = url
        self.reason_phrase = reason if reason is not None else _phrase(status_code)

    @property
    def text(self) -> str:
        m = re.search(r"charset=([\w.:-]+)", self.headers.get("content-type", ""), re.I)
        encoding = "utf-8"
        if m:
            try:
                encoding = codecs.lookup(m.group(1)).name
            except LookupError:
                pass
        return self.content.decode(encoding, errors="replace")

    def json(self):
        return json.loads(self.content)

    @property
    def has_redirect_location(self) -> bool:
        return self.status_code in (301, 302, 303, 307, 308) and "location" in self.headers

    def raise_for_status(self) -> "WebResponse":
        if 200 <= self.status_code < 300:
            return self
        kind = {1: "Informational response", 3: "Redirect response", 4: "Client error",
                5: "Server error"}.get(self.status_code // 100, "Invalid status code")
        message = f"{kind} '{self.status_code} {self.reason_phrase}' for url '{self.url}'\n"
        if self.has_redirect_location:
            message += f"Redirect location: '{self.headers['location']}'\n"
        message += ("For more information check: https://developer.mozilla.org/en-US/"
                    f"docs/Web/HTTP/Status/{self.status_code}")
        raise HTTPStatusError(message, self)


def _phrase(status: int) -> str:
    if status == 418:
        return "I'm a teapot"
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return ""


def http_transport(timeout: float) -> Callable[[WebRequest], WebResponse]:
    """The network: one ``http.client`` connection a request."""

    def send(req: WebRequest) -> WebResponse:
        p = urlsplit(req.url)
        if p.scheme not in ("http", "https"):
            raise ValueError(f"Request URL has an unsupported protocol '{p.scheme}://'.")
        cls = http.client.HTTPSConnection if p.scheme == "https" else http.client.HTTPConnection
        conn = cls(p.hostname, p.port, timeout=timeout)
        try:
            conn.request(req.method, (p.path or "/") + (f"?{p.query}" if p.query else ""),
                         headers=req.headers)
            resp = conn.getresponse()
            headers: dict = {}
            for k, v in resp.getheaders():
                headers[k.lower()] = f"{headers[k.lower()]}, {v}" if k.lower() in headers else v
            return WebResponse(resp.status, headers, resp.read(), req.url, resp.reason)
        finally:
            conn.close()

    return send


def _origin(url: str) -> tuple:
    p = urlsplit(url)
    return p.scheme, p.hostname, p.port or _DEFAULT_PORT.get(p.scheme)


class WebClient:
    """GET with the redirect and URL rules of ``httpx.Client(timeout=...,
    follow_redirects=True)``."""

    def __init__(self, timeout: float = 15.0,
                 transport: Optional[Callable[[WebRequest], WebResponse]] = None):
        self.transport = transport or http_transport(timeout)

    def get(self, url: str, params: Optional[dict] = None, headers: Optional[dict] = None,
            follow_redirects: bool = True) -> WebResponse:
        url = normalize_url(url, params)
        hdrs = {"Accept": "*/*", "User-Agent": "super-rag-torch", **(headers or {})}
        hops = 0
        while True:
            resp = self.transport(WebRequest("GET", url, dict(hdrs)))
            if not (follow_redirects and resp.has_redirect_location):
                return resp
            hops += 1
            if hops > MAX_REDIRECTS:
                raise TooManyRedirects("Exceeded maximum allowed redirects.")
            nxt = normalize_url(urljoin(url, resp.headers["location"]))
            if "#" in url and "#" not in nxt:
                nxt += url[url.index("#"):]
            before, after = _origin(url), _origin(nxt)
            if before != after and not (before[0] == "http" and before[2] == 80
                                        and after[0] == "https" and after[2] == 443
                                        and before[1] == after[1]):
                hdrs = {k: v for k, v in hdrs.items() if k.lower() != "authorization"}
            url = nxt


@dataclass
class SearchResult:
    title: str
    url: str
    snippet: str
    provider: str
    rank: int = 0

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def _strip_html(text: str) -> str:
    text = re.sub(r"<script.*?</script>|<style.*?</style>", " ", text,
                  flags=re.S | re.I)
    text = re.sub(r"<[^>]+>", " ", text)
    text = html_lib.unescape(text)
    return re.sub(r"[ \t]+", " ", text).strip()


def _domain(url: str) -> str:
    try:
        return (urlsplit(url).netloc or "").lower().removeprefix("www.")
    except ValueError:
        return ""


def merge_and_rank(per_provider: list[list[SearchResult]],
                   max_results: int) -> list[SearchResult]:
    """Reference merge semantics (api/web.py:185): concatenate, dedup by
    URL keeping the FIRST occurrence (provider order = priority), stable
    sort by each result's provider-local rank, re-sequence ranks."""
    seen: set[str] = set()
    unique: list[SearchResult] = []
    for results in per_provider:
        for r in results:
            if r.url and r.url not in seen:
                seen.add(r.url)
                unique.append(r)
    unique.sort(key=lambda r: r.rank)  # stable: ties keep provider order
    out = []
    for i, r in enumerate(unique[:max_results]):
        out.append(SearchResult(title=r.title, url=r.url, snippet=r.snippet,
                                provider=r.provider, rank=i + 1))
    return out


class Provider:
    name = "base"

    def search(self, query: str, max_results: int,
               source: Optional[str] = None) -> list[SearchResult]:
        """``source`` restricts to a site/domain (reference providers'
        site: handling)."""
        raise NotImplementedError

    @staticmethod
    def _site_query(query: str, source: Optional[str]) -> str:
        if not source:
            return query
        dom = _domain(source if "//" in source else "https://" + source)
        return f"site:{dom} {query}".strip() if dom else query


class DuckDuckGoProvider(Provider):
    name = "duckduckgo"

    def __init__(self, client: "WebClient"):
        self.client = client

    def search(self, query: str, max_results: int,
               source: Optional[str] = None) -> list[SearchResult]:
        r = self.client.get(
            "https://html.duckduckgo.com/html/",
            params={"q": self._site_query(query, source)},
            headers={"User-Agent": "Mozilla/5.0"},
        )
        r.raise_for_status()
        out = []
        for i, m in enumerate(
            re.finditer(
                r'<a[^>]+class="result__a"[^>]+href="([^"]+)"[^>]*>(.*?)</a>'
                r".*?result__snippet[^>]*>(.*?)</",
                r.text, re.S,
            )
        ):
            if i >= max_results:
                break
            out.append(SearchResult(
                title=_strip_html(m.group(2)), url=m.group(1),
                snippet=_strip_html(m.group(3)), provider=self.name,
                rank=i + 1,
            ))
        return out


class JinaProvider(Provider):
    """s.jina.ai search endpoint (needs an API key)."""

    name = "jina"

    def __init__(self, client: "WebClient", api_key: str):
        self.client = client
        self.api_key = api_key

    def search(self, query: str, max_results: int,
               source: Optional[str] = None) -> list[SearchResult]:
        r = self.client.get(
            f"https://s.jina.ai/{quote(self._site_query(query, source))}",
            headers={"Authorization": f"Bearer {self.api_key}",
                     "Accept": "application/json"},
        )
        r.raise_for_status()
        data = r.json().get("data", [])[:max_results]
        return [
            SearchResult(title=d.get("title", ""), url=d.get("url", ""),
                         snippet=d.get("description", ""), provider=self.name,
                         rank=i + 1)
            for i, d in enumerate(data)
        ]


class GoogleProvider(Provider):
    """Google Programmable Search (Custom Search JSON API).

    The reference scrapes via googlesearch-python
    (websearch/search/providers/google_search_provider.py); the official
    JSON API is the stable equivalent and needs api_key + engine id."""

    name = "google"

    def __init__(self, client: "WebClient", api_key: str, cx: str):
        self.client = client
        self.api_key = api_key
        self.cx = cx

    def search(self, query: str, max_results: int,
               source: Optional[str] = None) -> list[SearchResult]:
        params = {"key": self.api_key, "cx": self.cx,
                  "q": self._site_query(query, source),
                  "num": min(max_results, 10)}
        r = self.client.get("https://www.googleapis.com/customsearch/v1",
                            params=params)
        r.raise_for_status()
        items = r.json().get("items", [])[:max_results]
        return [
            SearchResult(title=d.get("title", ""), url=d.get("link", ""),
                         snippet=d.get("snippet", ""), provider=self.name,
                         rank=i + 1)
            for i, d in enumerate(items)
        ]


class YepProvider(Provider):
    """yep.com public search API (the reference wraps it via the
    yepsearch package — websearch/search/providers/yep_search_provider.py;
    same endpoint, no key required)."""

    name = "yep"

    def __init__(self, client: "WebClient"):
        self.client = client

    def search(self, query: str, max_results: int,
               source: Optional[str] = None) -> list[SearchResult]:
        r = self.client.get(
            "https://api.yep.com/fs/2/search",
            params={"client": "web", "gl": "all", "no_correct": "false",
                    "q": self._site_query(query, source),
                    "safeSearch": "off", "type": "web"},
            headers={"User-Agent": "Mozilla/5.0"},
        )
        r.raise_for_status()
        data = r.json()
        results = (data[1] if isinstance(data, list) and len(data) > 1
                   else data).get("results", [])
        out = []
        for d in results:
            if d.get("type") not in (None, "Organic", "web"):
                continue
            out.append(SearchResult(
                title=_strip_html(d.get("title", "")), url=d.get("url", ""),
                snippet=_strip_html(d.get("snippet", "")),
                provider=self.name, rank=len(out) + 1,
            ))
            if len(out) >= max_results:
                break
        return out


class LlmTxtProvider(Provider):
    """llms.txt discovery (reference llm_txt_search_provider.py): probe
    the domain's well-known llms.txt locations and return its link list
    as results.  Uses ``source`` as the domain; query filters links."""

    name = "llm_txt"
    PATHS = ("/llms.txt", "/.well-known/llms.txt", "/docs/llms.txt",
             "/api/llms.txt", "/reference/llms.txt")
    _LINK = re.compile(r"\[([^\]]+)\]\((https?://[^)\s]+)\)(?:\s*:\s*(.*))?")

    def __init__(self, client: "WebClient"):
        self.client = client

    def search(self, query: str, max_results: int,
               source: Optional[str] = None) -> list[SearchResult]:
        if not source:
            return []
        if source.endswith("llms.txt") and "//" in source:
            candidates = [source]
        else:
            dom = _domain(source if "//" in source else "https://" + source)
            if not dom:
                return []
            candidates = [f"https://{dom}{p}" for p in self.PATHS]
        content = ""
        for url in candidates:
            try:
                r = self.client.get(url, follow_redirects=True)
                if r.status_code == 200 and "[" in r.text:
                    content = r.text
                    break
            except Exception:  # noqa: BLE001 — try the next location
                continue
        if not content:
            return []
        terms = [t for t in query.lower().split() if t]
        out = []
        for m in self._LINK.finditer(content):
            title, url, desc = m.group(1), m.group(2), m.group(3) or ""
            hay = f"{title} {desc}".lower()
            if terms and not any(t in hay for t in terms):
                continue
            out.append(SearchResult(title=title.strip(), url=url,
                                    snippet=desc.strip(),
                                    provider=self.name, rank=len(out) + 1))
            if len(out) >= max_results:
                break
        return out


class WebSearchService:
    def __init__(self, jina_api_key: Optional[str] = None,
                 google_api_key: Optional[str] = None,
                 google_cx: Optional[str] = None,
                 timeout: float = 15.0, transport=None):
        self.client = WebClient(timeout=timeout, transport=transport)
        self.jina_api_key = jina_api_key
        self.providers: list[Provider] = []
        if jina_api_key:
            self.providers.append(JinaProvider(self.client, jina_api_key))
        self.providers.append(DuckDuckGoProvider(self.client))
        if google_api_key and google_cx:
            self.providers.append(
                GoogleProvider(self.client, google_api_key, google_cx)
            )
        self.providers.append(YepProvider(self.client))
        self.providers.append(LlmTxtProvider(self.client))

    def _named(self, names: list[str]) -> list[Provider]:
        by = {p.name: p for p in self.providers}
        return [by[n] for n in names if n in by]

    def search(self, query: str, max_results: int = 5,
               providers: Optional[list[str]] = None,
               source: Optional[str] = None) -> list[dict]:
        """Multi-provider search with reference merge/rank + fallback.

        No ``providers`` given -> the reference's ladder (api/web.py:380):
        jina (when a key exists) else duckduckgo; on empty results fall
        through duckduckgo then yep.  Explicit ``providers`` -> query all
        of them and merge/rank.  ``source`` restricts to a domain (and
        activates llms.txt discovery when it is the only signal)."""
        if providers:
            chosen = self._named(providers)
        elif source and not query.strip():
            chosen = self._named(["llm_txt"])
        else:
            ladder = (["jina"] if self.jina_api_key else []) \
                + ["duckduckgo", "yep"]
            for name in ladder:
                res = self._try(self._named([name])[0], query, max_results,
                                source)
                if res:
                    return [r.to_dict() for r in
                            merge_and_rank([res], max_results)]
            return []
        per = []
        for p in chosen:
            res = self._try(p, query, max_results, source)
            if res:
                per.append(res)
        return [r.to_dict() for r in merge_and_rank(per, max_results)]

    def _try(self, p: Provider, query: str, max_results: int,
             source: Optional[str]) -> list[SearchResult]:
        try:
            return p.search(query, max_results, source=source)
        except Exception as e:  # noqa: BLE001 — offline or provider down
            logger.warning("web provider %s failed: %s", p.name, e)
            return []

    # -- reader (jina -> local readability ladder, api/web.py:311-373) ----

    def read(self, urls: list[str], max_chars: int = 20000) -> list[dict]:
        out = []
        for url in urls[:10]:
            page = None
            if self.jina_api_key:
                page = self._read_jina(url, max_chars)
            if page is None:
                page = self._read_local(url, max_chars)
            out.append(page)
        return out

    def _read_jina(self, url: str, max_chars: int) -> Optional[dict]:
        try:
            r = self.client.get(
                "https://r.jina.ai/" + url,
                headers={"Authorization": f"Bearer {self.jina_api_key}",
                         "Accept": "text/plain"},
            )
            r.raise_for_status()
            text = r.text.strip()
            if not text:
                return None
            return {"url": url, "status": "ok", "reader": "jina",
                    "text": text[:max_chars]}
        except Exception as e:  # noqa: BLE001 — ladder falls through
            logger.info("jina reader failed for %s: %s", url, e)
            return None

    def _read_local(self, url: str, max_chars: int) -> dict:
        try:
            r = self.client.get(url, headers={"User-Agent": "Mozilla/5.0"})
            r.raise_for_status()
            return {"url": url, "status": "ok", "reader": "readability",
                    "text": extract_readable(r.text, max_chars)}
        except Exception as e:  # noqa: BLE001
            return {"url": url, "status": "error", "error": str(e)}

    def close(self) -> None:
        """Nothing stays open: the transport opens one connection a
        request (the JAX package closes its httpx client here)."""
