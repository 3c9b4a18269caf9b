"""The port's websearch/ against the JAX package's: one in-process stub web
(the StubWeb of test_websearch.py, recording every URL it is asked for)
feeds the JAX package through ``httpx.MockTransport`` and the port through
its ``transport`` seam.  Results, the URLs each provider asked for, the
search and reader ladders, the redirects, the error pages and readability's
text are equal.  A transport fault's text is a kept difference (ROADMAP
§C): httpx words it its own way, the port as the standard library does."""

import json

import httpx
import pytest

from super_rag_tpu.websearch import readability as jread
from super_rag_tpu.websearch import service as jsvc
from super_rag_tpu_torch.websearch import readability as tread
from super_rag_tpu_torch.websearch import service as tsvc

DDG_HTML = """
<html><body>
<a class="result__a" href="https://a.com/1">Alpha <b>One</b></a>
<div class="result__snippet">first &amp; snippet</div>
<a class="result__a" href="https://b.com/2">Beta Two</a>
<div class="result__snippet">second snippet</div>
<a class="result__a" href="https://c.com/3">Gamma</a>
<div class="result__snippet">third</div>
</body></html>
"""

ARTICLE_HTML = """
<html><head><title>The Article</title></head><body>
<nav><a href="/x">Home</a> <a href="/y">About</a> <a href="/z">More</a></nav>
<header><a href="/login">Log in here now</a></header>
<article>
<h1>Main headline</h1>
<p>This is the first real paragraph of the article, with enough prose to
be clearly content. It talks about things, at length, with commas and
periods. The quick brown fox jumps over the lazy dog repeatedly.</p>
<p>A second paragraph continues the discussion in detail, because real
articles have multiple dense paragraphs of actual text content.</p>
</article>
<footer><a href="/privacy">Privacy</a> <a href="/terms">Terms</a></footer>
</body></html>
"""

BROKEN_HTML = [
    "<p>unclosed <div>nested <b>bold<p>More prose here with, commas. And periods.",
    "", "plain text, no tags at all. Two sentences.", "<html><body></body></html>",
    "<script>var x = '<p>not text</p>';</script><p>After the script, prose.</p>",
    "<p>café &amp; cr&egrave;me &#x263A; &bogus; entities</p>" * 3,
    "<body><div>" + " ".join(f'<a href="/{i}">link {i}</a>' for i in range(50))
    + "</div><p>" + "Real prose sentence, with commas. " * 10 + "</p></body>",
    "<table><tr><td>cell one, with text.</td><td>cell two.</td></tr></table>",
    "<pre>code\n  block\n</pre><blockquote>a quote, quoted.</blockquote>",
    "<h1>Title only</h1>", "<<<>>> </p></div> <p>stray closers, then prose.",
    "<aside><p>sidebar prose, long enough to count as content here.</p></aside>",
]


class StubWeb:
    """Answers by host; ``fail`` hosts answer 500, ``redirects`` maps a URL
    to the Location a 302 sends."""

    def __init__(self):
        self.urls = []
        self.fail = set()
        self.redirects = {}

    def answer(self, method, url, headers):
        """(status, headers, body) for one request."""
        self.urls.append((method, url, headers.get("authorization")))
        u = httpx.URL(url)
        host = u.host
        if url in self.redirects:
            return 302, {"Location": self.redirects[url]}, b""
        if host in self.fail:
            return 500, {"Content-Type": "text/plain"}, b"down"
        if host == "html.duckduckgo.com":
            return 200, {"Content-Type": "text/html"}, DDG_HTML.encode()
        if host == "s.jina.ai":
            return 200, {"Content-Type": "application/json"}, json.dumps({"data": [
                {"title": "Jina Hit", "url": "https://j.com/1", "description": "jina snippet"},
                {"title": "Dup of A", "url": "https://a.com/1",
                 "description": "same url as ddg"}]}).encode()
        if host == "www.googleapis.com":
            return 200, {"Content-Type": "application/json"}, json.dumps({"items": [
                {"title": "Google Hit", "link": "https://g.com/1",
                 "snippet": "google snippet"}]}).encode()
        if host == "api.yep.com":
            return 200, {"Content-Type": "application/json"}, json.dumps(["Ok", {"results": [
                {"type": "Organic", "title": "Yep <b>Hit</b>", "url": "https://y.com/1",
                 "snippet": "yep snippet"},
                {"type": "Ad", "title": "ad", "url": "https://ad.com", "snippet": ""},
                {"title": "Yep Two", "url": "https://y.com/2", "snippet": "two"}]}]).encode()
        if host == "docs.example.com":
            if u.path == "/llms.txt":
                return 200, {"Content-Type": "text/plain"}, (
                    "# Docs\n[Quickstart](https://docs.example.com/qs): get going\n"
                    "[API Reference](https://docs.example.com/api): endpoints and auth\n"
                ).encode()
            return 404, {}, b""
        if host == "r.jina.ai":
            return 200, {"Content-Type": "text/plain"}, b"jina-extracted body text"
        if host == "page.test":
            return 200, {"Content-Type": "text/html; charset=utf-8"}, ARTICLE_HTML.encode()
        if host == "latin.test":
            return 200, {"Content-Type": "text/html; charset=iso-8859-1"}, \
                "<p>café prose, with commas. And periods.</p>".encode("latin-1")
        if host == "teapot.test":
            return 418, {}, b""
        return 404, {}, b""

    def jax(self, **kw):
        def handler(request: httpx.Request) -> httpx.Response:
            status, headers, body = self.answer(request.method, str(request.url),
                                                {k.lower(): v for k, v in
                                                 request.headers.items()})
            return httpx.Response(status, headers=headers, content=body)

        return jsvc.WebSearchService(transport=httpx.MockTransport(handler), **kw)

    def port(self, **kw):
        def send(req: tsvc.WebRequest) -> tsvc.WebResponse:
            status, headers, body = self.answer(req.method, req.url,
                                                {k.lower(): v for k, v in
                                                 req.headers.items()})
            return tsvc.WebResponse(status, headers, body, req.url)

        return tsvc.WebSearchService(transport=send, **kw)


def both(setup, call, **kw):
    """``call(service)`` on the JAX package's and on the port's service,
    each over its own stub; returns both results and both URL logs."""
    out = []
    for side in ("jax", "port"):
        stub = StubWeb()
        setup(stub)
        svc = getattr(stub, side)(**kw)
        out.append((call(svc), stub.urls))
    return out


KEYS = {"none": {}, "jina": {"jina_api_key": "k"},
        "all": {"jina_api_key": "k", "google_api_key": "g", "google_cx": "cx"}}


def test_five_providers_registered():
    for keys in KEYS.values():
        (want, _), (got, _) = both(lambda s: None, lambda svc: [p.name for p in svc.providers],
                                   **keys)
        assert got == want
    assert got == ["jina", "duckduckgo", "google", "yep", "llm_txt"]


SEARCHES = {
    "ladder, no key": ("none", dict(query="q")),
    "ladder, jina": ("jina", dict(query="q", max_results=5)),
    "ladder, jina down": ("jina", dict(query="q"), {"s.jina.ai"}),
    "ladder, jina and ddg down": ("jina", dict(query="q"),
                                  {"s.jina.ai", "html.duckduckgo.com"}),
    "ladder, all down": ("jina", dict(query="q"),
                         {"s.jina.ai", "html.duckduckgo.com", "api.yep.com"}),
    "explicit merge": ("jina", dict(query="q", max_results=10,
                                    providers=["jina", "duckduckgo", "yep"])),
    "explicit, one result": ("all", dict(query="q", max_results=1,
                                         providers=["yep", "jina", "google"])),
    "unknown provider": ("all", dict(query="q", providers=["bing", "google"])),
    "google": ("all", dict(query="rust async runtimes", providers=["google"])),
    "site search": ("all", dict(query="hello world & more", source="https://www.x.org/a",
                                providers=["duckduckgo", "google", "yep", "jina"])),
    "site by domain": ("none", dict(query="q é ü", source="docs.example.com")),
    "llms.txt": ("none", dict(query="", source="docs.example.com", providers=["llm_txt"],
                              max_results=5)),
    "llms.txt filtered": ("none", dict(query="endpoints", source="docs.example.com",
                                       providers=["llm_txt"])),
    "llms.txt url": ("none", dict(query="", source="https://docs.example.com/llms.txt",
                                  providers=["llm_txt"])),
    "llms.txt nowhere": ("none", dict(query="", source="nowhere.test",
                                      providers=["llm_txt"])),
    "source only": ("none", dict(query="", source="docs.example.com")),
    "ddg two": ("none", dict(query="q", max_results=2, providers=["duckduckgo"])),
}


@pytest.mark.parametrize("case", list(SEARCHES))
def test_search_results_and_urls(case):
    keys, kw, *down = SEARCHES[case]
    (want, wurls), (got, gurls) = both(lambda s: s.fail.update(*down),
                                       lambda svc: svc.search(**kw), **KEYS[keys])
    assert got == want
    assert gurls == wurls


def test_merge_and_rank_same_order():
    def rows(mod):
        a = [mod.SearchResult("A1", "https://a/1", "", "p1", 1),
             mod.SearchResult("A2", "https://a/2", "", "p1", 2),
             mod.SearchResult("A3", "", "", "p1", 3)]
        b = [mod.SearchResult("B1", "https://a/1", "", "p2", 1),
             mod.SearchResult("B2", "https://b/2", "", "p2", 2)]
        return [[r.to_dict() for r in mod.merge_and_rank([a, b], n)] for n in (10, 2, 0)]

    assert rows(tsvc) == rows(jsvc)


READS = {
    "jina": ("jina", ["https://page.test/x"], set()),
    "jina down": ("jina", ["https://page.test/x"], {"r.jina.ai"}),
    "readability": ("none", ["https://page.test/x", "https://page.test/y?q=1 2"], set()),
    "charset": ("none", ["https://latin.test/"], set()),
    "404": ("none", ["https://missing.test/x"], set()),
    "500": ("none", ["https://down.test/x"], {"down.test"}),
    "418": ("none", ["https://teapot.test/"], set()),
    "eleven urls": ("none", [f"https://page.test/{i}" for i in range(11)], set()),
}


@pytest.mark.parametrize("case", list(READS))
def test_reader_ladder_pages_and_error_pages(case):
    keys, urls, down = READS[case]
    (want, wurls), (got, gurls) = both(lambda s: s.fail.update(down),
                                       lambda svc: svc.read(urls, max_chars=500),
                                       **KEYS[keys])
    assert got == want
    assert gurls == wurls


def test_redirects_followed_as_httpx_follows_them():
    def setup(stub):
        stub.redirects.update({
            "https://page.test/old": "/new",  # relative
            "https://r.jina.ai/https://hop.test/a": "https://page.test/moved",
            "https://page.test/loop": "https://page.test/loop",
            "http://page.test/plain": "https://page.test/secure",  # https upgrade
        })

    urls = ["https://page.test/old", "https://hop.test/a", "https://page.test/loop",
            "http://page.test/plain"]
    for keys in ("jina", "none"):
        (want, wurls), (got, gurls) = both(setup, lambda svc: svc.read(urls, max_chars=200),
                                           **KEYS[keys])
        assert got == want
        assert gurls == wurls
    # the jina reader's Authorization is dropped where a redirect leaves
    # r.jina.ai; the loop gives up after 20 redirects
    assert ("GET", "https://page.test/moved", None) in both(
        setup, lambda svc: svc.read(urls), **KEYS["jina"])[1][1]
    assert "Exceeded maximum allowed redirects." in {p.get("error") for p in got}
    assert gurls.count(("GET", "https://page.test/loop", None)) == 21


def test_transport_fault_is_a_kept_difference():
    """A fault below HTTP (here a refused connection) answers an error page
    from both; its text is httpx's in one and the standard library's in the
    other (ROADMAP §C)."""
    def jax_handler(request):
        raise httpx.ConnectError("[Errno 111] Connection refused", request=request)

    def port_send(req):
        raise ConnectionRefusedError(111, "Connection refused")

    want = jsvc.WebSearchService(transport=httpx.MockTransport(jax_handler))
    got = tsvc.WebSearchService(transport=port_send)
    w, g = want.read(["https://x.test/"]), got.read(["https://x.test/"])
    assert [{k: v for k, v in p.items() if k != "error"} for p in g] == \
        [{k: v for k, v in p.items() if k != "error"} for p in w]
    assert g[0]["status"] == "error" and g[0]["error"] == "[Errno 111] Connection refused"
    assert want.search("q") == got.search("q") == []


@pytest.mark.parametrize("i", range(len(BROKEN_HTML) + 1))
@pytest.mark.parametrize("max_chars", [20000, 40])
def test_readability_same_text(i, max_chars):
    html = ARTICLE_HTML if i == len(BROKEN_HTML) else BROKEN_HTML[i]
    assert tread.extract_readable(html, max_chars) == jread.extract_readable(html, max_chars)


def test_url_normalization_matches_httpx():
    for url, params in [
        ("https://html.duckduckgo.com/html/", {"q": "site:x.org a & b"}),
        ("HTTPS://Page.Test:443/a/./b/../c d", None), ("http://h:80/x", None),
        ("https://h/ä/€?ü=1#frag ment", None), ("https://h/%zz%41", None),
        ("http://h:8080/x?y=1", {"z": True, "n": None, "k": 10}), ("https://h/x?", None),
        ("https://[::1]:8443/x", None), ("https://u:p@h/x", None),
    ]:
        want = str(httpx.Request("GET", url, params=params).url)
        assert tsvc.normalize_url(url, params) == want, url


def test_request_headers_up_to_the_transports_own():
    """Each provider's and reader's headers are the JAX package's; the
    transport's own defaults are a kept difference (ROADMAP §C): httpx
    sends ``User-Agent: python-httpx/...`` and ``Accept-Encoding: gzip,
    deflate``, the port its own agent and no encoding."""
    def run(side):
        stub = StubWeb()
        seen = []
        real = stub.answer

        def answer(method, url, headers):
            seen.append((url, headers))
            return real(method, url, headers)

        stub.answer = answer
        svc = getattr(stub, side)(**KEYS["all"])
        svc.search("q", providers=["jina", "duckduckgo", "google", "yep"])
        svc.search("", source="docs.example.com")
        svc.read(["https://page.test/x"])
        svc.jina_api_key = None
        svc.read(["https://page.test/y"])
        return seen

    want, got = run("jax"), run("port")
    own = {"user-agent", "accept-encoding", "host", "connection"}
    assert [(u, {k: v for k, v in h.items() if k not in own}) for u, h in got] == \
        [(u, {k: v for k, v in h.items() if k not in own}) for u, h in want]
    # a provider's own User-Agent is sent by both
    assert [h.get("user-agent") for u, h in got if "duckduckgo" in u] == ["Mozilla/5.0"]
    assert "accept-encoding" not in got[0][1] and "gzip" in want[0][1]["accept-encoding"]


def test_proxy_environment_is_a_kept_difference(monkeypatch):
    """httpx's client reads HTTP_PROXY; the port's transport connects
    directly (ROADMAP §C).  Both servers here listen on 127.0.0.1."""
    import http.server
    import threading

    def server(text):
        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = f"<p>{text}, prose with commas. And periods.</p>".encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    site, proxy = server("the site itself"), server("the proxy's answer")
    try:
        monkeypatch.setenv("HTTP_PROXY", f"http://127.0.0.1:{proxy.server_address[1]}")
        monkeypatch.setenv("http_proxy", f"http://127.0.0.1:{proxy.server_address[1]}")
        for name in ("NO_PROXY", "no_proxy", "ALL_PROXY", "all_proxy"):
            monkeypatch.delenv(name, raising=False)
        url = f"http://127.0.0.1:{site.server_address[1]}/page"
        jax_page = jsvc.WebSearchService(timeout=2.0).read([url])[0]
        port_page = tsvc.WebSearchService(timeout=2.0).read([url])[0]
        assert "the proxy's answer" in jax_page["text"]
        assert "the site itself" in port_page["text"]
        assert {k: v for k, v in port_page.items() if k != "text"} == \
            {k: v for k, v in jax_page.items() if k != "text"}
    finally:
        site.shutdown()
        proxy.shutdown()
