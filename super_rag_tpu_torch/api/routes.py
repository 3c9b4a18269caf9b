"""REST API routes of the serving seam (port of the JAX package's
api/routes.py, the routes of the search and document path).

Handlers are thin: auth resolution, request shaping, service call, JSON
response.  An audit middleware writes request/latency rows for every
/api/v1 call.  Served here: /health and /metrics; register, login,
logout, users/me and their unprefixed aliases; collection CRUD; the
collection search and the multi-collection search; document upload (JSON
and multipart, without archives), list, get, delete and chunks, flat and
nested under their collection.  Every other route of the JAX package
waits (ROADMAP A6); its URL answers 404, as any unknown route does.
"""

from __future__ import annotations

import base64
import time

from super_rag_tpu_torch.api.auth import COOKIE_NAME
from super_rag_tpu_torch.api.http import HttpError, Request, Response, Router
from super_rag_tpu_torch.schema import view_models as vm
from super_rag_tpu_torch.schema.view_models import parse_body
from super_rag_tpu_torch.service.collection_service import CollectionService
from super_rag_tpu_torch.service.context import AppContext
from super_rag_tpu_torch.service.document_service import DocumentService

# archives the JAX package expands into one document per member
ARCHIVE_EXTENSIONS = (".zip", ".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tbz2", ".7z")


def build_router(ctx: AppContext) -> Router:
    router = Router()
    collections = CollectionService(ctx)
    documents = DocumentService(ctx, collections)
    auth = ctx.auth

    # -- middleware: audit log ------------------------------------------------

    async def audit_mw(req: Request, nxt):
        t0 = time.perf_counter()
        resp = await nxt(req)
        if req.path.startswith("/api/v1"):
            user = req.state.get("user") or {}
            # response body captured for mutations only; streams are
            # skipped and credential-bearing routes are redacted
            secret = (
                "/auth/" in req.path
                or "/apikeys" in req.path
                or req.path.endswith("/key")
            )
            body_in = ("<redacted>" if secret
                       else req.body[:1000].decode("utf-8", "replace"))
            body_out = ""
            if req.method in ("POST", "PUT", "DELETE") and resp.stream is None:
                body_out = ("<redacted>" if secret
                            else resp.body[:1000].decode("utf-8", "replace"))
            ctx.db.add_audit(
                user.get("username", ""), req.path, req.method, resp.status,
                (time.perf_counter() - t0) * 1000,
                request=body_in,
                response=body_out,
            )
        return resp

    router.use(audit_mw)

    def me(req: Request) -> dict:
        user = auth.required(req)
        req.state["user"] = user
        return user

    # -- health / metrics ---------------------------------------------------------

    @router.get("/health")
    async def health(req: Request) -> Response:
        return Response.json({"status": "ok"})

    @router.get("/metrics")
    async def metrics(req: Request) -> Response:
        """Prometheus text exposition; requires auth (collection ids and
        row counts are not public)."""
        auth.required(req)
        lines = [
            "# TYPE super_rag_http_requests_total counter",
        ]
        rows = ctx.db.query(
            "SELECT method, status_code, COUNT(*) AS n,"
            " SUM(latency_ms) AS total_ms FROM audit_log"
            " GROUP BY method, status_code"
        )
        for r in rows:
            lines.append(
                f'super_rag_http_requests_total{{method="{r["method"]}",'
                f'status="{r["status_code"]}"}} {r["n"]}'
            )
            lines.append(
                f'super_rag_http_latency_ms_sum{{method="{r["method"]}",'
                f'status="{r["status_code"]}"}} {r["total_ms"]:.1f}'
            )
        with ctx.engines._lock:
            engines = dict(ctx.engines._engines)
        lines.append("# TYPE super_rag_index_rows gauge")
        for cid, eng in engines.items():
            lines.append(
                f'super_rag_index_rows{{collection="{cid}"}} {eng.index.size}'
            )
            lines.append(
                f'super_rag_index_live_rows{{collection="{cid}"}}'
                f" {eng.index.live_count}"
            )
        docs = ctx.db.query_one("SELECT COUNT(*) AS n FROM document")
        lines.append(f"super_rag_documents_total {docs['n']}")
        if ctx.batcher is not None:
            b = ctx.batcher.stats()
            lines.append("# TYPE super_rag_batcher_dispatches counter")
            lines.append(f"super_rag_batcher_dispatches {b['dispatches']}")
            lines.append(f"super_rag_batcher_queries {b['queries']}")
            lines.append(f"super_rag_batcher_avg_batch {b['avg_batch']}")
        return Response(
            status=200,
            headers={"Content-Type": "text/plain; version=0.0.4"},
            body=("\n".join(lines) + "\n").encode(),
        )

    # -- auth ----------------------------------------------------------------------

    @router.post("/api/v1/auth/register")
    async def register(req: Request) -> Response:
        body = parse_body(vm.RegisterRequest, req.json())
        user = auth.register(body.username, body.password, body.email)
        return Response.json(user, status=201)

    @router.post("/api/v1/auth/login")
    async def login(req: Request) -> Response:
        body = parse_body(vm.LoginRequest, req.json())
        user, token = auth.login(body.username, body.password)
        return Response.json(
            {"user": user, "token": token},
            headers={"Set-Cookie":
                     f"{COOKIE_NAME}={token}; HttpOnly; Path=/; SameSite=Lax"},
        )

    @router.post("/api/v1/auth/logout")
    async def logout(req: Request) -> Response:
        return Response.json(
            {"ok": True},
            headers={"Set-Cookie":
                     f"{COOKIE_NAME}=; Max-Age=0; Path=/"},
        )

    @router.get("/api/v1/users/me")
    async def users_me(req: Request) -> Response:
        return Response.json(me(req))

    # reference path dialect: unprefixed /register /login /logout /user
    router.add("POST", "/api/v1/register", register)
    router.add("POST", "/api/v1/login", login)
    router.add("POST", "/api/v1/logout", logout)
    router.add("GET", "/api/v1/user", users_me)

    # -- collections -------------------------------------------------------------------

    @router.post("/api/v1/collections")
    async def create_collection(req: Request) -> Response:
        user = me(req)
        body = parse_body(vm.CollectionCreate, req.json())
        coll = collections.create(
            user["username"], body.title, body.description,
            body.config.model_dump(exclude_none=True),
        )
        return Response.json(coll, status=201)

    def _paginate(req: Request, rows: list):
        """Two pagination dialects on every list endpoint: ?page/page_size/
        sort_by/sort_order/search -> envelope with items/total/page/
        page_size/total_pages/has_next/has_prev; ?offset/limit -> bare
        array (legacy)."""
        q = req.query

        def _int(name: str, default: int) -> int:
            try:
                return int(q.get(name, str(default)))
            except ValueError:
                raise HttpError(422, f"{name} must be an integer")

        if "page" in q or "page_size" in q:
            search = q.get("search", "").lower()
            if search:
                rows = [r for r in rows
                        if search in str(r.get("name", r.get("title", ""))).lower()]
            sort_by = q.get("sort_by", "created")
            order = q.get("sort_order", "desc")

            def _key(r: dict):
                v = r.get(sort_by)
                # dicts/lists (config, indexes, ...) are unorderable;
                # mixed types would raise TypeError mid-sort — compare
                # those as strings instead of 500ing on a query param
                if v is None or isinstance(v, bool) or not isinstance(
                        v, (int, float, str)):
                    return (v is None, 1, str(v))
                return (False, 0 if isinstance(v, (int, float)) else 1, v)

            try:
                rows = sorted(rows, key=_key, reverse=(order == "desc"))
            except TypeError:
                rows = sorted(rows, key=lambda r: str(r.get(sort_by)),
                              reverse=(order == "desc"))
            page = max(_int("page", 1), 1)
            size = min(max(_int("page_size", 10), 1), 100)
            total = len(rows)
            pages = max((total + size - 1) // size, 1)
            return {
                "items": rows[(page - 1) * size : page * size],
                "total": total,
                "page": page,
                "page_size": size,
                "total_pages": pages,
                "has_next": page < pages,
                "has_prev": page > 1,
            }
        limit = min(_int("limit", 100), 1000)
        offset = max(_int("offset", 0), 0)
        return rows[offset : offset + limit]

    @router.get("/api/v1/collections")
    async def list_collections(req: Request) -> Response:
        user = me(req)
        return Response.json(_paginate(req, collections.list(user["username"])))

    @router.get("/api/v1/collections/{cid}")
    async def get_collection(req: Request) -> Response:
        user = me(req)
        return Response.json(
            collections.get(user["username"], req.path_params["cid"])
        )

    @router.put("/api/v1/collections/{cid}")
    async def update_collection(req: Request) -> Response:
        user = me(req)
        body = parse_body(vm.CollectionUpdate, req.json())
        fields = body.model_dump(exclude_none=True)
        if "config" in fields:
            fields["config"] = body.config.model_dump(exclude_none=True)
        return Response.json(
            collections.update(user["username"], req.path_params["cid"],
                               **fields)
        )

    @router.delete("/api/v1/collections/{cid}")
    async def delete_collection(req: Request) -> Response:
        user = me(req)
        collections.delete(user["username"], req.path_params["cid"])
        return Response.no_content()

    # -- search (the north-star route) ----------------------------------------------------

    @router.post("/api/v1/collections/{cid}/searches")
    async def create_search(req: Request) -> Response:
        user = me(req)
        body = parse_body(vm.SearchRequest, req.json())
        result = await collections.execute_search(
            user["username"], req.path_params["cid"], body.query,
            top_k=body.top_k,
            similarity_threshold=body.similarity_threshold,
            use_fulltext=body.use_fulltext,
            use_graph=body.use_graph,
            use_rerank=body.use_rerank,
            chat_id=body.chat_id,
        )
        return Response.json(result, status=201)

    @router.post("/api/v1/searches")
    async def multi_search(req: Request) -> Response:
        """Search several collections in one request."""
        user = me(req)
        b = parse_body(vm.MultiSearchRequest, req.json())
        return Response.json(
            await collections.execute_multi_search(
                user["username"], b.collection_ids, b.query,
                top_k=b.top_k, use_rerank=b.use_rerank,
                chat_id=b.chat_id,
            ),
            status=201,
        )

    # -- documents ----------------------------------------------------------------------------

    @router.post("/api/v1/collections/{cid}/documents")
    async def upload_documents(req: Request) -> Response:
        user = me(req)
        cid = req.path_params["cid"]
        created = []
        ctype = req.headers.get("content-type", "")
        if ctype.startswith("multipart/form-data"):
            for part in req.multipart():
                if not part["filename"]:
                    continue
                if part["filename"].lower().endswith(ARCHIVE_EXTENSIONS):
                    raise HttpError(501, "archive uploads are not ported to the "
                                    "PyTorch port yet (ROADMAP A6)")
                created.append(
                    documents.create(
                        user["username"], cid, part["filename"], part["data"]
                    )
                )
        else:
            body = req.json()
            items = body if isinstance(body, list) else [body]
            for item in items:
                name = item.get("name", "")
                if not name:
                    raise HttpError(422, "document name required")
                if "content_base64" in item:
                    data = base64.b64decode(item["content_base64"])
                else:
                    data = item.get("content", "").encode()
                created.append(
                    documents.create(
                        user["username"], cid, name, data,
                        metadata=item.get("metadata"),
                        chat_id=item.get("chat_id"),
                    )
                )
        return Response.json(created, status=201)

    @router.get("/api/v1/collections/{cid}/documents")
    async def list_documents(req: Request) -> Response:
        user = me(req)
        return Response.json(_paginate(
            req, documents.list(user["username"], req.path_params["cid"])
        ))

    @router.get("/api/v1/documents/{did}")
    async def get_document(req: Request) -> Response:
        user = me(req)
        return Response.json(documents.get(user["username"],
                                           req.path_params["did"]))

    @router.delete("/api/v1/documents/{did}")
    async def delete_document(req: Request) -> Response:
        user = me(req)
        documents.delete(user["username"], req.path_params["did"])
        return Response.no_content()

    @router.get("/api/v1/documents/{did}/chunks")
    async def document_chunks(req: Request) -> Response:
        user = me(req)
        return Response.json(
            documents.chunks(user["username"], req.path_params["did"])
        )

    # -- nested document routes (every document route under its collection;
    # the flat /api/v1/documents/* routes above are kept for existing
    # clients) ------------------------------------------------------------------

    def _doc_in_collection(user: dict, cid: str, did: str) -> dict:
        doc = documents.get(user["username"], did)
        if doc["collection_id"] != cid:
            raise HttpError(404, f"document {did} not in collection {cid}")
        return doc

    @router.get("/api/v1/collections/{cid}/documents/{did}")
    async def get_document_nested(req: Request) -> Response:
        user = me(req)
        return Response.json(
            _doc_in_collection(user, req.path_params["cid"],
                               req.path_params["did"])
        )

    @router.delete("/api/v1/collections/{cid}/documents/{did}")
    async def delete_document_nested(req: Request) -> Response:
        user = me(req)
        doc = _doc_in_collection(user, req.path_params["cid"],
                                 req.path_params["did"])
        documents.delete(user["username"], doc["id"])
        return Response.no_content()

    return router
