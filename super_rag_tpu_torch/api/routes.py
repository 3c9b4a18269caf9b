"""REST API routes of the serving seam (port of the JAX package's
api/routes.py, the routes of the search and document path).

Handlers are thin: auth resolution, request shaping, service call, JSON
response.  An audit middleware writes request/latency rows for every
/api/v1 call.  Served here: /health and /metrics; register, login,
logout, users/me and their unprefixed aliases, change-password, users,
API keys and OAuth; collection CRUD; the collection search, the image
search, assets and the multi-collection search; document upload (JSON,
multipart and archives, and the two-phase upload + confirm), list, get,
delete (one or a batch), chunks, preview, object and rebuild, flat and
nested under their collection; the collection rebuilds; the knowledge
graph's labels, subgraph (also under the ``/graphs`` spelling), stats,
combined search, node and episode search and BFS expansion; the prompt
templates; the model providers (CRUD, keys, models, the masked
configuration, default models by scenario tag, the available-model
listings); ``POST /v1/embeddings``, a collection's embedder served as
an OpenAI-compatible provider; the workflows (CRUD, versions, runs and
their node runs, a saved workflow's run, a one-shot run and its SSE
stream) and the nodeflow catalog (node types, packs); direct sharing,
publishing, the marketplace (list, subscriptions, read-only browsing of a
published collection) and the sharing status; the audit log; agents
(CRUD, their chats, feedback and titles, the tool-loop WebSocket and the
AG-UI SSE stream); web search and page reading; chats (CRUD, chat files
and their search, feedback, titles, SSE completions, the frontend
completion route and the chat WebSocket, where a stop or cancel frame
ends the turn in flight).  The MCP endpoint and the web console of the
JAX package wait (ROADMAP A6i); their URLs answer 404, as any unknown
route does.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import functools
import posixpath
import time
import uuid
from typing import Optional

import numpy as np
import torch

from super_rag_tpu_torch.api import auth as A
from super_rag_tpu_torch.api.auth import COOKIE_NAME
from super_rag_tpu_torch.agent.ag_ui import to_ag_ui
from super_rag_tpu_torch.agent.session_manager import AgentSessionManager
from super_rag_tpu_torch.api.http import HttpError, Request, Response, Router, WebSocket
from super_rag_tpu_torch.api.wsflow import next_message, pump, start_reader
from super_rag_tpu_torch.llm import resolver as R
from super_rag_tpu_torch.llm.prompts import list_templates
from super_rag_tpu_torch.nodeflow.models import node_type_catalog
from super_rag_tpu_torch.nodeflow.registry import registry_summary
from super_rag_tpu_torch.schema import view_models as vm
from super_rag_tpu_torch.schema.view_models import parse_body
from super_rag_tpu_torch.service.chat_service import ChatService
from super_rag_tpu_torch.service.collection_service import CollectionService
from super_rag_tpu_torch.service.context import AppContext
from super_rag_tpu_torch.service.document_service import DocumentService
from super_rag_tpu_torch.service.workflow_service import WorkflowService
from super_rag_tpu_torch.models.image_decode import UnsupportedImageError
from super_rag_tpu_torch.store.objectstore import is_upload_id, safe_object_name
from super_rag_tpu_torch.utils.uncompress import iter_archive, supported_archive
from super_rag_tpu_torch.websearch.service import WebSearchService


def build_router(ctx: AppContext) -> Router:
    router = Router()
    collections = CollectionService(ctx)
    documents = DocumentService(ctx, collections)
    workflows = WorkflowService(ctx)
    chats = ChatService(ctx, collections)
    agent_sessions = AgentSessionManager(ctx)
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

    def _oauth_redirect(req: Request, provider: str) -> str:
        return req.query.get(
            "redirect_uri",
            f"http://{req.headers.get('host', 'localhost')}"
            f"/api/v1/auth/oauth/{provider}/callback",
        )

    @router.get("/api/v1/auth/oauth/{provider}/authorize")
    async def oauth_authorize(req: Request) -> Response:
        """Start the OAuth authorization-code flow."""
        provider = req.path_params["provider"]
        return Response.json(
            auth.oauth_authorize_url(provider, _oauth_redirect(req, provider)))

    @router.get("/api/v1/auth/oauth/{provider}/callback")
    async def oauth_callback(req: Request) -> Response:
        provider = req.path_params["provider"]
        code = req.query.get("code", "")
        state = req.query.get("state", "")
        if not code:
            raise HttpError(422, "code required")
        user, token = auth.oauth_callback(provider, code, state,
                                          _oauth_redirect(req, provider))
        return Response.json(
            {"user": user, "token": token},
            headers={"Set-Cookie":
                     f"{COOKIE_NAME}={token}; HttpOnly; Path=/; SameSite=Lax"},
        )

    @router.get("/api/v1/users/me/oauth_accounts")
    async def my_oauth_accounts(req: Request) -> Response:
        user = me(req)
        return Response.json(ctx.db.list_oauth_accounts(user["id"]))

    @router.post("/api/v1/change-password")
    async def change_password(req: Request) -> Response:
        """Verify the old password then rehash; the caller's own account
        unless admin."""
        user = me(req)
        body = parse_body(vm.ChangePasswordRequest, req.json())
        target = body.username or user["username"]
        if target != user["username"] and user["role"] != "admin":
            raise HttpError(403, "cannot change another user's password")
        row = ctx.db.get_user(target)
        if row is None:
            raise HttpError(400, "user not found")
        if not A.verify_password(body.old_password, row["password_hash"]):
            raise HttpError(400, "current password is incorrect")
        ctx.db.set_user_password(target, A.hash_password(body.new_password))
        return Response.json(auth._public(ctx.db.get_user(target)))

    @router.get("/api/v1/users")
    async def list_users(req: Request) -> Response:
        auth.required_admin(req)
        return Response.json([auth._public(u) for u in ctx.db.list_users()])

    @router.delete("/api/v1/users/{uid}")
    async def delete_user(req: Request) -> Response:
        # admin only, and never the caller's own account
        user = auth.required_admin(req)
        uid = req.path_params["uid"]
        if uid == user["id"]:
            raise HttpError(400, "cannot delete your own account")
        if not ctx.db.delete_user(uid):
            raise HttpError(404, "user not found")
        return Response.no_content()

    @router.post("/api/v1/apikeys")
    async def create_key(req: Request) -> Response:
        user = me(req)
        body = parse_body(vm.ApiKeyCreate, req.json())
        return Response.json(ctx.db.create_api_key(user["id"], body.description),
                             status=201)

    @router.get("/api/v1/apikeys")
    async def list_keys(req: Request) -> Response:
        user = me(req)
        return Response.json(ctx.db.list_api_keys(user["id"]))

    @router.delete("/api/v1/apikeys/{kid}")
    async def delete_key(req: Request) -> Response:
        user = me(req)
        if not ctx.db.delete_api_key(req.path_params["kid"], user["id"]):
            raise HttpError(404, "api key not found")
        return Response.no_content()

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

    # -- direct sharing (reference api/collections.py:62-120) -------------------

    @router.post("/api/v1/collections/{cid}/shares")
    async def share_collection(req: Request) -> Response:
        user = me(req)
        collections.get(user["username"], req.path_params["cid"],
                        allow_shared=False)
        b = req.json()
        target = b.get("username", "")
        if not target or ctx.db.get_user(target) is None:
            raise HttpError(422, f"unknown user {target!r}")
        return Response.json(
            ctx.db.share_collection(req.path_params["cid"], target,
                                    user["username"]),
            status=201,
        )

    @router.get("/api/v1/collections/{cid}/shares")
    async def list_shares(req: Request) -> Response:
        user = me(req)
        collections.get(user["username"], req.path_params["cid"],
                        allow_shared=False)
        return Response.json(
            ctx.db.list_collection_shares(req.path_params["cid"])
        )

    @router.delete("/api/v1/collections/{cid}/shares/{target}")
    async def unshare_collection(req: Request) -> Response:
        user = me(req)
        collections.get(user["username"], req.path_params["cid"],
                        allow_shared=False)
        ctx.db.unshare_collection(req.path_params["cid"],
                                  req.path_params["target"])
        return Response.no_content()

    @router.get("/api/v1/collections/shared-with-me")
    async def shared_with_me(req: Request) -> Response:
        user = me(req)
        return Response.json(ctx.db.list_shared_collections(user["username"]))

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

    @router.post("/api/v1/collections/{cid}/searches/image")
    async def image_search(req: Request) -> Response:
        """Image -> image retrieval over the collection's vision rows (the
        perceptual image embedder, ``models/image_embedder.py``)."""
        user = me(req)
        cid = req.path_params["cid"]
        coll = collections.get(user["username"], cid)
        b = parse_body(vm.ImageSearchRequest, req.json())
        try:
            blob = base64.b64decode(b.image_base64)
        except (binascii.Error, ValueError) as e:
            raise HttpError(422, "invalid base64") from e
        engine = ctx.engines.get(cid, coll["config"])
        dim = engine.image_query_dim()
        try:
            # the decode is pure-Python host work: it runs in a worker
            # subprocess, where it holds neither the event loop nor the
            # GIL that the device worker's searches need
            q = None if dim is None else await asyncio.get_running_loop(
            ).run_in_executor(None, ctx.embed_image, blob, dim)
        except UnsupportedImageError as e:
            raise HttpError(415, str(e)) from e
        search = functools.partial(engine.search_image_vector, q, top_k=b.top_k)
        hits = await ctx.batcher.run(search) if ctx.batcher else search()
        return Response.json({
            "items": [
                {"text": h.text, "score": h.score,
                 "asset_id": h.metadata.get("asset_id"),
                 "document_id": h.metadata.get("document_id"),
                 "recall_type": h.recall_type}
                for h in hits
            ]
        }, status=201)

    @router.get("/api/v1/collections/{cid}/assets/{asset_id}")
    async def get_asset(req: Request) -> Response:
        """Serve an extracted image asset (vision index preview)."""
        user = me(req)
        cid = req.path_params["cid"]
        collections.get(user["username"], cid)
        asset_id = req.path_params["asset_id"]
        if not safe_object_name(asset_id):
            raise HttpError(404, "asset not found")
        rows = ctx.db.query(
            "SELECT id FROM document WHERE collection_id=?", (cid,)
        )
        for r in rows:
            path = f"assets/{r['id']}/{asset_id}"
            try:
                data = ctx.objects.get(path)
            except (FileNotFoundError, KeyError):
                continue
            mime = "image/jpeg" if data[:2] == b"\xff\xd8" else "image/png"
            return Response(status=200, body=data,
                            headers={"Content-Type": mime})
        raise HttpError(404, "asset not found")

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
                if supported_archive(part["filename"]):
                    # an archive expands into one document per member
                    for member, data in iter_archive(part["filename"],
                                                     part["data"]):
                        created.append(
                            documents.create(user["username"], cid,
                                             member, data)
                        )
                else:
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

    # two-phase upload: stage bytes, then confirm into the collection.
    # Staged keys are built from the client's file name and upload id,
    # so both are checked before they reach the object store.
    @router.post("/api/v1/collections/{cid}/documents/upload")
    async def stage_upload(req: Request) -> Response:
        user = me(req)
        cid = req.path_params["cid"]
        collections.get(user["username"], cid, allow_shared=False)
        parts = [p for p in req.multipart() if p["filename"]]
        limit = ctx.cfg.max_document_size_mb * 1024 * 1024
        for part in parts:  # the whole batch is checked before any put
            if not safe_object_name(part["filename"]):
                raise HttpError(422, "invalid document name")
            if len(part["data"]) > limit:
                raise HttpError(413, "document exceeds size limit")
        staged = []
        for part in parts:
            upload_id = uuid.uuid4().hex
            ctx.objects.put(f"_staged/{cid}/{upload_id}/{part['filename']}",
                            part["data"])
            staged.append({"upload_id": upload_id,
                           "name": part["filename"],
                           "size": len(part["data"])})
        if not staged:
            raise HttpError(422, "no files in upload")
        return Response.json(staged, status=201)

    @router.post("/api/v1/collections/{cid}/documents/confirm")
    async def confirm_upload(req: Request) -> Response:
        user = me(req)
        cid = req.path_params["cid"]
        collections.get(user["username"], cid, allow_shared=False)
        body = req.json()
        items = body if isinstance(body, list) else [body]
        created = []
        for item in items:
            upload_id = item.get("upload_id", "")
            name = item.get("name", "")
            if not safe_object_name(name):
                raise HttpError(422, "invalid document name")
            path = f"_staged/{cid}/{upload_id}/{name}"
            if not is_upload_id(upload_id) or not ctx.objects.exists(path):
                raise HttpError(404, f"staged upload {upload_id} not found")
            data = ctx.objects.get(path)
            created.append(
                documents.create(user["username"], cid, name, data,
                                 metadata=item.get("metadata"))
            )
            ctx.objects.delete(path)
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

    @router.post("/api/v1/documents/{did}/rebuild_indexes")
    async def rebuild_indexes(req: Request) -> Response:
        user = me(req)
        only_failed = req.query.get("only_failed", "") in ("1", "true")
        n = documents.rebuild_indexes(
            user["username"], req.path_params["did"], only_failed=only_failed
        )
        return Response.json({"rebuilt": n})

    @router.get("/api/v1/documents/{did}/preview")
    async def preview_document(req: Request) -> Response:
        user = me(req)
        doc = documents.get(user["username"], req.path_params["did"])
        return _stream_object(req, doc["object_path"],
                              {"X-Document-Name": doc["name"]})

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

    @router.delete("/api/v1/collections/{cid}/documents")
    async def delete_documents_bulk(req: Request) -> Response:
        user = me(req)
        cid = req.path_params["cid"]
        body = req.json()
        ids = body.get("document_ids", []) if isinstance(body, dict) else body
        if not isinstance(ids, list) or not ids:
            raise HttpError(422, "document_ids list required")
        # check the whole batch before deleting anything: a bad id
        # mid-list must not leave a half-deleted, unretryable batch
        for did in ids:
            _doc_in_collection(user, cid, did)
        deleted = documents.delete_many(user["username"], ids)
        return Response.json({"deleted": deleted})

    def _stream_object(req: Request, path: str,
                       extra_headers: Optional[dict] = None) -> Response:
        """RFC 7233 single-range streaming with Content-Range.  Invalid
        Range headers are ignored (full 200 body), suffix ranges
        (bytes=-N) serve the last N bytes, and every 206 carries
        Content-Range so clients can check offsets."""
        if not ctx.objects.exists(path):
            raise HttpError(404, "object not found")
        size = ctx.objects.obj_size(path)
        start, stop, status = 0, size, 200
        headers = {"Content-Type": "application/octet-stream",
                   "Accept-Ranges": "bytes", **(extra_headers or {})}
        rng = req.headers.get("range", "")
        if rng.startswith("bytes="):
            spec = rng[6:].split(",")[0].strip()
            s, _, e = spec.partition("-")
            try:
                if not s and e:  # suffix range: last N bytes
                    n = min(int(e), size)
                    cand = (size - n, size)
                else:
                    cand = (int(s), min(int(e) + 1, size) if e else size)
                if 0 <= cand[0] < cand[1]:
                    start, stop = cand
                    status = 206
                    headers["Content-Range"] = \
                        f"bytes {start}-{stop - 1}/{size}"
            except ValueError:
                pass  # malformed Range: serve the full body (RFC 7233)
        # no Content-Length: a streamed response is chunked; Content-Range
        # carries offsets and the total size
        return Response(status=status, headers=headers,
                        stream=ctx.objects.stream_range(path, start, stop))

    def _asset_scoped_path(req: Request, doc: dict) -> str:
        """?path= must stay inside the document's own object directory;
        normalized first so '..' segments cannot escape it."""
        path = req.query.get("path", "") or doc["object_path"]
        path = posixpath.normpath(path.lstrip("/"))
        prefix = doc["object_path"].rsplit("/", 1)[0] + "/"
        if path != doc["object_path"] and not path.startswith(prefix):
            raise HttpError(403, "object path outside document scope")
        return path

    @router.get("/api/v1/collections/{cid}/documents/{did}/preview")
    async def preview_document_nested(req: Request) -> Response:
        user = me(req)
        doc = _doc_in_collection(user, req.path_params["cid"],
                                 req.path_params["did"])
        return _stream_object(req, doc["object_path"],
                              {"X-Document-Name": doc["name"]})

    @router.get("/api/v1/collections/{cid}/documents/{did}/object")
    async def document_object(req: Request) -> Response:
        """Raw object or asset download with Range support; ?path= selects
        an object stored beside the document."""
        user = me(req)
        doc = _doc_in_collection(user, req.path_params["cid"],
                                 req.path_params["did"])
        return _stream_object(req, _asset_scoped_path(req, doc))

    @router.post("/api/v1/collections/{cid}/documents/{did}/rebuild_indexes")
    async def rebuild_indexes_nested(req: Request) -> Response:
        user = me(req)
        doc = _doc_in_collection(user, req.path_params["cid"],
                                 req.path_params["did"])
        only_failed = req.query.get("only_failed", "") in ("1", "true")
        n = documents.rebuild_indexes(user["username"], doc["id"],
                                      only_failed=only_failed)
        return Response.json({"rebuilt": n})

    @router.post("/api/v1/collections/{cid}/rebuild_failed_indexes")
    async def rebuild_failed_indexes(req: Request) -> Response:
        user = me(req)
        cid = req.path_params["cid"]
        collections.get(user["username"], cid, allow_shared=False)
        total = 0
        for d in documents.list(user["username"], cid):
            total += documents.rebuild_indexes(user["username"], d["id"],
                                               only_failed=True,
                                               reconcile=False)
        ctx.reconciler.reconcile_all()  # one pass for the whole collection
        return Response.json({"rebuilt": total})

    @router.post("/api/v1/collections/{cid}/rebuild_indexes")
    async def rebuild_collection_indexes(req: Request) -> Response:
        """Re-drive every document's indexes."""
        user = me(req)
        cid = req.path_params["cid"]
        collections.get(user["username"], cid, allow_shared=False)
        only_failed = req.query.get("only_failed", "") in ("1", "true")
        n = 0
        for doc in ctx.db.list_documents(cid):
            n += ctx.db.rebuild_indexes(doc["id"], only_failed=only_failed)
        ctx.reconciler.reconcile_all()
        return Response.json({"rebuilt": n})

    # -- knowledge graph (reference api/collections.py:282-323) -------------------------

    def graph_of(req: Request) -> str:
        """The request's collection id, once the caller may read it and
        the knowledge graph exists."""
        user = me(req)
        collections.get(user["username"], req.path_params["cid"])
        if ctx.kg is None:
            raise HttpError(404, "knowledge graph not enabled")
        return req.path_params["cid"]

    @router.get("/api/v1/collections/{cid}/graph/labels")
    async def graph_labels(req: Request) -> Response:
        cid = graph_of(req)
        return Response.json(ctx.kg.labels(cid))

    @router.get("/api/v1/collections/{cid}/graph")
    async def graph_subgraph(req: Request) -> Response:
        cid = graph_of(req)
        return Response.json(ctx.kg.subgraph(
            cid, req.query.get("node"), limit=int(req.query.get("limit", "200"))))

    # reference path dialect (api/collections.py:282+ uses /graphs) — same
    # handlers under the plural spelling
    router.add("GET", "/api/v1/collections/{cid}/graphs", graph_subgraph)
    router.add("GET", "/api/v1/collections/{cid}/graphs/labels", graph_labels)

    @router.get("/api/v1/collections/{cid}/graph/stats")
    async def graph_stats(req: Request) -> Response:
        cid = graph_of(req)
        return Response.json(ctx.kg.stats(cid))

    @router.post("/api/v1/collections/{cid}/graph/search")
    async def graph_search(req: Request) -> Response:
        """Combined recipe search: edge/node/episode/community scopes,
        configurable reranker, point-in-time ``as_of``, BFS origins
        (graphiti search.py:54-180 recipe surface)."""
        cid = graph_of(req)
        body = req.json()
        query = (body.get("query") or "").strip()
        if not query:
            raise HttpError(400, "query is required")
        return Response.json(ctx.kg.search_combined(
            cid, query,
            limit=int(body.get("limit", 5)),
            center_node=body.get("center_node"),
            rerank=body.get("rerank"),
            as_of=body.get("as_of"),
            bfs_origin_nodes=body.get("bfs_origin_nodes"),
            scopes=body.get("scopes"),
        ))

    @router.get("/api/v1/collections/{cid}/graph/nodes")
    async def graph_nodes(req: Request) -> Response:
        cid = graph_of(req)
        q = (req.query.get("q") or "").strip()
        if not q:
            raise HttpError(400, "q is required")
        return Response.json(ctx.kg.search_nodes(
            cid, q,
            top_k=int(req.query.get("limit", "5")),
            center_node=req.query.get("center_node"),
            rerank=req.query.get("rerank"),
        ))

    @router.get("/api/v1/collections/{cid}/graph/episodes")
    async def graph_episodes(req: Request) -> Response:
        cid = graph_of(req)
        q = (req.query.get("q") or "").strip()
        if not q:
            raise HttpError(400, "q is required")
        return Response.json(ctx.kg.search_episodes(
            cid, q,
            top_k=int(req.query.get("limit", "5")),
        ))

    @router.get("/api/v1/collections/{cid}/graph/expand")
    async def graph_expand(req: Request) -> Response:
        """BFS hop expansion from origin nodes (?node=A,B&depth=2)."""
        cid = graph_of(req)
        # comma-separated origins: ?node=Alice,Bob (the runtime's query
        # dict keeps one value per key)
        origins = [n.strip() for n in (req.query.get("node") or "").split(",")
                   if n.strip()]
        if not origins:
            raise HttpError(400, "node is required")
        as_of = req.query.get("as_of")
        return Response.json(ctx.kg.expand(
            cid, origins,
            max_depth=int(req.query.get("depth", "1")),
            as_of=float(as_of) if as_of else None,
        ))

    # -- marketplace ---------------------------------------------------------------------

    @router.post("/api/v1/collections/{cid}/publish")
    async def publish(req: Request) -> Response:
        user = me(req)
        collections.get(user["username"], req.path_params["cid"],
                        allow_shared=False)
        return Response.json(ctx.db.publish_collection(req.path_params["cid"]))

    @router.post("/api/v1/collections/{cid}/unpublish")
    async def unpublish(req: Request) -> Response:
        user = me(req)
        collections.get(user["username"], req.path_params["cid"],
                        allow_shared=False)
        ctx.db.unpublish_collection(req.path_params["cid"])
        return Response.json({"ok": True})

    @router.get("/api/v1/marketplace/collections")
    async def marketplace_list(req: Request) -> Response:
        me(req)
        return Response.json(ctx.db.list_marketplace())

    @router.post("/api/v1/marketplace/collections/{cid}/subscribe")
    async def subscribe(req: Request) -> Response:
        user = me(req)
        return Response.json(
            ctx.db.subscribe(user["username"], req.path_params["cid"])
        )

    @router.delete("/api/v1/marketplace/collections/{cid}/subscribe")
    async def unsubscribe(req: Request) -> Response:
        user = me(req)
        ctx.db.unsubscribe(user["username"], req.path_params["cid"])
        return Response.no_content()

    @router.get("/api/v1/marketplace/subscriptions")
    async def subscriptions(req: Request) -> Response:
        user = me(req)
        return Response.json(ctx.db.list_subscriptions(user["username"]))

    # reference path (api/marketplace.py): subscriptions listed under
    # /marketplace/collections/subscriptions
    router.add("GET", "/api/v1/marketplace/collections/subscriptions",
               subscriptions)

    # -- marketplace sharing status + read-only browsing (reference
    # api/collections.py:61-120 "sharing", api/marketplace_collections.py) --

    def _sharing_status(cid: str) -> dict:
        row = ctx.db.query_one(
            "SELECT * FROM marketplace WHERE collection_id=?", (cid,)
        )
        published = bool(row and row["status"] == "PUBLISHED")
        return {"is_published": published,
                "published_at": row["published_at"] if published else None}

    @router.get("/api/v1/collections/{cid}/sharing")
    async def sharing_status(req: Request) -> Response:
        user = me(req)
        collections.get(user["username"], req.path_params["cid"],
                        allow_shared=False)
        return Response.json(_sharing_status(req.path_params["cid"]))

    @router.post("/api/v1/collections/{cid}/sharing")
    async def sharing_publish(req: Request) -> Response:
        user = me(req)
        collections.get(user["username"], req.path_params["cid"],
                        allow_shared=False)
        ctx.db.publish_collection(req.path_params["cid"])
        return Response.json(_sharing_status(req.path_params["cid"]))

    @router.delete("/api/v1/collections/{cid}/sharing")
    async def sharing_unpublish(req: Request) -> Response:
        user = me(req)
        collections.get(user["username"], req.path_params["cid"],
                        allow_shared=False)
        ctx.db.unpublish_collection(req.path_params["cid"])
        return Response.json({"is_published": False, "published_at": None})

    def _published_collection(req: Request) -> dict:
        """Any authenticated user may read a PUBLISHED collection.  A
        soft-deleted collection is not browsable even if its marketplace
        row was left PUBLISHED."""
        cid = req.path_params["cid"]
        status = _sharing_status(cid)
        if not status["is_published"]:
            raise HttpError(404, "collection not published")
        coll = ctx.db.get_collection(cid)
        if coll is None or coll.get("status") != "ACTIVE":
            raise HttpError(404, "collection not found")
        coll["published_at"] = status["published_at"]
        return coll

    @router.get("/api/v1/marketplace/collections/{cid}")
    async def marketplace_collection_detail(req: Request) -> Response:
        me(req)
        coll = _published_collection(req)
        return Response.json(
            {k: coll[k] for k in ("id", "title", "description",
                                  "published_at")}
            | {"owner": coll["user"]}
        )

    @router.get("/api/v1/marketplace/collections/{cid}/documents")
    async def marketplace_collection_documents(req: Request) -> Response:
        me(req)
        coll = _published_collection(req)
        rows = [d for d in ctx.db.list_documents(coll["id"])
                if d.get("status") not in ("DELETED", "DELETING")]
        return Response.json(_paginate(req, rows))

    def _marketplace_document(req: Request) -> dict:
        coll = _published_collection(req)
        doc = ctx.db.get_document(req.path_params["did"])
        if (doc is None or doc["collection_id"] != coll["id"]
                or doc.get("status") in ("DELETED", "DELETING")):
            raise HttpError(404, "document not found")
        return doc

    @router.get("/api/v1/marketplace/collections/{cid}/documents/{did}/preview")
    async def marketplace_document_preview(req: Request) -> Response:
        me(req)
        doc = _marketplace_document(req)
        return _stream_object(req, doc["object_path"],
                              {"X-Document-Name": doc["name"]})

    @router.get("/api/v1/marketplace/collections/{cid}/documents/{did}/object")
    async def marketplace_document_object(req: Request) -> Response:
        # ?path= selects an asset, scoped as on the owner-facing route
        me(req)
        doc = _marketplace_document(req)
        return _stream_object(req, _asset_scoped_path(req, doc))

    @router.get("/api/v1/marketplace/collections/{cid}/graph")
    async def marketplace_collection_graph(req: Request) -> Response:
        me(req)
        coll = _published_collection(req)
        if ctx.kg is None:
            raise HttpError(404, "knowledge graph not enabled")
        return Response.json(
            ctx.kg.subgraph(coll["id"], req.query.get("node"),
                            limit=int(req.query.get("limit", "200")))
        )

    # -- prompt templates (reference prompt_template_service) --------------------------------------------

    @router.get("/api/v1/prompt-templates")
    async def list_prompt_templates_route(req: Request) -> Response:
        """Builtin role presets for the language + the user's custom
        templates (reference list_prompt_templates)."""
        user = me(req)
        language = req.query.get("language", "en-US")
        return Response.json(list_templates(
            language, db=ctx.db, username=user["username"]
        ))

    @router.post("/api/v1/prompt-templates")
    async def create_prompt_template_route(req: Request) -> Response:
        user = me(req)
        b = req.json()
        if not b.get("name") or not b.get("prompt"):
            raise HttpError(422, "name and prompt are required")
        try:
            row = ctx.db.create_prompt_template(
                user["username"], b["name"], b["prompt"],
                description=b.get("description", ""),
                language=b.get("language", "en-US"),
            )
        except Exception as e:  # noqa: BLE001 — unique(user,name,language)
            raise HttpError(409, f"template exists: {e}") from e
        return Response.json(row, status=201)

    @router.put("/api/v1/prompt-templates/{pid}")
    async def update_prompt_template_route(req: Request) -> Response:
        user = me(req)
        row = ctx.db.get_prompt_template(req.path_params["pid"])
        if row is None or row["user"] != user["username"]:
            raise HttpError(404, "template not found")
        ctx.db.update_prompt_template(req.path_params["pid"], **req.json())
        return Response.json(
            ctx.db.get_prompt_template(req.path_params["pid"])
        )

    @router.delete("/api/v1/prompt-templates/{pid}")
    async def delete_prompt_template_route(req: Request) -> Response:
        user = me(req)
        row = ctx.db.get_prompt_template(req.path_params["pid"])
        if row is None or row["user"] != user["username"]:
            raise HttpError(404, "template not found")
        ctx.db.delete_prompt_template(req.path_params["pid"])
        return Response.no_content()

    # -- llm providers ------------------------------------------------------------------------------------

    @router.get("/api/v1/llm_providers")
    async def list_providers(req: Request) -> Response:
        me(req)
        return Response.json(ctx.db.list_providers())

    @router.post("/api/v1/llm_providers")
    async def upsert_provider(req: Request) -> Response:
        me(req)
        b_ = parse_body(vm.LLMProviderCreate, req.json())
        b = b_.model_dump()
        ctx.db.upsert_provider(
            b["name"], b.get("label", ""), b.get("base_url", ""),
            b.get("api_type", "openai"),
        )
        return Response.json(ctx.db.get_provider(b["name"]), status=201)

    @router.delete("/api/v1/llm_providers/{name}")
    async def delete_provider(req: Request) -> Response:
        me(req)
        ctx.db.delete_provider(req.path_params["name"])
        return Response.no_content()

    @router.get("/api/v1/llm_providers/{name}/models")
    async def list_provider_models(req: Request) -> Response:
        me(req)
        return Response.json(ctx.db.list_models(req.path_params["name"]))

    @router.post("/api/v1/llm_providers/{name}/models")
    async def upsert_model(req: Request) -> Response:
        me(req)
        b = parse_body(vm.LLMProviderModelCreate, req.json())
        ctx.db.upsert_model(
            req.path_params["name"], b.api, b.model, b.context_window,
            b.max_tokens, b.tags,
        )
        return Response.json(ctx.db.list_models(req.path_params["name"]),
                             status=201)

    @router.post("/api/v1/llm_providers/{name}/key")
    async def set_provider_key(req: Request) -> Response:
        user = me(req)
        b = parse_body(vm.ProviderKeySet, req.json())
        ctx.db.set_provider_key(
            req.path_params["name"], user["username"], b.api_key
        )
        return Response.json({"ok": True})

    @router.get("/api/v1/llm_providers/{name}")
    async def get_provider(req: Request) -> Response:
        me(req)
        row = ctx.db.get_provider(req.path_params["name"])
        if row is None:
            raise HttpError(404, "provider not found")
        return Response.json(row)

    @router.put("/api/v1/llm_providers/{name}")
    async def update_provider(req: Request) -> Response:
        # reference api/llm.py:92 LlmProviderUpdateWithApiKey: dialect and
        # base-url fields plus an optional api_key in the same body
        user = me(req)
        body = req.json()
        api_key = body.pop("api_key", None)
        row = ctx.db.update_provider(req.path_params["name"], **{
            k: body.get(k) for k in (
                "label", "base_url", "api_type", "allow_custom_base_url",
                "completion_dialect", "embedding_dialect", "rerank_dialect",
            )
        })
        if row is None:
            raise HttpError(404, "provider not found")
        if api_key:
            ctx.db.set_provider_key(row["name"], user["username"], api_key)
        return Response.json(row)

    @router.get("/api/v1/llm_provider_models")
    async def list_all_models(req: Request) -> Response:
        # reference api/llm.py:115 flat model listing w/ optional provider
        me(req)
        return Response.json(
            ctx.db.list_models(req.query.get("provider_name") or None)
        )

    @router.put("/api/v1/llm_providers/{name}/models/{api}/{model:path}")
    async def update_model(req: Request) -> Response:
        me(req)
        p = req.path_params
        existing = [m for m in ctx.db.list_models(p["name"], p["api"])
                    if m["model"] == p["model"]]
        if not existing:
            raise HttpError(404, "model not found")
        body = req.json()
        cur = existing[0]
        ctx.db.upsert_model(
            p["name"], p["api"], p["model"],
            body.get("context_window", cur["context_window"]),
            body.get("max_tokens", cur["max_tokens"]),
            body.get("tags", cur["tags"]),
        )
        return Response.json(
            [m for m in ctx.db.list_models(p["name"], p["api"])
             if m["model"] == p["model"]][0]
        )

    @router.delete("/api/v1/llm_providers/{name}/models/{api}/{model:path}")
    async def delete_model(req: Request) -> Response:
        me(req)
        p = req.path_params
        ctx.db.delete_model(p["name"], p["api"], p["model"])
        return Response.no_content()

    @router.get("/api/v1/llm_configuration")
    async def llm_configuration(req: Request) -> Response:
        """Providers (api keys masked) + models in one payload (reference
        api/llm.py:61, llm_provider_service.get_llm_configuration)."""
        user = me(req)
        providers = []
        for p in ctx.db.list_providers():
            key = ctx.db.get_provider_key(p["name"], user["username"])
            p["api_key"] = (key[:4] + "****" + key[-4:]) if key and len(key) > 8 \
                else ("****" if key else None)
            providers.append(p)
        return Response.json({"providers": providers,
                              "models": ctx.db.list_models()})

    _SCENARIOS = (
        "default_for_collection_completion",
        "default_for_agent_completion",
        "default_for_embedding",
        "default_for_rerank",
        "default_for_background_task",
    )

    def _default_models_payload() -> dict:
        items = []
        for scenario in _SCENARIOS:
            models = ctx.db.list_models(tag=scenario)
            items.append({
                "scenario": scenario,
                "provider_name": models[0]["provider"] if models else None,
                "model": models[0]["model"] if models else None,
            })
        return {"items": items}

    @router.get("/api/v1/default_models")
    async def get_default_models(req: Request) -> Response:
        me(req)
        return Response.json(_default_models_payload())

    @router.put("/api/v1/default_models")
    async def put_default_models(req: Request) -> Response:
        """Defaults are stored as scenario tags on the chosen model, exactly
        the reference mechanism (default_model_service.py:94-160)."""
        me(req)
        body = req.json()
        for cfg in body.get("defaults", []):
            scenario = cfg.get("scenario")
            if scenario not in _SCENARIOS:
                raise HttpError(422, f"unknown scenario {scenario!r}")
            # clear the tag everywhere, then set it on the named model
            for m in ctx.db.list_models(tag=scenario):
                m["tags"].remove(scenario)
                ctx.db.upsert_model(m["provider"], m["api"], m["model"],
                                    m["context_window"], m["max_tokens"],
                                    m["tags"])
            if cfg.get("provider_name") and cfg.get("model"):
                hits = [m for m in ctx.db.list_models(cfg["provider_name"])
                        if m["model"] == cfg["model"]]
                if not hits:
                    raise HttpError(404, f"model {cfg['model']} not found")
                m = hits[0]
                ctx.db.upsert_model(m["provider"], m["api"], m["model"],
                                    m["context_window"], m["max_tokens"],
                                    m["tags"] + [scenario])
        return Response.json(_default_models_payload())

    @router.post("/api/v1/available_models")
    async def available_models_filtered(req: Request) -> Response:
        """Tag-filtered model listing (reference api/llm.py:30; empty body
        means the "recommend"-tagged set, OR across conditions, AND within)."""
        me(req)
        try:
            body = req.json() or {}
        except HttpError:
            body = {}
        conds = body.get("tag_filters") or [{"operation": "AND",
                                             "tags": ["recommend"]}]
        out = []
        for m in ctx.db.list_models():
            tags = set(m["tags"])
            for c in conds:
                want = set(c.get("tags", []))
                op = (c.get("operation") or "AND").upper()
                if (op == "AND" and want <= tags) or \
                        (op == "OR" and want & tags):
                    out.append(m)
                    break
        return Response.json({"items": out})

    @router.get("/api/v1/llm/available_models")
    async def available_models(req: Request) -> Response:
        me(req)
        tag = req.query.get("tag")
        return Response.json(ctx.db.list_models(tag=tag))

    @router.get("/api/v1/llm/default_models")
    async def default_models(req: Request) -> Response:
        """Per-scenario defaults (reference default_model_service.py)."""
        me(req)
        out = {}
        for scenario, tag in (
            ("collection_completion", R.TAG_COLLECTION_COMPLETION),
            ("agent_completion", R.TAG_AGENT_COMPLETION),
            ("embedding", R.TAG_EMBEDDING),
            ("rerank", R.TAG_RERANK),
            ("background", R.TAG_BACKGROUND),
        ):
            models = ctx.db.list_models(tag=tag)
            out[scenario] = (
                {"provider": models[0]["provider"], "model": models[0]["model"]}
                if models else None
            )
        return Response.json(out)

    # -- embeddings serving (OpenAI-compatible; the on-device encoder exposed
    # as a provider other systems can point at) ---------------------------------

    @router.post("/v1/embeddings")
    async def serve_embeddings(req: Request) -> Response:
        user = auth.resolve(req)
        if user is None:
            raise HttpError(401, "authentication required")
        b = req.json()
        texts = b.get("input", [])
        if isinstance(texts, str):
            texts = [texts]
        if not texts or len(texts) > 2048:
            raise HttpError(422, "input must be 1..2048 texts")
        cid = b.get("model", "")  # model name = collection id (its embedder)
        coll = ctx.db.get_collection(cid) if cid else None
        # the collection's own engine's embedder (the JAX app builds a new
        # one from the same config per request: the same vectors)
        embedder = (ctx.engines.get(cid, coll["config"]).embedder
                    if coll is not None else ctx.engines._embedder_factory({}))
        vecs = embedder.embed(list(texts))
        if isinstance(vecs, torch.Tensor):
            vecs = vecs.float().cpu().numpy()
        vecs = np.asarray(vecs)
        return Response.json({
            "object": "list",
            "model": cid or "hash-embedder",
            "data": [
                {"object": "embedding", "index": i, "embedding": v.tolist()}
                for i, v in enumerate(vecs)
            ],
            "usage": {"prompt_tokens": sum(len(t.split()) for t in texts),
                      "total_tokens": sum(len(t.split()) for t in texts)},
        })

    # -- workflows -----------------------------------------------------------------------------------

    @router.post("/api/v1/workflows")
    async def create_workflow(req: Request) -> Response:
        user = me(req)
        raw = req.json()
        if "definition" in (raw or {}):
            parse_body(vm.WorkflowDefinition, raw["definition"])
        body = raw or {}
        return Response.json(
            workflows.create(
                user["username"], body.get("title", "workflow"),
                body.get("definition", body.get("graph", {})),
                body.get("description", ""),
            ),
            status=201,
        )

    @router.get("/api/v1/workflows")
    async def list_workflows(req: Request) -> Response:
        user = me(req)
        return Response.json(workflows.list(user["username"]))

    @router.get("/api/v1/workflows/{wid}")
    async def get_workflow(req: Request) -> Response:
        user = me(req)
        return Response.json(workflows.get(user["username"],
                                           req.path_params["wid"]))

    @router.put("/api/v1/workflows/{wid}")
    async def update_workflow(req: Request) -> Response:
        user = me(req)
        body = req.json()
        return Response.json(
            workflows.update_definition(
                user["username"], req.path_params["wid"],
                body.get("definition", {}),
            )
        )

    @router.delete("/api/v1/workflows/{wid}")
    async def delete_workflow(req: Request) -> Response:
        # reference api/workflow.py:53
        user = me(req)
        workflows.delete(user["username"], req.path_params["wid"])
        return Response.no_content()

    @router.get("/api/v1/workflows/{wid}/versions")
    async def workflow_versions(req: Request) -> Response:
        user = me(req)
        return Response.json(workflows.versions(user["username"],
                                                req.path_params["wid"]))

    @router.post("/api/v1/workflows/{wid}/versions")
    async def create_workflow_version(req: Request) -> Response:
        # reference api/workflow.py:63 — snapshot a version (manual save)
        user = me(req)
        body = req.json() or {}
        return Response.json(
            workflows.create_version(user["username"], req.path_params["wid"],
                                     body.get("definition")),
            status=201,
        )

    @router.get("/api/v1/workflows/{wid}/versions/{version}")
    async def workflow_version_detail(req: Request) -> Response:
        user = me(req)
        try:
            version = int(req.path_params["version"])
        except ValueError:
            raise HttpError(422, "version must be an integer")
        return Response.json(
            workflows.version_detail(user["username"],
                                     req.path_params["wid"], version)
        )

    @router.get("/api/v1/workflows/{wid}/runs/{rid}")
    async def workflow_run_nested(req: Request) -> Response:
        # reference nests run detail under the workflow (api/workflow.py)
        user = me(req)
        run = workflows.run_detail(user["username"], req.path_params["rid"])
        if run.get("workflow_id") != req.path_params["wid"]:
            raise HttpError(404, "run not found for this workflow")
        return Response.json(run)

    @router.post("/api/v1/workflows/{wid}/run")
    async def run_workflow(req: Request) -> Response:
        user = me(req)
        body = req.json()
        return Response.json(
            await workflows.run(user["username"], req.path_params["wid"],
                                body.get("inputs", body))
        )

    @router.get("/api/v1/workflows/{wid}/runs")
    async def workflow_runs(req: Request) -> Response:
        user = me(req)
        return Response.json(workflows.runs(user["username"],
                                            req.path_params["wid"]))

    @router.get("/api/v1/workflow-runs/{rid}")
    async def workflow_run_detail(req: Request) -> Response:
        user = me(req)
        return Response.json(workflows.run_detail(user["username"],
                                                  req.path_params["rid"]))

    @router.post("/api/v1/workflows/run")
    async def run_workflow_once(req: Request) -> Response:
        user = me(req)
        body = req.json()
        return Response.json(
            await workflows.run_definition(
                user["username"],
                body.get("definition", body.get("workflow", {})),
                body.get("inputs", {}),
            )
        )

    @router.post("/api/v1/workflows/run/stream")
    async def run_workflow_stream(req: Request) -> Response:
        """SSE stream of node events + final result (reference
        flow_service SSE)."""
        user = me(req)
        body = req.json()

        async def events():
            async for ev in workflows.run_definition_streaming(
                user["username"],
                body.get("definition", body.get("workflow", {})),
                body.get("inputs", {}),
            ):
                yield {"event": ev.get("event", "EVENT"), "data": ev}

        return Response.sse(events())

    # -- nodeflow catalog ---------------------------------------------------------------------------------

    @router.get("/api/v1/nodeflow/node-types")
    async def node_types(req: Request) -> Response:
        return Response.json(node_type_catalog())

    @router.get("/api/v1/nodeflow/packs")
    async def nodeflow_packs(req: Request) -> Response:
        """Installed/installable node packs (reference api/nodeflow.py:21)."""
        return Response.json(registry_summary())

    # -- audit ---------------------------------------------------------------------------------------

    @router.get("/api/v1/audit_logs")
    async def audit_logs(req: Request) -> Response:
        user = auth.required(req)
        limit = int(req.query.get("limit", "100"))
        offset = int(req.query.get("offset", "0"))
        who = None if user["role"] == "admin" else user["username"]
        return Response.json(ctx.db.list_audit(who, limit, offset))

    @router.get("/api/v1/audit_logs/{aid}")
    async def audit_detail(req: Request) -> Response:
        user = auth.required(req)
        row = ctx.db.get_audit(int(req.path_params["aid"]))
        if row is None or (
            user["role"] != "admin" and row["user"] != user["username"]
        ):
            raise HttpError(404, "audit record not found")
        return Response.json(row)

    # reference path dialect (api/audit.py:18,105 uses hyphens)
    router.add("GET", "/api/v1/audit-logs", audit_logs)
    router.add("GET", "/api/v1/audit-logs/{aid}", audit_detail)

    # -- agents (bots) ---------------------------------------------------------------------------------

    @router.post("/api/v1/agents")
    async def create_agent(req: Request) -> Response:
        user = me(req)
        b = parse_body(vm.AgentCreate, req.json())
        return Response.json(
            ctx.db.create_agent(user["username"], b.title,
                                b.description, b.config),
            status=201,
        )

    @router.get("/api/v1/agents")
    async def list_agents(req: Request) -> Response:
        user = me(req)
        return Response.json(ctx.db.list_agents(user["username"]))

    def _owned_agent(req: Request, user: dict) -> dict:
        a = ctx.db.get_agent(req.path_params["aid"])
        if a is None or a["user"] != user["username"]:
            raise HttpError(404, "agent not found")
        return a

    @router.get("/api/v1/agents/{aid}")
    async def get_agent(req: Request) -> Response:
        user = me(req)
        return Response.json(_owned_agent(req, user))

    @router.put("/api/v1/agents/{aid}")
    async def update_agent(req: Request) -> Response:
        user = me(req)
        a = _owned_agent(req, user)
        b = parse_body(vm.AgentUpdate, req.json())
        allowed = b.model_dump(exclude_none=True)
        if allowed:
            ctx.db.update_agent(a["id"], **allowed)
        return Response.json(ctx.db.get_agent(a["id"]))

    @router.delete("/api/v1/agents/{aid}")
    async def delete_agent(req: Request) -> Response:
        user = me(req)
        a = _owned_agent(req, user)
        ctx.db.delete_agent(a["id"])
        return Response.no_content()

    def _agent_collections(agent: dict) -> list[str]:
        return list(agent.get("config", {}).get("collection_ids", []))

    # -- agent-scoped chat CRUD (reference api/chat.py:27-73,260) ------------

    def _agent_chat(req: Request, user: dict) -> dict:
        agent = _owned_agent(req, user)
        chat = chats.get(user["username"], req.path_params["chat_id"])
        if chat.get("bot_id") != agent["id"]:
            raise HttpError(404, "chat not found for this agent")
        return chat

    @router.post("/api/v1/agents/{aid}/chats")
    async def create_agent_chat(req: Request) -> Response:
        user = me(req)
        agent = _owned_agent(req, user)
        b = req.json() or {}
        chat = ctx.db.create_chat(user["username"], b.get("title", ""),
                                  bot_id=agent["id"])
        ctx.db.update_chat(chat["id"], peer_type="agent")
        return Response.json(ctx.db.get_chat(chat["id"]), status=201)

    @router.get("/api/v1/agents/{aid}/chats")
    async def list_agent_chats(req: Request) -> Response:
        user = me(req)
        agent = _owned_agent(req, user)
        rows = [c for c in chats.list(user["username"])
                if c.get("bot_id") == agent["id"]]
        return Response.json(_paginate(req, rows))

    @router.get("/api/v1/agents/{aid}/chats/{chat_id}")
    async def get_agent_chat(req: Request) -> Response:
        user = me(req)
        chat = _agent_chat(req, user)
        chat["messages"] = chats.messages(user["username"], chat["id"])
        return Response.json(chat)

    @router.put("/api/v1/agents/{aid}/chats/{chat_id}")
    async def update_agent_chat(req: Request) -> Response:
        user = me(req)
        chat = _agent_chat(req, user)
        b = req.json()
        return Response.json(
            chats.update(user["username"], chat["id"], title=b.get("title"))
        )

    @router.delete("/api/v1/agents/{aid}/chats/{chat_id}")
    async def delete_agent_chat(req: Request) -> Response:
        user = me(req)
        chat = _agent_chat(req, user)
        chats.delete(user["username"], chat["id"])
        return Response.no_content()

    @router.post("/api/v1/agents/{aid}/chats/{chat_id}/messages/{mid}")
    async def agent_message_feedback(req: Request) -> Response:
        # reference Feedback body: {type, tag, message} (api/chat.py:61-73)
        user = me(req)
        chat = _agent_chat(req, user)
        b = req.json()
        chats.feedback(user["username"], chat["id"], req.path_params["mid"],
                       b.get("type", b.get("feedback")))
        return Response.json({"ok": True})

    @router.post("/api/v1/agents/{aid}/chats/{chat_id}/title")
    async def agent_chat_title(req: Request) -> Response:
        user = me(req)
        chat = _agent_chat(req, user)
        out = await chats.generate_title(user["username"], chat["id"])
        return Response.json({"id": out["id"], "title": out["title"]})

    async def _ws_turns(ws: WebSocket, turn) -> None:
        """A WebSocket's turns: each user frame's events through ``pump``,
        so that a stop or cancel frame ends the turn in flight; ``turn``
        maps a frame and its text to ``(events, on_events)``."""
        inbox: asyncio.Queue = asyncio.Queue()
        reader = start_reader(ws, inbox)
        leftover: list[dict] = []
        try:
            while True:
                msg = await next_message(inbox, leftover)
                if msg is None:
                    return
                text = msg.get("message", msg.get("query", ""))
                if not text:
                    await ws.send_json({"event": "error",
                                        "data": "empty message"})
                    continue
                events, finish = turn(msg, text)
                sent: list[dict] = []

                async def send(event):
                    sent.append(event)
                    await ws.send_json(event)

                outcome, extra = await pump(events, inbox, send)
                leftover.extend(extra)
                finish(sent)
                if outcome == "closed":
                    return
        finally:
            reader.cancel()

    @router.websocket("/api/v1/agents/{aid}/chats/{chat_id}/connect")
    async def agent_chat_ws(req: Request, ws: WebSocket) -> None:
        """Agent tool-loop chat over WebSocket (reference api/chat.py:75)."""
        user = auth.resolve(req)
        if user is None:
            await ws.send_json({"event": "error", "data": "unauthorized"})
            return
        agent = ctx.db.get_agent(req.path_params["aid"])
        if agent is None or agent["user"] != user["username"]:
            await ws.send_json({"event": "error", "data": "agent not found"})
            return
        chat_id = req.path_params["chat_id"]
        # ownership before any message is written: an id that exists must
        # belong to the caller (an unknown id is an ephemeral agent chat)
        existing = ctx.db.get_chat(chat_id)
        if existing is not None and existing["user"] != user["username"]:
            await ws.send_json({"event": "error", "data": "chat not found"})
            return
        session = agent_sessions.get(user["username"], chat_id,
                                     _agent_collections(agent),
                                     agent_config=agent.get("config"))

        def turn(msg: dict, text: str):
            ctx.db.add_chat_message(chat_id, "user",
                                    [{"type": "text", "text": text}])

            def finish(sent: list) -> None:
                final = ""
                for event in sent:
                    if event.get("event") == "done":
                        final = event["data"].get("text", "")
                if final:
                    ctx.db.add_chat_message(
                        chat_id, "assistant", [{"type": "text", "text": final}])

            return session.run(text), finish

        await _ws_turns(ws, turn)

    @router.post("/api/v1/agents/{aid}/chats/{chat_id}/ag-ui")
    async def agent_ag_ui(req: Request) -> Response:
        """AG-UI protocol SSE endpoint (reference api/chat.py:150)."""
        user = me(req)
        agent = _owned_agent(req, user)
        existing = ctx.db.get_chat(req.path_params["chat_id"])
        if existing is not None and existing["user"] != user["username"]:
            raise HttpError(404, "chat not found")
        b = req.json()
        text = b.get("message", "")
        if not text:
            raise HttpError(422, "message required")
        session = agent_sessions.get(
            user["username"], req.path_params["chat_id"],
            _agent_collections(agent),
            agent_config=agent.get("config"),
        )
        return Response.sse(to_ag_ui(session.run(text)))

    # -- web search ---------------------------------------------------------------------------------------
    # a middleware may put a WebSearchService of its own into
    # req.state["web"] (the tests' stub web); else each request makes one

    @router.post("/api/v1/web/search")
    async def web_search(req: Request) -> Response:
        me(req)
        b = parse_body(vm.WebSearchRequest, req.json())
        if not b.query.strip() and not (b.source or "").strip():
            raise HttpError(422, "query or source is required")
        svc = req.state.get("web") or WebSearchService()
        results = svc.search(b.query, max_results=b.max_results,
                             providers=b.providers, source=b.source)
        return Response.json({"results": results,
                              "offline": len(results) == 0})

    @router.post("/api/v1/web/read")
    async def web_read(req: Request) -> Response:
        me(req)
        b = req.json()
        urls = b.get("urls") or ([b["url"]] if b.get("url") else [])
        if not urls:
            raise HttpError(422, "urls required")
        svc = req.state.get("web") or WebSearchService()
        return Response.json({"pages": svc.read(urls)})

    # -- chats ------------------------------------------------------------------------------------------------

    @router.post("/api/v1/chats")
    async def create_chat(req: Request) -> Response:
        user = me(req)
        b = parse_body(vm.ChatCreate, req.json())
        return Response.json(
            chats.create(user["username"], b.title,
                         b.collection_ids or None),
            status=201,
        )

    @router.get("/api/v1/chats")
    async def list_chats(req: Request) -> Response:
        user = me(req)
        return Response.json(_paginate(req, chats.list(user["username"])))

    @router.get("/api/v1/chats/{chat_id}")
    async def get_chat(req: Request) -> Response:
        user = me(req)
        chat = chats.get(user["username"], req.path_params["chat_id"])
        chat["messages"] = chats.messages(user["username"], chat["id"])
        return Response.json(chat)

    @router.put("/api/v1/chats/{chat_id}")
    async def update_chat(req: Request) -> Response:
        user = me(req)
        b = req.json()
        return Response.json(
            chats.update(user["username"], req.path_params["chat_id"],
                         title=b.get("title"))
        )

    @router.delete("/api/v1/chats/{chat_id}")
    async def delete_chat(req: Request) -> Response:
        user = me(req)
        chats.delete(user["username"], req.path_params["chat_id"])
        return Response.no_content()

    @router.post("/api/v1/chats/{chat_id}/documents")
    async def upload_chat_file(req: Request) -> Response:
        """Chat-scoped upload (reference api/chat.py:358)."""
        user = me(req)
        created = []
        for part in req.multipart():
            if part["filename"]:
                created.append(
                    chats.upload_chat_file(
                        user["username"], req.path_params["chat_id"],
                        part["filename"], part["data"],
                    )
                )
        if not created:
            raise HttpError(422, "no files in upload")
        return Response.json(created, status=201)

    @router.get("/api/v1/chats/{chat_id}/documents/{did}")
    async def chat_document_detail(req: Request) -> Response:
        # reference api/chat.py:369 chat file detail
        user = me(req)
        return Response.json(
            chats.chat_document(user["username"], req.path_params["chat_id"],
                                req.path_params["did"])
        )

    @router.post("/api/v1/chats/{chat_id}/files/search")
    async def search_chat_files(req: Request) -> Response:
        """Chat-file search (reference api/chat.py:311)."""
        user = me(req)
        b = req.json()
        if not b.get("query"):
            raise HttpError(422, "query required")
        return Response.json(
            await chats.search_chat_files(
                user["username"], req.path_params["chat_id"], b["query"],
                top_k=b.get("top_k", 5),
            )
        )

    # reference path dialect (api/chat.py:311 mounts chat-file search at
    # /chats/{chat_id}/search)
    router.add("POST", "/api/v1/chats/{chat_id}/search", search_chat_files)

    @router.post("/api/v1/chats/{chat_id}/messages/{mid}/feedback")
    async def message_feedback(req: Request) -> Response:
        user = me(req)
        b = req.json()
        chats.feedback(user["username"], req.path_params["chat_id"],
                       req.path_params["mid"], b.get("feedback"))
        return Response.json({"ok": True})

    @router.post("/api/v1/chats/{chat_id}/title")
    async def generate_chat_title(req: Request) -> Response:
        """Explicit title generation (reference api/chat.py:260)."""
        user = me(req)
        chat = await chats.generate_title(user["username"],
                                          req.path_params["chat_id"])
        return Response.json({"id": chat["id"], "title": chat["title"]})

    @router.post("/api/v1/chat/completions/frontend")
    async def frontend_completions(req: Request) -> Response:
        """Reference api/chat.py:281: message in body (JSON or raw text),
        chat_id/stream in query params.  Streams SSE when stream=true,
        otherwise returns the final text in one JSON payload."""
        user = me(req)
        try:
            b = req.json()
            text = b.get("message", "") if isinstance(b, dict) else str(b)
        except HttpError:
            text = req.body.decode("utf-8", "replace")
        if not text:
            raise HttpError(422, "message required")
        chat_id = req.query.get("chat_id", "")
        if not chat_id:
            chat_id = chats.create(user["username"], title="")["id"]
        stream = req.query.get("stream", "false").lower() == "true"
        events = chats.process_message(user["username"], chat_id, text)
        if stream:
            return Response.sse(events)
        parts, msg_id = [], ""
        async for ev in events:
            if ev.get("event") == "delta":
                parts.append(ev["data"].get("text", ""))
            elif ev.get("event") == "done":
                msg_id = ev["data"].get("message_id", "")
        return Response.json({"chat_id": chat_id, "message_id": msg_id,
                              "text": "".join(parts)})

    @router.post("/api/v1/chats/{chat_id}/completions")
    async def chat_completions(req: Request) -> Response:
        """SSE chat completion (reference frontend_chat_completions)."""
        user = me(req)
        b = req.json()
        text = b.get("message", b.get("query", ""))
        if not text:
            raise HttpError(422, "message required")
        events = chats.process_message(
            user["username"], req.path_params["chat_id"], text,
            collection_ids=b.get("collection_ids"),
        )
        return Response.sse(events)

    @router.websocket("/api/v1/chats/{chat_id}/connect")
    async def chat_ws(req: Request, ws: WebSocket) -> None:
        """WebSocket chat (reference api/chat.py:75-105)."""
        user = auth.resolve(req)
        if user is None:
            await ws.send_json({"event": "error", "data": "unauthorized"})
            return
        chat_id = req.path_params["chat_id"]

        def turn(msg: dict, text: str):
            events = chats.process_message(
                user["username"], chat_id, text,
                collection_ids=msg.get("collection_ids"))
            return events, lambda sent: None

        await _ws_turns(ws, turn)

    return router
