"""MCP server: the platform's tools for agent LLMs, over JSON-RPC HTTP
(port of the JAX package's mcp/server.py).

Tools ``list_collections`` (subscriptions included), ``search_collection``,
``search_chat_files``, ``web_search`` and ``web_read``, and a usage-guide
prompt, on the MCP Streamable-HTTP wire shape (JSON-RPC 2.0 over
``POST /mcp``) without external SDKs.  The tools call the service layer
in-process: ``search_collection`` is the served hybrid query of
``CollectionService.execute_search`` (``dense_topk`` on the card, then
the reranker).  Tool arguments go through the REST contract model
(``schema/view_models.py SearchRequest``), so both surfaces refuse the
same payloads with the same messages.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from super_rag_tpu_torch.api.http import HttpError, Request, Response, Router
from super_rag_tpu_torch.schema.view_models import SearchRequest, parse_body
from super_rag_tpu_torch.service.collection_service import CollectionService
from super_rag_tpu_torch.service.context import AppContext
from super_rag_tpu_torch.websearch.service import WebSearchService

PROTOCOL_VERSION = "2025-03-26"

USAGE_GUIDE = """super-rag-tpu exposes document collections searchable by
hybrid dense+BM25 retrieval running on TPU. Call list_collections first,
then search_collection with a natural-language query. Results include
scored text chunks with document metadata. Use web_search/web_read for
fresh public information when collections lack coverage."""


def _tool_defs(web_enabled: bool) -> list[dict]:
    tools = [
        {
            "name": "list_collections",
            "description": "List the document collections available to you.",
            "inputSchema": {"type": "object", "properties": {}},
        },
        {
            "name": "search_collection",
            "description": (
                "Hybrid (dense + full-text) search over one collection; "
                "returns scored text chunks."
            ),
            "inputSchema": {
                "type": "object",
                "properties": {
                    "collection_id": {"type": "string"},
                    "query": {"type": "string"},
                    "top_k": {"type": "integer", "default": 5},
                    "use_rerank": {"type": "boolean", "default": True},
                },
                "required": ["collection_id", "query"],
            },
        },
        {
            "name": "search_chat_files",
            "description": "Search documents uploaded to a specific chat.",
            "inputSchema": {
                "type": "object",
                "properties": {
                    "collection_id": {"type": "string"},
                    "chat_id": {"type": "string"},
                    "query": {"type": "string"},
                    "top_k": {"type": "integer", "default": 5},
                },
                "required": ["collection_id", "chat_id", "query"],
            },
        },
    ]
    if web_enabled:
        tools += [
            {
                "name": "web_search",
                "description": "Search the public web.",
                "inputSchema": {
                    "type": "object",
                    "properties": {"query": {"type": "string"},
                                   "max_results": {"type": "integer",
                                                   "default": 5}},
                    "required": ["query"],
                },
            },
            {
                "name": "web_read",
                "description": "Fetch and extract readable text from URLs.",
                "inputSchema": {
                    "type": "object",
                    "properties": {"urls": {"type": "array",
                                            "items": {"type": "string"}}},
                    "required": ["urls"],
                },
            },
        ]
    return tools


class McpServer:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self.collections = CollectionService(ctx)
        # the web tools are listed while this is set (the JAX package leaves
        # it None where its httpx-based service fails to build)
        self.web: Optional[Any] = WebSearchService()

    # -- JSON-RPC dispatch -----------------------------------------------------

    async def handle(self, req: Request) -> Response:
        user = self.ctx.auth.resolve(req)
        try:
            msg = req.json()
        except HttpError:
            return Response.json(_rpc_error(None, -32700, "parse error"))
        if isinstance(msg, list):
            out = [await self._dispatch(m, user) for m in msg]
            out = [o for o in out if o is not None]
            return Response.json(out)
        result = await self._dispatch(msg, user)
        if result is None:  # notification
            return Response(status=202)
        return Response.json(result)

    async def _dispatch(self, msg: dict, user: Optional[dict]) -> Optional[dict]:
        mid = msg.get("id")
        method = msg.get("method", "")
        params = msg.get("params") or {}
        try:
            if method == "initialize":
                return _rpc_result(mid, {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}, "prompts": {}},
                    "serverInfo": {"name": "super-rag-tpu",
                                   "version": "0.1.0"},
                })
            if method in ("notifications/initialized", "initialized"):
                return None
            if method == "ping":
                return _rpc_result(mid, {})
            if method == "tools/list":
                return _rpc_result(
                    mid, {"tools": _tool_defs(self.web is not None)}
                )
            if method == "prompts/list":
                return _rpc_result(mid, {"prompts": [
                    {"name": "super_rag_usage_guide",
                     "description": "How to use the retrieval tools"},
                ]})
            if method == "prompts/get":
                return _rpc_result(mid, {
                    "messages": [{"role": "user",
                                  "content": {"type": "text",
                                              "text": USAGE_GUIDE}}]
                })
            if method == "tools/call":
                if user is None:
                    return _rpc_error(mid, -32001,
                                      "authentication required (API key)")
                result = await self._call_tool(
                    params.get("name", ""), params.get("arguments") or {}, user
                )
                return _rpc_result(mid, {
                    "content": [{"type": "text",
                                 "text": json.dumps(result, default=str)}],
                    "isError": False,
                })
            return _rpc_error(mid, -32601, f"method not found: {method}")
        except HttpError as e:
            return _rpc_error(mid, -32000, e.message)
        except Exception as e:  # noqa: BLE001
            return _rpc_error(mid, -32000, str(e))

    # -- tools ----------------------------------------------------------------------

    async def _call_tool(self, name: str, args: dict, user: dict) -> Any:
        username = user["username"]
        if name == "list_collections":
            cols = self.ctx.db.list_collections(username)
            subs = self.ctx.db.list_subscriptions(username)
            return {
                "collections": [
                    {"id": c["id"], "title": c["title"],
                     "description": c["description"]}
                    for c in cols
                ] + [
                    {"id": s["collection_id"], "title": s["title"],
                     "shared": True}
                    for s in subs
                ]
            }
        if name == "search_collection":
            # tool args share the REST contract model, so both surfaces
            # reject the same invalid payloads (schema/view_models.py)
            body = parse_body(SearchRequest, {
                "query": args.get("query", ""),
                **{k: v for k, v in args.items()
                   if k in ("top_k", "use_rerank", "chat_id")
                   and v is not None},
            })
            result = await self.collections.execute_search(
                username, args["collection_id"], body.query,
                top_k=body.top_k, use_rerank=body.use_rerank,
            )
            return result
        if name == "search_chat_files":
            body = parse_body(SearchRequest, {
                "query": args.get("query", ""),
                "chat_id": args["chat_id"],
                **{k: v for k, v in args.items()
                   if k == "top_k" and v is not None},
            })
            result = await self.collections.execute_search(
                username, args["collection_id"], body.query,
                top_k=body.top_k, chat_id=body.chat_id,
            )
            return result
        if name == "web_search" and self.web is not None:
            return {"results": self.web.search(
                args["query"], max_results=args.get("max_results", 5)
            )}
        if name == "web_read" and self.web is not None:
            return {"pages": self.web.read(args["urls"])}
        raise HttpError(404, f"unknown tool {name!r}")


def _rpc_result(mid, result) -> dict:
    return {"jsonrpc": "2.0", "id": mid, "result": result}


def _rpc_error(mid, code, message) -> dict:
    return {"jsonrpc": "2.0", "id": mid,
            "error": {"code": code, "message": message}}


def register_mcp_routes(router: Router, ctx: AppContext) -> None:
    server = McpServer(ctx)

    router.add("POST", "/mcp", server.handle)

    async def mcp_get(req: Request) -> Response:
        # Streamable HTTP GET opens an SSE channel; we have no
        # server-initiated messages, so reply 405 per spec option.
        raise HttpError(405, "SSE channel not supported; POST JSON-RPC")

    router.add("GET", "/mcp", mcp_get)
