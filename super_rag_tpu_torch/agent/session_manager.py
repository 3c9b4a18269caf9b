"""Agent session cache with expiry + platform tool bindings (port of the
JAX package's agent/session_manager.py).

Counterpart of the reference's session manager
(agent/agent_session_manager.py:20-200: module-level cache keyed by
user+chat+provider with a 30-minute expiry) and of MCPAppFactory (which
wires the agent to the app's own /mcp over HTTP — ours binds the same
tools in-process).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from super_rag_tpu_torch.agent.runtime import AgentSession, Tool, ToolRegistry

SESSION_TTL_S = 30 * 60  # reference expiry


def platform_tools(ctx, username: str, collection_ids: list[str]) -> ToolRegistry:
    """Bind the platform's MCP-equivalent tools for one user."""
    from super_rag_tpu_torch.service.collection_service import CollectionService

    collections = CollectionService(ctx)

    async def search_collections(query: str, top_k: int = 5,
                                 collection_id: Optional[str] = None):
        cids = [collection_id] if collection_id else collection_ids
        items = []
        for cid in cids:
            try:
                r = await collections.execute_search(username, cid, query,
                                                     top_k=top_k)
                items.extend(r["items"])
            except Exception:  # noqa: BLE001 — other collections still count
                continue
        items.sort(key=lambda d: -d["score"])
        return {"items": items[:top_k]}

    def list_collections():
        cols = ctx.db.list_collections(username)
        return {"collections": [
            {"id": c["id"], "title": c["title"]} for c in cols
        ]}

    def graph_search(query: str, collection_id: Optional[str] = None,
                     top_k: int = 5):
        if ctx.kg is None:
            return {"results": []}
        cids = [collection_id] if collection_id else collection_ids
        out = []
        for cid in cids:
            out.extend(ctx.kg.search(cid, query, top_k=top_k))
        return {"results": out[:top_k]}

    reg = ToolRegistry([
        Tool("search_collections",
             "Hybrid search over the chat's document collections",
             {"type": "object", "properties": {
                 "query": {"type": "string"},
                 "top_k": {"type": "integer"},
                 "collection_id": {"type": "string"}},
              "required": ["query"]},
             search_collections),
        Tool("list_collections", "List available collections",
             {"type": "object", "properties": {}}, list_collections),
        Tool("graph_search", "Search the knowledge graph for facts",
             {"type": "object", "properties": {
                 "query": {"type": "string"},
                 "collection_id": {"type": "string"},
                 "top_k": {"type": "integer"}},
              "required": ["query"]},
             graph_search),
    ])
    return reg


class AgentSessionManager:
    def __init__(self, ctx):
        self.ctx = ctx
        self._sessions: dict[tuple, tuple[AgentSession, float]] = {}
        self._lock = threading.Lock()

    def get(self, username: str, chat_id: str,
            collection_ids: list[str],
            agent_config: dict | None = None) -> AgentSession:
        key = (username, chat_id)
        now = time.time()
        with self._lock:
            entry = self._sessions.get(key)
            if entry and now - entry[1] < SESSION_TTL_S:
                self._sessions[key] = (entry[0], now)
                return entry[0]
            # per-agent prompt overrides (reference api/chat.py:180:
            # bot_config.agent.system_prompt_template / language)
            acfg = (agent_config or {}).get("agent", agent_config or {})
            tools = platform_tools(self.ctx, username, collection_ids)
            # progressive skills: built-ins (python sandbox, plan-execute
            # — the agent_pro analogs) + operator .skills/ markdown dir
            import os

            from super_rag_tpu_torch.agent.skills import (
                SkillLibrary,
                builtin_skills,
            )

            lib = SkillLibrary(builtin_skills(
                completion=self.ctx.completion, base_tools=tools,
            ))
            skills_dir = os.path.join(
                getattr(self.ctx.cfg, "data_dir", "."), ".skills"
            )
            for s in SkillLibrary.from_directory(skills_dir)._skills.values():
                lib.add(s)
            tools.add(lib.as_tool(tools))
            session = AgentSession(
                tools=tools,
                completion=self.ctx.completion,
                system_template=acfg.get("system_prompt_template"),
                language=acfg.get("language", "en-US"),
                skills=lib,
            )
            self._sessions[key] = (session, now)
            return session

    def evict_expired(self) -> int:
        now = time.time()
        with self._lock:
            stale = [k for k, (_, t) in self._sessions.items()
                     if now - t >= SESSION_TTL_S]
            for k in stale:
                del self._sessions[k]
        return len(stale)
