"""Chat service: sessions, history, and the RAG answer pipeline (port of
the JAX package's service/chat_service.py).

Counterpart of the reference's chat/agent services (chat_service.py,
agent_chat_service.py:474-567): per-message pipeline = persist user
message -> retrieve from the chat's collections -> build prompt with
history -> generate -> persist assistant message with references.  The
reference's generation is a remote MCP-agent tool loop; ours retrieves
in-process (one device program) and generates via the pluggable
completion client, falling back to an extractive answer when no LLM is
configured.  The completion client is called on the event loop's thread,
as the JAX package calls it: a slow provider holds every connection of
the app while it answers.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Optional

from super_rag_tpu_torch.api.http import HttpError
from super_rag_tpu_torch.llm.prompts import CHAT_ANSWER, CHAT_TITLE
from super_rag_tpu_torch.service.collection_service import CollectionService
from super_rag_tpu_torch.service.context import AppContext


class ChatService:
    def __init__(self, ctx: AppContext, collections: CollectionService):
        self.ctx = ctx
        self.collections = collections

    # -- CRUD -------------------------------------------------------------

    def create(self, user: str, title: str = "",
               collection_ids: Optional[list[str]] = None) -> dict:
        chat = self.ctx.db.create_chat(user, title)
        if collection_ids:
            self.ctx.db.update_chat(
                chat["id"], bot_id=",".join(collection_ids)
            )
            chat = self.ctx.db.get_chat(chat["id"])
        return chat

    def get(self, user: str, chat_id: str) -> dict:
        chat = self.ctx.db.get_chat(chat_id)
        if chat is None or chat["user"] != user or chat["status"] != "ACTIVE":
            raise HttpError(404, f"chat {chat_id} not found")
        return chat

    def list(self, user: str) -> list[dict]:
        return self.ctx.db.list_chats(user)

    def update(self, user: str, chat_id: str, title: Optional[str] = None) -> dict:
        """Rename a chat (reference ChatUpdate, api/chat.py:50-58)."""
        self.get(user, chat_id)
        if title is not None:
            self.ctx.db.update_chat(chat_id, title=title)
        return self.get(user, chat_id)

    def chat_document(self, user: str, chat_id: str, document_id: str) -> dict:
        """Chat file detail (reference api/chat.py:369-384): the document
        must live in the user's chat-files collection AND be bound to this
        chat via its chat_id column."""
        self.get(user, chat_id)
        doc = self.ctx.db.get_document(document_id)
        coll = self._chat_collection(user)
        if (doc is None or doc["collection_id"] != coll["id"]
                or doc.get("chat_id") != chat_id):
            raise HttpError(404, "document not found in this chat")
        return doc

    def delete(self, user: str, chat_id: str) -> None:
        self.get(user, chat_id)
        self.ctx.db.update_chat(chat_id, status="DELETED")

    def messages(self, user: str, chat_id: str) -> list[dict]:
        self.get(user, chat_id)
        return self.ctx.db.list_chat_messages(chat_id)

    def feedback(self, user: str, chat_id: str, message_id: str,
                 feedback: Optional[str]) -> None:
        self.get(user, chat_id)
        self.ctx.db.set_message_feedback(message_id, feedback)

    # -- message pipeline ------------------------------------------------------

    async def process_message(
        self, user: str, chat_id: str, text: str,
        collection_ids: Optional[list[str]] = None,
    ) -> AsyncIterator[dict]:
        """Yields events: start, references, delta(s), done."""
        chat = self.get(user, chat_id)
        self.ctx.db.add_chat_message(chat_id, "user", [{"type": "text",
                                                        "text": text}])
        if not chat.get("title"):
            self.ctx.db.update_chat(chat_id,
                                    title=await self._make_title(text))
        yield {"event": "start", "data": {"chat_id": chat_id}}

        cids = collection_ids or [
            c for c in (chat.get("bot_id") or "").split(",") if c
        ]
        references = []
        docs = []
        if cids:
            for cid in cids:
                try:
                    result = await self.collections.execute_search(
                        user, cid, text, chat_id=chat_id
                    )
                    docs.extend(result["items"])
                except HttpError:
                    continue
            docs.sort(key=lambda d: -d["score"])
            docs = docs[: self.ctx.cfg.default_top_k]
            references = [
                {"rank": i + 1, "score": d["score"], "text": d["text"][:300],
                 "metadata": d["metadata"]}
                for i, d in enumerate(docs)
            ]
        if references:
            yield {"event": "references", "data": references}

        history = self.ctx.db.list_chat_messages(chat_id, limit=8)
        answer = await self._generate(text, docs, history)
        # stream in a few chunks to exercise the streaming protocol
        step = max(1, len(answer) // 4)
        for i in range(0, len(answer), step):
            yield {"event": "delta", "data": {"text": answer[i : i + step]}}
            await asyncio.sleep(0)

        msg = self.ctx.db.add_chat_message(
            chat_id, "assistant",
            [{"type": "text", "text": answer},
             {"type": "references", "references": references}],
        )
        yield {"event": "done", "data": {"message_id": msg["id"]}}

    # -- chat-scoped documents (reference chat_collection_service +
    # chat_document_service: a per-user chat collection holds files
    # uploaded into chats, searchable only within that chat) -------------

    def _chat_collection(self, user: str) -> dict:
        title = f"__chat_files__{user}"
        row = self.ctx.db.query_one(
            "SELECT * FROM collection WHERE user=? AND title=?"
            " AND status != 'DELETED'",
            (user, title),
        )
        if row is not None:
            import json as _json

            row["config"] = _json.loads(row["config"]) if isinstance(
                row["config"], str) else row["config"]
            return row
        return self.collections.create(user, title,
                                       description="chat file uploads")

    def upload_chat_file(self, user: str, chat_id: str, name: str,
                         data: bytes) -> dict:
        self.get(user, chat_id)
        coll = self._chat_collection(user)
        from super_rag_tpu_torch.service.document_service import DocumentService

        docs = DocumentService(self.ctx, self.collections)
        return docs.create(user, coll["id"], name, data, chat_id=chat_id)

    async def search_chat_files(self, user: str, chat_id: str, query: str,
                                top_k: int = 5) -> dict:
        self.get(user, chat_id)
        coll = self._chat_collection(user)
        return await self.collections.execute_search(
            user, coll["id"], query, top_k=top_k, chat_id=chat_id,
        )

    async def generate_title(self, user: str, chat_id: str) -> dict:
        """Explicit title (re)generation (reference api/chat.py:260 +
        chat_title_service.py): titles from the first user message via
        the completion model, truncation fallback offline."""
        chat = self.get(user, chat_id)
        first = next(
            (p.get("text", "") for m in self.ctx.db.list_chat_messages(chat_id)
             if m["role"] == "user" for p in m["parts"]
             if p.get("type") == "text"),
            "",
        )
        if not first:
            raise HttpError(409, "chat has no user messages to title")
        title = await self._make_title(first)
        self.ctx.db.update_chat(chat_id, title=title)
        chat = self.ctx.db.get_chat(chat_id)
        return chat

    async def _make_title(self, first_message: str) -> str:
        """Title from the first message (reference chat_title_service:
        LLM-generated with truncation fallback)."""
        completion = self.ctx.completion
        if completion is not None:
            try:
                result = completion(
                    prompt=CHAT_TITLE.format(first_message=first_message[:400])
                )
                if hasattr(result, "__await__"):
                    result = await result
                title = str(result).strip().strip('"')[:80]
                if title:
                    return title
            except Exception:  # noqa: BLE001 — fall back to truncation
                pass
        return first_message.strip()[:50] or "New chat"

    async def _generate(self, query: str, docs: list[dict],
                        history: list[dict]) -> str:
        completion = self.ctx.completion
        if completion is not None:
            context = "\n\n".join(f"[{i+1}] {d['text']}" for i, d in enumerate(docs))
            hist = "\n".join(
                f"{m['role']}: {p.get('text', '')}"
                for m in history[-6:] for p in m["parts"]
                if p.get("type") == "text"
            )
            prompt = CHAT_ANSWER.format(history=hist, context=context,
                                        query=query)
            result = completion(prompt=prompt)
            if hasattr(result, "__await__"):
                result = await result
            return str(result)
        if docs:
            return docs[0]["text"]
        return "No relevant context found for your question."
