"""Agent runtime: an LLM tool loop over the platform's tools (port of
the JAX package's agent/runtime.py).

Counterpart of the reference's MCP-agent chat runtime (super_rag/agent/:
ChatSession wiring an agent LLM to the app's own /mcp endpoint over
loopback HTTP; generate_str_streaming with tool-call events,
openai_llm_tool_events.py:55-116, <=10 tool iterations).  Ours binds the
same tools in-process (no loopback hop) and speaks a model-agnostic
JSON tool protocol so any prompt-in/text-out completion client works.
With no LLM configured the loop degrades to a deterministic
retrieve-then-answer policy, so agent chat works fully offline.
"""

from __future__ import annotations

import inspect
import json
import re
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Optional

MAX_TOOL_ITERATIONS = 10  # reference cap (SURVEY.md 3.3)

from super_rag_tpu_torch.llm.prompts import AGENT_SYSTEM as SYSTEM_PROMPT


@dataclass
class Tool:
    name: str
    description: str
    input_schema: dict
    fn: Callable[..., Any]  # sync or async (**arguments) -> jsonable

    async def call(self, arguments: dict) -> Any:
        out = self.fn(**arguments)
        if inspect.isawaitable(out):
            out = await out
        return out


class ToolRegistry:
    def __init__(self, tools: Optional[list[Tool]] = None):
        self._tools: dict[str, Tool] = {t.name: t for t in (tools or [])}

    def add(self, tool: Tool) -> None:
        self._tools[tool.name] = tool

    def get(self, name: str) -> Optional[Tool]:
        return self._tools.get(name)

    def descriptions(self) -> str:
        return "\n".join(
            f"- {t.name}: {t.description} args={json.dumps(t.input_schema.get('properties', {}))}"
            for t in self._tools.values()
        )

    def __len__(self) -> int:
        return len(self._tools)


_TOOL_CALL = re.compile(r"\{.*\}", re.S)


@dataclass
class AgentSession:
    """One user+chat agent loop with short-term memory.

    ``system_template`` overrides the built-in system prompt (jinja2,
    variables tool_descriptions/history/query — reference api/chat.py:180
    bot_config.agent.system_prompt_template); ``language`` selects the
    en/zh default when no override is set."""

    tools: ToolRegistry
    completion: Optional[Callable] = None  # (prompt) -> str | awaitable
    history_limit: int = 4  # reference context_limit=4
    history: list[dict] = field(default_factory=list)
    system_template: Optional[str] = None
    language: str = "en-US"
    # progressive skills (agent/skills.py SkillLibrary) — listed at L2 in
    # the prompt, escalated to L3/L4 through the use_skill tool
    skills: Optional[object] = None
    # lifecycle observers (agent/planner.py AgentCallback — the
    # reference agent_pro Callback hooks, llm_agent.py:200-228)
    callbacks: list = field(default_factory=list)

    def _fire(self, hook: str, *args) -> None:
        from super_rag_tpu_torch.agent.planner import fire

        fire(self.callbacks, hook, *args)

    def _tool_descriptions(self) -> str:
        desc = self.tools.descriptions()
        if self.skills is not None:
            section = self.skills.prompt_section()
            if section:
                desc = desc + "\n\n" + section
        return desc

    async def run(self, query: str) -> AsyncIterator[dict]:
        """Yields: tool_call, tool_result, delta, done events."""
        self.history.append({"role": "user", "text": query})
        self._fire("on_task_begin", query)
        if self.completion is None:
            async for ev in self._offline_policy(query):
                yield ev
            return

        transcript: list[str] = []
        answer = ""
        for _ in range(MAX_TOOL_ITERATIONS):
            if self.system_template:
                from super_rag_tpu_torch.llm.prompts import render_template

                prompt = render_template(
                    self.system_template,
                    tool_descriptions=self._tool_descriptions(),
                    history=self._render_history(extra=transcript),
                    query=query,
                )
            else:
                from super_rag_tpu_torch.llm.prompts import (
                    get_agent_system_prompt,
                )

                prompt = get_agent_system_prompt(self.language).format(
                    tool_descriptions=self._tool_descriptions(),
                    history=self._render_history(extra=transcript),
                    query=query,
                )
            raw = self.completion(prompt=prompt)
            if inspect.isawaitable(raw):
                raw = await raw
            raw = str(raw).strip()
            self._fire("on_generate_response", prompt, raw)
            call = self._parse_tool_call(raw)
            if call is None:
                answer = raw
                break
            name, args = call
            yield {"event": "tool_call", "data": {"tool": name,
                                                  "arguments": args}}
            self._fire("on_tool_call", name, args)
            tool = self.tools.get(name)
            if tool is None:
                result = {"error": f"unknown tool {name!r}"}
            else:
                try:
                    result = await tool.call(args)
                except Exception as e:  # noqa: BLE001 — feed error back
                    result = {"error": str(e)}
            self._fire("after_tool_call", name, result)
            yield {"event": "tool_result", "data": {"tool": name,
                                                    "result": result}}
            transcript.append(
                f"[tool {name}({json.dumps(args)}) ->"
                f" {json.dumps(result, default=str)[:2000]}]"
            )
        else:
            answer = "I could not finish within the tool-call budget."

        self.history.append({"role": "assistant", "text": answer})
        self._fire("on_task_end", answer)
        self._trim_history()
        step = max(1, len(answer) // 4)
        for i in range(0, len(answer), step):
            yield {"event": "delta", "data": {"text": answer[i : i + step]}}
        yield {"event": "done", "data": {"text": answer}}

    async def _offline_policy(self, query: str) -> AsyncIterator[dict]:
        """No LLM: search every searchable tool and answer extractively."""
        answer = ""
        search = self.tools.get("search_collections") or self.tools.get(
            "search_collection"
        )
        if search is not None:
            args = {"query": query}
            yield {"event": "tool_call", "data": {"tool": search.name,
                                                  "arguments": args}}
            try:
                result = await search.call(args)
            except Exception as e:  # noqa: BLE001
                result = {"error": str(e)}
            yield {"event": "tool_result", "data": {"tool": search.name,
                                                    "result": result}}
            items = (result or {}).get("items", []) if isinstance(result, dict) else []
            if items:
                answer = items[0].get("text", "")
        if not answer:
            answer = "No relevant context found for your question."
        self.history.append({"role": "assistant", "text": answer})
        self._trim_history()
        yield {"event": "delta", "data": {"text": answer}}
        yield {"event": "done", "data": {"text": answer}}

    def _render_history(self, extra: list[str]) -> str:
        lines = [f"{m['role']}: {m['text']}" for m in
                 self.history[-2 * self.history_limit :]]
        return "\n".join(lines + list(extra)) or "(empty)"

    def _trim_history(self) -> None:
        self.history = self.history[-2 * self.history_limit :]

    @staticmethod
    def _parse_tool_call(raw: str) -> Optional[tuple[str, dict]]:
        if not raw.lstrip().startswith("{"):
            return None
        m = _TOOL_CALL.search(raw)
        if not m:
            return None
        try:
            data = json.loads(m.group(0))
        except json.JSONDecodeError:
            return None
        if "tool" not in data:
            return None
        return str(data["tool"]), dict(data.get("arguments") or {})
