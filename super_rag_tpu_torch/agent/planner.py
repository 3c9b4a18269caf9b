"""Plan-and-execute layer for the agent runtime (agent_pro parity; port
of the JAX package's agent/planner.py).

The reference's second agent stack (agent_pro/llm_agent.py:30) adds a
lifecycle beyond the plain tool loop: planning, memory condensation, and
Callback hooks fired at task begin/end, around tool calls, and per
response.  This module re-creates that surface the repo's way:

  - :class:`AgentCallback` — the Callback protocol
    (on_task_begin / on_generate_response / on_tool_call /
    after_tool_call / on_task_end, mirroring llm_agent.py:200-228);
  - :func:`make_plan` — ask the completion model for a typed JSON plan
    (steps = tool calls or sandboxed code), with a deterministic
    offline fallback;
  - :func:`execute_plan` — run the steps sequentially, feeding each
    result into the next step's context, firing callbacks, executing
    ``code`` steps through the sandbox (agent/code_runner.py).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

from super_rag_tpu_torch.agent.code_runner import run_python
from super_rag_tpu_torch.agent.runtime import ToolRegistry


class AgentCallback:
    """Lifecycle hooks (reference agent_pro Callback contract)."""

    def on_task_begin(self, query: str) -> None:
        pass

    def on_generate_response(self, prompt: str, response: str) -> None:
        pass

    def on_tool_call(self, tool: str, arguments: dict) -> None:
        pass

    def after_tool_call(self, tool: str, result) -> None:
        pass

    def on_task_end(self, answer: str) -> None:
        pass


def fire(callbacks, hook: str, *args) -> None:
    for cb in callbacks or ():
        try:
            getattr(cb, hook)(*args)
        except Exception:  # noqa: BLE001 — observers must not break the run
            import logging

            logging.getLogger(__name__).exception("callback %s failed", hook)


@dataclass
class PlanStep:
    goal: str
    tool: Optional[str] = None  # a registry tool name, or 'code'
    arguments: dict = field(default_factory=dict)
    code: Optional[str] = None  # python source for tool == 'code'


@dataclass
class Plan:
    objective: str
    steps: list[PlanStep]

    def to_dict(self) -> dict:
        return {"objective": self.objective, "steps": [
            {"goal": s.goal, "tool": s.tool, "arguments": s.arguments,
             "code": s.code} for s in self.steps
        ]}


_PLAN_PROMPT = """Break the task into at most {max_steps} executable steps.
Reply with ONLY this JSON shape:
{{"objective": "...", "steps": [
  {{"goal": "...", "tool": "<tool name or 'code'>",
    "arguments": {{...}}, "code": "<python source when tool is 'code'>"}}
]}}

Available tools:
{tools}
Steps with tool "code" run python in a sandbox; print() their result.

Task: {query}
JSON:"""

_JSON = re.compile(r"\{.*\}", re.S)


def make_plan(query: str, completion: Optional[Callable],
              tools: Optional[ToolRegistry] = None,
              max_steps: int = 5) -> Plan:
    """LLM plan generation with a deterministic offline fallback."""
    if completion is not None:
        prompt = _PLAN_PROMPT.format(
            max_steps=max_steps, query=query,
            tools=tools.descriptions() if tools else "(none)",
        )
        try:
            raw = str(completion(prompt=prompt))
            m = _JSON.search(raw)
            data = json.loads(m.group(0)) if m else {}
            steps = [
                PlanStep(goal=s.get("goal", ""), tool=s.get("tool"),
                         arguments=s.get("arguments", {}) or {},
                         code=s.get("code"))
                for s in data.get("steps", [])[:max_steps]
            ]
            if steps:
                return Plan(objective=data.get("objective", query),
                            steps=steps)
        except Exception:  # noqa: BLE001 — fall through to offline plan
            pass
    # offline: one retrieval step when a search tool exists, else echo
    if tools is not None and tools.get("search_collections") is not None:
        return Plan(objective=query, steps=[
            PlanStep(goal="retrieve relevant passages",
                     tool="search_collections",
                     arguments={"query": query}),
        ])
    return Plan(objective=query, steps=[PlanStep(goal="answer directly")])


async def execute_plan(plan: Plan, tools: Optional[ToolRegistry] = None,
                       callbacks: Optional[list] = None,
                       code_timeout_s: float = 10.0) -> list[dict]:
    """Run the plan's steps in order; returns one transcript row per
    step: {goal, tool, result}.  Code steps execute in the sandbox;
    tool steps resolve against the registry; previous results are
    injected into later code steps as the PLAN_CONTEXT json variable."""
    transcript: list[dict] = []
    for step in plan.steps:
        if step.tool == "code" and step.code:
            fire(callbacks, "on_tool_call", "code", {"goal": step.goal})
            context_preamble = (
                "PLAN_CONTEXT = " + repr(json.dumps(
                    transcript, default=str)[:8000]) + "\n"
            )
            res = run_python(context_preamble + step.code,
                             timeout_s=code_timeout_s)
            result = res.to_dict()
            fire(callbacks, "after_tool_call", "code", result)
        elif step.tool and tools is not None:
            tool = tools.get(step.tool)
            if tool is None:
                result = {"error": f"unknown tool {step.tool!r}"}
            else:
                fire(callbacks, "on_tool_call", step.tool, step.arguments)
                try:
                    result = await tool.call(step.arguments)
                except Exception as e:  # noqa: BLE001 — step fails, plan goes on
                    result = {"error": str(e)}
                fire(callbacks, "after_tool_call", step.tool, result)
        else:
            result = {"note": "no-op step"}
        transcript.append({"goal": step.goal, "tool": step.tool,
                           "result": result})
    return transcript
