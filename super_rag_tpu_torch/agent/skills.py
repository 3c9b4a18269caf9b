"""Progressive agent skills (L1-L4 loading; port of the JAX package's
agent/skills.py).

Counterpart of the reference's AgentSkill system
(agent_pro/agent_skill.py:29-38): a skill exposes progressively more
detail as the agent engages with it —

  L1 name only            (always in the prompt; costs ~nothing)
  L2 + one-line description
  L3 + full instructions  (loaded when the agent invokes the skill)
  L4 + bound tools        (registered into the session's tool registry)

Skills are plain dataclasses or markdown files with frontmatter, loaded
from a directory (``.skills/`` by default).
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field
from typing import Optional

from super_rag_tpu_torch.agent.runtime import Tool, ToolRegistry

logger = logging.getLogger(__name__)

_FRONTMATTER = re.compile(r"^---\n(.*?)\n---\n(.*)$", re.S)


@dataclass
class AgentSkill:
    name: str
    description: str = ""
    instructions: str = ""
    tools: list[Tool] = field(default_factory=list)

    def render(self, level: int) -> str:
        """Prompt text for a given disclosure level."""
        if level <= 1 or not self.description:
            return f"- {self.name}"
        if level == 2 or not self.instructions:
            return f"- {self.name}: {self.description}"
        return (f"## Skill: {self.name}\n{self.description}\n\n"
                f"{self.instructions}")


def parse_skill_markdown(text: str, default_name: str = "skill") -> AgentSkill:
    """Markdown skill file: optional `key: value` frontmatter + body."""
    m = _FRONTMATTER.match(text)
    meta: dict[str, str] = {}
    body = text
    if m:
        for line in m.group(1).splitlines():
            k, _, v = line.partition(":")
            if _:
                meta[k.strip()] = v.strip()
        body = m.group(2).strip()
    return AgentSkill(
        name=meta.get("name", default_name),
        description=meta.get("description", ""),
        instructions=body,
    )


def builtin_skills(completion=None,
                   base_tools: Optional[ToolRegistry] = None
                   ) -> list[AgentSkill]:
    """The built-in L4 skills (reference agent_pro analogs).

    ``python-sandbox`` is the CodeAgent counterpart
    (agent_pro/code_agent.py:10-47): its run_python tool executes
    snippets through the resource-limited sandbox.  ``plan-execute`` is
    the LLMAgent planning lifecycle (llm_agent.py:30): its tool asks the
    model for a typed JSON plan and executes the steps (code via the
    sandbox, tool steps via the session registry), returning the full
    transcript.
    """
    from super_rag_tpu_torch.agent.code_runner import run_python as _run

    def run_python(code: str, timeout_s: float = 10.0):
        return _run(code, timeout_s=min(float(timeout_s), 60.0)).to_dict()

    code_skill = AgentSkill(
        name="python-sandbox",
        description="Execute short python programs in a sandbox "
                    "(compute, parse, transform data)",
        instructions=(
            "Call run_python with a complete python program. It runs in "
            "an isolated subprocess with CPU/memory/file limits and a "
            "wall-clock timeout; print() anything you need back. Files "
            "written to the working directory come back in `files`."
        ),
        tools=[Tool(
            "run_python",
            "Run a python program in the sandbox; returns stdout/stderr",
            {"type": "object", "properties": {
                "code": {"type": "string"},
                "timeout_s": {"type": "number"}},
             "required": ["code"]},
            run_python,
        )],
    )

    async def plan_execute(task: str, max_steps: int = 5):
        from super_rag_tpu_torch.agent.planner import execute_plan, make_plan

        plan = make_plan(task, completion, tools=base_tools,
                         max_steps=int(max_steps))
        transcript = await execute_plan(plan, tools=base_tools)
        return {"plan": plan.to_dict(), "transcript": transcript}

    plan_skill = AgentSkill(
        name="plan-execute",
        description="Plan a multi-step task and execute the steps "
                    "(tools and sandboxed code)",
        instructions=(
            "Call plan_execute with the task. A typed plan is generated "
            "(steps = registry tools or sandboxed python) and executed "
            "sequentially; you get the plan plus each step's result, and "
            "should synthesize the final answer from the transcript."
        ),
        tools=[Tool(
            "plan_execute",
            "Generate a step plan for the task and execute it",
            {"type": "object", "properties": {
                "task": {"type": "string"},
                "max_steps": {"type": "integer"}},
             "required": ["task"]},
            plan_execute,
        )],
    )
    return [code_skill, plan_skill]


class SkillLibrary:
    def __init__(self, skills: Optional[list[AgentSkill]] = None):
        self._skills: dict[str, AgentSkill] = {
            s.name: s for s in (skills or [])
        }
        self._engaged: set[str] = set()  # escalated to L3/L4

    @classmethod
    def from_directory(cls, path: str) -> "SkillLibrary":
        skills = []
        if os.path.isdir(path):
            for fn in sorted(os.listdir(path)):
                if not fn.endswith(".md"):
                    continue
                with open(os.path.join(path, fn)) as f:
                    skills.append(
                        parse_skill_markdown(f.read(), default_name=fn[:-3])
                    )
        return cls(skills)

    def add(self, skill: AgentSkill) -> None:
        self._skills[skill.name] = skill

    def engage(self, name: str, registry: Optional[ToolRegistry] = None) -> Optional[AgentSkill]:
        """Escalate a skill to full disclosure; bind its tools (L4)."""
        skill = self._skills.get(name)
        if skill is None:
            return None
        self._engaged.add(name)
        if registry is not None:
            for t in skill.tools:
                registry.add(t)
        return skill

    def prompt_section(self) -> str:
        """Progressive prompt: engaged skills at L3+, others at L2."""
        if not self._skills:
            return ""
        lines = ["Available skills (reply with "
                 '{"tool": "use_skill", "arguments": {"name": "<skill>"}} '
                 "to load one):"]
        for s in self._skills.values():
            lines.append(s.render(3 if s.name in self._engaged else 2))
        return "\n".join(lines)

    def engaged(self) -> set[str]:
        return set(self._engaged)

    def as_tool(self, registry: ToolRegistry) -> Tool:
        """The use_skill tool the agent calls to escalate a skill."""

        def use_skill(name: str):
            skill = self.engage(name, registry)
            if skill is None:
                return {"error": f"unknown skill {name!r}",
                        "available": sorted(self._skills)}
            return {"name": skill.name, "instructions": skill.instructions,
                    "tools_added": [t.name for t in skill.tools]}

        return Tool(
            "use_skill",
            "Load a skill's full instructions and bind its tools",
            {"type": "object", "properties": {"name": {"type": "string"}},
             "required": ["name"]},
            use_skill,
        )
