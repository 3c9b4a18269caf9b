"""Central prompt-template library + template service (port of the JAX
package's llm/prompts.py).

Every subsystem that talks to a completion model sources its template
here: RAG answering, summary map-reduce, vision captions, chat titles,
the agent prompts, the knowledge graph's extraction / dedupe / summary
prompts and the role-preset library.  Custom user templates persist in
the prompt_template table (store/db.py) and merge into
:func:`list_templates`; user templates render in jinja2's sandbox.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# -- RAG answering (nodeflow/runners/llm.py) ---------------------------------

RAG_ANSWER = """Answer the question using ONLY the context below. If the
context is insufficient, say so.

# Context
{context}

# Question
{query}

# Answer
"""

# -- chat pipeline (service/chat_service.py) ---------------------------------

CHAT_ANSWER = """Answer using the context; cite [n] indices.

# History
{history}

# Context
{context}

# Question
{query}

# Answer
"""

CHAT_TITLE = (
    "Give a 3-6 word title for a conversation that starts with: "
    "{first_message}\nTitle:"
)

# -- agent runtime (agent/runtime.py) -----------------------------------------

AGENT_SYSTEM = """You are a retrieval assistant with tools.

Tools:
{tool_descriptions}

To call a tool reply with EXACTLY one JSON object and nothing else:
{{"tool": "<name>", "arguments": {{...}}}}

When you can answer, reply with the answer text directly (no JSON).
Cite facts from tool results. Conversation so far:
{history}

User: {query}
"""

# -- document summary index (index/summary.py) -------------------------------

SUMMARY_MAP = """Summarize the passage in 2-3 sentences, keeping key entities
and numbers.

Passage:
{text}

Summary:"""

SUMMARY_REDUCE = """Combine the partial summaries into one coherent document
summary of at most 200 words titled '{title}'.

Partial summaries:
{parts}

Document summary:"""

# -- vision index (index/vision.py) -------------------------------------------

VISION_CAPTION = (
    "Describe this image in 2-3 sentences for search indexing. Include any "
    "visible text, charts, and key objects."
)

# -- knowledge graph extraction (kg/extract.py) --------------------------------

KG_EXTRACTION = """Extract knowledge triples from the text as JSON:
{{"triples": [{{"source": "...", "source_type": "...", "relation": "...",
"target": "...", "target_type": "...", "fact": "one sentence",
"valid_at": "YYYY-MM-DD or null"}}]}}

Rules:
- Only include facts stated in the text.
- source_type/target_type is one of:
{types}
- valid_at is the date the fact BECAME TRUE, only if the text states it
  (e.g. "founded in 2019" -> "2019-01-01"); otherwise null.

Text:
{text}

JSON:"""

# reflexion pass (ports the semantics of graphiti's
# prompts/extract_nodes.py reflexion prompt): a second look for entities
# the first extraction missed
KG_REFLEXION = """The following entities were extracted from the text:
{entities}

List entities that are clearly mentioned in the text but MISSING from
that list, as JSON: {{"missed": ["...", "..."]}}.  Respond with
{{"missed": []}} if nothing important was missed.

Text:
{text}

JSON:"""

KG_EXTRACTION_FOCUSED = """Extract knowledge triples INVOLVING these
entities from the text, as JSON:
{{"triples": [{{"source": "...", "source_type": "...", "relation": "...",
"target": "...", "target_type": "...", "fact": "one sentence",
"valid_at": "YYYY-MM-DD or null"}}]}}
Entity types:
{types}
Only facts stated in the text.

Entities: {entities}

Text:
{text}

JSON:"""


# -- knowledge graph construction (kg/construct.py) ---------------------------
# Ports the SEMANTICS of graphiti's construction prompts
# (graphiti_core/prompts/dedupe_nodes.py, dedupe_edges.py,
# summarize_nodes.py) — texts are original.

KG_DEDUPE_NODE = """Decide whether NEW ENTITY refers to the same
real-world object or concept as one of the EXISTING ENTITIES.

Entities are duplicates ONLY if they denote the same thing (name
variants, abbreviations, acronyms, descriptive labels of a named
entity). Related-but-distinct entities, or similar names for separate
instances, are NOT duplicates.

NEW ENTITY: {name}
CONTEXT: {context}

EXISTING ENTITIES:
{candidates}

Reply with JSON only:
{{"duplicate_name": "<exact existing name, or empty string if none>"}}
"""

KG_RESOLVE_EDGE = """You maintain a temporal knowledge graph. Given a
NEW FACT and numbered EXISTING FACTS about the same entities, decide:

1. duplicates: idx values of existing facts stating the SAME factual
   information as the new fact (similar facts with key differences —
   especially numbers, dates, roles — are NOT duplicates).
2. contradictions: idx values of existing facts the new fact
   contradicts or supersedes (a fact can be both duplicate and
   contradicted when the new fact restates and updates it).

NEW FACT: {fact}

EXISTING FACTS:
{existing}

Reply with JSON only:
{{"duplicates": [idx, ...], "contradictions": [idx, ...]}}
"""

KG_SUMMARIZE_NODE = """Summarize what is known about the entity from
its facts in under 250 characters. Plain prose, no preamble.

Entity: {name}
Facts:
{facts}

Summary:"""

KG_COMBINE_SUMMARIES = """Synthesize these two summaries into one
succinct summary under 250 characters. Plain prose, no preamble.

1. {a}
2. {b}

Combined summary:"""

KG_SUMMARIZE_NODES_BATCH = """Summarize what is known about EACH entity
from its facts, in under 250 characters each. Reply with JSON only:
{{"summaries": {{"<entity name>": "<summary>", ...}}}}

{entities}
"""


# -- language-variant agent system prompts ------------------------------------
# (reference prompt_template_service.py get_agent_system_prompt en/zh)

AGENT_SYSTEM_ZH = """你是一个带工具的检索助手。

可用工具：
{tool_descriptions}

调用工具时，只回复一个 JSON 对象，不要有其他内容：
{{"tool": "<name>", "arguments": {{...}}}}

可以直接回答时，直接回复答案文本（不要 JSON）。
引用工具结果中的事实。到目前为止的对话：
{history}

用户：{query}
"""


def get_agent_system_prompt(language: str = "en-US",
                            custom: Optional[str] = None) -> str:
    """Agent system prompt by language; a per-agent custom template wins
    (reference api/chat.py:180 system_prompt_template)."""
    if custom:
        return custom
    return AGENT_SYSTEM_ZH if language == "zh-CN" else AGENT_SYSTEM


# -- jinja2 rendering ---------------------------------------------------------


def render_template(template_str: str, **variables) -> str:
    """Render a jinja2 template (the reference's engine for custom
    templates — prompt_template_service.py:349); falls back to simple
    ``{{name}}`` substitution if jinja2 is unavailable.

    Templates here include USER-CONTROLLED strings (prompt_template CRUD
    rows, per-agent system_prompt_template), so rendering must go through
    jinja2's SandboxedEnvironment: a plain Template exposes the full
    attribute graph (``cycler.__init__.__globals__.os``…) and is
    in-process RCE for any authenticated user."""
    try:
        from jinja2.sandbox import SandboxedEnvironment

        env = SandboxedEnvironment(autoescape=False)
        return env.from_string(template_str).render(**variables)
    except ImportError:  # pragma: no cover — jinja2 is baked in
        out = template_str
        for k, v in variables.items():
            out = out.replace("{{" + k + "}}", str(v))
            out = out.replace("{{ " + k + " }}", str(v))
        return out


# default agent QUERY templates (jinja2; reference
# DEFAULT_AGENT_QUERY_PROMPT_EN/ZH).  Variables: query, history,
# collections (list of titles), web_search_enabled, chat_id, language.

DEFAULT_AGENT_QUERY_TEMPLATE_EN = """{{ history }}

User question: {{ query }}

{% if collections -%}
Relevant collections: {{ collections | join(', ') }}
{%- else -%}
Relevant collections: (none)
{%- endif %}
{% if web_search_enabled -%}
Web search is enabled: supplement collection results with current web
information when helpful, and attribute web sources clearly.
{%- endif %}
Use the search tool before answering questions about document content."""

DEFAULT_AGENT_QUERY_TEMPLATE_ZH = """{{ history }}

用户问题：{{ query }}

{% if collections -%}
相关知识库：{{ collections | join('，') }}
{%- else -%}
相关知识库：（无）
{%- endif %}
{% if web_search_enabled -%}
已启用网络搜索：必要时用最新的网络信息补充知识库结果，并清楚标注来源。
{%- endif %}
回答文档内容相关的问题前，请先使用搜索工具。"""


def get_default_agent_query_prompt_template(
    language: str = "en-US",
) -> str:
    return (DEFAULT_AGENT_QUERY_TEMPLATE_ZH if language == "zh-CN"
            else DEFAULT_AGENT_QUERY_TEMPLATE_EN)


def build_agent_query_prompt(
    query: str,
    history: Optional[list[dict]] = None,
    collection_titles: Optional[list[str]] = None,
    language: str = "en-US",
    web_search_enabled: bool = False,
    chat_id: Optional[str] = None,
    custom_template: Optional[str] = None,
) -> str:
    """Render a retrieval-grounded user turn (reference
    prompt_template_service.py:349 build_agent_query_prompt).
    ``history`` rows are chat-message dicts with ``role`` + text
    ``parts`` (store/db.py chat_message schema).  ``custom_template``
    is a jinja2 string with the same variables as the defaults."""
    lines = []
    for m in (history or [])[-6:]:
        for p in m.get("parts", []):
            if p.get("type") == "text" and p.get("text"):
                lines.append(f"{m.get('role', 'user')}: {p['text']}")
    hist = "\n".join(lines) if lines else "(no prior messages)"
    template = custom_template or get_default_agent_query_prompt_template(
        language
    )
    return render_template(
        template, query=query, history=hist,
        collections=list(collection_titles or []),
        web_search_enabled=web_search_enabled, chat_id=chat_id,
        language=language,
    )


# -- role-preset template library ---------------------------------------------
# (reference MULTI_ROLE_EN/ZH_PROMPT_TEMPLATES, llm/prompts.py:660; texts
# here are original)


@dataclass
class PromptTemplate:
    name: str
    prompt: str
    description: str = ""
    language: str = "en-US"
    id: Optional[str] = None  # set for user-created templates
    builtin: bool = True

    def to_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "prompt": self.prompt,
                "description": self.description, "language": self.language,
                "builtin": self.builtin}


def _bt(name, prompt, description, language="en-US"):
    return PromptTemplate(name=name, prompt=prompt,
                          description=description, language=language)


BUILTIN_TEMPLATES: list[PromptTemplate] = [
    _bt("universal", "{{ query }}", "pass the query through unchanged"),
    _bt("rag-cited-answer",
        "Answer strictly from the provided context. Cite supporting "
        "passages as [n]. If the context does not contain the answer, "
        "say exactly what is missing.\n\nContext:\n{{ context }}\n\n"
        "Question: {{ query }}",
        "grounded answer with [n] citations"),
    _bt("summarizer",
        "Condense the following into at most {{ max_words | default(150) }} "
        "words. Preserve named entities, dates, and quantities; drop "
        "examples and repetition.\n\n{{ query }}",
        "length-bounded extractive-leaning summary"),
    _bt("translator-en-zh",
        "Translate the following English text into natural, fluent "
        "Chinese. Keep technical terms, product names, and citation "
        "markers (like [12]) unchanged; keep Markdown structure intact. "
        "Translate meaning-for-meaning rather than word-for-word.\n\n"
        "{{ query }}",
        "English -> Chinese technical translation"),
    _bt("translator-zh-en",
        "Translate the following Chinese text into clear, idiomatic "
        "English. Keep technical terms and Markdown structure intact.\n\n"
        "{{ query }}",
        "Chinese -> English technical translation"),
    _bt("code-explainer",
        "Explain what this code does, walking through it section by "
        "section, then list potential bugs or edge cases.\n\n"
        "```\n{{ query }}\n```",
        "code walkthrough + bug hunt"),
    _bt("sql-generator",
        "Write a single SQL query for the request below. Use standard "
        "SQL unless a dialect is named. Reply with the SQL in a code "
        "block, then one sentence explaining it.\n\nSchema:\n"
        "{{ schema | default('(not provided)') }}\n\nRequest: {{ query }}",
        "natural language -> SQL"),
    _bt("meeting-minutes",
        "Turn this transcript into minutes: a one-paragraph summary, "
        "decisions made, action items as '- [owner] task (due)', and "
        "open questions.\n\n{{ query }}",
        "transcript -> structured minutes"),
    _bt("socratic-tutor",
        "Act as a tutor for the topic below. Do not give the answer "
        "outright: ask one guiding question at a time, adapting to the "
        "student's replies, and only reveal the full solution when asked."
        "\n\nTopic: {{ query }}",
        "guided questioning instead of direct answers"),
    _bt("fact-checker",
        "For each factual claim in the text, state whether it is "
        "supported, contradicted, or not covered by the provided "
        "context, quoting the relevant evidence.\n\nContext:\n"
        "{{ context }}\n\nText to check:\n{{ query }}",
        "claim-by-claim verification against context"),
    # zh-CN presets
    _bt("universal", "{{ query }}", "直接传递用户问题", "zh-CN"),
    _bt("rag-cited-answer",
        "仅根据提供的上下文回答，用 [n] 标注引用来源。"
        "如果上下文不包含答案，请明确说明缺少什么信息。\n\n"
        "上下文：\n{{ context }}\n\n问题：{{ query }}",
        "基于上下文的引用式回答", "zh-CN"),
    _bt("summarizer",
        "将以下内容压缩到 {{ max_words | default(150) }} 字以内，"
        "保留实体、日期和数字，去掉例子和重复。\n\n{{ query }}",
        "限长摘要", "zh-CN"),
    _bt("code-explainer",
        "逐段解释这段代码的作用，然后列出潜在的 bug 和边界情况。\n\n"
        "```\n{{ query }}\n```",
        "代码讲解与隐患排查", "zh-CN"),
]


def list_templates(language: str = "en-US",
                   db=None, username: Optional[str] = None) -> list[dict]:
    """Builtin presets for ``language`` + the user's custom templates
    (reference list_prompt_templates + the per-user CRUD the reference
    keeps in prompt_template_service)."""
    out = [t.to_dict() for t in BUILTIN_TEMPLATES if t.language == language]
    if db is not None and username:
        for row in db.list_prompt_templates(username, language=language):
            out.append({"id": row["id"], "name": row["name"],
                        "prompt": row["prompt"],
                        "description": row["description"],
                        "language": row["language"], "builtin": False})
    return out


def build_rag_context(docs: list[tuple[int, str]]) -> str:
    """Number context items as ``[n] text`` for citation-style answers."""
    return "\n\n".join(f"[{i}] {text}" for i, text in docs)
