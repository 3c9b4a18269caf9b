"""The port's agent/ (runtime, planner, skills, code_runner, session
manager, AG-UI) against the JAX package's: the cases of test_agent.py,
test_skills.py and test_code_agent.py run through both packages with the
same scripted completion, and the events, tool calls, tool results,
prompts and sandbox results are equal.  AG-UI ids (uuid4) and sandbox
durations are the only fields taken out; search scores agree within
1e-5.  Every sandbox wall clock here is 2 s or less."""

import asyncio
import json
import os
import signal
import time
import types

import pytest

from super_rag_tpu.agent import ag_ui as j_ag_ui
from super_rag_tpu.agent import code_runner as j_code
from super_rag_tpu.agent import planner as j_planner
from super_rag_tpu.agent import runtime as j_runtime
from super_rag_tpu.agent import session_manager as j_sessions
from super_rag_tpu.agent import skills as j_skills
from super_rag_tpu_torch.agent import ag_ui as t_ag_ui
from super_rag_tpu_torch.agent import code_runner as t_code
from super_rag_tpu_torch.agent import planner as t_planner
from super_rag_tpu_torch.agent import runtime as t_runtime
from super_rag_tpu_torch.agent import session_manager as t_sessions
from super_rag_tpu_torch.agent import skills as t_skills

SCORE_TOL = 1e-5
WALL_S = 2.0  # every sandbox run's own wall clock

PKGS = {
    "jax": types.SimpleNamespace(rt=j_runtime, plan=j_planner, skills=j_skills,
                                 code=j_code, ag_ui=j_ag_ui, sessions=j_sessions),
    "torch": types.SimpleNamespace(rt=t_runtime, plan=t_planner, skills=t_skills,
                                   code=t_code, ag_ui=t_ag_ui, sessions=t_sessions),
}


def both(fn):
    """``fn(package namespace)`` for the JAX package, then the port."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


def collect(aiter):
    async def go():
        return [e async for e in aiter]

    return asyncio.run(go())


def scripted(script, prompts=None):
    state = {"i": 0}

    def completion(prompt):
        if prompts is not None:
            prompts.append(prompt)
        out = script[min(state["i"], len(script) - 1)]
        state["i"] += 1
        return out(prompt) if callable(out) else out

    return completion


def lookup_tools(p, calls):
    def lookup(query: str):
        calls.append(query)
        return {"items": [{"text": f"fact about {query}", "score": 1.0}]}

    return p.rt.ToolRegistry([
        p.rt.Tool("search_collections", "search docs",
                  {"type": "object", "properties": {"query": {"type": "string"}}},
                  lookup)])


SCRIPTS = {
    "tool loop": ['{"tool": "search_collections", "arguments": {"query": "foxes"}}',
                  "Foxes are canids; see the retrieved fact."],
    "unknown tool": ['{"tool": "nope", "arguments": {}}', "final answer"],
    "budget": ['{"tool": "search_collections", "arguments": {"query": "x"}}'],
    "tool raises": ['{"tool": "search_collections", "arguments": {"bad": 1}}', "done"],
    "no arguments": ['{"tool": "search_collections"}', "ok"],
    "prose before json": ['I will call {"tool": "search_collections"}', "after"],
    "broken json": ['{"tool": "search_collections", "arguments": {', "x"],
    "json without tool": ['{"answer": 42}'],
    "empty answer": [""],
}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_tool_loop_events_prompts_and_history(case):
    def run(p):
        calls, prompts = [], []
        session = p.rt.AgentSession(tools=lookup_tools(p, calls),
                                    completion=scripted(SCRIPTS[case], prompts))
        events = collect(session.run("tell me about foxes"))
        second = collect(session.run("and wolves?"))
        return events, second, calls, prompts, session.history

    want, got = both(run)
    assert got == want
    if case == "budget":
        assert len([e for e in got[0] if e["event"] == "tool_call"]) == 10


def test_async_completion_and_tool():
    def run(p):
        async def complete(prompt):
            return "plain" if "[tool" in prompt else \
                '{"tool": "lookup", "arguments": {"q": "z"}}'

        async def lookup(q):
            await asyncio.sleep(0)
            return {"q": q}

        reg = p.rt.ToolRegistry([p.rt.Tool("lookup", "l", {"type": "object"}, lookup)])
        return collect(p.rt.AgentSession(tools=reg, completion=complete).run("q"))

    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("language,template", [
    ("en-US", None), ("zh-CN", None),
    ("en-US", "Tools: {{ tool_descriptions }} | {{ history }} | Q: {{ query }}"),
])
def test_system_prompt_language_and_template(language, template):
    def run(p):
        prompts = []
        session = p.rt.AgentSession(tools=lookup_tools(p, []),
                                    completion=scripted(["answer"], prompts),
                                    language=language, system_template=template)
        return collect(session.run("what?")), prompts

    want, got = both(run)
    assert got == want


def test_offline_policy_over_a_collection(tmp_path):
    from super_rag_tpu.config import Settings as JSettings
    from super_rag_tpu.service.collection_service import CollectionService as JColl
    from super_rag_tpu.service.context import build_context as j_build
    from super_rag_tpu_torch.config import Settings as TSettings
    from super_rag_tpu_torch.service.collection_service import CollectionService as TColl
    from super_rag_tpu_torch.service.context import build_context as t_build

    settings = dict(embedding_dim=64, index_dtype="float32", vocab_size=1 << 14)
    texts = ["TPUs use systolic arrays for matrix multiplication.",
             "GPUs run warps of threads over tensor cores.",
             "The fox jumps over the lazy dog."]
    out = []
    for name, build, settings_cls, coll_cls, kw in (
            ("jax", j_build, JSettings, JColl, {}),
            ("torch", t_build, TSettings, TColl, {"device": "cpu"})):
        ctx = build(settings_cls(data_dir=str(tmp_path / name), **settings), **kw)
        coll = coll_cls(ctx).create("u", "kb")
        ctx.engines.get(coll["id"], coll["config"]).ingest(texts)
        p = PKGS[name]
        tools = p.sessions.platform_tools(ctx, "u", [coll["id"]])
        events = collect(p.rt.AgentSession(tools=tools, completion=None).run(
            "how do TPUs multiply matrices"))
        listed = asyncio.run(tools.get("list_collections").call({}))
        out.append((events, listed))
    (want, jlist), (got, tlist) = out
    assert [c["title"] for c in jlist["collections"]] == [c["title"]
                                                         for c in tlist["collections"]]
    assert [e["event"] for e in got] == [e["event"] for e in want]
    assert got[-1] == want[-1] and "systolic" in got[-1]["data"]["text"]
    wi = want[1]["data"]["result"]["items"]
    gi = got[1]["data"]["result"]["items"]
    assert [i["text"] for i in gi] == [i["text"] for i in wi] and gi
    for a, b in zip(gi, wi):
        assert abs(a["score"] - b["score"]) <= SCORE_TOL


def _strip_ids(events):
    out = []
    for e in events:
        data = {k: v for k, v in e["data"].items()
                if k not in ("runId", "toolCallId", "messageId")}
        out.append((e["event"], data))
    return out


@pytest.mark.parametrize("case", ["tool loop", "unknown tool", "empty answer"])
def test_ag_ui_mapping(case):
    def run(p):
        session = p.rt.AgentSession(tools=lookup_tools(p, []),
                                    completion=scripted(SCRIPTS[case]))
        events = collect(p.ag_ui.to_ag_ui(session.run("q"), run_id="r1"))
        ids = {e["data"]["runId"] for e in events}
        msgs = {e["data"]["messageId"] for e in events if "messageId" in e["data"]}
        assert ids == {"r1"} and len(msgs) <= 1
        return _strip_ids(events)

    want, got = both(run)
    assert got == want
    assert got[0][0] == "RunStarted" and got[-1][0] == "RunFinished"


def test_session_manager_caching_and_expiry(tmp_path):
    from super_rag_tpu.config import Settings as JSettings
    from super_rag_tpu.service.context import build_context as j_build
    from super_rag_tpu_torch.config import Settings as TSettings
    from super_rag_tpu_torch.service.context import build_context as t_build

    settings = dict(embedding_dim=64, index_dtype="float32", vocab_size=1 << 14)
    skill_dir = {}
    out = []
    for name, build, settings_cls, kw in (("jax", j_build, JSettings, {}),
                                          ("torch", t_build, TSettings, {"device": "cpu"})):
        data = tmp_path / name
        os.makedirs(data / ".skills")
        (data / ".skills" / "deploy.md").write_text(
            "---\nname: deploy\ndescription: ship it\n---\npress the button")
        skill_dir[name] = data
        ctx = build(settings_cls(data_dir=str(data), **settings), **kw)
        mgr = PKGS[name].sessions.AgentSessionManager(ctx)
        s1 = mgr.get("u", "chat1", [], agent_config={
            "agent": {"language": "zh-CN", "system_prompt_template": "T {{ query }}"}})
        assert mgr.get("u", "chat1", []) is s1
        s3 = mgr.get("u", "chat2", [])
        assert s3 is not s1
        sess, _ = mgr._sessions[("u", "chat1")]
        mgr._sessions[("u", "chat1")] = (sess, 0.0)
        out.append((mgr.evict_expired(), list(mgr._sessions), s1.language,
                    s1.system_template, s3._tool_descriptions(),
                    sorted(s3.skills._skills)))
    assert out[1] == out[0]
    assert PKGS["torch"].sessions.SESSION_TTL_S == 30 * 60


# -- skills -------------------------------------------------------------------


def test_render_levels_and_markdown():
    def run(p):
        s = p.skills.AgentSkill(name="sql", description="query databases",
                                instructions="Use SELECT ...")
        parsed = [p.skills.parse_skill_markdown(t, default_name="dflt") for t in (
            "---\nname: deploy\ndescription: ship a release\n---\nStep 1: build.",
            "no frontmatter at all", "---\nbad line\nname: x\n---\nbody",
            "---\nname: y\n---\n")]
        return ([s.render(level) for level in (0, 1, 2, 3, 4)],
                [p.skills.AgentSkill(name="n").render(3)],
                [(x.name, x.description, x.instructions) for x in parsed])

    want, got = both(run)
    assert got == want


def test_directory_loading(tmp_path):
    (tmp_path / "a.md").write_text("---\nname: alpha\ndescription: first\n---\nbody")
    (tmp_path / "b.md").write_text("plain body, name from the file")
    (tmp_path / "ignore.txt").write_text("x")
    want, got = both(lambda p: (
        p.skills.SkillLibrary.from_directory(str(tmp_path)).prompt_section(),
        p.skills.SkillLibrary.from_directory(str(tmp_path / "missing")).prompt_section()))
    assert got == want and "alpha" in got[0]


def test_engage_binds_tools_and_escalates():
    def run(p):
        calls = []
        tool = p.rt.Tool("deploy_now", "do it", {"type": "object", "properties": {}},
                         lambda: calls.append(1) or {"ok": True})
        lib = p.skills.SkillLibrary([p.skills.AgentSkill(
            name="deploy", description="ship", instructions="press the button",
            tools=[tool])])
        reg = p.rt.ToolRegistry()
        reg.add(lib.as_tool(reg))
        before = (lib.prompt_section(), reg.get("deploy_now") is None, len(reg))
        out = asyncio.run(reg.get("use_skill").call({"name": "deploy"}))
        missing = asyncio.run(reg.get("use_skill").call({"name": "nope"}))
        return before, out, missing, lib.prompt_section(), sorted(lib.engaged()), len(reg)

    want, got = both(run)
    assert got == want and got[1]["tools_added"] == ["deploy_now"]


def test_agent_uses_skill_in_loop():
    def run(p):
        lib = p.skills.SkillLibrary([p.skills.AgentSkill(
            name="math", description="arithmetic helper",
            instructions="add numbers carefully",
            tools=[p.rt.Tool("add", "add two ints",
                             {"type": "object",
                              "properties": {"a": {"type": "integer"},
                                             "b": {"type": "integer"}}},
                             lambda a, b: {"sum": a + b})])])
        reg = p.rt.ToolRegistry()
        reg.add(lib.as_tool(reg))
        prompts = []
        session = p.rt.AgentSession(tools=reg, skills=lib, completion=scripted([
            '{"tool": "use_skill", "arguments": {"name": "math"}}',
            '{"tool": "add", "arguments": {"a": 2, "b": 3}}',
            "The sum is 5."], prompts))
        return collect(session.run("add 2 and 3")), prompts

    want, got = both(run)
    assert got == want


def test_callbacks_fire_in_the_same_order():
    def run(p):
        hooks = []

        class Rec(p.plan.AgentCallback):
            def on_task_begin(self, query):
                hooks.append(("begin", query))

            def on_generate_response(self, prompt, response):
                hooks.append(("gen", response))

            def on_tool_call(self, tool, arguments):
                hooks.append(("call", tool, arguments))

            def after_tool_call(self, tool, result):
                hooks.append(("after", tool, result))

            def on_task_end(self, answer):
                hooks.append(("end", answer))
                raise RuntimeError("observers must not break the run")

        session = p.rt.AgentSession(tools=lookup_tools(p, []), callbacks=[Rec()],
                                    completion=scripted(SCRIPTS["tool loop"]))
        return collect(session.run("q")), hooks

    want, got = both(run)
    assert got == want and got[1][0] == ("begin", "q")


# -- planner ------------------------------------------------------------------


PLAN_REPLIES = {
    "llm json": json.dumps({"objective": "obj", "steps": [
        {"goal": "compute", "tool": "code", "code": "print(6 * 7)"}]}),
    "not json": "not json",
    "no steps": json.dumps({"objective": "o", "steps": []}),
    "too many steps": json.dumps({"steps": [{"goal": str(i)} for i in range(9)]}),
    "raises": None,
}


@pytest.mark.parametrize("reply", list(PLAN_REPLIES))
@pytest.mark.parametrize("with_tools", [False, True])
def test_make_plan(reply, with_tools):
    def run(p):
        prompts = []

        def completion(prompt):
            prompts.append(prompt)
            if PLAN_REPLIES[reply] is None:
                raise RuntimeError("provider down")
            return PLAN_REPLIES[reply]

        reg = p.rt.ToolRegistry([p.rt.Tool("search_collections", "s",
                                           {"type": "object", "properties": {}},
                                           lambda **kw: {"items": []})]) \
            if with_tools else None
        return (p.plan.make_plan("q", completion, tools=reg, max_steps=3).to_dict(),
                p.plan.make_plan("q", None, tools=reg).to_dict(), prompts)

    want, got = both(run)
    assert got == want


def _run_sandbox_fields(res: dict) -> dict:
    return {k: v for k, v in res.items() if k != "duration_s"}


def test_execute_plan_code_and_tools_with_callbacks():
    def run(p):
        events = []

        class Rec(p.plan.AgentCallback):
            def on_tool_call(self, tool, arguments):
                events.append(("call", tool, arguments))

            def after_tool_call(self, tool, result):
                events.append(("after", tool))

        reg = p.rt.ToolRegistry([p.rt.Tool("lookup", "l",
                                           {"type": "object", "properties": {}},
                                           lambda **kw: {"value": 21})])
        plan = p.plan.Plan(objective="o", steps=[
            p.plan.PlanStep(goal="fetch", tool="lookup", arguments={}),
            p.plan.PlanStep(goal="double it", tool="code",
                            code="import json\nctx = json.loads(PLAN_CONTEXT)\n"
                                 "print(ctx[0]['result']['value'] * 2)"),
            p.plan.PlanStep(goal="missing", tool="nope"),
            p.plan.PlanStep(goal="no-op"),
        ])
        transcript = asyncio.run(p.plan.execute_plan(plan, tools=reg, callbacks=[Rec()],
                                                     code_timeout_s=WALL_S))
        transcript[1]["result"] = _run_sandbox_fields(transcript[1]["result"])
        return transcript, events

    want, got = both(run)
    assert got == want
    assert got[0][1]["result"]["stdout"].strip() == "42"


# -- sandbox ------------------------------------------------------------------


SNIPPETS = {
    "basic": "print(2 + 40)",
    "error": "raise ValueError('boom')",
    "exit code": "import sys; print('x'); sys.exit(3)",
    "files": "open('out.txt', 'w').write('artifact'); open('b.bin', 'wb').write(b'\\xff\\xfe')",
    "isolated env": "import os; print(os.environ.get('PYTHONPATH', 'none'), "
                    "sorted(os.environ))",
    "limits": "import resource as r; print([r.getrlimit(k) for k in (r.RLIMIT_CPU, "
              "r.RLIMIT_AS, r.RLIMIT_FSIZE, r.RLIMIT_NPROC)])",
    "big output": "print('y' * 30000)",
    "stderr": "import sys; sys.stderr.write('warn\\n'); print('out')",
}


@pytest.mark.parametrize("case", list(SNIPPETS))
def test_run_python_case_for_case(case):
    want, got = both(lambda p: _run_sandbox_fields(
        p.code.run_python(SNIPPETS[case], timeout_s=WALL_S).to_dict()))
    assert got == want
    assert not got["timed_out"]


def test_run_python_wall_clock_kill():
    want, got = both(lambda p: _run_sandbox_fields(
        p.code.run_python("import time; time.sleep(60)", timeout_s=1.0).to_dict()))
    assert got == want and got["timed_out"] and "killed" in got["stderr"]


def test_run_python_cpu_limit():
    res = t_code.run_python("while True: pass", timeout_s=WALL_S, cpu_seconds=1)
    # the CPU limit's signal at one CPU second (SIGXCPU, or SIGKILL where
    # the soft limit is the hard one), or the wall clock first on a loaded host
    assert res.exit_code != 0
    assert res.timed_out or res.exit_code in (-signal.SIGXCPU, -signal.SIGKILL)
    assert res.duration_s < 10


def test_run_python_timeout_kills_grandchildren(tmp_path):
    beat = tmp_path / "beat"
    code = f"""
import os, time
pid = os.fork()
if pid == 0:
    while True:
        with open({str(beat)!r}, 'a') as f:
            f.write('x')
        time.sleep(0.05)
time.sleep(60)
"""
    res = t_code.run_python(code, timeout_s=1.0)
    assert res.timed_out
    time.sleep(0.3)
    n1 = beat.stat().st_size if beat.exists() else 0
    time.sleep(0.6)
    n2 = beat.stat().st_size if beat.exists() else 0
    assert n1 > 0 and n2 == n1, "a grandchild outlived the sandbox's wall clock"


# -- L1 -> L4 escalation through an agent chat --------------------------------


def test_agent_chat_escalates_skill_to_l4_and_runs_code(monkeypatch):
    for p in PKGS.values():  # the skill's sandbox at this file's wall clock
        real = p.code.run_python
        monkeypatch.setattr(p.code, "run_python",
                            lambda code, timeout_s=10.0, _r=real: _r(code, timeout_s=WALL_S))

    def run(p):
        tools = p.rt.ToolRegistry()
        lib = p.skills.SkillLibrary(p.skills.builtin_skills())
        tools.add(lib.as_tool(tools))
        session = p.rt.AgentSession(tools=tools, skills=lib, completion=scripted([
            json.dumps({"tool": "use_skill", "arguments": {"name": "python-sandbox"}}),
            json.dumps({"tool": "run_python", "arguments": {"code": "print(19 * 3)"}}),
            "the answer is 57"]))
        before = (tools.get("run_python") is None, session._tool_descriptions())
        events = collect(session.run("what is 19*3?"))
        for e in events:
            if e["event"] == "tool_result" and e["data"]["tool"] == "run_python":
                e["data"]["result"] = _run_sandbox_fields(e["data"]["result"])
        return before, events, sorted(lib.engaged()), tools.get("run_python") is not None

    want, got = both(run)
    assert got == want
    results = [e["data"]["result"] for e in got[1] if e["event"] == "tool_result"
               and e["data"]["tool"] == "run_python"]
    assert results[0]["stdout"].strip() == "57"


def test_agent_chat_executes_tool_generated_plan(monkeypatch):
    for p in PKGS.values():
        real = p.plan.run_python
        monkeypatch.setattr(p.plan, "run_python",
                            lambda code, timeout_s=10.0, _r=real: _r(code, timeout_s=WALL_S))
    plan_json = json.dumps({"objective": "compute", "steps": [
        {"goal": "calc", "tool": "code", "code": "print(8 * 8)"}]})

    def run(p):
        script = scripted([
            json.dumps({"tool": "use_skill", "arguments": {"name": "plan-execute"}}),
            json.dumps({"tool": "plan_execute", "arguments": {"task": "compute 8*8"}}),
            "64 it is"])

        def completion(prompt):
            return plan_json if "Break the task into" in prompt else script(prompt)

        tools = p.rt.ToolRegistry()
        lib = p.skills.SkillLibrary(p.skills.builtin_skills(completion=completion,
                                                            base_tools=tools))
        tools.add(lib.as_tool(tools))
        session = p.rt.AgentSession(tools=tools, completion=completion, skills=lib)
        events = collect(session.run("compute 8*8"))
        for e in events:
            if e["event"] == "tool_result" and e["data"]["tool"] == "plan_execute":
                for row in e["data"]["result"]["transcript"]:
                    row["result"] = _run_sandbox_fields(row["result"])
        return events

    want, got = both(run)
    assert got == want
    result = [e["data"]["result"] for e in got if e["event"] == "tool_result"
              and e["data"]["tool"] == "plan_execute"][0]
    assert result["transcript"][0]["result"]["stdout"].strip() == "64"
