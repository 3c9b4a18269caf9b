"""Sandboxed code execution for the code-agent skill (port of the JAX
package's agent/code_runner.py).

Counterpart of the reference's CodeAgent (agent_pro/code_agent.py:10-47
runs workflow code; its `trust_remote_code` flag gates arbitrary
execution).  Here execution is ALWAYS sandboxed: the snippet runs in a
fresh python subprocess inside a temp working directory with hard OS
resource limits (CPU seconds, address space, file size, process count
via ``resource.setrlimit`` in the child) and a wall-clock timeout —
an untrusted tool-generated program cannot hold the agent loop hostage
or fill the disk.  Network isolation is left to the host; the limits below are
enforced in the child on any host.
"""

from __future__ import annotations

import os
import resource
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

MAX_OUTPUT = 20_000  # chars of stdout/stderr kept per run


@dataclass
class CodeResult:
    exit_code: int
    stdout: str
    stderr: str
    duration_s: float
    timed_out: bool = False
    files: dict | None = None  # small text files the code wrote

    def to_dict(self) -> dict:
        return {
            "exit_code": self.exit_code, "stdout": self.stdout,
            "stderr": self.stderr,
            "duration_s": round(self.duration_s, 3),
            "timed_out": self.timed_out, "files": self.files or {},
        }


def run_python(
    code: str,
    timeout_s: float = 10.0,
    cpu_seconds: int = 10,
    memory_bytes: int = 512 << 20,
    max_file_bytes: int = 5 << 20,
    collect_files: bool = True,
) -> CodeResult:
    """Execute ``code`` in a sandboxed subprocess; returns CodeResult.

    The child gets a fresh temp cwd; small text files it creates there
    are collected into ``files`` so multi-step plans can pass artifacts
    forward.
    """

    def limits() -> None:  # runs in the child before exec
        # no import here: a forked child of a threaded parent must not
        # wait on the import lock
        resource.setrlimit(resource.RLIMIT_CPU, (cpu_seconds, cpu_seconds))
        resource.setrlimit(resource.RLIMIT_AS, (memory_bytes, memory_bytes))
        resource.setrlimit(resource.RLIMIT_FSIZE,
                           (max_file_bytes, max_file_bytes))
        resource.setrlimit(resource.RLIMIT_NPROC, (32, 32))
        # own session/pgroup so the parent can killpg the WHOLE tree on
        # timeout (subprocess.run's TimeoutExpired kills only the direct
        # child — a forking snippet would otherwise outlive the sandbox)
        os.setsid()

    with tempfile.TemporaryDirectory(prefix="agent-code-") as workdir:
        env = {
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": workdir,
            "PYTHONDONTWRITEBYTECODE": "1",
            # no PYTHONPATH: the snippet sees the stdlib + site, not the
            # serving process's repo
        }
        t0 = time.perf_counter()
        timed_out = False
        proc = subprocess.Popen(
            [sys.executable, "-I", "-c", code],
            cwd=workdir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, preexec_fn=limits,
        )
        try:
            out, err = proc.communicate(timeout=timeout_s)
            exit_code = proc.returncode
        except subprocess.TimeoutExpired:
            timed_out = True
            exit_code = -1
            # kill the whole session group, not just the direct child:
            # grandchildren forked by the snippet live in the same group
            # (os.setsid above) and must not survive the wall clock
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                proc.kill()
            try:
                out, err = proc.communicate(timeout=5)
            except subprocess.TimeoutExpired:  # pragma: no cover
                out, err = "", ""
            out = out or ""
            err = (err or "") + f"\n[killed: exceeded {timeout_s}s wall clock]"
        duration = time.perf_counter() - t0

        files: dict[str, str] = {}
        if collect_files:
            for root, _dirs, names in os.walk(workdir):
                for name in names:
                    p = os.path.join(root, name)
                    rel = os.path.relpath(p, workdir)
                    try:
                        if os.path.getsize(p) > 64_000 or len(files) >= 16:
                            continue
                        with open(p, "r", encoding="utf-8") as f:
                            files[rel] = f.read()
                    except (UnicodeDecodeError, OSError):
                        continue

        return CodeResult(
            exit_code=exit_code,
            stdout=out[:MAX_OUTPUT], stderr=err[:MAX_OUTPUT],
            duration_s=duration, timed_out=timed_out,
            files=files or None,
        )
