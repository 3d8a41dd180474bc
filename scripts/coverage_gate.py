#!/usr/bin/env python
"""Statement-coverage measurement + gate for innr_tpu (no coverage.py).

The reference's coverage CI job exists to prove every dispatch arm
executes (``/root/reference/.github/workflows/ci.yml:174-191``,
cargo-llvm-cov). This environment has no coverage.py, so this script is a
self-contained analog built on Python 3.12 ``sys.monitoring`` (PEP 669):
a LINE-event callback records the first execution of every
``innr_tpu/``-file line and then returns ``DISABLE`` for that location,
so steady-state overhead is near zero (the same trick coverage.py's
sysmon core uses). Executable lines come from walking each module's
compiled code objects (``co_lines``); ``# pragma: no cover`` lines — and
whole ``def``/``class`` bodies whose header carries the pragma — are
excluded.

Usage:
    python scripts/coverage_gate.py                       # full suite
    python scripts/coverage_gate.py tests/test_dense.py   # subset
    python scripts/coverage_gate.py --threshold 0.85

Writes ``COVERAGE_LINES.md`` (per-module table + worst uncovered runs) and
exits 1 when total statement coverage falls below the threshold.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "innr_tpu"
TOOL_ID = sys.monitoring.COVERAGE_ID

# Child-process instrumentation (VERDICT r3 item 6: the gate was blind to
# code running in spawned children — multihost workers, the dryrun CPU
# child — so e.g. parallel/multihost.py read 0% despite being tested).
# A sitecustomize hook dir is prepended to PYTHONPATH; every python child
# chain-loads the displaced sitecustomize, installs the same first-hit LINE monitor gated on
# INNR_COVER_DIR, and atexit-dumps its hits as JSON for the parent to
# merge. cargo-llvm-cov gets this for free; sys.monitoring does not.
_HOOK_SRC = '''\
import atexit
import json
import os
import sys

_me = os.path.dirname(os.path.abspath(__file__))

# Chain-load the sitecustomize this hook displaced so child processes keep their normal startup behavior.
for _p in list(sys.path):
    try:
        _ap = os.path.abspath(_p or os.getcwd())
    except OSError:
        continue
    if _ap == _me:
        continue
    _cand = os.path.join(_ap, "sitecustomize.py")
    if os.path.isfile(_cand):
        import runpy

        try:
            runpy.run_path(_cand, run_name="sitecustomize_chained")
        except Exception:
            pass
        break

_dir = os.environ.get("INNR_COVER_DIR")
if _dir:
    _prefix = os.environ.get("INNR_COVER_PREFIX", "")
    _hits = {}

    def _on_line(code, line):
        fn = code.co_filename
        if fn.startswith(_prefix):
            _hits.setdefault(fn, set()).add(line)
        return sys.monitoring.DISABLE

    _tid = sys.monitoring.COVERAGE_ID
    try:
        sys.monitoring.use_tool_id(_tid, "innr-coverage-child")
        sys.monitoring.register_callback(
            _tid, sys.monitoring.events.LINE, _on_line
        )
        sys.monitoring.set_events(_tid, sys.monitoring.events.LINE)
    except ValueError:
        pass  # tool id already taken in this process; skip quietly
    else:
        def _dump():
            try:
                sys.monitoring.set_events(_tid, 0)
            except Exception:
                pass
            out = {k: sorted(v) for k, v in _hits.items()}
            path = os.path.join(
                _dir, f"cov_{os.getpid()}_{id(_hits):x}.json"
            )
            try:
                with open(path, "w") as f:
                    json.dump(out, f)
            except OSError:
                pass

        atexit.register(_dump)
'''


def executable_lines(path: Path) -> set[int]:
    """Lines that can execute: union of co_lines() over all nested code
    objects, minus pragma exclusions."""
    src = path.read_text()
    code = compile(src, str(path), "exec")
    lines: set[int] = set()

    def walk(co):
        for (_, _, line) in co.co_lines():
            if line is not None:
                lines.add(line)
        for const in co.co_consts:
            if hasattr(const, "co_lines"):
                walk(const)

    walk(code)

    # pragma exclusions: the flagged line, plus the whole body when the
    # pragma sits on a def/class/if header.
    raw = src.splitlines()
    pragma = {
        i + 1 for i, text in enumerate(raw) if "pragma: no cover" in text
    }
    if pragma:
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                       ast.If)
            ) and node.lineno in pragma:
                end = getattr(node, "end_lineno", node.lineno)
                pragma.update(range(node.lineno, end + 1))
    return lines - pragma


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tests", nargs="*", default=["tests/"])
    ap.add_argument("--threshold", type=float, default=0.80)
    ap.add_argument("--report", default="COVERAGE_LINES.md")
    args = ap.parse_args()

    prefix = str(PKG)
    hits: dict[str, set[int]] = {}

    def on_line(code, line):
        fn = code.co_filename
        if fn.startswith(prefix):
            hits.setdefault(fn, set()).add(line)
        return sys.monitoring.DISABLE  # first-hit only per location

    # Instrument child processes: hook dir on PYTHONPATH + dump dir.
    cover_tmp = tempfile.mkdtemp(prefix="innr_cov_")
    hook_dir = os.path.join(cover_tmp, "hook")
    os.makedirs(hook_dir)
    with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
        f.write(_HOOK_SRC)
    os.environ["INNR_COVER_DIR"] = cover_tmp
    os.environ["INNR_COVER_PREFIX"] = prefix
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [hook_dir] + [p for p in
                      os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    )

    sys.monitoring.use_tool_id(TOOL_ID, "innr-coverage")
    sys.monitoring.register_callback(
        TOOL_ID, sys.monitoring.events.LINE, on_line
    )
    sys.monitoring.set_events(TOOL_ID, sys.monitoring.events.LINE)
    try:
        import pytest

        rc = pytest.main(["-x", "-q", "-p", "no:cacheprovider",
                          *args.tests])
    finally:
        sys.monitoring.set_events(TOOL_ID, 0)
        sys.monitoring.free_tool_id(TOOL_ID)
    if rc != 0:
        print(f"pytest failed (rc={rc}); coverage not gated", file=sys.stderr)
        return int(rc)

    # Merge child-process dumps.
    n_children = 0
    for name in os.listdir(cover_tmp):
        if not name.startswith("cov_") or not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(cover_tmp, name)) as f:
                dump = json.load(f)
        except (OSError, ValueError):
            continue
        n_children += 1
        for fn, lines in dump.items():
            hits.setdefault(fn, set()).update(lines)
    if n_children:
        print(f"merged coverage from {n_children} child process dumps")

    rows = []
    tot_hit = tot_all = 0
    worst: list[tuple[str, list[int]]] = []
    for path in sorted(PKG.rglob("*.py")):
        exe = executable_lines(path)
        if not exe:
            continue
        got = hits.get(str(path), set()) & exe
        missing = sorted(exe - got)
        tot_hit += len(got)
        tot_all += len(exe)
        rel = str(path.relative_to(REPO))
        rows.append((rel, len(got), len(exe), missing))
    rows.sort(key=lambda r: r[1] / r[2])

    total = tot_hit / max(tot_all, 1)
    lines = [
        "# Statement coverage (sys.monitoring gate)",
        "",
        f"Total: **{total:.1%}** ({tot_hit}/{tot_all} executable lines) — "
        f"threshold {args.threshold:.0%}; suite: {' '.join(args.tests)}",
        "",
        "| module | covered | lines | % | first uncovered lines |",
        "|---|---|---|---|---|",
    ]
    for rel, got_n, all_n, missing in rows:
        head = ", ".join(map(str, missing[:12]))
        if len(missing) > 12:
            head += ", …"
        lines.append(
            f"| {rel} | {got_n} | {all_n} | {got_n / all_n:.0%} | {head} |"
        )
    (REPO / args.report).write_text("\n".join(lines) + "\n")
    print(f"\nTOTAL statement coverage: {total:.1%} "
          f"({tot_hit}/{tot_all}) -> {args.report}")
    return 0 if total >= args.threshold else 1


if __name__ == "__main__":
    sys.exit(main())
