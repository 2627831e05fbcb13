"""AST static-lint framework (counterpart of ``paddle_tpu/analysis/lint.py``;
docs/ANALYSIS.md) — the "check everywhere" half of the sanitizer suite.

Pluggable passes over ``paddle_tpu_torch/`` for the failure modes of a
PyTorch serving stack, each one mechanizing an invariant a past change
argued by hand:

==========================  =================================================
pass id                     what it catches
==========================  =================================================
``silent-except``           broad ``except Exception`` handlers that neither
                            re-raise, log, nor count a metric — errors that
                            simply vanish
``bare-thread``             ``threading.Thread(...)`` without ``name=`` (and
                            postmortem/LockSan stack dumps full of
                            ``Thread-7``)
``wallclock-duration``      ``time.time()`` inside arithmetic/comparison —
                            duration or deadline math that corrupts when the
                            wall clock steps; use ``time.monotonic()``
``time-in-jit``             ``time.*`` / stdlib ``random`` reachable from a
                            compiled function (decorated with, or passed to,
                            ``torch.compile`` or ``jit.to_static``) — traced
                            once, constant forever
``tracer-leak``             storing values on ``self`` / globals / nonlocals
                            from inside a compiled function (the stored
                            value is a trace-time fake or proxy)
``host-sync-in-hot-path``   ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                            ``.numpy()`` / ``np.asarray`` /
                            ``torch.cuda.synchronize`` in the engine's step
                            functions, the paged cache's per-step and spill
                            paths and the kernel wrappers — a hidden
                            device→host sync per step
``fault-site-doc-sync``     every ``faults.inject("site")`` in code appears
                            in docs/ROBUSTNESS.md
``metric-registration``     every registered metric family appears in
                            docs/OBSERVABILITY.md (generalizes
                            tests/test_metrics_reference.py)
==========================  =================================================

**Waivers** are in-source comments on (or adjacent to) the flagged line::

    except Exception:  # lint: allow-silent(best-effort cleanup; errors moot)

with one token per pass (``allow-silent``, ``allow-bare-thread``,
``allow-wallclock``, ``allow-time-in-jit``, ``allow-tracer-leak``,
``allow-host-sync``). The reason inside the parentheses is mandatory —
an empty waiver does not waive. The doc-sync passes have no waiver: fix
the doc.

**Findings are keyed**, and the keys are line-number independent
(``pass:relpath:scope:detail#n``) so the checked-in
``paddle_tpu_torch/analysis/baseline.json`` survives unrelated edits. The
baseline grandfathers pre-existing findings; anything *not* in it fails
``python -m paddle_tpu_torch.analysis.lint --check`` and
``tests/test_torch_lint.py``. The gate ratchets: fix a finding, run
``python -m paddle_tpu_torch.analysis.lint --baseline-update``, and the
stale entry is pruned — it can never come back silently.

The doc-sync passes read the repository's ``docs/ROBUSTNESS.md`` and
``docs/OBSERVABILITY.md``: the port uses the reference's fault-site and
metric-family names.

This module imports nothing from the rest of the package (pure stdlib).
"""
from __future__ import annotations

import argparse
import ast
import fnmatch
import json
import os
import re
import sys
from dataclasses import dataclass, field

__all__ = [
    "Finding", "PASS_IDS", "scan_files", "run", "load_baseline",
    "baseline_payload", "diff_against_baseline",
]

# --------------------------------------------------------------------------
# findings and waivers
# --------------------------------------------------------------------------

PASS_IDS = (
    "silent-except",
    "bare-thread",
    "wallclock-duration",
    "time-in-jit",
    "tracer-leak",
    "host-sync-in-hot-path",
    "fault-site-doc-sync",
    "metric-registration",
)

# pass id -> waiver token accepted in `# lint: allow-<token>(reason)`
WAIVER_TOKENS = {
    "silent-except": "silent",
    "bare-thread": "bare-thread",
    "wallclock-duration": "wallclock",
    "time-in-jit": "time-in-jit",
    "tracer-leak": "tracer-leak",
    "host-sync-in-hot-path": "host-sync",
}

_WAIVER_RE = re.compile(r"#\s*lint:\s*allow-([a-z][a-z0-9-]*)\(([^)]+)\)")


@dataclass
class Finding:
    pass_id: str
    path: str          # repo-relative, forward slashes
    line: int
    scope: str         # dotted enclosing class/function chain, or <module>
    detail: str        # short, line-independent discriminator
    message: str
    key: str = field(default="")

    def as_dict(self) -> dict:
        return {"key": self.key, "pass": self.pass_id, "path": self.path,
                "line": self.line, "scope": self.scope,
                "message": self.message}


def _assign_keys(findings: list[Finding]) -> list[Finding]:
    """Stable keys: identical (pass, path, scope, detail) tuples get an
    occurrence index in source order — immune to line-number drift."""
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id, f.detail))
    seen: dict[tuple, int] = {}
    for f in findings:
        ident = (f.pass_id, f.path, f.scope, f.detail)
        n = seen.get(ident, 0)
        seen[ident] = n + 1
        f.key = f"{f.pass_id}:{f.path}:{f.scope}:{f.detail}#{n}"
    return findings


def _collect_waivers(lines: list[str]) -> dict[int, set[str]]:
    """{1-based line: {tokens}} — empty-reason waivers are ignored."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        for m in _WAIVER_RE.finditer(text):
            token, reason = m.group(1), m.group(2).strip()
            if reason:
                out.setdefault(i, set()).add(token)
    return out


def _waived(waivers: dict[int, set[str]], token: str,
            start: int, end: int | None = None) -> bool:
    """A waiver counts on the flagged line, the line above, or (for
    multi-line constructs) any line the construct spans."""
    end = end or start
    for ln in range(start - 1, end + 1):
        if token in waivers.get(ln, ()):
            return True
    return False


# --------------------------------------------------------------------------
# per-file AST machinery
# --------------------------------------------------------------------------

class _FileCtx:
    def __init__(self, root: str, path: str):
        self.root = root
        self.abspath = path
        self.relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            self.src = f.read()
        self.lines = self.src.splitlines()
        self.tree = ast.parse(self.src, filename=self.relpath)
        self.waivers = _collect_waivers(self.lines)
        self.parents: dict[ast.AST, ast.AST] = {}
        self.scopes: dict[ast.AST, str] = {}
        self._index(self.tree, parent=None, scope=())

    def _index(self, node, parent, scope):
        self.scopes[node] = ".".join(scope) or "<module>"
        if parent is not None:
            self.parents[node] = parent
        child_scope = scope
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            child_scope = scope + (node.name,)
        for child in ast.iter_child_nodes(node):
            self._index(child, node, child_scope)

    def scope_of(self, node) -> str:
        return self.scopes.get(node, "<module>")


def _dotted(node) -> str | None:
    """'a.b.c' for Name/Attribute chains; unwraps Call funcs one level."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return None


def _terminal(node) -> str | None:
    """Last attribute segment of a call target ('self.log.warning'->'warning')."""
    d = _dotted(node)
    return d.rsplit(".", 1)[-1] if d else None


# --------------------------------------------------------------------------
# pass: silent-except
# --------------------------------------------------------------------------

# a call to any of these inside the handler body counts as "handled":
# logging, printing, metric counting, flight-recorder events, re-queueing
# an error for someone who looks, or explicit process exit.
HANDLER_HINTS = {
    "log", "debug", "info", "warning", "warn", "error", "exception",
    "critical", "print", "inc", "dec", "observe", "set", "record",
    "record_event", "dump", "add_note", "fail", "count", "note", "emit",
    "exit", "_exit", "abort", "put", "put_nowait", "append_error",
    # repo idioms: the error is routed into a reporting path
    "_fail", "_emit", "_write_response", "set_exception", "write",
}

_BROAD = {"Exception", "BaseException"}


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Tuple):
        return any(_terminal(e) in _BROAD for e in t.elts)
    return _terminal(t) in _BROAD


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Call) and _terminal(node.func) in HANDLER_HINTS:
            return False
        if isinstance(node, ast.AugAssign):
            return False        # `self.errors += 1` — the error is counted
    return True


def _pass_silent_except(ctx: _FileCtx) -> list[Finding]:
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad_handler(node) or not _handler_is_silent(node):
            continue
        # waiver may sit on the `except` line, the line above, or the
        # first body line (black-formatted handlers put it there)
        end = node.body[0].lineno if node.body else node.lineno
        if _waived(ctx.waivers, "silent", node.lineno, end):
            continue
        out.append(Finding(
            "silent-except", ctx.relpath, node.lineno, ctx.scope_of(node),
            "except", "broad except swallows the error: re-raise, log, "
            "count a metric, or add `# lint: allow-silent(reason)`"))
    return out


# --------------------------------------------------------------------------
# pass: bare-thread
# --------------------------------------------------------------------------

def _pass_bare_thread(ctx: _FileCtx) -> list[Finding]:
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d not in ("threading.Thread", "Thread"):
            continue
        kwargs = {k.arg for k in node.keywords}
        if "name" in kwargs:
            continue
        end = getattr(node, "end_lineno", node.lineno)
        if _waived(ctx.waivers, "bare-thread", node.lineno, end):
            continue
        out.append(Finding(
            "bare-thread", ctx.relpath, node.lineno, ctx.scope_of(node),
            "Thread", "Thread created without name= — postmortem stack "
            "dumps and LockSan reports show an anonymous Thread-N"))
    return out


# --------------------------------------------------------------------------
# pass: wallclock-duration
# --------------------------------------------------------------------------

def _pass_wallclock(ctx: _FileCtx) -> list[Finding]:
    out = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and _dotted(node.func) == "time.time"):
            continue
        # climb to the enclosing statement; flag if any ancestor on the
        # way is arithmetic or a comparison (duration / deadline math)
        cur, hot = node, False
        while cur in ctx.parents and not isinstance(cur, ast.stmt):
            cur = ctx.parents[cur]
            if isinstance(cur, ast.BinOp) and isinstance(
                    cur.op, (ast.Add, ast.Sub)):
                hot = True
            if isinstance(cur, ast.Compare):
                hot = True
        if not hot:
            continue
        if _waived(ctx.waivers, "wallclock", node.lineno):
            continue
        out.append(Finding(
            "wallclock-duration", ctx.relpath, node.lineno,
            ctx.scope_of(node), "time.time",
            "time.time() inside duration/deadline arithmetic — a wall "
            "clock step (NTP, leap smear) corrupts the timeout; use "
            "time.monotonic(), or waive with allow-wallclock(reason) "
            "where the stamp is genuinely exported wall time"))
    return out


# --------------------------------------------------------------------------
# jit-aware passes: time-in-jit, tracer-leak
# --------------------------------------------------------------------------

def _is_compile(dotted: str | None) -> bool:
    """``torch.compile`` or (``jit.`` / ``paddle.jit.``) ``to_static``."""
    d = dotted or ""
    return d == "torch.compile" or d == "to_static" \
        or d.endswith(".to_static")


def _jitted_functions(ctx: _FileCtx) -> list[ast.AST]:
    """Defs decorated with ``torch.compile`` / ``to_static`` (bare or
    called with options), plus defs whose name is later passed to such a
    call in the same scope (``def step(...): ...`` then
    ``torch.compile(step)``)."""
    # (enclosing scope, name): scope-qualified so a method named `step`
    # does not collide with a compiled nested fn named `step` elsewhere
    jit_args: set[tuple[str, str]] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _is_compile(_dotted(node.func)):
            for a in node.args:
                if isinstance(a, ast.Name):
                    jit_args.add((ctx.scope_of(node), a.id))
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        deco = any(_is_compile(_dotted(d)) for d in node.decorator_list)
        if deco or (ctx.scope_of(node), node.name) in jit_args:
            out.append(node)
    return out


_JIT_BANNED = {"time.time", "time.monotonic", "time.perf_counter",
               "time.process_time", "datetime.now",
               "datetime.datetime.now", "datetime.utcnow"}


def _pass_time_in_jit(ctx: _FileCtx) -> list[Finding]:
    out = []
    for fn in _jitted_functions(ctx):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            # stdlib random and np.random are *stateful* — a fresh draw
            # per trace, then frozen; torch's generators are graph ops
            bad = (d in _JIT_BANNED or d.startswith("random.")
                   or d.startswith(("np.random.", "numpy.random.")))
            if not bad:
                continue
            if _waived(ctx.waivers, "time-in-jit", node.lineno):
                continue
            out.append(Finding(
                "time-in-jit", ctx.relpath, node.lineno,
                ctx.scope_of(node), d,
                f"{d}() inside compiled `{fn.name}` — evaluated once at "
                "trace time, then baked in as a constant forever; hoist "
                "it to the caller or pass the stamp in as an argument"))
    return out


def _pass_tracer_leak(ctx: _FileCtx) -> list[Finding]:
    out = []
    for fn in _jitted_functions(ctx):
        for node in ast.walk(fn):
            leak = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        leak = f"self.{t.attr}"
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                kind = ("global" if isinstance(node, ast.Global)
                        else "nonlocal")
                leak = f"{kind} {','.join(node.names)}"
            if leak is None:
                continue
            if _waived(ctx.waivers, "tracer-leak", node.lineno):
                continue
            out.append(Finding(
                "tracer-leak", ctx.relpath, node.lineno,
                ctx.scope_of(node), leak,
                f"compiled `{fn.name}` writes {leak} — the stored value is "
                "a trace-time fake or proxy that escapes the trace (an "
                "error at best, a silently stale constant at worst); "
                "return it instead"))
    return out


# --------------------------------------------------------------------------
# pass: host-sync-in-hot-path
# --------------------------------------------------------------------------

# hot paths: the engine's step functions, the paged cache's per-step
# attention and its spill tier, and the kernel wrappers. Keys are fnmatch
# patterns of repo-relative paths; "*" = every function in the file,
# otherwise function-name prefixes.
HOT_PATHS = {
    "paddle_tpu_torch/serving/engine.py": (
        "_prefill_forward", "_decode_forward", "_run_prefill",
        "_run_decode", "_decode_step"),
    "paddle_tpu_torch/serving/kv_cache.py": (
        "attend", "_decode", "_prefill", "_spill_block", "_promote"),
    "paddle_tpu_torch/kernels/*.py": ("*",),
}

_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SYNC_CALLS = {"np.asarray", "numpy.asarray", "torch.cuda.synchronize"}


def _hot_prefixes(relpath: str):
    for pattern, prefixes in HOT_PATHS.items():
        if fnmatch.fnmatchcase(relpath, pattern):
            return prefixes
    return None


def _pass_host_sync(ctx: _FileCtx) -> list[Finding]:
    prefixes = _hot_prefixes(ctx.relpath)
    if not prefixes:
        return []
    out = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if "*" not in prefixes and not fn.name.startswith(prefixes):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            term = _terminal(node.func)
            bad = None
            if term in _SYNC_ATTRS and isinstance(node.func, ast.Attribute):
                bad = f".{term}()"
            elif d in _SYNC_CALLS:
                bad = f"{d}()"
            elif (d == "float" and node.args
                  and isinstance(node.args[0], ast.Name)):
                bad = "float(arr)"
            if bad is None:
                continue
            if _waived(ctx.waivers, "host-sync", node.lineno):
                continue
            out.append(Finding(
                "host-sync-in-hot-path", ctx.relpath, node.lineno,
                ctx.scope_of(node), bad,
                f"{bad} in hot path `{fn.name}` forces a device→host "
                "sync per call — batch the transfer outside the loop or "
                "waive with allow-host-sync(reason) where the host needs "
                "the value"))
    return out


# --------------------------------------------------------------------------
# cross-file textual passes: fault-site-doc-sync, metric-registration
# --------------------------------------------------------------------------

_INJECT_RE = re.compile(r"""\bfaults\.inject\(\s*\n?\s*["']([\w.\-]+)["']""")

# same scan tests/test_metrics_reference.py runs: a literal first argument
# to .counter/.gauge/.histogram or the single-letter C/G/H wrappers
_METRIC_RE = re.compile(
    r"""(?:\.\s*(?:counter|gauge|histogram)|\b[CGH])\(\s*\n?\s*"""
    r"""["']([a-z][a-z0-9_]*)["']""")
_METRIC_IGNORE = {"x"}     # docstring examples


def _textual_pass(root, ctxs, pass_id, doc_rel, regex, ignore=(),
                  what="name"):
    doc_path = os.path.join(root, doc_rel)
    if not os.path.exists(doc_path):
        return []          # synthetic test trees without docs/: nothing to sync
    with open(doc_path, encoding="utf-8") as f:
        doc = f.read()
    out = []
    seen: set[str] = set()
    for ctx in ctxs:
        for m in regex.finditer(ctx.src):
            name = m.group(1)
            if name in ignore or name in seen or name in doc:
                continue
            seen.add(name)
            line = ctx.src.count("\n", 0, m.start()) + 1
            out.append(Finding(
                pass_id, ctx.relpath, line, "<module>", name,
                f"{what} `{name}` is used in code but absent from "
                f"{doc_rel} — add it to the reference table"))
    return out


def _pass_fault_site_doc_sync(root, ctxs):
    return _textual_pass(root, ctxs, "fault-site-doc-sync",
                         os.path.join("docs", "ROBUSTNESS.md"),
                         _INJECT_RE, what="fault site")


def _pass_metric_registration(root, ctxs):
    pkg = [c for c in ctxs if c.relpath.startswith("paddle_tpu_torch/")]
    return _textual_pass(root, pkg, "metric-registration",
                         os.path.join("docs", "OBSERVABILITY.md"),
                         _METRIC_RE, ignore=_METRIC_IGNORE,
                         what="metric family")


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

_FILE_PASSES = {
    "silent-except": _pass_silent_except,
    "bare-thread": _pass_bare_thread,
    "wallclock-duration": _pass_wallclock,
    "time-in-jit": _pass_time_in_jit,
    "tracer-leak": _pass_tracer_leak,
    "host-sync-in-hot-path": _pass_host_sync,
}

SCAN_ROOTS = ("paddle_tpu_torch",)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASELINE = os.path.join(REPO, "paddle_tpu_torch", "analysis",
                        "baseline.json")


def scan_files(root: str) -> list[str]:
    out = []
    for sub in SCAN_ROOTS:
        top = os.path.join(root, sub)
        if not os.path.isdir(top):
            continue
        for dirpath, dirnames, files in os.walk(top):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(files):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def run(root: str, files: list[str] | None = None,
        passes: list[str] | None = None) -> list[Finding]:
    """Run the requested passes (default: all) and return keyed findings."""
    active = list(passes) if passes else list(PASS_IDS)
    unknown = set(active) - set(PASS_IDS)
    if unknown:
        raise ValueError(f"unknown lint pass(es): {sorted(unknown)}; "
                         f"known: {list(PASS_IDS)}")
    paths = files if files is not None else scan_files(root)
    ctxs, findings = [], []
    for path in paths:
        try:
            ctx = _FileCtx(root, path)
        except (SyntaxError, UnicodeDecodeError) as exc:
            findings.append(Finding(
                "silent-except", os.path.relpath(path, root), 0,
                "<module>", "unparseable",
                f"file does not parse ({exc.__class__.__name__}): {exc}"))
            continue
        ctxs.append(ctx)
        for pass_id, fn in _FILE_PASSES.items():
            if pass_id in active:
                findings.extend(fn(ctx))
    if "fault-site-doc-sync" in active:
        findings.extend(_pass_fault_site_doc_sync(root, ctxs))
    if "metric-registration" in active:
        findings.extend(_pass_metric_registration(root, ctxs))
    return _assign_keys(findings)


# --------------------------------------------------------------------------
# baseline (the ratchet)
# --------------------------------------------------------------------------

def load_baseline(path: str) -> dict:
    if not os.path.exists(path):
        return {"version": 1, "findings": {}}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != 1 or not isinstance(
            data.get("findings"), dict):
        raise ValueError(f"unrecognized baseline format in {path}")
    return data


def baseline_payload(findings: list[Finding]) -> dict:
    return {
        "version": 1,
        "comment": "grandfathered lint findings of paddle_tpu_torch/. "
                   "Never add entries by hand: fix the finding or waive "
                   "it in-source; regenerate with `python -m "
                   "paddle_tpu_torch.analysis.lint --baseline-update`.",
        "findings": {
            f.key: {"path": f.path, "line": f.line, "message": f.message}
            for f in findings
        },
    }


def diff_against_baseline(findings: list[Finding], baseline: dict):
    """(new, stale): findings absent from the baseline, and baseline keys
    no longer produced (fixed — prune with --baseline-update)."""
    known = baseline.get("findings", {})
    current = {f.key for f in findings}
    new = [f for f in findings if f.key not in known]
    stale = sorted(k for k in known if k not in current)
    return new, stale


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    """``python -m paddle_tpu_torch.analysis.lint --check`` exits 1 naming
    the findings not in the baseline (stale baseline keys are reported
    too); ``--baseline-update`` rewrites the baseline to the current
    findings; ``--json`` prints the report as JSON; ``--pass ID``
    (repeatable) runs only those passes."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis.lint",
        description="paddle_tpu_torch AST lint suite")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if findings not in the baseline exist")
    ap.add_argument("--baseline-update", action="store_true",
                    help="rewrite the baseline to the current findings")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON on stdout")
    ap.add_argument("--pass", dest="passes", action="append", default=None,
                    metavar="PASS", help="run only this pass (repeatable)")
    ap.add_argument("--root", default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    findings = run(args.root, passes=args.passes)
    if args.baseline_update:
        with open(BASELINE, "w", encoding="utf-8") as f:
            json.dump(baseline_payload(findings), f, indent=1,
                      sort_keys=True)
            f.write("\n")
        print(f"baseline updated: {len(findings)} grandfathered finding(s) "
              f"-> {os.path.relpath(BASELINE, args.root)}")
        return 0
    new, stale = diff_against_baseline(findings, load_baseline(BASELINE))
    if args.json:
        print(json.dumps({
            "total": len(findings),
            "grandfathered": len(findings) - len(new),
            "new": [f.as_dict() for f in new],
            "stale_baseline_keys": stale,
        }, indent=1, sort_keys=True))
    else:
        print(f"lint: {len(findings)} finding(s), "
              f"{len(findings) - len(new)} grandfathered, {len(new)} new")
        for f in new:
            print(f"  {f.path}:{f.line} [{f.pass_id}] {f.message}")
        for k in stale:
            print(f"  stale baseline key (fixed; prune with "
                  f"--baseline-update): {k}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
