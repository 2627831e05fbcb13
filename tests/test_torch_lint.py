"""The port's AST lint framework (``paddle_tpu_torch/analysis/lint.py``)
against the JAX package's (``paddle_tpu/analysis/lint.py``):

- every pass gives the reference's findings (pass, line, scope, detail,
  key past the package prefix) on the same synthetic sources: a positive,
  a negative and a waived variant each. Only the idioms differ: the port's
  compiled functions are ``torch.compile`` / ``to_static`` ones where the
  reference's are ``jax.jit`` ones, and its hot paths are the port's
  engine step functions, paged-cache paths and kernel wrappers, whose
  syncs include ``.cpu()`` / ``.numpy()`` / ``torch.cuda.synchronize``;
- keys are line-independent and the baseline diff works;
- the tree gate: ``paddle_tpu_torch/`` has no finding outside
  ``paddle_tpu_torch/analysis/baseline.json``, and the entry point's
  ``--check`` exits 0.
"""
import importlib.util
import json
import os
import sys

import pytest

from paddle_tpu_torch.analysis import lint as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference():
    path = os.path.join(REPO, "paddle_tpu", "analysis", "lint.py")
    spec = importlib.util.spec_from_file_location("_ref_lint", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_ref_lint"] = mod
    spec.loader.exec_module(mod)
    return mod


jl = _load_reference()
PKG = {jl: "paddle_tpu", tl: "paddle_tpu_torch"}


def _run(mod, root, src, passes, rel="mod.py", docs=None):
    f = root / PKG[mod] / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    for name, text in (docs or {}).items():
        (root / "docs").mkdir(exist_ok=True)
        (root / "docs" / name).write_text(text)
    return mod.run(str(root), files=[str(f)], passes=passes)


def _view(mod, found):
    pre = PKG[mod] + "/"
    return [(f.pass_id, f.line, f.scope, f.detail,
             f.key.replace(pre, "", 1)) for f in found]


def _both(tmp_path, src, passes, tsrc=None, **kw):
    j = _run(jl, tmp_path / "j", src, passes, **kw)
    t = _run(tl, tmp_path / "t", tsrc or src, passes, **kw)
    return _view(jl, j), _view(tl, t)


SILENT = {
    "positive": "def f():\n    try:\n        g()\n    except Exception:\n"
                "        pass\n",
    "bare": "def f():\n    try:\n        g()\n    except:\n        pass\n",
    "negative": "def f():\n    try:\n        g()\n    except Exception as e:\n"
                "        log.warning(e)\n    try:\n        g()\n"
                "    except Exception:\n        raise\n    try:\n        g()\n"
                "    except Exception:\n        self.errors += 1\n"
                "    try:\n        g()\n    except ValueError:\n"
                "        pass\n",
    "waiver": "def f():\n    try:\n        g()\n"
              "    except Exception:  # lint: allow-silent(best effort)\n"
              "        pass\n",
    "empty waiver": "def f():\n    try:\n        g()\n"
                    "    except Exception:  # lint: allow-silent()\n"
                    "        pass\n",
}
THREAD = {
    "positive": "import threading\nt = threading.Thread(target=f)\n",
    "negative": "import threading\nt = threading.Thread(target=f, "
                "name='w')\n",
    "waiver": "import threading\nt = threading.Thread(target=f)"
              "  # lint: allow-bare-thread(test helper)\n",
}
WALL = {
    "positive": "import time\ndeadline = time.time() + 30\n"
                "if time.time() > deadline:\n    pass\n",
    "negative": "import time\nstamp = time.time()\n"
                "deadline = time.monotonic() + 30\n",
    "waiver": "import time\n# lint: allow-wallclock(exported wall time)\n"
              "deadline_unix = time.time() + 30\n",
}


@pytest.mark.parametrize("pass_id,case", [
    ("silent-except", c) for c in SILENT] + [
    ("bare-thread", c) for c in THREAD] + [
    ("wallclock-duration", c) for c in WALL])
def test_plain_passes_match(tmp_path, pass_id, case):
    src = {"silent-except": SILENT, "bare-thread": THREAD,
           "wallclock-duration": WALL}[pass_id][case]
    j, t = _both(tmp_path, src, [pass_id])
    assert t == j
    assert bool(t) == (case in ("positive", "bare", "empty waiver"))


# the compiled-function idioms: the reference's jax.jit, the port's
# torch.compile / to_static
JIT = {
    "decorator": ("@jax.jit\ndef f(x):\n    return x * time.time()\n",
                  "@torch.compile\ndef f(x):\n    return x * time.time()\n"),
    "decorator with options": (
        "@jax.jit(static_argnums=0)\ndef f(x):\n    return random.random()\n",
        "@torch.compile(dynamic=False)\ndef f(x):\n"
        "    return random.random()\n"),
    "passed in the same scope": (
        "def build():\n    def step(x):\n        return np.random.rand()\n"
        "    return jax.jit(step)\n",
        "def build():\n    def step(x):\n        return np.random.rand()\n"
        "    return torch.compile(step)\n"),
    "to_static": ("@paddle.jit.to_static\ndef f(x):\n"
                  "    return time.perf_counter()\n",
                  "@paddle.jit.to_static\ndef f(x):\n"
                  "    return time.perf_counter()\n"),
    "no cross-scope collision": (
        "def build():\n    def step(x):\n        return x\n"
        "    return jax.jit(step)\nclass E:\n    def step(self):\n"
        "        return time.time()\n",
        "def build():\n    def step(x):\n        return x\n"
        "    return torch.compile(step)\nclass E:\n    def step(self):\n"
        "        return time.time()\n"),
    "unjitted": ("def g():\n    return time.time()\n",) * 2,
    "waiver": ("@jax.jit\ndef f(x):\n    return x * time.time()"
               "  # lint: allow-time-in-jit(trace stamp wanted)\n",
               "@torch.compile\ndef f(x):\n    return x * time.time()"
               "  # lint: allow-time-in-jit(trace stamp wanted)\n"),
}
LEAK = {
    "self write": ("class M:\n    @jax.jit\n    def f(self, x):\n"
                   "        self.cache = x\n        return x\n",
                   "class M:\n    @torch.compile\n    def f(self, x):\n"
                   "        self.cache = x\n        return x\n"),
    "nonlocal": ("def build():\n    acc = None\n    @jax.jit\n    def f(x):\n"
                 "        nonlocal acc\n        acc = x\n        return x\n"
                 "    return f\n",
                 "def build():\n    acc = None\n    @torch.compile\n"
                 "    def f(x):\n        nonlocal acc\n        acc = x\n"
                 "        return x\n    return f\n"),
    "negative": ("@jax.jit\ndef f(x):\n    y = x + 1\n    return y\n"
                 "class M:\n    def g(self, x):\n        self.c = x\n",
                 "@torch.compile\ndef f(x):\n    y = x + 1\n    return y\n"
                 "class M:\n    def g(self, x):\n        self.c = x\n"),
    "waiver": ("class M:\n    @jax.jit\n    def f(self, x):\n"
               "        # lint: allow-tracer-leak(trace-time counter)\n"
               "        self.traces = 1\n        return x\n",
               "class M:\n    @torch.compile\n    def f(self, x):\n"
               "        # lint: allow-tracer-leak(trace-time counter)\n"
               "        self.traces = 1\n        return x\n"),
}


@pytest.mark.parametrize("pass_id,case", [
    ("time-in-jit", c) for c in JIT] + [("tracer-leak", c) for c in LEAK])
def test_compiled_function_passes_match(tmp_path, pass_id, case):
    jsrc, tsrc = (JIT if pass_id == "time-in-jit" else LEAK)[case]
    j, t = _both(tmp_path, jsrc, [pass_id], tsrc=tsrc)
    assert t == j
    assert bool(t) == (case in ("decorator", "decorator with options",
                                "passed in the same scope", "to_static",
                                "self write", "nonlocal"))
    # the other package's idiom is not a compiled function here
    other = _run(tl, tmp_path / "x", jsrc, [pass_id])
    if "jax.jit" in jsrc:
        assert other == []


# each package's hot files and function names
HOT = {
    "item": ("def decode_step(arr):\n    return arr.item()\n",
             "serving/engine.py",
             "def _decode_step(arr):\n    return arr.item()\n"),
    "tolist": ("def prefill(a):\n    return a.tolist()\n",
               "serving/engine.py",
               "def _run_prefill(a):\n    return a.tolist()\n"),
    "asarray": ("def f(a):\n    return np.asarray(a)\n",
                "kernels/paged_attention.py",
                "def f(a):\n    return np.asarray(a)\n"),
    "float": ("def f(a):\n    return float(a)\n",
              "kernels/flash_attention.py",
              "def f(a):\n    return float(a)\n"),
    "cold function": ("def report(a):\n    return a.item()\n",
                      "serving/engine.py",
                      "def report(a):\n    return a.item()\n"),
    "waiver": ("def prefill(a):\n    return a.item()"
               "  # lint: allow-host-sync(the sampled token)\n",
               "serving/engine.py",
               "def _run_prefill(a):\n    return a.item()"
               "  # lint: allow-host-sync(the sampled token)\n"),
}


@pytest.mark.parametrize("case", list(HOT))
def test_host_sync_matches(tmp_path, case):
    jsrc, rel, tsrc = HOT[case]
    j = _view(jl, _run(jl, tmp_path / "j", jsrc, ["host-sync-in-hot-path"],
                       rel=rel))
    t = _view(tl, _run(tl, tmp_path / "t", tsrc, ["host-sync-in-hot-path"],
                       rel=rel))
    assert [x[:2] + x[3:4] for x in t] == [x[:2] + x[3:4] for x in j]
    assert bool(t) == (case not in ("cold function", "waiver"))
    # the same call outside a hot file is clean
    assert _run(tl, tmp_path / "c", tsrc, ["host-sync-in-hot-path"]) == []


@pytest.mark.parametrize("src,detail", [
    ("def f(a):\n    return a.cpu()\n", ".cpu()"),
    ("def f(a):\n    return a.numpy()\n", ".numpy()"),
    ("def f():\n    torch.cuda.synchronize()\n", ".synchronize()"),
])
def test_host_sync_port_calls(tmp_path, src, detail):
    """The port's sync calls, in every kernel wrapper and in the paged
    cache's spill path."""
    for rel in ("kernels/rmsnorm.py", "kernels/new_kernel.py"):
        found = _run(tl, tmp_path / rel.replace("/", "_"), src,
                     ["host-sync-in-hot-path"], rel=rel)
        assert [f.detail for f in found] == [detail]
    spill = src.replace("def f(", "def _spill_block(")
    found = _run(tl, tmp_path / "kv", spill, ["host-sync-in-hot-path"],
                 rel="serving/kv_cache.py")
    assert [f.detail for f in found] == [detail]


def test_doc_sync_passes_match(tmp_path):
    code = ('faults.inject("a.documented")\nfaults.inject("b.missing")\n'
            'reg.counter(\n    "documented_total", "h")\n'
            'reg.gauge("missing_gauge", "h")\n')
    docs = {"ROBUSTNESS.md": "| `a.documented` | somewhere | error |\n",
            "OBSERVABILITY.md": "| `documented_total` | counter |\n"}
    for pass_id, want in (("fault-site-doc-sync", ["b.missing"]),
                          ("metric-registration", ["missing_gauge"])):
        j, t = _both(tmp_path / pass_id, code, [pass_id], docs=docs)
        assert t == j and [x[3] for x in t] == want
    # a tree without docs/ has nothing to sync
    assert _run(tl, tmp_path / "nodocs", code,
                ["fault-site-doc-sync", "metric-registration"]) == []


def test_keys_are_line_independent_and_baseline_diff(tmp_path):
    src = SILENT["positive"]
    k1 = _run(tl, tmp_path / "a", src, ["silent-except"])[0].key
    k2 = _run(tl, tmp_path / "b", "\n\n\n" + src, ["silent-except"])[0].key
    assert k1 == k2 == "silent-except:paddle_tpu_torch/mod.py:f:except#0"
    two = _run(tl, tmp_path / "c", src + src.replace("def f", "def g")
               + src.replace("def f", "def h").replace("pass", "pass\n"
                                                       "    try:\n"
                                                       "        g()\n"
                                                       "    except "
                                                       "Exception:\n"
                                                       "        pass"),
               ["silent-except"])
    keys = [f.key for f in two]
    assert len(keys) == len(set(keys)) == 4
    found = _run(tl, tmp_path / "d", src, ["silent-except"])
    base = tl.baseline_payload(found)
    assert base == json.loads(json.dumps(base))
    assert tl.diff_against_baseline(found, base) == ([], [])
    assert tl.diff_against_baseline([], base) == ([], [found[0].key])
    assert [f.key for f in tl.diff_against_baseline(found, {})[0]] == \
        [found[0].key]
    with pytest.raises(ValueError):
        tl.run(REPO, files=[], passes=["no-such-pass"])
    assert tl.PASS_IDS == jl.PASS_IDS
    assert tl.WAIVER_TOKENS == jl.WAIVER_TOKENS


def test_tree_gate():
    findings = tl.run(REPO)
    new, stale = tl.diff_against_baseline(
        findings, tl.load_baseline(tl.BASELINE))
    assert not new, "lint findings outside the port's baseline:\n" + "\n".join(
        f"  {f.path}:{f.line} [{f.pass_id}] {f.message}" for f in new)
    assert not stale, f"stale baseline keys (prune them): {stale}"
    assert all(f.path.startswith("paddle_tpu_torch/") for f in findings)
    assert tl.main(["--check"]) == 0
