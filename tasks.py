"""Developer task runner for perphil-tpu.

Plays the role of the reference's Invoke-based ``tasks.py`` (18 tasks,
``/root/reference/tasks.py:251-1494``). Most of the reference's tasks exist
to build PETSc/Firedrake from source — a problem this library does not have
(JAX is the only runtime dependency) — so the surviving vocabulary is the
development workflow: environment setup, tests, benchmarks, notebook
regeneration and pairing, and hygiene.

Zero-dependency: plain argparse (Invoke is not assumed). Usage:

    python tasks.py <task> [args...]
    python tasks.py --list
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).parent

TASKS = {}


def task(fn):
    TASKS[fn.__name__.replace("_", "-")] = fn
    return fn


def _run(cmd, **kw):
    print("+", " ".join(map(str, cmd)))
    return subprocess.run([str(c) for c in cmd], check=True, **kw)


@task
def dev_install(args):
    """Editable install of the package (zero-egress safe)."""
    _run([sys.executable, "-m", "pip", "install", "-e", ".", "--no-deps",
          "--no-build-isolation"])


@task
def tests(args):
    """Run the FULL test suite, slow-marked tests included (mirrors
    `inv tests`, reference tasks.py:1262-1338). Bare `pytest -q` skips the
    slow set for a fast everyday loop (see tests/conftest.py)."""
    import os

    extra = args.rest or ["-q"]
    env = {**os.environ, "PERPHIL_RUN_SLOW": "1"}
    _run([sys.executable, "-m", "pytest", "tests/", *extra], env=env)


@task
def tests_regression(args):
    """Only the golden-number regression tests against the reference CSVs."""
    _run([sys.executable, "-m", "pytest", "tests/", "-q", "-m", "regression",
          *(args.rest or [])])


@task
def bench(args):
    """Run the headline benchmark (one JSON line; needs a GPU)."""
    _run([sys.executable, "bench.py"])


@task
def notebooks(args):
    """Regenerate every study's CSV/PNG artifacts (PERPHIL_FAST=1 for a
    quick pass). Mirrors running the reference's six Jupytext studies."""
    import os

    env = dict(**__import__("os").environ)
    if args.rest and args.rest[0] == "fast":
        env["PERPHIL_FAST"] = "1"
    for nb in sorted((ROOT / "notebooks").glob("*.py")):
        if nb.name.startswith("_"):  # shared libraries, not studies
            continue
        print(f"=== {nb.name}")
        subprocess.run([sys.executable, str(nb)], check=True, env=env)


@task
def pair_ipynbs(args):
    """Generate paired .ipynb files from the percent-format notebook scripts
    (mirrors `inv pair-ipynbs`, reference tasks.py:1212-1241; uses jupytext
    when available, otherwise a built-in percent parser + nbformat)."""
    scripts = [
        s for s in sorted((ROOT / "notebooks").glob("*.py"))
        if not s.name.startswith("_")  # shared libraries, not studies
    ]
    try:
        import jupytext  # noqa: F401

        for s in scripts:
            _run([sys.executable, "-m", "jupytext", "--to", "ipynb", str(s)])
        return
    except ImportError:
        pass
    import nbformat as nbf

    for s in scripts:
        nb = nbf.v4.new_notebook()
        cells = []
        kind, buf = None, []

        def flush():
            if kind is None or not buf:
                return
            src = "".join(buf).strip("\n")
            if kind == "markdown":
                src = "\n".join(
                    line[2:] if line.startswith("# ") else line.lstrip("#")
                    for line in src.splitlines()
                )
                cells.append(nbf.v4.new_markdown_cell(src))
            else:
                cells.append(nbf.v4.new_code_cell(src))

        for line in s.read_text().splitlines(keepends=True):
            if line.startswith("# %% [markdown]"):
                flush()
                kind, buf = "markdown", []
            elif line.startswith("# %%"):
                flush()
                kind, buf = "code", []
            else:
                if kind is None:
                    kind, buf = "code", []
                buf.append(line)
        flush()
        nb["cells"] = cells
        out = s.with_suffix(".ipynb")
        nbf.write(nb, out)
        print("paired", out.name)


@task
def type_check(args):
    """mypy over the package when available (reference tasks.py:1415-1446)."""
    try:
        import mypy  # noqa: F401
    except ImportError:
        print("mypy not installed; skipping (baked image has no mypy)")
        return
    _run([sys.executable, "-m", "mypy", "perphil_tpu"])


@task
def clean(args):
    """Remove caches and build artifacts (reference tasks.py:1118)."""
    for pat in ("**/__pycache__", "**/*.egg-info", ".pytest_cache", "build", "dist"):
        for p in ROOT.glob(pat):
            shutil.rmtree(p, ignore_errors=True)
            print("removed", p)


@task
def hooks(args):
    """Install the pre-commit git hooks (reference tasks.py:1156-1170).
    Pass `overwrite` to reinstall over an existing hook."""
    if shutil.which("pre-commit") is None:
        print("pre-commit not installed; hook config is .pre-commit-config.yaml")
        return
    cmd = ["pre-commit", "install"]
    if args.rest and args.rest[0] == "overwrite":
        cmd.append("--overwrite")
    _run(cmd)


@task
def run_hooks(args):
    """Run the configured pre-commit hooks (reference tasks.py:1172-1210).
    Pass `all` to run on every file instead of the staged diff."""
    if shutil.which("pre-commit") is None:
        print("pre-commit not installed; running the built-in fallback checks")
        _builtin_hygiene_checks()
        return
    cmd = ["pre-commit", "run"]
    if args.rest and args.rest[0] == "all":
        cmd.append("--all-files")
    _run(cmd)


def _builtin_hygiene_checks():
    """Zero-dependency analogue of the hook suite: trailing whitespace,
    missing final newline, and compileall over the package."""
    import compileall

    bad = []
    for p in sorted(ROOT.glob("perphil_tpu/**/*.py")) + sorted(ROOT.glob("tests/**/*.py")):
        text = p.read_text()
        if any(line != line.rstrip() for line in text.splitlines()):
            bad.append(f"{p}: trailing whitespace")
        if text and not text.endswith("\n"):
            bad.append(f"{p}: no final newline")
    if not compileall.compile_dir(str(ROOT / "perphil_tpu"), quiet=2):
        bad.append("compileall failed")
    for b in bad:
        print(b)
    if bad:
        sys.exit(1)
    print("built-in hygiene checks passed")


@task
def diff_coverage(args):
    """Coverage of new/changed lines vs origin/main (reference
    tasks.py:1397-1413). Uses diff-cover when installed, else coverage.py's
    own report filtered to the changed files."""
    if shutil.which("diff-cover") is not None:
        _run(["diff-cover", "coverage.xml", "--config-file", "pyproject.toml"])
        return
    try:
        import coverage  # noqa: F401
    except ImportError:
        print("neither diff-cover nor coverage installed; skipping")
        return
    _run([sys.executable, "-m", "coverage", "run", "-m", "pytest", "tests/", "-q"])
    changed = subprocess.run(
        ["git", "diff", "--name-only", "HEAD~1", "--", "perphil_tpu/"],
        capture_output=True, text=True, cwd=ROOT,
    ).stdout.split()
    cmd = [sys.executable, "-m", "coverage", "report", "--show-missing"]
    if changed:
        cmd += [c for c in changed if Path(ROOT, c).exists()]
    _run(cmd)


@task
def dev_clean(args):
    """clean + remove generated notebook ipynb pairs and coverage artifacts
    (reference tasks.py:1449-1494)."""
    clean(args)
    for pat in ("notebooks/*.ipynb", ".coverage", "coverage.xml", "htmlcov"):
        for p in ROOT.glob(pat):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)
            print("removed", p)


@task
def graft_check(args):
    """Driver-hook sanity: compile entry() and dry-run the multichip path."""
    _run([sys.executable, "__graft_entry__.py"])
    _run([sys.executable, "__graft_entry__.py", "multichip", "8"])


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("task", nargs="?", help="task name")
    ap.add_argument("rest", nargs="*", help="extra args for the task")
    ap.add_argument("--list", action="store_true", help="list tasks")
    ns = ap.parse_args()
    if ns.list or not ns.task:
        for name, fn in sorted(TASKS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:<18} {doc}")
        return
    if ns.task not in TASKS:
        sys.exit(f"Unknown task {ns.task!r}; --list to enumerate")
    TASKS[ns.task](ns)


if __name__ == "__main__":
    main()
