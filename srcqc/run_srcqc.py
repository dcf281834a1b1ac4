#!/usr/bin/env python3
"""Source-quality gate, run as part of the dev verify recipe.

The reference gates every dev build on cppcheck-as-error plus
warnings-as-errors (reference: docs/developerGuide/README.md:71-79,
src/srcqc/run_cppcheck.py). This repo's equivalent has two parts:

  1. native: g++ -Wall -Wextra -Werror -fsyntax-only over
     native/manta_core.cpp (the whole native layer is one TU);
  2. python: an AST lint over every first-party source file —
     stdlib-only because the image ships no third-party linters —
     checking the defect classes that have actually bitten this
     codebase: unused imports, duplicate definitions in one scope,
     mutable default arguments, bare except, and `== None`/`!= None`
     comparisons.

Any finding is an error (exit 1). Suppress a line with `# noqa`.

Usage: python srcqc/run_srcqc.py [--no-native]
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PY_ROOTS = ["manta_tpu", "tests", "benchmarks", "srcqc",
            "bench.py", "chip_smoke.py", "__graft_entry__.py"]

# import names that exist for side effects / re-export by convention
SIDE_EFFECT_IMPORTS = {"__future__"}


def _noqa_lines(src: str) -> set[int]:
    return {i + 1 for i, line in enumerate(src.splitlines())
            if "# noqa" in line}


class _ScopeChecker(ast.NodeVisitor):
    """Collects findings for one module."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.noqa = _noqa_lines(src)
        self.findings: list[tuple[int, str]] = []
        self.tree = ast.parse(src, filename=path)

    def err(self, lineno: int, msg: str):
        if lineno not in self.noqa:
            self.findings.append((lineno, msg))

    # -- unused imports (module scope only: function-level imports are
    # often deliberate lazy loads whose use sits in nested scopes;
    # __init__.py files are exempt — their imports ARE the re-export
    # surface)
    def check_unused_imports(self):
        if os.path.basename(self.path) == "__init__.py":
            return
        imported: dict[str, int] = {}
        for node in self.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = (a.asname or a.name).split(".")[0]
                    imported[name] = node.lineno
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "") in SIDE_EFFECT_IMPORTS:
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    imported[a.asname or a.name] = node.lineno
        if not imported:
            return
        used: set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                pass  # attribute roots arrive as Name nodes anyway
        # names referenced in __all__ strings count as used (facades)
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets)):
                for c in ast.walk(node.value):
                    if isinstance(c, ast.Constant) and isinstance(
                            c.value, str):
                        used.add(c.value)
        # string annotations may reference imported types
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str):
                for name in imported:
                    if name in node.value:
                        used.add(name)
        for name, lineno in sorted(imported.items(), key=lambda kv: kv[1]):
            if name not in used:
                self.err(lineno, f"unused import: {name}")

    # -- everything else in one walk
    def check_nodes(self):
        self._dup_scope(self.tree.body, "module")
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._dup_scope(node.body, f"def {node.name}")
                self._mutable_defaults(node)
            elif isinstance(node, ast.ClassDef):
                self._dup_scope(node.body, f"class {node.name}")
            elif isinstance(node, ast.ExceptHandler) and node.type is None:
                self.err(node.lineno, "bare except:")
            elif isinstance(node, ast.Compare):
                for op, cmp_ in zip(node.ops, node.comparators):
                    if (isinstance(op, (ast.Eq, ast.NotEq))
                            and isinstance(cmp_, ast.Constant)
                            and cmp_.value is None):
                        self.err(node.lineno,
                                 "== None / != None (use `is None`)")

    def _dup_scope(self, body, scope: str):
        seen: dict[str, int] = {}
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                # a def directly following a same-named def/class in the
                # same suite silently shadows it
                if any(isinstance(d, ast.Name) and d.id in
                       ("property", "overload", "singledispatchmethod")
                       for d in stmt.decorator_list):
                    continue
                if any(isinstance(d, ast.Attribute) for d in
                       stmt.decorator_list):
                    continue  # x.setter / x.register style decorators
                if stmt.name in seen:
                    self.err(stmt.lineno,
                             f"duplicate definition of {stmt.name!r} in "
                             f"{scope} (first at line {seen[stmt.name]})")
                seen[stmt.name] = stmt.lineno

    def _mutable_defaults(self, node):
        for d in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                self.err(d.lineno, "mutable default argument")


def iter_py_files():
    for root in PY_ROOTS:
        p = os.path.join(REPO, root)
        if os.path.isfile(p):
            yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".pytest_cache")]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)


def run_python_lint() -> int:
    n = 0
    for path in iter_py_files():
        src = open(path, encoding="utf-8").read()
        rel = os.path.relpath(path, REPO)
        try:
            chk = _ScopeChecker(path, src)
        except SyntaxError as e:
            print(f"{rel}:{e.lineno}: syntax error: {e.msg}")
            n += 1
            continue
        chk.check_unused_imports()
        chk.check_nodes()
        for lineno, msg in sorted(chk.findings):
            print(f"{rel}:{lineno}: {msg}")
        n += len(chk.findings)
    return n


def run_native_gate() -> int:
    src = os.path.join(REPO, "native", "manta_core.cpp")
    r = subprocess.run(
        ["g++", "-O1", "-fsyntax-only", "-Wall", "-Wextra", "-Werror", src],
        capture_output=True, text=True)
    if r.returncode != 0:
        sys.stderr.write(r.stderr)
        print("native/manta_core.cpp: FAILED -Wall -Wextra -Werror")
        return 1
    return 0


def main() -> int:
    errors = run_python_lint()
    if "--no-native" not in sys.argv:
        errors += run_native_gate()
    if errors:
        print(f"srcqc: {errors} finding(s)")
        return 1
    print("srcqc: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
