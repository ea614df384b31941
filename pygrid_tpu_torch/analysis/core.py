"""gridlint core: the shared visitor plumbing every checker rides.

One ``ast.parse`` per file, shared by all checkers; findings flow
through per-line suppression directives and the committed baseline
before anything is reported as a failure. Checkers are two-phase:
``check_module`` sees each parsed file, ``finalize`` runs once after
the whole tree is parsed (cross-file rules: lock-order cycles, doc
drift against constants collected elsewhere).
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

#: ``# gridlint: disable=GL202`` / ``disable=GL202,GL301`` / ``disable=all``
_DIRECTIVE = re.compile(r"#\s*gridlint:\s*disable=([A-Za-z0-9_,]+|all)")
#: ``# gridlint: disable-next=GL202 — justification`` on its own line
#: suppresses findings on the FOLLOWING line (the justified-comment style)
_DIRECTIVE_NEXT = re.compile(
    r"#\s*gridlint:\s*disable-next=([A-Za-z0-9_,]+|all)"
)
#: whole-file opt-out (generated code, vendored files)
_SKIP_FILE = re.compile(r"#\s*gridlint:\s*skip-file")


@dataclass(frozen=True)
class Finding:
    """One defect: ``path:line:col: CODE message``."""

    code: str  # e.g. "GL202"
    path: str  # repo-relative, POSIX separators
    line: int
    col: int
    message: str
    #: last physical line of the offending statement — a suppression
    #: directive anywhere in [line, end_line] covers the finding
    end_line: int = 0
    #: the witness chain for propagated findings (GL204/GL205 call
    #: chains, GL601/GL602 taint paths, GL604 escape routes) — rendered
    #: by ``--explain`` and as SARIF codeFlows
    witness: tuple = ()

    @property
    def checker(self) -> str:
        """The checker family — ``GL2`` for ``GL202``."""
        return self.code[:3]

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


class ModuleContext:
    """Everything a checker needs about one parsed file."""

    def __init__(
        self,
        path: str,
        rel_path: str,
        source: str,
        tree: ast.Module,
        runner: "Runner | None" = None,
    ):
        self.path = path
        self.rel_path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        #: the owning Runner — checkers reach the shared whole-program
        #: graph through it (``mod.runner.graph()``); None only when a
        #: test constructs a ModuleContext by hand
        self.runner = runner

    def finding(
        self, code: str, node: ast.AST, message: str,
        witness: tuple = (),
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            code=code,
            path=self.rel_path,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            end_line=getattr(node, "end_lineno", None) or line,
            witness=tuple(witness),
        )

    def suppressed_codes(self, line: int, end_line: int | None) -> set[str]:
        """Directive codes active over ``[line, end_line]`` (pylint-style:
        a disable comment on ANY physical line of the statement counts,
        so black-wrapped statements stay suppressible)."""
        out: set[str] = set()

        def _collect(raw: str) -> None:
            if raw.strip().lower() == "all":
                out.add("all")
            else:
                out.update(
                    c.strip().upper() for c in raw.split(",") if c.strip()
                )

        last = end_line if end_line and end_line >= line else line
        for n in range(line, min(last, len(self.lines)) + 1):
            m = _DIRECTIVE.search(self.lines[n - 1])
            if m:
                _collect(m.group(1))
        if line >= 2:
            m = _DIRECTIVE_NEXT.search(self.lines[line - 2])
            if m:
                _collect(m.group(1))
        return out


class Checker:
    """Base checker. Subclasses set ``name``/``codes`` and override
    ``check_module`` (per file) and/or ``finalize`` (once per run)."""

    name: str = "GL?"
    description: str = ""
    codes: dict[str, str] = {}

    def check_module(self, mod: ModuleContext) -> Iterable[Finding]:
        return ()

    def finalize(self, run: "Runner") -> Iterable[Finding]:
        return ()


@dataclass
class BaselineEntry:
    path: str
    code: str
    count: int
    note: str = ""


class Baseline:
    """Committed allowance for pre-existing findings.

    Keyed ``(path, code) -> count`` — deliberately NOT line numbers, so
    unrelated edits above a finding never invalidate the baseline. Each
    entry carries a justification ``note``. If a file heals (fewer
    findings than its allowance) the entry is reported *stale* so the
    committed count ratchets down instead of masking regressions."""

    def __init__(self, entries: Sequence[BaselineEntry] = ()) -> None:
        self.entries = {(e.path, e.code): e for e in entries}

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        entries = [
            BaselineEntry(
                path=e["path"],
                code=e["code"],
                count=int(e["count"]),
                note=e.get("note", ""),
            )
            for e in data.get("entries", [])
        ]
        return cls(entries)

    def allowance(self, path: str, code: str) -> int:
        entry = self.entries.get((path, code))
        return entry.count if entry else 0


@dataclass
class RunResult:
    """The outcome of one gridlint run over a file set."""

    failures: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stale_baseline: list[str] = field(default_factory=list)
    parse_errors: list[str] = field(default_factory=list)
    files_checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.failures and not self.parse_errors


#: directories never worth parsing
_PRUNE_DIRS = {
    "__pycache__", ".git", ".venv", "venv", "node_modules", ".eggs",
    "build", "dist",
}


def _iter_py_files(targets: Sequence[str]) -> list[str]:
    # dedup by real path: overlapping targets (a dir plus a file inside
    # it) must not parse a module twice — duplicate findings would blow
    # past baseline allowances and double GL2/GL4 cross-file state
    out: list[str] = []
    seen: set[str] = set()

    def _add(path: str) -> None:
        key = os.path.realpath(path)
        if key not in seen:
            seen.add(key)
            out.append(path)

    for target in targets:
        if os.path.isfile(target):
            if target.endswith(".py"):
                _add(target)
            continue
        for root, dirs, files in os.walk(target):
            dirs[:] = sorted(d for d in dirs if d not in _PRUNE_DIRS)
            for name in sorted(files):
                if name.endswith(".py"):
                    _add(os.path.join(root, name))
    return out


class Runner:
    """Parses the tree once and drives every checker over it."""

    def __init__(
        self,
        checkers: Sequence[Checker],
        root: str | Path | None = None,
        exclude: Sequence[str] = (),
    ) -> None:
        self.checkers = list(checkers)
        self.root = str(root) if root else os.getcwd()
        self.exclude = list(exclude)
        self.modules: list[ModuleContext] = []
        self._graph = None

    def graph(self):
        """The shared whole-program graph (symbol table + call graph +
        execution domains, :mod:`pygrid_tpu_torch.analysis.graph`), built
        LAZILY on first use and exactly once per run — every checker
        that needs cross-module state rides this one artifact. Valid
        once the parse phase of :meth:`run` has populated
        ``self.modules`` (i.e. from any ``check_module``/``finalize``
        hook)."""
        if self._graph is None:
            from pygrid_tpu_torch.analysis.graph import ProgramGraph

            self._graph = ProgramGraph(self.modules)
        return self._graph

    def _rel(self, path: str) -> str:
        try:
            rel = os.path.relpath(path, self.root)
        except ValueError:  # different drive (windows) — keep absolute
            rel = path
        return rel.replace(os.sep, "/")

    def _excluded(self, rel_path: str) -> bool:
        return any(fnmatch.fnmatch(rel_path, pat) for pat in self.exclude)

    def run(
        self,
        targets: Sequence[str],
        baseline: Baseline | None = None,
        stale_scope: set[str] | None = None,
    ) -> RunResult:
        result = RunResult()
        raw_findings: list[tuple[ModuleContext | None, Finding]] = []
        # phase 1: parse EVERY file before any checker runs, so the
        # whole-program graph (``self.graph()``) is complete from the
        # first ``check_module`` call
        for path in _iter_py_files(targets):
            rel = self._rel(path)
            if self._excluded(rel):
                continue
            try:
                with open(path, encoding="utf-8") as fh:
                    source = fh.read()
            except OSError as err:
                result.parse_errors.append(f"{rel}: unreadable: {err}")
                continue
            if _SKIP_FILE.search(source.split("\n", 1)[0]) or (
                "\n" in source
                and _SKIP_FILE.search(source.split("\n", 2)[1])
            ):
                continue
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as err:
                result.parse_errors.append(f"{rel}: syntax error: {err}")
                continue
            self.modules.append(ModuleContext(path, rel, source, tree, self))
            result.files_checked += 1
        # phase 2: per-module checks
        for mod in self.modules:
            for checker in self.checkers:
                for f in checker.check_module(mod):
                    raw_findings.append((mod, f))
        mods_by_rel = {m.rel_path: m for m in self.modules}
        for checker in self.checkers:
            for f in checker.finalize(self):
                raw_findings.append((mods_by_rel.get(f.path), f))

        # 1. per-line suppressions
        unsuppressed: list[Finding] = []
        for mod, f in raw_findings:
            codes: set[str] = set()
            if mod is not None:
                codes = mod.suppressed_codes(f.line, f.end_line or f.line)
            if "all" in codes or f.code in codes or f.checker in codes:
                result.suppressed.append(f)
            else:
                unsuppressed.append(f)

        # 2. baseline allowances, per (path, code), oldest-line-first so
        # which findings are "covered" is deterministic
        baseline = baseline or Baseline()
        by_key: dict[tuple[str, str], list[Finding]] = {}
        for f in sorted(unsuppressed, key=lambda x: (x.path, x.code, x.line)):
            by_key.setdefault((f.path, f.code), []).append(f)
        seen_keys = set(by_key)
        for key, group in by_key.items():
            allowed = baseline.allowance(*key)
            result.baselined.extend(group[:allowed])
            result.failures.extend(group[allowed:])
            if allowed > len(group):
                result.stale_baseline.append(
                    f"{key[0]}: {key[1]} baseline allows {allowed} but only "
                    f"{len(group)} found — shrink the entry"
                )
        # an absent entry is only STALE when this run could have produced
        # it: the entry's checker ran and its file was scanned — else a
        # --select or subset-target run would fail clean trees and tell
        # the operator to delete allowances that are still live. A
        # --changed run narrows further via ``stale_scope``: files that
        # rode along only as forward-import CONTEXT cannot reproduce
        # findings whose producer (a taint source, a lock holder) lives
        # outside the subset
        ran_families = {c.name for c in self.checkers}
        scanned = set(mods_by_rel)
        if stale_scope is not None:
            scanned &= stale_scope
        for (path, code), entry in baseline.entries.items():
            if (
                (path, code) not in seen_keys
                and entry.count > 0
                and code[:3] in ran_families
                and path in scanned
            ):
                result.stale_baseline.append(
                    f"{path}: {code} baseline allows {entry.count} but none "
                    "found — remove the entry"
                )
        result.failures.sort(key=lambda f: (f.path, f.line, f.code))
        result.stale_baseline.sort()
        return result


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def run_checks(
    targets: Sequence[str],
    checkers: Sequence[Checker] | None = None,
    baseline_path: str | Path | None = None,
    root: str | Path | None = None,
    exclude: Sequence[str] = (),
    stale_scope: set[str] | None = None,
) -> RunResult:
    """One-call API: run ``checkers`` (default: all) over ``targets``
    with the committed baseline (pass ``baseline_path=""`` for none).
    ``stale_scope`` (rel paths) narrows which files' baseline entries
    may be reported stale — ``--changed`` passes the non-context subset."""
    from pygrid_tpu_torch.analysis.checkers import ALL_CHECKERS

    if checkers is None:
        checkers = [cls() for cls in ALL_CHECKERS]
    if baseline_path is None:
        baseline_path = default_baseline_path()
    baseline = None
    if baseline_path and os.path.exists(str(baseline_path)):
        baseline = Baseline.load(baseline_path)
    if root is None:
        root = _infer_root(targets)
    runner = Runner(checkers, root=root, exclude=exclude)
    return runner.run(targets, baseline, stale_scope=stale_scope)


def _infer_root(targets: Sequence[str]) -> str:
    """The repo root the baseline's relative paths anchor to: walk up
    from the first target looking for pyproject.toml / .git."""
    start = os.path.abspath(targets[0]) if targets else os.getcwd()
    if os.path.isfile(start):
        start = os.path.dirname(start)
    cur = start
    while True:
        if any(
            os.path.exists(os.path.join(cur, probe))
            for probe in ("pyproject.toml", ".git")
        ):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return start
        cur = parent
