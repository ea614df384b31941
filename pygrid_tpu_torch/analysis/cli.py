"""The gridlint command line: ``python -m pygrid_tpu_torch.analysis [paths]``.

Exit status: 0 when every finding is suppressed or baselined, 1 when
non-baselined findings (or parse errors) exist, 2 on usage errors.
Stale-baseline entries are reported but non-fatal unless
``--strict-baseline`` (the tier-1 test runs strict so allowances
ratchet down as code heals).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

from pygrid_tpu_torch.analysis.checkers import ALL_CHECKERS
from pygrid_tpu_torch.analysis.core import default_baseline_path, run_checks


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pygrid_tpu_torch.analysis",
        description="gridlint for the PyTorch/CUDA port — repo-native "
        "static analysis (program safety, lock discipline, async hygiene, "
        "contract drift, CUDA launch bounds, taint, protocol)",
    )
    parser.add_argument(
        "targets", nargs="*", default=["pygrid_tpu_torch"],
        help="files or directories to check (default: pygrid_tpu_torch)",
    )
    parser.add_argument(
        "--select",
        help="comma-separated checker families to run (e.g. GL1,GL3)",
    )
    parser.add_argument(
        "--baseline", default=None,
        help="baseline JSON path (default: the committed "
        "pygrid_tpu_torch/analysis/baseline.json)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, committed allowances ignored",
    )
    parser.add_argument(
        "--strict-baseline", action="store_true",
        help="stale baseline entries fail the run",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="analyze only files changed per git (diff vs HEAD + "
        "untracked) plus their call-graph dependents — the fast "
        "pre-commit loop",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "github", "sarif"),
        default="text",
        help="github: one ::warning file=…,line=…:: annotation per "
        "finding, for CI inline surfacing; sarif: SARIF 2.1.0 with the "
        "witness chain of each propagated finding as codeFlows",
    )
    parser.add_argument(
        "--output",
        help="write the formatted report to this file instead of "
        "stdout (the CI artifact path for --format sarif)",
    )
    parser.add_argument(
        "--explain", metavar="GLNNN",
        help="print every finding of one rule (failures AND baselined "
        "allowances) with its witness chain — the call path a "
        "propagated GL204/GL205 finding rode, the source→sink taint "
        "path of a GL601/GL602, the escape route of a GL604",
    )
    parser.add_argument(
        "--list-checkers", action="store_true",
        help="print the rule catalogue and exit",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="suppress the summary (findings only)",
    )
    return parser


def _list_checkers() -> str:
    lines = []
    for cls in ALL_CHECKERS:
        lines.append(f"{cls.name}  {cls.description}")
        for code, what in sorted(cls.codes.items()):
            lines.append(f"  {code}  {what}")
    return "\n".join(lines)


def _git_changed_files(root: str) -> set[str] | None:
    """Repo-relative POSIX paths of changed .py files: ``git diff
    --name-only HEAD`` (staged + unstaged) plus untracked. With
    ``GRIDLINT_BASE`` set (CI: the PR's base ref), the diff is taken
    against ``<base>...HEAD`` instead, so a PR job lints every commit
    on the branch, not just the dirty tree. None when git is
    unavailable (not a repo, no binary) — callers treat that as a
    usage error, not an empty change set."""
    import os
    import subprocess

    base = os.environ.get("GRIDLINT_BASE", "").strip()
    diff_cmd = (
        ["git", "diff", "--name-only", f"{base}...HEAD"]
        if base
        else ["git", "diff", "--name-only", "HEAD"]
    )
    out: set[str] = set()
    for cmd in (
        diff_cmd,
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                cmd, cwd=root, capture_output=True, text=True, timeout=30
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        out.update(
            line.strip()
            for line in proc.stdout.splitlines()
            if line.strip().endswith(".py")
        )
    return out


def _changed_closure(
    targets: list[str],
) -> tuple[list[str], set[str]] | str:
    """The ``--changed`` target set: changed files under ``targets``
    plus their transitive reverse-import dependents (a changed callee
    can flip a caller's cross-module findings) plus forward-import
    context. Returns ``(file list, stale scope rel-paths)`` —
    ``([], …)`` for "nothing changed" — or an error string."""
    import os

    from pygrid_tpu_torch.analysis.core import _infer_root, _iter_py_files
    from pygrid_tpu_torch.analysis.graph import import_dependents

    root = _infer_root(targets)
    changed = _git_changed_files(root)
    if changed is None:
        return "--changed needs a git work tree (git diff failed)"
    files = _iter_py_files(targets)
    by_rel = {
        os.path.relpath(p, root).replace(os.sep, "/"): p for p in files
    }
    keep, stale_scope = import_dependents(
        files,
        lambda p: os.path.relpath(p, root).replace(os.sep, "/"),
        set(changed),
    )
    return (
        [by_rel[rel] for rel in sorted(keep) if rel in by_rel],
        stale_scope,
    )


#: parses the ``… at path:line`` location a witness step carries
#: (possibly mid-step — GL204 edges end with their provenance), so
#: each SARIF codeFlow location points at real code
_STEP_LOC = re.compile(r" at ([\w./-]+\.py):(\d+)")


def _sarif_location(path: str, line: int, col: int = 0) -> dict:
    return {
        "physicalLocation": {
            "artifactLocation": {"uri": path},
            "region": {
                "startLine": max(1, line),
                "startColumn": max(1, col + 1),
            },
        }
    }


def _sarif_report(result) -> dict:
    """SARIF 2.1.0: one result per finding; witness chains become
    codeFlows (threadFlow locations, source first) so SARIF viewers
    render the whole propagation path inline."""
    rules: dict[str, dict] = {}
    for cls in ALL_CHECKERS:
        for code, what in cls.codes.items():
            rules[code] = {
                "id": code,
                "shortDescription": {"text": what},
                "helpUri": "docs/ANALYSIS.md",
            }
    results = []
    for f in result.failures:
        entry = {
            "ruleId": f.code,
            "level": "warning",
            "message": {"text": f.message},
            "locations": [_sarif_location(f.path, f.line, f.col)],
        }
        if f.witness:
            flow_locs = []
            for step in f.witness:
                m = _STEP_LOC.search(step)
                loc = (
                    _sarif_location(m.group(1), int(m.group(2)))
                    if m
                    else _sarif_location(f.path, f.line, f.col)
                )
                flow_locs.append(
                    {"location": {**loc, "message": {"text": step}}}
                )
            entry["codeFlows"] = [
                {"threadFlows": [{"locations": flow_locs}]}
            ]
        results.append(entry)
    for err in result.parse_errors:
        results.append(
            {
                "ruleId": "GL000",
                "level": "error",
                "message": {"text": f"parse error: {err}"},
            }
        )
    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "gridlint",
                        "informationUri": "docs/ANALYSIS.md",
                        "rules": sorted(
                            rules.values(), key=lambda r: r["id"]
                        ),
                    }
                },
                "results": results,
            }
        ],
    }


def _explain(result, code: str) -> str:
    """Human rendering of every finding of ``code`` with its witness
    chain — baselined allowances included (explaining a deliberate
    allowance is the command's main use)."""
    lines: list[str] = []
    shown = 0
    for f, status in [(f, "FAIL") for f in result.failures] + [
        (f, "baselined") for f in result.baselined
    ]:
        if f.code != code.upper():
            continue
        shown += 1
        lines.append(f"[{status}] {f.render()}")
        if f.witness:
            for i, step in enumerate(f.witness):
                lines.append(f"    {'└─' if i else '┌─'} {step}")
        else:
            lines.append("    (no recorded witness chain — the finding "
                         "is sited where it fires)")
    if not shown:
        lines.append(f"no {code.upper()} findings in this run")
    return "\n".join(lines)


def _github_annotations(result) -> list[str]:
    """One workflow-command annotation per finding — GitHub renders
    them inline on the PR diff."""
    lines = []
    for err in result.parse_errors:
        lines.append(f"::error title=gridlint parse error::{err}")
    for f in result.failures:
        message = f.message.replace("%", "%25").replace(
            "\r", "%0D"
        ).replace("\n", "%0A")
        lines.append(
            f"::warning file={f.path},line={f.line},col={f.col + 1},"
            f"title=gridlint {f.code}::{message}"
        )
    return lines


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_checkers:
        print(_list_checkers())
        return 0

    import os

    missing = [t for t in args.targets if not os.path.exists(t)]
    if missing:
        # a typo'd path silently checking nothing would make the lint
        # gate pass vacuously — that is a usage error, not a clean run
        print(
            f"no such target(s): {', '.join(missing)}", file=sys.stderr
        )
        return 2

    targets = list(args.targets)
    stale_scope: set[str] | None = None
    if args.changed:
        closure = _changed_closure(targets)
        if isinstance(closure, str):
            print(closure, file=sys.stderr)
            return 2
        targets, stale_scope = closure
        if not targets:
            if not args.quiet:
                print("gridlint --changed: no python changes")
            return 0

    checkers = [cls() for cls in ALL_CHECKERS]
    if args.select:
        wanted = {s.strip().upper() for s in args.select.split(",")}
        unknown = wanted - {cls.name for cls in ALL_CHECKERS}
        if unknown:
            print(
                f"unknown checker(s): {', '.join(sorted(unknown))}",
                file=sys.stderr,
            )
            return 2
        checkers = [c for c in checkers if c.name in wanted]

    baseline_path: str | None
    if args.no_baseline:
        baseline_path = ""
    elif args.baseline is not None:
        baseline_path = args.baseline
    else:
        baseline_path = str(default_baseline_path())

    t0 = time.perf_counter()
    result = run_checks(
        targets, checkers=checkers, baseline_path=baseline_path,
        stale_scope=stale_scope,
    )
    elapsed = time.perf_counter() - t0

    failed = bool(result.failures or result.parse_errors) or (
        args.strict_baseline and bool(result.stale_baseline)
    )

    def _emit(text: str) -> None:
        if args.output:
            with open(args.output, "w", encoding="utf-8") as fh:
                fh.write(text if text.endswith("\n") else text + "\n")
            if not args.quiet:
                print(f"gridlint: wrote {args.format} to {args.output}")
        else:
            print(text)

    if args.explain:
        _emit(_explain(result, args.explain))
        return 0  # informational — the gate is the plain run

    if args.format == "sarif":
        _emit(json.dumps(_sarif_report(result), indent=2))
        return 1 if failed else 0

    if args.format == "github":
        lines = _github_annotations(result)
        lines.extend(
            f"::notice title=gridlint stale baseline::{note}"
            for note in result.stale_baseline
        )
        if lines:
            _emit("\n".join(lines))
        if not args.quiet:
            print(
                f"gridlint: {result.files_checked} files, "
                f"{len(result.failures)} finding(s), "
                f"{len(result.stale_baseline)} stale baseline entr"
                f"{'y' if len(result.stale_baseline) == 1 else 'ies'} "
                f"in {elapsed:.2f}s"
            )
        return 1 if failed else 0

    if args.format == "json":
        _emit(
            json.dumps(
                {
                    "ok": not failed,
                    "files_checked": result.files_checked,
                    "elapsed_s": round(elapsed, 3),
                    "failures": [f.__dict__ for f in result.failures],
                    "baselined": [f.__dict__ for f in result.baselined],
                    "suppressed": [f.__dict__ for f in result.suppressed],
                    "stale_baseline": result.stale_baseline,
                    "parse_errors": result.parse_errors,
                },
                indent=2,
            )
        )
        return 1 if failed else 0

    lines = [f"PARSE ERROR {err}" for err in result.parse_errors]
    lines.extend(f.render() for f in result.failures)
    lines.extend(f"suppressed: {f.render()}" for f in result.suppressed)
    lines.extend(
        f"stale baseline: {note}" for note in result.stale_baseline
    )
    if lines:
        _emit("\n".join(lines))
    if not args.quiet:
        print(
            f"gridlint: {result.files_checked} files, "
            f"{len(result.failures)} finding(s), "
            f"{len(result.baselined)} baselined, "
            f"{len(result.suppressed)} suppressed, "
            f"{len(result.stale_baseline)} stale baseline entr"
            f"{'y' if len(result.stale_baseline) == 1 else 'ies'} "
            f"in {elapsed:.2f}s"
        )
    return 1 if failed else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
