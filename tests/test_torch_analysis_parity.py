"""The port's gridlint against the JAX package's, family by family.

**Fixture parity.** ``torch_analysis_fixtures.py`` holds every source tree
the JAX package's gridlint tests (``tests/unit/test_gridlint.py``,
``test_gridconc.py``, ``test_gridflow.py``, ``test_gridproto.py``) lint
with a GL2, GL3, GL4, GL6 or GL7 checker, or build the program graph
from. Each tree goes through ``pygrid_tpu.analysis.run_checks`` and
``pygrid_tpu_torch.analysis.run_checks`` with the same checker families
and no baseline, and the two must report the same ``(code, path, line)``
findings. One parametrised test per family: each case counts.

**Tree parity.** Both linters run once each over ``pygrid_tpu_torch/``
(module-scoped) and must agree on every GL2/GL3/GL4/GL6/GL7 finding.

GL1 and GL5 are the port's own (programs and CUDA launches instead of
``jax.jit`` and ``pallas_call``): ``test_torch_analysis.py`` holds them.

Regenerate the fixtures (after the JAX tests change) with
``JAX_PLATFORMS=cpu python tests/test_torch_analysis_parity.py``: it runs
the four JAX test files and records every tree their linter runs see.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

import pygrid_tpu.analysis as jax_lint  # noqa: E402
import pygrid_tpu_torch.analysis as port_lint  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_analysis_fixtures.py"
FAMILIES = ("GL2", "GL3", "GL4", "GL6", "GL7")


def _load_cases() -> list[dict]:
    spec = importlib.util.spec_from_file_location("torch_analysis_fixtures", FIXTURES)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


CASES = _load_cases() if __name__ != "__main__" else []


def _findings(lint, root: str, targets, families, exclude=()) -> list[tuple]:
    checkers = [cls() for cls in lint.ALL_CHECKERS if cls.name in families]
    res = lint.run_checks(
        [os.path.join(root, t) for t in targets], checkers=checkers,
        baseline_path="", root=root, exclude=exclude,
    )
    assert not res.parse_errors, res.parse_errors
    return sorted(
        (f.code, f.path, f.line) for f in res.failures + res.suppressed
    )


def _run_case(case: dict, tmp_path) -> None:
    for rel, text in case["files"].items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    families = [f for f in case["families"] or FAMILIES if f in FAMILIES]
    want = _findings(jax_lint, str(tmp_path), case["targets"], families, case["exclude"])
    got = _findings(port_lint, str(tmp_path), case["targets"], families, case["exclude"])
    assert got == want, f"{case['id']}: port {got} != reference {want}"


def _cases(family: str) -> list:
    return [pytest.param(c, id=c["id"]) for c in CASES if c["family"] == family]


@pytest.mark.parametrize("case", _cases("GL2"))
def test_fixture_parity_gl2(case, tmp_path):
    _run_case(case, tmp_path)


@pytest.mark.parametrize("case", _cases("GL3"))
def test_fixture_parity_gl3(case, tmp_path):
    _run_case(case, tmp_path)


@pytest.mark.parametrize("case", _cases("GL4"))
def test_fixture_parity_gl4(case, tmp_path):
    _run_case(case, tmp_path)


@pytest.mark.parametrize("case", _cases("GL6"))
def test_fixture_parity_gl6(case, tmp_path):
    _run_case(case, tmp_path)


@pytest.mark.parametrize("case", _cases("GL7"))
def test_fixture_parity_gl7(case, tmp_path):
    _run_case(case, tmp_path)


def test_fixtures_cover_every_family():
    counts = {f: sum(c["family"] == f for c in CASES) for f in FAMILIES}
    assert all(n >= 8 for n in counts.values()), counts
    assert len({c["id"] for c in CASES}) == len(CASES)


@pytest.fixture(scope="module")
def tree_findings() -> dict:
    """Each linter once over the port's tree, every parity family."""
    return {
        name: _findings(lint, str(ROOT), ["pygrid_tpu_torch"], FAMILIES)
        for name, lint in (("reference", jax_lint), ("port", port_lint))
    }


@pytest.mark.parametrize("family", FAMILIES)
def test_tree_parity(tree_findings, family):
    want = [f for f in tree_findings["reference"] if f[0][:3] == family]
    got = [f for f in tree_findings["port"] if f[0][:3] == family]
    assert got == want


# ── regenerating the fixtures ─────────────────────────────────────────────

_JAX_TESTS = (
    "tests/unit/test_gridlint.py", "tests/unit/test_gridconc.py",
    "tests/unit/test_gridflow.py", "tests/unit/test_gridproto.py",
)


def _primary_family(test_id: str, families: list[str]) -> str:
    """The family a recorded tree is held under: the one its test
    selected, else the family its test file or class is about."""
    picked = [f for f in families if f in FAMILIES]
    if len(picked) == 1:
        return picked[0]
    for key, fam in (("gridconc", "GL2"), ("gridflow", "GL6"), ("gridproto", "GL7")):
        if key in test_id:
            return fam
    cls = test_id.split("::")[1] if "::" in test_id else ""
    for fam in FAMILIES:
        if cls.startswith("Test" + fam):
            return fam
    return "GL2"


def record_fixtures() -> list[dict]:
    """Run the JAX gridlint tests and record every (temporary) tree their
    linter runs see, with the checker families and targets of the run."""
    import tempfile

    from pygrid_tpu.analysis import core

    current: dict = {"id": None}
    records: list[dict] = []
    original = core.Runner.run

    def run(self, targets, baseline=None, stale_scope=None):
        root = os.path.realpath(self.root)
        if current["id"] and root.startswith(os.path.realpath(tempfile.gettempdir())):
            files = {}
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", ".git"))
                for name in sorted(filenames):
                    path = os.path.join(dirpath, name)
                    try:
                        text = Path(path).read_text(encoding="utf-8")
                    except (UnicodeDecodeError, OSError):
                        continue
                    files[os.path.relpath(path, root).replace(os.sep, "/")] = text
            families = sorted({c.name for c in self.checkers})
            if set(families) & set(FAMILIES) or not families:
                records.append({
                    "test": current["id"], "families": families,
                    "targets": [os.path.relpath(os.path.realpath(t), root).replace(os.sep, "/")
                                for t in targets],
                    "exclude": list(self.exclude), "files": files,
                })
        return original(self, targets, baseline, stale_scope)

    class Recorder:
        def pytest_runtest_setup(self, item):
            current["id"] = item.nodeid

        def pytest_runtest_teardown(self, item):
            current["id"] = None

    core.Runner.run = run
    try:
        rc = pytest.main(["-q", "-p", "no:cacheprovider", *(str(ROOT / t) for t in _JAX_TESTS)],
                         plugins=[Recorder()])
    finally:
        core.Runner.run = original
    assert rc == 0, f"the JAX gridlint tests failed (exit {rc})"
    cases, seen, per_test = [], set(), {}
    for r in records:
        key = repr((r["families"], r["targets"], r["exclude"], sorted(r["files"].items())))
        if key in seen:
            continue
        seen.add(key)
        test = r["test"].replace("tests/unit/test_", "").replace(".py::", ".").replace("::", ".")
        n = per_test[test] = per_test.get(test, 0) + 1
        cases.append({
            "id": test if n == 1 else f"{test}#{n}",
            "family": _primary_family(r["test"], r["families"]),
            "families": [f for f in r["families"] if f in FAMILIES],
            "targets": r["targets"], "exclude": r["exclude"], "files": r["files"],
        })
    return cases


def write_fixtures(cases: list[dict]) -> None:
    import pprint

    FIXTURES.write_text(
        '"""Source trees the JAX package\'s gridlint tests lint, recorded by\n'
        "``python tests/test_torch_analysis_parity.py`` (do not edit by hand).\n"
        "Each case: its id (test file, class and test), the family it is\n"
        "held under, the checker families its run selected (empty: all five\n"
        'parity families), its targets and excludes, and every file."""\n\n'
        f"CASES = {pprint.pformat(cases, width=100, sort_dicts=False)}\n"
    )


if __name__ == "__main__":
    os.chdir(ROOT)
    found = record_fixtures()
    write_fixtures(found)
    print(f"wrote {len(found)} cases to {FIXTURES}")
