"""The port's gridlint on its own terms: GL1 over the port's programs, GL5
over its CUDA launches, the YAML-subset reader GL7 reads its spec with,
the command line, and the port's tree clean against its baseline.

GL1's fixtures build programs the ways the port does (``ProgramSet._build``,
``torch.autograd.Function``, the FedAvg round builders' closures,
``torch.compile``/``torch.export``/CUDA-graph capture); each rule code has a
firing and a quiet case. GL5's fixtures are copies of the real
``pygrid_tpu_torch/csrc`` sources: unchanged they are clean, and each
mutation of one launch (a floor-divided grid, a grid divided by another
tile, a block that is not the kernel's ``__launch_bounds__``, shared memory
past 227 KB at one template instantiation) fires at that launch's line.
"""

from __future__ import annotations

import ast
import json
import shutil
import textwrap
from pathlib import Path

import pytest

from pygrid_tpu_torch.analysis import cli, run_checks
from pygrid_tpu_torch.analysis.checkers import CudaBoundsChecker, TraceSafetyChecker
from pygrid_tpu_torch.analysis.checkers.gl5_cuda import (
    SMEM_LIMIT,
    Env,
    axis_tiles,
    launch_model,
)
from pygrid_tpu_torch.analysis.yaml_subset import YamlSubsetError, safe_load

ROOT = Path(__file__).resolve().parent.parent
ANALYSIS = ROOT / "pygrid_tpu_torch" / "analysis"
CSRC = ROOT / "pygrid_tpu_torch" / "csrc"


def _lint(tmp_path, files, checker_cls):
    (tmp_path / "pyproject.toml").write_text("[tool.none]\n")
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return run_checks([str(tmp_path)], checkers=[checker_cls()], baseline_path="",
                      root=str(tmp_path))


def _codes(result):
    return sorted(f.code for f in result.failures)


# ── GL1: programs ─────────────────────────────────────────────────────────

_PROGRAMSET = """
    import logging, threading, time
    import numpy as np
    import torch
    from pkg import telemetry

    logger = logging.getLogger(__name__)

    class ProgramSet:
        def __init__(self):
            self._lock = threading.Lock()
            self.device = torch.device("cpu")

        def _build(self, fn, kind, bucket):
            return fn

        def decode(self, width):
            def _step(params, tokens):
                {body}
                return params[0] + tokens

            return self._build(_step, "decode", width)
"""

GL1_CASES = {
    # name: (body of a program, expected codes)
    "telemetry": ("telemetry.incr('steps_total')", ["GL101"]),
    "perf_counter": ("t0 = time.perf_counter()", ["GL101"]),
    "print_and_log": ("print('x'); logger.info('y')", ["GL101", "GL101"]),
    "lock": ("with self._lock: pass", ["GL101"]),
    "item": ("n = tokens.sum().item()", ["GL102"]),
    "int_of_tensor": ("n = int(torch.max(tokens))", ["GL102"]),
    "tolist_cpu_numpy": ("a = tokens.tolist(); b = tokens.cpu(); c = tokens.numpy()",
                         ["GL102", "GL102", "GL102"]),
    "tensor_in_if": ("if (tokens > 0).any(): pass", ["GL102"]),
    "tensor_in_while": ("while torch.any(tokens < 0): tokens = tokens + 1", ["GL102"]),
    "nonzero": ("idx = torch.nonzero(tokens)", ["GL102"]),
    "one_arg_where": ("idx = torch.where(tokens > 0)", ["GL102"]),
    "host_copy_device_kw": ("t = torch.as_tensor(np.ones(3), device=self.device)", ["GL102"]),
    "host_copy_to": ("t = torch.tensor([1, 2]).to(self.device)", ["GL102"]),
    "host_scalar_store": ("params[0][0] = int(width)", ["GL102"]),
    # quiet: host values, numpy tests, device-only work
    "clean": ("t = torch.where(tokens > 0, tokens, -tokens)", []),
    "host_ints": ("n = int(width) + float(3)", []),
    "numpy_any": ("if np.any(np.asarray([width]) > 0): pass", []),
    "host_tensor": ("t = torch.as_tensor(np.ones(3))", []),
    "profiler_flag": ("if torch.autograd._profiler_enabled(): pass", []),
    "graph_task_id": ("if torch._C._current_graph_task_id() == -1: pass", []),
}


@pytest.mark.parametrize("body,want", GL1_CASES.values(), ids=GL1_CASES.keys())
def test_gl1_program_set_bodies(tmp_path, body, want):
    src = _PROGRAMSET.replace("{body}", body)
    files = {"pkg/__init__.py": "", "pkg/telemetry.py": "def incr(*a, **k): pass\n",
             "pkg/serving.py": src}
    assert _codes(_lint(tmp_path, files, TraceSafetyChecker)) == want


def test_gl1_outside_a_program_is_quiet(tmp_path):
    res = _lint(tmp_path, {"pkg/mod.py": """
        import time
        import torch

        def host_side(x):
            t0 = time.perf_counter()
            return x.sum().item(), t0
    """}, TraceSafetyChecker)
    assert _codes(res) == []


def test_gl1_autograd_function_and_round_closure(tmp_path):
    res = _lint(tmp_path, {"pkg/mod.py": """
        import torch

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                print("forward")
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return g * float(g.sum())

            @staticmethod
            def helper(x):
                return x.item()  # not forward/backward: not a program

        def make_round(step):
            def round_fn(params, X):
                loss = step(params, X)
                if loss.isnan():
                    pass
                return params

            return round_fn
    """}, TraceSafetyChecker)
    lines = sorted((f.code, f.line) for f in res.failures)
    assert lines == [("GL101", 7), ("GL102", 12), ("GL102", 21)]


def test_gl1_cross_module_reach(tmp_path):
    res = _lint(tmp_path, {
        "pkg/__init__.py": "",
        "pkg/helpers.py": """
            import torch

            def sync_helper(x):
                return x.sum().item()

            def clean_helper(x):
                return x + 1
        """,
        "pkg/rounds.py": """
            from pkg import helpers
            from pkg.helpers import clean_helper

            def make_fused_rounds(loss_fn):
                def rounds_fn(p, X):
                    return helpers.sync_helper(clean_helper(X))

                return rounds_fn
        """,
    }, TraceSafetyChecker)
    found = [(f.code, f.path, f.line) for f in res.failures]
    assert found == [("GL102", "pkg/helpers.py", 5)]


def test_gl1_export_compile_and_graph_capture(tmp_path):
    res = _lint(tmp_path, {"pkg/mod.py": """
        import time
        import torch

        def traced(x):
            return x + time.time()

        exported = torch.export.export(traced, (torch.ones(2),))

        @torch.compile
        def compiled(x):
            return x.cpu()

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                print("captured once")
            return y
    """}, TraceSafetyChecker)
    assert sorted((f.code, f.line) for f in res.failures) == [
        ("GL101", 6), ("GL101", 17), ("GL102", 12)]


def test_gl103_program_built_per_call_or_in_a_loop(tmp_path):
    res = _lint(tmp_path, {"pkg/mod.py": """
        import torch

        def f(x):
            return x * 2

        def per_call(x):
            return torch.compile(f)(x)

        def in_loop(xs):
            return [torch.compile(f) for _ in range(1)] + [
                torch.export.export(f, (x,)) for x in xs]

        def loop(xs):
            out = []
            for x in xs:
                out.append(torch.compile(f))
            return out

        ONCE = torch.compile(f)
    """}, TraceSafetyChecker)
    assert [(f.code, f.line) for f in res.failures] == [("GL103", 8), ("GL103", 17)]


def test_gl105_request_scalar_baked_into_a_program(tmp_path):
    res = _lint(tmp_path, {"pkg/mod.py": """
        import torch

        def handler(message):
            n_new = int(message["n_new"])
            fn = torch.compile(lambda x, n=n_new: x * n)

            def body(x):
                return x * n_new

            other = torch.compile(body)
            quiet = torch.compile(lambda x, n: x * n)
            return fn, other, quiet(torch.ones(2), n_new)
    """}, TraceSafetyChecker)
    assert [(f.code, f.line) for f in res.failures] == [("GL105", 6), ("GL105", 11)]


def test_gl1_closure_records_program_bodies(tmp_path):
    checker = TraceSafetyChecker()
    (tmp_path / "pyproject.toml").write_text("")
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "serving.py").write_text(
        textwrap.dedent(_PROGRAMSET.replace("{body}", "pass")))
    run_checks([str(tmp_path)], checkers=[checker], baseline_path="", root=str(tmp_path))
    assert {name for _, _, name in checker.closure["pkg/serving.py"]} == {"_step"}
    assert {name for _, _, name in checker.roots["pkg/serving.py"]} == {"_step"}


# ── GL5: CUDA launches ────────────────────────────────────────────────────


def _csrc_tree(tmp_path, edits=()):
    """A package holding copies of the real csrc sources, with ``edits``
    ((file, old, new, count)) applied; returns the tree's root."""
    (tmp_path / "pyproject.toml").write_text("")
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    shutil.copytree(CSRC, pkg / "csrc")
    for name, old, new, count in edits:
        path = pkg / "csrc" / name
        text = path.read_text()
        assert text.count(old) == count, (name, old)
        path.write_text(text.replace(old, new))
    return tmp_path


def _line_of(path: Path, needle: str) -> int:
    lines = [i for i, t in enumerate(path.read_text().splitlines(), 1) if needle in t]
    assert len(lines) == 1, needle
    return lines[0]


def _gl5(tmp_path, edits=()):
    root = _csrc_tree(tmp_path, edits)
    res = run_checks([str(root)], checkers=[CudaBoundsChecker()], baseline_path="",
                     root=str(root))
    return root, sorted((f.code, f.path, f.line) for f in res.failures)


def test_gl5_real_sources_are_clean(tmp_path):
    assert _gl5(tmp_path)[1] == []


GL5_CASES = {
    # name: (file, old, new, count, launch line marker(s), code, findings per launch)
    "floor_divided_grid": (
        "flash_fwd.cu", "const dim3 grid(B * H, (Lq + TC_BM - 1) / TC_BM);",
        "const dim3 grid(B * H, Lq / TC_BM);", 1,
        "flash_fwd_tc_kernel<DP, BAND><<<", "GL501", 6),
    "grid_divided_by_another_tile": (
        "ring_matmul.cu", "(N + pgt::TN - 1) / pgt::TN", "(N + pgt::TK - 1) / pgt::TK", 1,
        "ring_matmul_tc_kernel<<<", "GL501", 1),
    "not_a_ceiling_division": (
        "flash_bwd.cu", "const dim3 grid(B * (H / group), (Lk + TC_BK - 1) / TC_BK);",
        "const dim3 grid(B * (H / group), (Lk + TC_BK - 1) / TC_BQ);", 1,
        "flash_bwd_dkv_tc_kernel<DP, BAND><<<", "GL501", 6),
    "grid_with_no_division": (
        "ring_matmul.cu", "(unsigned)tiles_m, (unsigned)batch", "(unsigned)M, (unsigned)batch",
        1, "ring_matmul_tc_kernel<<<", "GL501", 1),
    "helper_grid_by_wrong_chunk": (
        "flash_common.cuh", "return (D + W - 1) / W;", "return (D + TILE - 1) / TILE;", 1,
        # the wide kernels' slice axis at both of their instantiations
        ("flash_fwd.cu:flash_fwd_kernel<<<", "flash_fwd.cu:flash_fwd_tc_wide_kernel<CW><<<",
         "flash_fwd.cu:flash_fwd_tc_wide_kernel<CW><<<",
         "flash_bwd.cu:flash_bwd_dkv_kernel<<<", "flash_bwd.cu:flash_bwd_dq_kernel<<<",
         "flash_bwd.cu:flash_bwd_dkv_tc_wide_kernel<CW><<<",
         "flash_bwd.cu:flash_bwd_dkv_tc_wide_kernel<CW><<<",
         "flash_bwd.cu:flash_bwd_dq_tc_wide_kernel<CW><<<",
         "flash_bwd.cu:flash_bwd_dq_tc_wide_kernel<CW><<<"),
        "GL501", 1),
    "narrow_v_grid_by_the_value_slice": (
        "flash_bwd.cu", "(Lq + TC_DQ_BQ - 1) / TC_DQ_BQ, n_chunks(D, CW));",
        "(Lq + TC_DQ_BQ - 1) / TC_DQ_BQ, n_chunks(D, DC));", 1,
        "flash_bwd_dq_tc_wide_kernel<CW><<<", "GL501", 1),
    "block_is_not_launch_bounds": (
        "flash_fwd.cu", "flash_fwd_tc_kernel<DP, BAND><<<grid, TC_THREADS, smem, stream>>>",
        "flash_fwd_tc_kernel<DP, BAND><<<grid, 2 * TC_THREADS, smem, stream>>>", 1,
        "flash_fwd_tc_kernel<DP, BAND><<<", "GL502", 6),
    "launch_bounds_changed": (
        "ring_matmul.cu", "__global__ void __launch_bounds__(THREADS)",
        "__global__ void __launch_bounds__(THREADS / 2)", 1,
        "ring_matmul_tc_kernel<<<", "GL502", 1),
    "shared_memory_over_227_kb": (
        "ring_matmul.cu", "constexpr int TK = 32;", "constexpr int TK = 64;", 1,
        "ring_matmul_tc_kernel<<<", "GL502", 1),
    "one_instantiation_over_227_kb": (
        "flash_fwd.cu", ": pgt::launch_fwd_tc<48, 0>(", ": pgt::launch_fwd_tc<512, 0>(", 1,
        "flash_fwd_tc_kernel<DP, BAND><<<", "GL502", 1),
}


@pytest.mark.parametrize("case", GL5_CASES.values(), ids=GL5_CASES.keys())
def test_gl5_mutated_launch_fires_at_its_line(tmp_path, case):
    name, old, new, count, markers, code, n = case
    root, found = _gl5(tmp_path, [(name, old, new, count)])
    want = []
    for marker in [markers] if isinstance(markers, str) else markers:
        launch_file, _, marker = marker.rpartition(":")
        launch_file = launch_file or name
        line = _line_of(root / "pkg" / "csrc" / launch_file, marker)
        want += [(code, f"pkg/csrc/{launch_file}", line)] * n
    assert found == sorted(want)


def test_gl5_resolves_the_real_launches():
    launches = {(lc.name, lc.launcher): lc for lc in launch_model(str(CSRC))}
    assert len(launches) == 40
    for band in (0, 1):  # the band instantiation takes the shared memory it always had
        fwd = launches[(f"flash_fwd_tc_kernel<128,{band}>", "launch_fwd_tc")]
        assert (fwd.block, fwd.threads, fwd.smem()) == (128, 128, 2 * (64 + 4 * 64) * 136)
    ring = launches[("ring_matmul_tc_kernel", "pgt_ring_matmul")]
    assert (ring.block, ring.smem()) == (256, 2 * 8 * 128 * 34 + 2 * 8 * 128 * 48)
    assert axis_tiles(ring.kernel_fn, ring.kernel_env()) == {"x": 64, "y": 64}
    wide = launches[("flash_fwd_tc_wide_kernel<128>", "launch_fwd_tc_wide")]
    assert wide.smem() is None  # D is a runtime value: quiet
    assert wide.smem(D=512) == 2 * (64 * 4 + 4 * 64) * 136 <= SMEM_LIMIT
    narrow_v = launches[("flash_fwd_tc_wide_kernel<192>", "launch_fwd_tc_wide")]
    assert narrow_v.smem(D=192) == 2 * (3 * 64 * 200 + 2 * 64 * 136) <= SMEM_LIMIT
    dkv = launches[("flash_bwd_dkv_tc_wide_kernel<192>", "launch_dkv_tc_wide")]
    assert dkv.smem(D=192) == 2 * (64 + 2 * 16) * (200 + 136) + 4 * 4 * 16
    f32 = launches[("flash_fwd_kernel", "launch_fwd")]
    assert f32.smem(D=64) == 4 * (3 * 64 * 65 + 64 * 65 + 3 * 64)
    rows = [lc for (name, _), lc in launches.items() if name.startswith("moe_")]
    assert len(rows) == 12  # six row kernels, each in bf16 and f32
    assert {(lc.block, lc.threads, lc.smem()) for lc in rows} == {(256, 256, 0)}


def test_gl5_expression_reader():
    env = Env({"A": 3, "B": "A * 4 + 1"}, {"imin": (["a", "b"], "a < b ? a : b")})
    assert env.eval("(B + 2) / A") == 5
    assert env.eval("imin(B, 7) - (long long)A % 2") == 6
    assert env.eval("sizeof(__nv_bfloat16) * B") == 26
    assert env.eval("-7 / 2") == -3  # C truncates toward zero
    assert env.eval("B * unknown") is None
    assert env.eval("a b") is None


# ── the YAML subset ───────────────────────────────────────────────────────


def test_yaml_subset_equals_pyyaml_on_the_wire_spec():
    yaml = pytest.importorskip("yaml")
    source = (ROOT / "docs" / "wire_protocol.yaml").read_text()
    assert safe_load(source) == yaml.safe_load(source)


YAML_CASES = {
    "mapping_and_sequence": ("a: 1\nb:\n  - x\n  - {p: 1, q: [1, 2]}\n",
                             {"a": 1, "b": ["x", {"p": 1, "q": [1, 2]}]}),
    "sequence_at_key_indent": ("a:\n- 1\n- two\n", {"a": [1, "two"]}),
    "scalars": ("s: 'a # b'  # c\nn: ~\nt: true\nf: 1.5\ne: {}\nd: \"x\"\n",
                {"s": "a # b", "n": None, "t": True, "f": 1.5, "e": {}, "d": "x"}),
    "mapping_items": ("l:\n  - k: 1\n    j: {terminal: true}\n  - k: 3\n",
                      {"l": [{"k": 1, "j": {"terminal": True}}, {"k": 3}]}),
}


@pytest.mark.parametrize("source,want", YAML_CASES.values(), ids=YAML_CASES.keys())
def test_yaml_subset_cases(source, want):
    assert safe_load(source) == want


@pytest.mark.parametrize("source", ["a: 1\n  b: 2\n", "a: [1, 2\n", "a: 1\na: 2\n", "a: |\n x\n"])
def test_yaml_subset_refuses_what_it_does_not_read(source):
    with pytest.raises(YamlSubsetError):
        safe_load(source)


# ── the package and its command line ──────────────────────────────────────


def test_analysis_imports_no_jax_no_reference_no_yaml():
    for path in sorted(ANALYSIS.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "pygrid_tpu", "yaml"), (
                    f"{path.relative_to(ROOT)} imports {name}")


def test_list_checkers_names_every_family(capsys):
    assert cli.main(["--list-checkers"]) == 0
    out = capsys.readouterr().out
    families = {line.split()[0] for line in out.splitlines() if line[:2] == "GL"}
    assert families == {f"GL{i}" for i in range(1, 8)}
    assert "GL104" not in out


def test_cli_exit_codes_json_and_sarif(tmp_path, capsys):
    (tmp_path / "pyproject.toml").write_text("")
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "mod.py").write_text(textwrap.dedent("""
        import torch

        def make_round(step):
            def round_fn(p):
                return p.sum().item()

            return round_fn
    """))
    target = str(tmp_path / "pkg")
    assert cli.main([target, "--no-baseline", "-q"]) == 1
    capsys.readouterr()
    assert cli.main([target, "--no-baseline", "--format", "json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [f["code"] for f in report["failures"]] == ["GL102"]
    sarif = tmp_path / "out.sarif"
    assert cli.main([target, "--no-baseline", "--format", "sarif", "--output", str(sarif),
                     "-q"]) == 1
    assert json.loads(sarif.read_text())["runs"][0]["results"][0]["ruleId"] == "GL102"
    assert cli.main([target, "--no-baseline", "--select", "GL5", "-q"]) == 0
    assert cli.main([str(tmp_path / "missing")]) == 2


def test_port_tree_is_clean_against_its_baseline(monkeypatch):
    """Strict: no failure, no stale entry, no parse error; every entry
    carries a note; the program graph is built once for all checkers."""
    from pygrid_tpu_torch.analysis import graph

    built = []
    original = graph.ProgramGraph.__init__

    def counting(self, modules):
        built.append(len(modules))
        original(self, modules)

    monkeypatch.setattr(graph.ProgramGraph, "__init__", counting)
    res = run_checks([str(ROOT / "pygrid_tpu_torch")], root=str(ROOT))
    assert res.parse_errors == []
    assert [f.render() for f in res.failures] == []
    assert res.stale_baseline == []
    assert len(built) == 1 and res.files_checked == built[0]
    entries = json.loads((ANALYSIS / "baseline.json").read_text())["entries"]
    assert all(len(e["note"]) > 40 for e in entries)


def test_chip_smoke_sync_twin_holds_syncs_against_gl102():
    """``chip_smoke.py`` phase lint's (b) on made-up stacks: a sync inside a
    program passes on a GL102 line and fails on any other line of the
    program's reach; a sync outside every program is only counted."""
    import chip_smoke

    gl1 = TraceSafetyChecker()
    res = run_checks([str(ROOT / "pygrid_tpu_torch")], checkers=[gl1], root=str(ROOT))
    gl102 = {}
    for f in res.failures + res.baselined:
        if f.code == "GL102":
            gl102.setdefault(f.path, []).append((f.line, f.end_line))
    programs = "pygrid_tpu_torch/serving/programs.py"
    engine = "pygrid_tpu_torch/serving/engine.py"
    src = (ROOT / programs).read_text().splitlines()
    fused = next(i for i, t in enumerate(src, 1) if "def _fused(" in t)
    ints = next(i for i, t in enumerate(src, 1)
                if "return host.pin_memory().to(self.device, non_blocking=True)" in t)
    # the programs' host inputs no longer sync, so GL102 reports no line
    # there: stand one finding in for the classifier
    gl102.setdefault(programs, []).append((ints, ints))
    loop = next(i for i, t in enumerate(src, 1) if i > fused and "for s in range(steps)" in t)
    call_site = (programs, fused + 3, "_fused")
    outside = chip_smoke._classify_syncs(
        "made-up", [[call_site, (programs, ints, "_ints")], [(engine, 1, "f")]], gl1, gl102)
    assert outside == {(f"{engine}:1", "f"): 1}
    with pytest.raises(RuntimeError, match="GL102 reported clean"):
        chip_smoke._classify_syncs("made-up", [[(programs, loop, "_fused")]], gl1, gl102)
    with pytest.raises(RuntimeError, match="no pygrid_tpu_torch frame"):
        chip_smoke._classify_syncs("made-up", [[]], gl1, gl102)
