"""Nothing the harness loads has the top-level name ``jax`` or ``pygrid_tpu``,
and nothing under ``reference/`` imports the port."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

# a meta-path hook that refuses whole top-level names, then loads run.py,
# every entry, family, metric and reference module, and the port's modules
# the entries call
PROBE = r'''
import importlib.abc, json, sys
BLOCK = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[2])
from pathlib import Path
from benchmark import harness as H
root = Path(sys.argv[2])
H.load_module(root / "benchmark" / "run.py", "bench_run")
for group in sys.argv[3].split(","):
    for p in sorted((root / "benchmark" / group).glob("*.py")):
        H.load_module(p, f"probe.{group}.{p.stem.replace('.', '_')}")
for extra in sys.argv[4:]:
    importlib.import_module(extra)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)))
'''


def _probe(block, groups, *extra):
    r = subprocess.run([sys.executable, "-c", PROBE, block, str(REPO), groups, *extra],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_harness_loads_no_jax_and_no_jax_package():
    out = _probe("jax,jaxlib,flax,pygrid_tpu", "entries,families,metrics,reference,work",
                 "pygrid_tpu_torch.parallel", "pygrid_tpu_torch.models.transformer",
                 "pygrid_tpu_torch.models.mlp", "pygrid_tpu_torch.smpc",
                 "pygrid_tpu_torch.serde", "pygrid_tpu_torch.runtime")
    assert out == "[]"


def test_references_load_nothing_of_the_port():
    out = _probe("jax,jaxlib,flax,pygrid_tpu,pygrid_tpu_torch", "reference,work")
    assert out == "[]"


def test_reference_sources_name_no_program():
    for p in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "pygrid_tpu",
                                               "pygrid_tpu_torch"), (p.name, n)
