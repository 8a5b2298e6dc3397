"""The benchmark's files: what ``BENCHMARK.json`` names exists, the
harness imports nothing of JAX or the JAX package, the reference nothing
of the port, and the command refuses to run without a card."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from hbench import harness

HB = Path(__file__).resolve().parents[1]
ROOT = HB.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere_and_no_port_in_the_reference():
    for py in HB.rglob("*.py"):
        tops = set(imports(py))
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, py
        if "reference" in py.parts:
            assert "repro_torch" not in tops, py


def test_benchmark_names_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["hbench"]
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert k in cfg["published"] and cfg["published"][k] != cfg[k]
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (HB / "traffic" / f"{w['traffic']}.json").exists()
        assert (HB / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert harness.reader_path(m["name"]).exists(), m["name"]
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved), m["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_command_refuses_without_a_card(tmp_path):
    if subprocess.run([sys.executable, "-c", "import torch,sys; "
                       "sys.exit(0 if torch.cuda.is_available() else 1)"]).returncode == 0:
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "hbench/run.py", "--workload", "qwen15b-train",
                        "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
