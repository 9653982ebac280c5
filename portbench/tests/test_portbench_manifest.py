"""BENCHMARK.json against the benchmark's contract, every entry's files
found by name, and the import rule: nothing under portbench/ imports JAX
or the JAX package, and the reference nothing of the program."""

import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert all(line_ok(w) for w in MANIFEST["command"])
    assert MANIFEST["paths"] == ["portbench"]
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 24 * (14 * (rs + 60) + 180) + 2 * (rs + 60) + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert line_ok(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
    if section == "end_to_end":
        for e in entries:
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        assert "setup_s" in names


def test_configs_and_cells_find_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    for c in configs.values():
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        assert NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1
        pairs.add((w["config"], w["traffic"]))
    assert used == set(configs)
    assert len(pairs) == len(MANIFEST["workloads"])


def test_every_cell_reports_what_its_metrics_move():
    cells = [w["name"] for w in MANIFEST["workloads"]]

    def reports(cell, metrics):
        return {m["name"] for m in metrics
                if cell in m.get("workloads", cells)}

    layers = {}
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], set()).add(m["name"])
        for cell in m.get("workloads", cells):
            assert m["moves"] in reports(cell, MANIFEST["end_to_end"]), \
                (m["name"], cell)
    for cell in cells:
        e2e = reports(cell, MANIFEST["end_to_end"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reports(cell, MANIFEST["per_layer"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere_under_portbench():
    banned = {"jax", "jaxlib", "flax", "face_detection_multi_scale_tpu"}
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & banned, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert "face_detection_multi_scale_tpu_torch" not in names, path
        assert names <= {"torch", "numpy", "contextlib", "typing",
                         "__future__", "math", "portbench"}, (path, names)


def test_layers_json_targets_exist():
    import importlib

    for e in json.loads((BENCH / "layers.json").read_text()):
        mod, attr = e["target"].split(":")
        owner = importlib.import_module(mod)
        for part in attr.split("."):
            owner = getattr(owner, part)
