"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, the metrics each cell reports and the share of four-chip cells."""

import json
import re

import pytest

from portbench import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expansion|experts_per_tok|_dim$|_rank$|embed)")


@pytest.fixture(scope="module")
def bench():
    return json.load(open(mf.ROOT / "BENCHMARK.json"))


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len((mf.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (mf.ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(bench, key):
    names = [e["name"] for e in bench[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert (mf.ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert json.load(open(mf.ROOT / c["file"]))["reduced"] == c["reduced"]


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (mf.PACKAGE_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (mf.PACKAGE_DIR / "limits" / f"{w['name']}.json").is_file()
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells), f"{m['name']} in {cell}, which lacks {m['moves']}"
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        assert (mf.PACKAGE_DIR / "layers" / f"{m['name'].split('.')[0]}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m["name"] for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_limits_are_numbers(bench):
    for w in bench["workloads"]:
        limits = mf.Manifest.load().limits(w["name"])
        compared = {k: v for k, v in limits.items() if v is not None}  # null: read, not compared
        assert compared and all(isinstance(v, (int, float)) and v >= 0 for v in compared.values())


def test_file_names_are_names():
    for p in mf.PACKAGE_DIR.rglob("*"):
        if "__pycache__" in p.parts or p.suffix == ".pyc":
            continue
        rel = p.relative_to(mf.ROOT).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel
