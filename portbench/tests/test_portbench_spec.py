"""BENCHMARK.json against the benchmark's contract, and the loading of
configs, traffic mixes, limits and metric readers by name, including ones
added in a fresh directory by files alone."""

import json
import os
import re
import shutil

import pytest

from portbench import harness, spec

BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
COMPARED = ("segments_heatmap_mismatch", "iou_mismatch", "outcome_mismatch", "rel_logit_err")
COMPARED_BY_KIND = {"window_sweep": set(harness._blank()), "bo_request": set(harness._bo_blank())}


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text(c["source"]) and text(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert c["name"] in used


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and text(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c = spec.Cell(cell)
    assert set(c.limits) == COMPARED_BY_KIND[c.traffic["kind"]]
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics(kind):
            assert callable(spec.reader(m["name"]))


def test_paths_hold_only_the_benchmark():
    for dirpath, _, files in os.walk(os.path.join(spec.ROOT, "portbench")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_missing_net_raises_naming_it(tmp_path):
    root = tmp_path
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = spec.load_json(os.path.join(spec.ROOT, "portbench/configs/resnet101-224-bf16.json"))
    (root / "portbench/configs/resnet101-224-bf16.json").write_text(
        json.dumps(dict(cfg, net="inception_v3")))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ModuleNotFoundError, match="inception_v3"):
        spec.Cell("r101.window-1024", root=str(root))
    for name in ("no_such_net", "../metrics/setup_s"):
        with pytest.raises(ModuleNotFoundError, match=re.escape(name)):
            spec.net({"name": "x", "net": name})


def test_a_config_a_mix_and_a_metric_added_by_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries; the harness finds them by
    name with no file of it edited."""
    root = tmp_path
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = spec.load_json(os.path.join(spec.ROOT, "portbench/configs/resnet101-224-bf16.json"))
    cfg.update(name="resnet152-224-bf16", arch="resnet152", stage_sizes=[3, 8, 36, 3])
    (root / "portbench/configs/resnet152-224-bf16.json").write_text(json.dumps(cfg))
    mix = spec.load_json(os.path.join(spec.ROOT, "portbench/traffic/window-1024.json"))
    mix.update(masks_per_image=2048)
    (root / "portbench/traffic/window-2048.json").write_text(json.dumps(mix))
    (root / "portbench/limits/r152.window-2048.json").write_text(
        json.dumps({"limits": {n: 0 for n in COMPARED}}))
    (root / "portbench/metrics/images_per_s.window.py").write_text(
        "def read(ctx):\n    return ctx.images / ctx.window_s if ctx.window_s else None\n")
    bench["configs"].append({"name": "resnet152-224-bf16", "source": "https://arxiv.org/abs/1512.03385",
                             "file": "portbench/configs/resnet152-224-bf16.json", "reduced": [],
                             "why": "deeper"})
    bench["workloads"].append({"name": "r152.window-2048", "config": "resnet152-224-bf16",
                               "traffic": "window-2048", "chips": 1, "why": "deeper, more masks"})
    for m in bench["end_to_end"]:
        if m["name"] == "evals_per_s":
            m["workloads"].append("r152.window-2048")
    bench["per_layer"].append({"name": "images_per_s.window", "unit": "images/s",
                               "better": "higher", "source": "host_clock", "layer": "device",
                               "moves": "evals_per_s", "workloads": ["r152.window-2048"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell("r152.window-2048", root=str(root))
    assert cell.config["stage_sizes"] == [3, 8, 36, 3]
    assert cell.traffic["masks_per_image"] == 2048
    assert cell.limits["rel_logit_err"] == 0

    class Ctx:
        kind, window_s, images, evals, setup_s, traced = "window_sweep", 2.0, 10, 20480, 5.0, False

    assert [m["name"] for m in cell.metrics("per_layer")] == ["images_per_s.window"]
    got = spec.read_metrics(cell, "per_layer", Ctx())
    assert got == {"images_per_s.window": {"value": 5.0, "unit": "images/s"}}
    e2e = spec.read_metrics(cell, "end_to_end", Ctx())
    assert e2e["evals_per_s"]["value"] == 10240.0 and e2e["setup_s"]["value"] == 5.0
