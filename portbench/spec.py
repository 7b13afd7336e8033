"""What a run is: the cell from ``BENCHMARK.json``, its configuration and
traffic files, its limits, the reference net of the configuration's family,
and the metric readers, all found by name.

A later change adds a configuration, a family of nets, a traffic mix, a
cell or a metric by adding a file and an entry; nothing here names one but
the family of a configuration that names none."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_NET = "bottleneck_resnet"   # the family of a configuration with no "net"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One ``workloads`` entry with everything it names, loaded."""

    def __init__(self, name: str, bench_path: Optional[str] = None,
                 root: Optional[str] = None) -> None:
        root = root or ROOT
        self.root = root
        self.bench = load_json(bench_path or os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        self.net = net(self.config, root)
        self.traffic = load_json(os.path.join(root, "portbench", "traffic",
                                              self.entry["traffic"] + ".json"))
        limits = os.path.join(root, "portbench", "limits", name + ".json")
        self.limits: Dict[str, float] = load_json(limits)["limits"] if os.path.isfile(limits) else {}
        self.chips = int(self.entry["chips"])

    def metrics(self, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def _load(path: str, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def net(config: dict, root: Optional[str] = None) -> ModuleType:
    """The module ``portbench/nets/<net>.py`` of the configuration's family,
    ``net`` its key ``"net"`` (:data:`DEFAULT_NET` where it has none). It
    gives ``state_shapes(cfg)``, ``HEAD``, ``residual_bn_keys(cfg)``,
    ``Plain`` and ``forward_flops(cfg)`` (see ``portbench/README.md``)."""
    name = config.get("net", DEFAULT_NET)
    path = os.path.join(root or ROOT, "portbench", "nets", f"{name}.py")
    if not (isinstance(name, str) and re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name)
            and os.path.isfile(path)):
        raise ModuleNotFoundError(f"configuration {config.get('name')!r} names the net {name!r}, "
                                  f"and there is no portbench/nets/{name}.py")
    return _load(path, "portbench_net_" + name)


def reader(name: str, root: Optional[str] = None) -> Callable:
    """``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root or ROOT, "portbench", "metrics", name + ".py")
    return _load(path, "portbench_metric_" + name.replace(".", "_").replace("-", "_")).read


def read_metrics(cell: Cell, kind: str, ctx) -> Dict[str, dict]:
    """Each of the cell's metrics of ``kind`` whose reader finds something,
    as ``{name: {"value", "unit"}}``; a reader that finds nothing returns
    None and its metric is left out."""
    out = {}
    for m in cell.metrics(kind):
        value = reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
