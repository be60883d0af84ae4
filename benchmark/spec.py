"""Everything the harness finds by name: ``BENCHMARK.json`` at the root of
the checkout, and the files beside this one that its names point to.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``;
- a metric, end-to-end or per-layer: its reader ``metrics/<name>.py``,
  whose ``read(ctx)`` returns the value or None where it finds nothing;
- a layer of the device trace: ``layers/<layer>.json``, its ``rules``
  tried in the ``order`` of the files (then by name), ``each`` to keep
  every kernel's time in order.

A cell, configuration, traffic mix, metric or layer is added by adding its
files (and a cell, configuration or metric its entry in
``BENCHMARK.json``): nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))


class Spec:
    def __init__(self, root: str, bench_dir: str = HERE):
        """``root``: where ``BENCHMARK.json`` is; ``bench_dir``: where the
        traffic files, metric readers and layer rules are."""
        self.root = root
        self.bench_dir = bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for cfg in self.data["configs"]:
            if cfg["name"] == cell["config"]:
                with open(os.path.join(self.root, cfg["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        with open(os.path.join(self.bench_dir, "traffic",
                               cell["traffic"] + ".json")) as f:
            return json.load(f)

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The cell's metrics: its end-to-end ones, or with ``trace`` its
        per-layer ones (a metric without ``workloads`` is every cell's)."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name: str) -> Callable:
        path = os.path.join(self.bench_dir, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def layer_rules(self) -> List[dict]:
        """Every layer file's rules, each with its ``layer`` (the file's
        name) and ``each``, in the files' order."""
        folder = os.path.join(self.bench_dir, "layers")
        layers = []
        for name in sorted(os.listdir(folder)):
            if name.endswith(".json"):
                with open(os.path.join(folder, name)) as f:
                    layers.append((name[:-len(".json")], json.load(f)))
        layers.sort(key=lambda nl: (nl[1]["order"], nl[0]))
        return [dict(rule, layer=name, each=bool(data.get("each")))
                for name, data in layers for rule in data["rules"]]
