"""The benchmark's spec and the files it finds by name.

`BENCHMARK.json` at the repository's root names the cells; everything
that belongs to one configuration, traffic mix, cell, system or per-layer
metric sits in a file of its own under the data directory (benchmark/ by
default), found by its name:

- configs/<config>.json: the deployment's sizes and settings; its
  `system` names the driver;
- traffic/<mix>.json: the parameters of benchmark/traffic.py's generator;
- cells/<cell>.json: a cell's check (the chunks it compares, the limits of
  its numbers) and its traced span;
- systems/<system>.py: the driver of one entry of the program (a
  `System` class);
- metrics/<metric>.py: the reader of one per-layer metric (a `read(ctx)`
  function that returns a number, or None where it finds nothing).

A later change adds a configuration, a mix, a cell or a metric as new
files and new entries of BENCHMARK.json, and edits no file that is here.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
import re
import sys

DATA = pathlib.Path(__file__).resolve().parent
ROOT = DATA.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Bench:
    """BENCHMARK.json (`spec`) with its files under `data`."""

    def __init__(self, spec=ROOT / "BENCHMARK.json", data=DATA):
        self.spec_path = pathlib.Path(spec)
        self.data = pathlib.Path(data)
        self.spec = json.loads(self.spec_path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.spec_path}")

    def _json(self, kind: str, name: str) -> dict:
        if not NAME.match(name):
            raise ValueError(f"bad name {name!r}")
        return json.loads((self.data / kind / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def mix(self, name: str) -> dict:
        return self._json("traffic", name)

    def cell_params(self, name: str) -> dict:
        return self._json("cells", name)

    def module(self, kind: str, name: str):
        """The module <data>/<kind>/<name>.py, loaded once."""
        if not NAME.match(name):
            raise ValueError(f"bad module name {name!r}")
        path = self.data / kind / f"{name}.py"
        tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:10]
        key = re.sub(r"[.-]", "_", f"benchmark_{kind}_{name}_{tag}")
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return sys.modules[key]

    def system(self, config: dict):
        return self.module("systems", config["system"]).System

    def metrics(self, cell: str, key: str) -> list:
        """The `key` ("end_to_end" or "per_layer") metrics a cell reports."""
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return self.module("metrics", metric).read
