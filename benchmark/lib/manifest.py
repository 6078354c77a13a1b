"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration and its traffic
mix; the harness reads ``configs/<config>.json``, ``traffic/<traffic>.json``
and ``workloads/<cell>.json`` under the benchmark's folder, the driver
``drivers/<kind>.py`` that the configuration's ``kind`` names, and one
reader ``metrics/<metric>.py`` a per-layer metric. A later change adds a
configuration, a traffic mix, a cell or a metric as new files and a new
entry here, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def named_file(kind: str, name: str, ext: str = ".json") -> str:
    """The file of ``name`` under the benchmark's ``kind`` folder; raises
    for a name outside the allowed characters."""
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} has characters a name may "
                         "not have")
    path = os.path.join(HERE, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_module(kind: str, name: str):
    """The module in ``<kind>/<name>.py``, loaded from its file (a name may
    hold dots, which an import statement would read as packages)."""
    path = named_file(kind, name, ".py")
    mod_name = f"benchmark.{kind}._{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell with everything the manifest and its files say of it."""

    def __init__(self, name: str, bench: dict):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(entries)})")
        self.name = name
        self.entry = entries[name]
        self.config = load_json(named_file("configs", self.entry["config"]))
        self.traffic = load_json(named_file("traffic", self.entry["traffic"]))
        self.spec = load_json(named_file("workloads", name))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def driver(self):
        return load_module("drivers", self.config["kind"])

    def reader(self, metric: str):
        return load_module("metrics", metric)
