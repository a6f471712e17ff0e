"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file, the model that file names (``models/<model>.py``),
its traffic mix (``traffic/<mix>.json``) and the readers of its metrics
(``metrics/<metric>.py``)."""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from typing import List, Mapping, NamedTuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict         # the configuration file
    traffic: dict        # the traffic mix
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; raises KeyError for
    a name it does not list."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return make(name, work["chips"], root / conf["file"], work["traffic"],
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def make(name: str, chips: int, config_file, traffic: str, end_to_end: List[dict],
         per_layer: List[dict]) -> Cell:
    """A cell of a configuration file and the mix ``traffic/<traffic>.json``;
    raises KeyError for a configuration file without a ``model``."""
    with open(config_file) as f:
        config = json.load(f)
    model(config)
    with open(BENCH / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    return Cell(name=name, chips=chips, config=config, traffic=mix, end_to_end=end_to_end,
                per_layer=per_layer)


@functools.lru_cache(maxsize=None)
def _load(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark, loaded once."""
    path = BENCH / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The ``read(cell, outcome)`` function of ``metrics/<name>.py``."""
    return _load("metrics", name).read


def model(config: Mapping):
    """The module ``models/<model>.py`` that a configuration file names by
    its ``model`` key: the program it runs, its weights, its reference,
    its check and its counts (``PERF.md`` §3 lists what a model module
    gives)."""
    return _load("models", config["model"])
