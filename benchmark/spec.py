"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<mix>.json``) and the
readers of its per-layer metrics (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple

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
    """A cell of a configuration file and the mix ``traffic/<traffic>.json``."""
    with open(config_file) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    return Cell(name=name, chips=chips, config=config, traffic=mix, end_to_end=end_to_end,
                per_layer=per_layer)


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    module_name = "benchmark_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def detector_kwargs(detector: Dict, reference: bool = False) -> Dict:
    """A configuration file's ``detector`` object as the keyword arguments
    of the port's ``DetectorConfig`` (``reference``: of the reference's
    copy), its ``mtcnn`` object made that package's ``MTCNNConfig`` and
    lists made tuples."""
    if reference:
        from benchmark.reference.config import MTCNNConfig
    else:
        from truely_tpu_torch.config import MTCNNConfig

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    kw = tup({k: v for k, v in detector.items() if k != "mtcnn"})
    kw["mtcnn"] = MTCNNConfig(**tup(detector["mtcnn"]))
    return kw
