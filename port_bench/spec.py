"""A cell's inputs, found by name: its entry in ``BENCHMARK.json``, its
configuration file (``configs/<config>.json``), its traffic file
(``traffic/<traffic>.json``) and its limits file (``limits/<cell>.json``).

A configuration file holds the network (``n_peers`` inside ``sim``, the
underlay's ``degree``, the subscription probability) and every
``SimConfig`` and ``TopicScoreParams`` value of the builder it stands
for; a traffic file holds the ``SimConfig`` values it changes (``sim``),
optionally the topics' score parameters (``topics``), and the supervised
path's settings (``supervisor``). Nothing here imports the program."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict          # number name -> limit
    entry: dict           # the workloads entry
    bench: dict           # the whole BENCHMARK.json

    @property
    def sim(self) -> dict:
        """Every SimConfig value of the cell: the configuration's, with the
        traffic's changes."""
        return {**self.config["sim"], **self.traffic.get("sim", {})}

    @property
    def topics(self) -> list:
        return self.traffic.get("topics", self.config["topics"])

    @property
    def chunk_ticks(self) -> int:
        return int(self.traffic.get("supervisor", {}).get("chunk_ticks", 8))

    def metrics(self, trace: bool) -> list:
        """The BENCHMARK.json metric entries this cell reports."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    config = _load(os.path.join(root, cfg_entry["file"]))
    traffic = _load(os.path.join(BENCH_DIR, "traffic",
                                 entry["traffic"] + ".json"))
    limits = _load(os.path.join(BENCH_DIR, "limits", name + ".json"))
    return Cell(name, config, traffic, limits["limits"], entry, bench)


def subscriptions(n: int, t: int, prob: float, seed: int) -> np.ndarray:
    """[N, T] bool: each peer joins each topic with probability ``prob``,
    and a peer with none takes topic 0 (the churn_50k builder's rule),
    drawn from ``seed``."""
    if prob >= 1.0:
        return np.ones((n, t), dtype=bool)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    sub = rng.random((n, t)) < prob
    sub[~sub.any(axis=1), 0] = True
    return sub
