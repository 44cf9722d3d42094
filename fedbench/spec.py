"""Finds the benchmark's parts by name: configurations, cells, metric readers.

Everything that belongs to one configuration, one cell or one metric is a
file of its own; nothing here lists them.

- ``configs/<name>.json``: a model configuration (sizes, source, ``kind``);
- ``workloads/<name>.json``: a cell (its ``config``, traffic, round options,
  the limits of its checks);
- ``metrics/<name>.py``: one reader per metric;
- ``party/<kind>.py``, ``reference/<kind>.py``, ``flops/<kind>.py``: the
  trainer, the plain reference and the operation counts of a model kind;
- ``reference/<fold>.py``: the plain fold a cell's ``fold`` names.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(folder: str, name: str) -> dict:
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def names(folder: str, suffix: str = ".json") -> list:
    return sorted(p.name[: -len(suffix)] for p in (HERE / folder).glob(f"*{suffix}"))


def cell(name: str) -> tuple:
    """``(workload, config)`` of the cell ``name``."""
    workload = load_json("workloads", name)
    return workload, load_json("configs", workload["config"])


def _load_file(path: Path):
    spec = importlib.util.spec_from_file_location(f"fedbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics() -> dict:
    """Every reader under ``metrics/``, by metric name (its file's stem)."""
    return {p.name[:-3]: _load_file(p) for p in sorted((HERE / "metrics").glob("*.py"))}


def kind_module(package: str, kind: str):
    """``fedbench.<package>.<kind>``: a model kind's trainer, reference or counts."""
    return importlib.import_module(f"fedbench.{package}.{kind}")


def mix(seed: int, *keys) -> int:
    """A 63-bit seed for one purpose, from the run's seed and names."""
    h = hashlib.blake2b(repr((int(seed),) + tuple(keys)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1
