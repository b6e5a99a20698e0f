"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<file>``, ``traffic/<name>.json``, ``metrics/<name>.py``
and ``reference/<name>.py`` beside this package."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT, bench_dir: Path | None = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else self.root / BENCH_DIR.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        """The workload ``name``; refused where its ``chips`` is not the
        number of cards its configuration's ``devices`` names."""
        from pbench.system import cuda_cards

        for w in self.data["workloads"]:
            if w["name"] == name:
                cards = cuda_cards(self.config(w["config"]).get("devices"))
                if cards != w["chips"]:
                    raise ValueError(
                        f"workload {name!r} asks for {w['chips']} chip(s), but its configuration "
                        f"{w['config']!r} names {cards} card(s) in 'devices'")
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` false) or its per-layer
        ones: those that list the cell, or list no cells and move an
        end-to-end metric that the cell reports."""
        e2e = [m for m in self.data["end_to_end"] if _applies(m, cell)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py", f"pb_metric_{metric}")

    def reference(self, cfg: dict):
        name = cfg["reference"]
        return load_module(self.dir / "reference" / f"{name}.py", f"pb_reference_{name}")


def _applies(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (registered, so that its
    dataclasses resolve)."""
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over`` laid on it, nested dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out
