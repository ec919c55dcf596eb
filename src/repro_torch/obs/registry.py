"""Benchmark metrics as a registry view.

The port's copy of the JAX package's ``obs/registry.py``.  A benchmark
routes every leaf of its nested report through the process recorder's
registry (dotted keys, gauges), and the JSON file is re-materialized
*from* the registry, so `trace.json`, flight dumps and bench results all
hang off the same spine.

    report = {"free": {"sync": {"goodput": 3.1}}, ...}
    out = bench_report("elastic", report, RESULTS_DIR)
    # registry now holds bench.elastic.free.sync.goodput = 3.1
    # out == RESULTS_DIR/elastic.json, content identical to `report`
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional, Union

from repro_torch.obs import recorder as _recorder
from repro_torch.obs.recorder import Recorder

# Benches must register metrics even when no --trace-out recorder is
# installed, so a dedicated always-on recorder backs them by default.
_bench_rec: Optional[Recorder] = None


def _metrics_recorder() -> Recorder:
    global _bench_rec
    rec = _recorder.get()
    if rec.enabled:
        return rec
    if _bench_rec is None:
        _bench_rec = Recorder(host="bench")
    return _bench_rec


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def emit_metrics(prefix: str, tree: Dict[str, Any],
                 rec: Optional[Recorder] = None) -> Recorder:
    """Write every leaf of `tree` into the registry as `<prefix>.<path>`."""
    rec = rec or _metrics_recorder()
    for key, v in flatten(tree, prefix).items():
        rec.gauge(key, v)
    return rec


def registry_view(prefix: str, rec: Optional[Recorder] = None
                  ) -> Dict[str, Any]:
    """Re-materialize the nested dict under `<prefix>.` from the registry."""
    rec = rec or _metrics_recorder()
    pre = prefix + "."
    flat = {k[len(pre):]: v for k, v in rec.registry.items()
            if k.startswith(pre)}
    return unflatten(flat)


def bench_report(name: str, report: Dict[str, Any],
                 results_dir: Union[str, pathlib.Path]) -> pathlib.Path:
    """Register `report` under `bench.<name>.*`, then write
    `<results_dir>/<name>.json` as a view over the registry."""
    rec = emit_metrics(f"bench.{name}", report)
    view = registry_view(f"bench.{name}", rec)
    results = pathlib.Path(results_dir)
    results.mkdir(parents=True, exist_ok=True)
    out = results / f"{name}.json"
    out.write_text(json.dumps(view, indent=1))
    return out
