"""Exporters: Prometheus textfile format and JSONL snapshots.

(a copy of the JAX package's stdlib-only ``obs/export.py``;
``obs/serve.py`` serves its text.)

Both read the registry, neither mutates it.  The Prometheus text is the
node-exporter *textfile collector* dialect (write the file into its
watched directory and the fleet scraper picks it up — no HTTP server to
babysit on a box whose processes die by design); the JSONL exporter is
the greppable local form (one snapshot+delta per line, same spirit as
the scalars.jsonl the MetricsLogger already writes).

Output is canonically ordered (families and series sorted), so golden
tests pin the exact bytes and a diff between two exports is a diff
between two states — not between two dict orderings.
"""

from __future__ import annotations

import json

from distributedtensorflowexample_tpu_torch.obs import metrics as _metrics
from distributedtensorflowexample_tpu_torch.obs import recorder as _recorder


def _fmt(value) -> str:
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


def _series_with_label(key: str, extra: str) -> str:
    """Append one label to a series key that may or may not already
    carry a label set (``h{a="1"}`` + ``le="5"`` -> ``h{a="1",le="5"}``)."""
    if key.endswith("}"):
        return f'{key[:-1]},{extra}}}'
    return f"{key}{{{extra}}}"


def prometheus_text(registry: _metrics.MetricsRegistry | None = None) -> str:
    reg = registry or _metrics.registry()
    lines: list[str] = []
    for fam in reg.families():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in fam.series():
            if fam.kind == "histogram":
                # One copy of the counts backs every derived line (see
                # MetricsRegistry.snapshot: a later read of child.count
                # under concurrent observes could break the +Inf >=
                # finite-bucket monotonicity Prometheus requires).
                counts = list(child.counts)
                total = sum(counts)
                cum = 0
                base, labels = key, ""
                if key.endswith("}"):
                    base = key[:key.index("{")]
                    labels = key[key.index("{"):]
                for bound, n in zip(child.bounds, counts):
                    cum += n
                    lines.append(_series_with_label(
                        f"{base}_bucket{labels}", f'le="{bound}"')
                        + f" {cum}")
                lines.append(_series_with_label(
                    f"{base}_bucket{labels}", 'le="+Inf"')
                    + f" {total}")
                lines.append(f"{base}_sum{labels} {_fmt(child.sum)}")
                lines.append(f"{base}_count{labels} {total}")
            else:
                lines.append(f"{key} {_fmt(child.value)}")
    return "\n".join(lines) + "\n"


def write_prometheus_textfile(
        path: str,
        registry: _metrics.MetricsRegistry | None = None) -> str:
    """Atomic write — the textfile collector may read at any instant
    and a torn scrape half-counts everything."""
    _recorder.atomic_write(path, prometheus_text(registry).encode())
    return path


class JsonlExporter:
    """Append one ``{"unix_ts", "snapshot", "delta"}`` line per export;
    the delta is against this exporter's previous snapshot (None on the
    first line), so consumers get rates without re-deriving them."""

    def __init__(self, path: str):
        self._path = path
        self._prev: dict | None = None

    def export(self,
               registry: _metrics.MetricsRegistry | None = None) -> dict:
        reg = registry or _metrics.registry()
        snap = reg.snapshot()
        # Through the _wall seam (not time.time directly): the PR-13
        # clock-seam rule — a test that pins the seam must pin THIS
        # stamp too, or JSONL exports are not bitwise-reproducible.
        rec = {"unix_ts": round(_metrics._wall(), 3),
               "snapshot": snap,
               "delta": (_metrics.MetricsRegistry.delta(self._prev, snap)
                         if self._prev is not None else None)}
        with open(self._path, "a") as f:
            f.write(json.dumps(_metrics.json_safe(rec), sort_keys=True,
                               allow_nan=False, default=str) + "\n")
        self._prev = snap
        return rec
