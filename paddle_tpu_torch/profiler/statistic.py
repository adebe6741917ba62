"""Profiler statistics tables (counterpart of
paddle_tpu/profiler/statistic.py; reference
python/paddle/profiler/profiler_statistic.py).

The source is the chrome trace `torch.profiler` writes
(`export_chrome_trace`, plain or gzipped JSON). An event is on the
device lane when its category is one of the card's (`kernel`,
`gpu_memcpy`, `gpu_memset`), else on the host lane (operators, CUDA
runtime calls, RecordEvent spans, Python functions).

`collect(trace_dir)` loads the newest trace under the directory;
`build_tables(collected)` aggregates into

* overview — wall span and busy time per lane,
* op summary — per event name: calls, total / avg / max / min µs and
  share of its lane's busy time,

and `render(tables)` formats them in the reference's table style.
"""
import glob
import gzip
import json
import os

__all__ = ["collect", "build_tables", "render", "SummaryData",
           "DEVICE_CATEGORIES"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _newest_trace(trace_dir):
    hits = []
    for pat in ("*.json", "*.json.gz"):
        hits.extend(glob.glob(os.path.join(trace_dir, "**", pat),
                              recursive=True))
    if not hits:
        return None
    return max(hits, key=os.path.getmtime)


def collect(trace_dir):
    """Events of the newest trace under `trace_dir`:
    (events, process_names, thread_names), or None."""
    path = _newest_trace(trace_dir)
    if path is None:
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) \
        else data
    proc_names, thread_names = {}, {}
    for ev in events:
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                proc_names[ev.get("pid")] = ev["args"].get("name", "")
            elif ev.get("name") == "thread_name":
                thread_names[(ev.get("pid"), ev.get("tid"))] = \
                    ev["args"].get("name", "")
    return events, proc_names, thread_names


def _category(ev):
    return "device" if ev.get("cat") in DEVICE_CATEGORIES else "host"


class SummaryData:
    def __init__(self, overview, op_table):
        self.overview = overview    # {category: {busy_us, span_us}}
        self.op_table = op_table    # {category: {name: row-dict}}

    def rows(self, category="device", sorted_by="total"):
        key = {"total": "total_us", "calls": "calls", "avg": "avg_us",
               "max": "max_us", "name": "name"}[sorted_by]
        rows = list(self.op_table.get(category, {}).values())
        rows.sort(key=lambda r: r[key], reverse=key != "name")
        return rows


def build_tables(collected):
    events = collected[0]
    overview = {}
    ops = {}
    for ev in events:
        if ev.get("ph") != "X":  # complete events carry durations
            continue
        dur = float(ev.get("dur", 0.0))
        name = ev.get("name", "")
        if not name:
            continue
        cat = _category(ev)
        ov = overview.setdefault(cat, {"busy_us": 0.0, "first": None,
                                       "last": None})
        ts = float(ev.get("ts", 0.0))
        ov["busy_us"] += dur
        ov["first"] = ts if ov["first"] is None else min(ov["first"], ts)
        ov["last"] = (ts + dur if ov["last"] is None
                      else max(ov["last"], ts + dur))
        row = ops.setdefault(cat, {}).setdefault(
            name, {"name": name, "calls": 0, "total_us": 0.0,
                   "max_us": 0.0, "min_us": float("inf")})
        row["calls"] += 1
        row["total_us"] += dur
        row["max_us"] = max(row["max_us"], dur)
        row["min_us"] = min(row["min_us"], dur)
    for cat, table in ops.items():
        busy = max(overview[cat]["busy_us"], 1e-9)
        for row in table.values():
            row["avg_us"] = row["total_us"] / row["calls"]
            row["ratio"] = row["total_us"] / busy
    for ov in overview.values():
        ov["span_us"] = (ov["last"] - ov["first"]) if ov["first"] is not \
            None else 0.0
        ov.pop("first", None)
        ov.pop("last", None)
    return SummaryData(overview, ops)


def _fmt_us(us):
    if us >= 1e6:
        return f"{us / 1e6:.3f} s"
    if us >= 1e3:
        return f"{us / 1e3:.3f} ms"
    return f"{us:.1f} us"


def render(data, sorted_by="total", max_rows=30, categories=None):
    """Reference-style text tables (profiler_statistic.py layout)."""
    lines = []
    cats = categories or [c for c in ("device", "host")
                          if c in data.op_table]
    bar = "-" * 78
    lines.append(bar)
    lines.append("Overview Summary")
    lines.append(bar)
    for cat, ov in sorted(data.overview.items()):
        lines.append(f"{cat:<10} span {_fmt_us(ov['span_us']):>12}   "
                     f"busy {_fmt_us(ov['busy_us']):>12}")
    for cat in cats:
        rows = data.rows(category=cat, sorted_by=sorted_by)
        if not rows:
            continue
        lines.append(bar)
        lines.append(f"{cat.capitalize()} Op Summary "
                     f"(sorted by {sorted_by})")
        lines.append(bar)
        lines.append(f"{'Name':<34}{'Calls':>7}{'Total':>12}{'Avg':>12}"
                     f"{'Max':>12}{'Ratio':>8}")
        for row in rows[:max_rows]:
            nm = row["name"]
            nm = nm if len(nm) <= 33 else nm[:30] + "..."
            lines.append(
                f"{nm:<34}{row['calls']:>7}"
                f"{_fmt_us(row['total_us']):>12}"
                f"{_fmt_us(row['avg_us']):>12}"
                f"{_fmt_us(row['max_us']):>12}"
                f"{row['ratio'] * 100:>7.1f}%")
        if len(rows) > max_rows:
            lines.append(f"... {len(rows) - max_rows} more rows")
    lines.append(bar)
    return "\n".join(lines)
