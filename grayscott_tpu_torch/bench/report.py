"""Benchmark report generation: the port's copy of
``grayscott_tpu/bench/report.py``, unchanged but for this docstring.

Sweep JSON (``harness.sweep --output``) -> markdown/HTML tables and SVG
throughput plots: a table of throughputs with per-row deltas against a
baseline sweep, a dispersion column (median ± MAD from the per-rep
samples, ``bench/stats.py``), and an SVG throughput-vs-domain-size plot
per backend with CI95 bands.

Regression checking is gated on CONFIDENCE-INTERVAL OVERLAP, not point
deltas: a delta whose CI95s overlap renders as within-noise ("~") and
never fails the ``gate`` check.

Rows are keyed on (backend, workload, shape, steps, boundary, dtype) so
results from mixed sweeps line up; baseline rows with no counterpart are
listed as "gone", new rows carry no delta.
"""

from __future__ import annotations

import html as _html
import json
from typing import Iterable, List, Mapping, Tuple

from . import stats as _stats


def load_results(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a JSON list of sweep results")
    return data


def row_key(r: Mapping) -> Tuple:
    return (
        r.get("backend"), r.get("workload", "compute"),
        tuple(r.get("shape", ())), r.get("steps"),
        r.get("boundary", ""), r.get("dtype", "") or "",
    )


def _fmt_shape(shape) -> str:
    return "x".join(str(s) for s in shape)


def build_rows(
    results: Iterable[Mapping], baseline: Iterable[Mapping] | None = None
) -> List[dict]:
    """Joined rows: each current result plus its baseline delta (%).

    When BOTH sides carry sample statistics, the delta is additionally
    classified by CI95 overlap: ``within_noise=True`` means the
    difference is not statistically resolvable and must not drive a
    decision (``significant`` is the negation, only present when the
    classification was possible)."""
    base = {row_key(r): r for r in (baseline or [])}
    rows = []
    for r in results:
        k = row_key(r)
        cur = float(r["gcells_per_sec"])
        entry = {
            "backend": k[0], "workload": k[1],
            "shape": _fmt_shape(k[2]), "steps": k[3],
            "boundary": k[4], "dtype": k[5] or "float32",
            "gcells_per_sec": cur,
        }
        st = r.get("stats") or {}
        if st:
            entry["median"] = st.get("median")
            entry["mad"] = st.get("mad")
            entry["ci95"] = st.get("ci95")
        old = base.pop(k, None)
        if old is not None:
            prev = float(old["gcells_per_sec"])
            entry["baseline"] = prev
            entry["delta_pct"] = (cur / prev - 1.0) * 100.0 if prev else 0.0
            ost = old.get("stats") or {}
            if st.get("ci95") and ost.get("ci95"):
                overlap = _stats.intervals_overlap(st["ci95"], ost["ci95"])
                entry["within_noise"] = overlap
                entry["significant"] = not overlap
                if st.get("median") and ost.get("median"):
                    # the CI verdict describes the MEDIANS: the delta
                    # must be the median delta too, or a best-of delta
                    # can carry the opposite sign of the significance
                    # label it is printed next to
                    entry["delta_pct"] = (
                        st["median"] / ost["median"] - 1.0) * 100.0
        rows.append(entry)
    for k, old in base.items():
        rows.append({
            "backend": k[0], "workload": k[1], "shape": _fmt_shape(k[2]),
            "steps": k[3], "boundary": k[4], "dtype": k[5] or "float32",
            "gcells_per_sec": None,
            "baseline": float(old["gcells_per_sec"]),
        })
    return rows


def gate(rows: List[dict]) -> List[dict]:
    """Significant regressions only: matched rows whose rate dropped AND
    whose CI95s do not overlap the baseline's. The CI-overlap criterion
    is the whole point — a -3% point delta inside overlapping CIs is
    measurement noise, not a regression (criterion reasons the same way
    about its sampled estimates)."""
    return [r for r in rows
            if r.get("significant") and r.get("delta_pct", 0.0) < 0.0]


_COLS = ("backend", "workload", "shape", "steps", "boundary", "dtype")


def _cells(row, with_delta: bool, with_stats: bool) -> List[str]:
    cur = row["gcells_per_sec"]
    cells = [str(row[c]) for c in _COLS]
    cells.append("gone" if cur is None else f"{cur:.2f}")
    if with_stats:
        if row.get("median") is not None:
            cells.append(f"{row['median']:.2f} ± {row.get('mad', 0.0):.2f}")
        else:
            cells.append("")
    if with_delta:
        if "delta_pct" in row:
            d = f"{row['delta_pct']:+.1f}%"
            if row.get("within_noise"):
                d += " ~"  # CIs overlap: within measurement noise
            cells.append(d)
        elif cur is None:
            cells.append(f"was {row['baseline']:.2f}")
        else:
            cells.append("new")
    return cells


def _headers(with_delta: bool, with_stats: bool) -> List[str]:
    h = list(_COLS) + ["Gcell/s"]
    if with_stats:
        h.append("median ± MAD")
    if with_delta:
        h.append("vs baseline")
    return h


def render_markdown(rows: List[dict], title: str = "Benchmark report") -> str:
    with_delta = any("baseline" in r for r in rows)
    with_stats = any(r.get("median") is not None for r in rows)
    header = _headers(with_delta, with_stats)
    lines = [f"# {title}", ""]
    lines.append("| " + " | ".join(header) + " |")
    lines.append("|" + "---|" * len(header))
    for row in rows:
        lines.append(
            "| " + " | ".join(_cells(row, with_delta, with_stats)) + " |")
    if with_delta:
        deltas = [r["delta_pct"] for r in rows if "delta_pct" in r]
        if deltas:
            lines += ["", f"Mean delta: {sum(deltas) / len(deltas):+.1f}% "
                      f"over {len(deltas)} matched rows."]
        noisy = sum(1 for r in rows if r.get("within_noise"))
        sig = [r for r in rows if r.get("significant")]
        if noisy or sig:
            lines.append(
                f"CI95 classification: {noisy} matched rows within noise "
                f"(marked ~), {len(sig)} significant changes, "
                f"{len(gate(rows))} significant regressions.")
    return "\n".join(lines) + "\n"


def render_html(rows: List[dict], title: str = "Benchmark report") -> str:
    with_delta = any("baseline" in r for r in rows)
    with_stats = any(r.get("median") is not None for r in rows)
    header = _headers(with_delta, with_stats)
    out = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(title)}</title><style>",
        "body{font:14px sans-serif;margin:2em}",
        "table{border-collapse:collapse}",
        "td,th{border:1px solid #999;padding:.3em .6em;text-align:right}",
        "td:first-child,th:first-child{text-align:left}",
        ".neg{color:#b00}.pos{color:#070}.noise{color:#52514e}",
        "</style></head><body>",
        f"<h1>{_html.escape(title)}</h1>",
    ]
    svg = render_svg(rows, title="")
    if svg:
        out.append(svg)
    out.append("<table><tr>")
    out += [f"<th>{_html.escape(h)}</th>" for h in header]
    out.append("</tr>")
    for row in rows:
        out.append("<tr>")
        for cell in _cells(row, with_delta, with_stats):
            cls = ""
            if cell.endswith("~"):
                cls = " class='noise'"  # within CI noise: no verdict color
            elif cell.endswith("%"):
                cls = " class='neg'" if cell.startswith("-") else \
                    " class='pos'"
            out.append(f"<td{cls}>{_html.escape(cell)}</td>")
        out.append("</tr>")
    out.append("</table></body></html>")
    return "".join(out)


#: Categorical series colors (fixed assignment by ladder position, never
#: cycled): the validated default palette's light-mode order — adjacent
#: pairs pass CVD dE >= 8 and normal-vision dE >= 15; the full data
#: table always accompanies the plot (relief rule for the low-contrast
#: slots).
_SERIES_COLORS = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                  "#e87ba4", "#008300", "#4a3aa7", "#e34948")

#: Canonical backend order = the performance ladder; a backend keeps its
#: color across reports regardless of which subset was swept.
_LADDER = ("naive", "regular", "conv", "fused", "pallas", "sharded")


def _series_color(backend: str, seen_extra: List[str]) -> str:
    if backend in _LADDER:
        return _SERIES_COLORS[_LADDER.index(backend) % len(_SERIES_COLORS)]
    if backend not in seen_extra:
        seen_extra.append(backend)
    idx = len(_LADDER) + seen_extra.index(backend)
    return _SERIES_COLORS[idx % len(_SERIES_COLORS)]


def _fmt_cells_count(n: float) -> str:
    for div, suf in ((1 << 30, "G"), (1 << 20, "M"), (1 << 10, "K")):
        if n >= div:
            v = n / div
            return f"{v:.0f}{suf}" if v >= 10 or v == int(v) else f"{v:.1f}{suf}"
    return f"{n:.0f}"


def render_svg(rows: List[dict], title: str = "Throughput vs size") -> str:
    """Throughput-vs-domain-size line plot, one series per (backend,
    workload, dtype, boundary), with CI95 bands where sample statistics
    exist (the criterion-plots analog). Per shape the deepest step batch
    is plotted (most amortized = the steady-state rate). Returns '' when
    fewer than two distinct sizes exist (a one-point plot says nothing a
    table doesn't)."""
    import math

    # series -> {cells -> row at max steps}
    series: dict[tuple, dict[float, dict]] = {}
    for r in rows:
        if r.get("gcells_per_sec") is None:
            continue
        rr, _, cc = r["shape"].partition("x")
        try:
            cells = float(rr) * float(cc)
        except ValueError:
            continue
        skey = (r["backend"], r["workload"], r["dtype"], r["boundary"])
        cur = series.setdefault(skey, {})
        prev = cur.get(cells)
        if prev is None or (r["steps"] or 0) > (prev["steps"] or 0):
            cur[cells] = r
    series = {k: v for k, v in series.items() if len(v) >= 2}
    if not series:
        return ""
    all_cells = sorted({c for v in series.values() for c in v})
    ymax = max(
        max(r.get("ci95", [0, r["gcells_per_sec"]])[1]
            if r.get("ci95") else r["gcells_per_sec"] for r in v.values())
        for v in series.values())
    ymax = ymax * 1.08 or 1.0
    W, H = 760, 420
    ML, MR, MT, MB = 64, 16, 34, 46
    pw, ph = W - ML - MR, H - MT - MB
    lx0, lx1 = math.log2(all_cells[0]), math.log2(all_cells[-1])

    def X(c):
        return ML + (math.log2(c) - lx0) / max(lx1 - lx0, 1e-9) * pw

    def Y(v):
        return MT + ph - v / ymax * ph

    o = [f"<svg xmlns='http://www.w3.org/2000/svg' width='{W}' "
         f"height='{H}' viewBox='0 0 {W} {H}' role='img' "
         f"aria-label='Throughput vs domain size'>",
         f"<rect width='{W}' height='{H}' fill='#fcfcfb'/>"]
    if title:
        o.append(f"<text x='{ML}' y='20' font-family='sans-serif' "
                 f"font-size='14' font-weight='bold' fill='#0b0b0b'>"
                 f"{_html.escape(title)}</text>")
    # recessive grid + y ticks (5 round steps)
    step = ymax / 5
    mag = 10 ** math.floor(math.log10(step)) if step > 0 else 1
    step = math.ceil(step / mag) * mag
    v = 0.0
    while v <= ymax + 1e-9:
        y = Y(v)
        o.append(f"<line x1='{ML}' y1='{y:.1f}' x2='{W - MR}' y2='{y:.1f}' "
                 "stroke='#e7e6e4' stroke-width='1'/>")
        o.append(f"<text x='{ML - 8}' y='{y + 4:.1f}' text-anchor='end' "
                 f"font-family='sans-serif' font-size='11' fill='#52514e'>"
                 f"{v:g}</text>")
        v += step
    # x ticks on the swept sizes (thinned to <= 10 labels)
    thin = max(1, len(all_cells) // 10)
    for i, c in enumerate(all_cells):
        if i % thin:
            continue
        x = X(c)
        o.append(f"<line x1='{x:.1f}' y1='{MT + ph}' x2='{x:.1f}' "
                 f"y2='{MT + ph + 4}' stroke='#52514e' stroke-width='1'/>")
        o.append(f"<text x='{x:.1f}' y='{MT + ph + 18}' text-anchor='middle' "
                 f"font-family='sans-serif' font-size='11' fill='#52514e'>"
                 f"{_fmt_cells_count(c)}</text>")
    o.append(f"<text x='{ML + pw / 2:.0f}' y='{H - 8}' text-anchor='middle' "
             "font-family='sans-serif' font-size='11' fill='#52514e'>"
             "domain cells</text>")
    o.append(f"<text x='14' y='{MT + ph / 2:.0f}' text-anchor='middle' "
             "font-family='sans-serif' font-size='11' fill='#52514e' "
             f"transform='rotate(-90 14 {MT + ph / 2:.0f})'>Gcell/s</text>")
    seen_extra: List[str] = []
    legend = []
    for skey in sorted(series, key=lambda k: (
            _LADDER.index(k[0]) if k[0] in _LADDER else 99, k)):
        pts = sorted(series[skey].items())
        color = _series_color(skey[0], seen_extra)
        band_hi = [(X(c), Y(r["ci95"][1])) for c, r in pts if r.get("ci95")]
        band_lo = [(X(c), Y(r["ci95"][0])) for c, r in pts if r.get("ci95")]
        if len(band_hi) >= 2:
            path = "M" + " L".join(f"{x:.1f},{y:.1f}" for x, y in band_hi) \
                + " L" + " L".join(f"{x:.1f},{y:.1f}"
                                   for x, y in reversed(band_lo)) + " Z"
            o.append(f"<path d='{path}' fill='{color}' fill-opacity='0.14' "
                     "stroke='none'/>")
        line = " L".join(
            f"{X(c):.1f},{Y(r.get('median') or r['gcells_per_sec']):.1f}"
            for c, r in pts)
        o.append(f"<path d='M{line}' fill='none' stroke='{color}' "
                 "stroke-width='2'/>")
        for c, r in pts:
            yv = r.get("median") or r["gcells_per_sec"]
            o.append(f"<circle cx='{X(c):.1f}' cy='{Y(yv):.1f}' r='4' "
                     f"fill='{color}' stroke='#fcfcfb' stroke-width='2'>"
                     f"<title>{_html.escape(skey[0])} {r['shape']} "
                     f"steps={r['steps']}: {yv:.2f} Gcell/s</title></circle>")
        label = skey[0] + (f" ({skey[2]})" if skey[2] != "float32" else "")
        if skey[1] != "compute":
            label += f" [{skey[1]}]"
        legend.append((label, color))
    ly = MT + 4
    for label, color in legend:
        o.append(f"<rect x='{W - MR - 150}' y='{ly}' width='12' height='12' "
                 f"rx='2' fill='{color}'/>")
        o.append(f"<text x='{W - MR - 133}' y='{ly + 10}' "
                 "font-family='sans-serif' font-size='11' fill='#0b0b0b'>"
                 f"{_html.escape(label)}</text>")
        ly += 17
    o.append("</svg>")
    return "".join(o)


def report(
    results_path: str, baseline_path: str | None = None,
    fmt: str = "markdown", title: str | None = None,
) -> str:
    results = load_results(results_path)
    baseline = load_results(baseline_path) if baseline_path else None
    rows = build_rows(results, baseline)
    if title is None:
        title = f"Benchmark report — {results_path}" + (
            f" vs {baseline_path}" if baseline_path else ""
        )
    if fmt in ("markdown", "md"):
        return render_markdown(rows, title)
    if fmt == "html":
        return render_html(rows, title)
    if fmt == "svg":
        return render_svg(rows, title)
    raise ValueError(f"unknown report format {fmt!r}")
