"""AP result tables (port of the table printers of `omni3d_tpu.vis.logperf`;
reference cubercnn/vis/logperf.py:9-117).

The reference renders its tables with termcolor + tabulate (pipe/grid
formats, cyan/magenta); a small pure-Python subset reproduces the same
layouts, with ANSI colours only on a tty (NO_COLOR respected).
"""
from __future__ import annotations

import itertools
import os
import sys

_ANSI = {"cyan": "36", "magenta": "35", "red": "31", "green": "32"}


def colored(text: str, color: str | None) -> str:
    """termcolor.colored subset; plain when not a tty or NO_COLOR is set."""
    if (color is None or os.environ.get("NO_COLOR")
            or not getattr(sys.stdout, "isatty", lambda: False)()):
        return text
    code = _ANSI.get(color)
    return f"\033[{code}m{text}\033[0m" if code else text


def _cell(v) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.4f}" if v == v else "nan"
    return str(v)


def tabulate(rows, headers, tablefmt: str = "pipe") -> str:
    """tabulate subset: 'pipe' and 'grid' formats, centered headers,
    left-aligned cells (the reference's numalign='left', stralign='center'
    combination as rendered for its numeric tables)."""
    srows = [[_cell(v) for v in r] for r in rows]
    headers = [str(h) for h in headers]
    ncol = max([len(headers)] + [len(r) for r in srows]) if srows else len(headers)
    headers += [""] * (ncol - len(headers))
    srows = [r + [""] * (ncol - len(r)) for r in srows]
    widths = [max([len(headers[i])] + [len(r[i]) for r in srows] + [3])
              for i in range(ncol)]

    def line(cells, align="left"):
        out = []
        for c, w in zip(cells, widths):
            out.append(c.center(w) if align == "center" else c.ljust(w))
        return "| " + " | ".join(out) + " |"

    if tablefmt == "grid":
        hsep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        body = [hsep, line(headers, "center"),
                hsep.replace("-", "=")]
        for r in srows:
            body.append(line(r))
            body.append(hsep)
        return "\n".join(body)
    # pipe
    sep = "|" + "|".join(":" + "-" * w + ":" for w in widths) + "|"
    return "\n".join([line(headers, "center"), sep]
                     + [line(r) for r in srows])


def format_table(rows: list[list], headers: list[str]) -> str:
    """Plain left-justified columns under a dashed rule."""
    widths = [max(len(str(r[i])) for r in [headers] + rows) for i in range(len(headers))]

    def fmt(row):
        return "  ".join(str(v).ljust(w) for v, w in zip(row, widths))
    sep = "-" * (sum(widths) + 2 * (len(widths) - 1))
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])


def print_ap_category_histogram(dataset, results):
    """Reference print_ap_category_histogram (logperf.py:9-41): N_COLS=9
    multi-column (category, AP2D, AP3D) x3 pipe table, cyan."""
    num_classes = len(results)
    N_COLS = 9
    data = list(itertools.chain(*[
        [cat, out["AP2D"], out["AP3D"]] for cat, out in results.items()
    ]))
    if len(data) % N_COLS:
        data.extend([None] * (N_COLS - (len(data) % N_COLS)))
    rows = list(itertools.zip_longest(*[data[i::N_COLS] for i in range(N_COLS)]))
    table = tabulate(rows, headers=["category", "AP2D", "AP3D"] * (N_COLS // 3),
                     tablefmt="pipe")
    print(f"Performance for each of {num_classes} categories on {dataset}:\n"
          + colored(table, "cyan"))


def print_ap_analysis_histogram(results):
    """Reference print_ap_analysis_histogram (logperf.py:44-67): grid table
    of AP2D/AP3D + IoU-threshold and depth-range splits, cyan."""
    rows = [[name, m.get("iters", "-"), m.get("AP2D"), m.get("AP3D"),
             m.get("AP3D@15"), m.get("AP3D@25"), m.get("AP3D@50"),
             m.get("AP3D-N", m.get("AP3D-near")),
             m.get("AP3D-M", m.get("AP3D-med")),
             m.get("AP3D-F", m.get("AP3D-far"))]
            for name, m in results.items() if isinstance(m, dict)]
    table = tabulate(rows, headers=["Dataset", "#iters", "AP2D", "AP3D",
                                    "AP3D@15", "AP3D@25", "AP3D@50",
                                    "AP3D-N", "AP3D-M", "AP3D-F"],
                     tablefmt="grid")
    print("Per-dataset performance analysis on test set:\n"
          + colored(table, "cyan"))


def _ap_table(results):
    """Grid table of AP2D / AP3D per dataset (the dataset and Omni3D
    histograms' layout)."""
    rows = [[name, m.get("iters", "-"), m.get("AP2D"), m.get("AP3D")]
            for name, m in results.items() if isinstance(m, dict)]
    return tabulate(rows, headers=["Dataset", "#iters", "AP2D", "AP3D"], tablefmt="grid")


def print_ap_dataset_histogram(results):
    """Reference print_ap_dataset_histogram (logperf.py:70-90): AP2D/AP3D
    per dataset, grid table, cyan."""
    table = _ap_table(results)
    print("Per-dataset performance on test set:\n" + colored(table, "cyan"))


def print_ap_omni_histogram(results):
    """Reference print_ap_omni_histogram (logperf.py:93-117), magenta."""
    table = _ap_table(results)
    print("Omni3D performance on test set. The numbers below should be used "
          "to compare to other approaches on Omni3D, such as Cube R-CNN")
    print("Performance on Omni3D:\n" + colored(table, "magenta"))


def print_ap_analysis_table(results: dict, title: str = "Omni3D analysis"):
    if title:
        print(title)
    print_ap_analysis_histogram(
        {k: v for k, v in results.items() if isinstance(v, dict)})


# analysis-stat suffixes sharing the "AP{2,3}D-" prefix with per-category
# entries (size splits small/med/large; depth splits near/med/far) — no
# Omni3D category uses these names
STAT_SUFFIXES = frozenset({"small", "med", "large", "near", "far"})


def print_ap_category_table(per_cat: dict, cat_names: dict, title: str = ""):
    """Per-category AP3D ({category id: AP}) as the category histogram."""
    if title:
        print(title)
    print_ap_category_histogram(
        title or "dataset",
        {cat_names.get(cid, cid): {"AP2D": float("nan"), "AP3D": ap}
         for cid, ap in sorted(per_cat.items())})


def print_dataset_results(results: dict):
    print_ap_analysis_table(results)


def _is_per_category(metric: str) -> bool:
    for tag in ("AP2D-", "AP3D-"):
        if metric.startswith(tag):
            return metric[len(tag):] not in STAT_SUFFIXES
    return False


def print_cross_dataset_table(summary: dict, title: str = "Cross-dataset"):
    """Group `summarize_all`'s "<split>/<metric>" flat keys into one row per
    split (Concat / Omni3D / Omni3D_In / Omni3D_Out), then print BOTH
    reference tables: the full analysis histogram (IoU-threshold and
    depth-split columns) and the AP2D/AP3D Omni3D headline table
    (reference logperf.print_ap_analysis_histogram +
    print_ap_omni_histogram)."""
    grouped: dict = {}
    for k, v in summary.items():
        split, _, metric = k.partition("/")
        if _is_per_category(metric):
            continue  # per-category entries get their own table
        m = grouped.setdefault(split, {})
        m[metric.replace("AP3D-near", "AP3D-N").replace("AP3D-med", "AP3D-M")
          .replace("AP3D-far", "AP3D-F")] = v
    if title:
        print(title)
    print_ap_analysis_histogram(grouped)
    print_ap_omni_histogram(grouped)


def print_per_category_table(summary: dict, title: str = "<Concat> per-category"):
    """Per-category AP2D/AP3D columns from the overall re-accumulation
    (reference logperf.print_ap_category_histogram)."""
    cats: dict = {}
    for k, v in summary.items():
        split, _, metric = k.partition("/")
        if split != "Concat" or not _is_per_category(metric):
            continue
        for tag in ("AP2D-", "AP3D-"):
            if metric.startswith(tag):
                cats.setdefault(metric[len(tag):], {})[tag[:-1]] = v
    if not cats:
        return
    print_ap_category_histogram(
        title, {n: {"AP2D": d.get("AP2D", float("nan")),
                    "AP3D": d.get("AP3D", float("nan"))}
                for n, d in sorted(cats.items())})
