"""Colored AP result tables (counterpart of ``threedod/vis/logperf.py``).

After cubercnn/vis/logperf.py:9-120 — per-category AP tables,
analysis tables (AP3D @15/25/50, near/medium/far) and the omni summary,
rendered with simple aligned text (tabulate is unavailable; the layout
matches).
"""
from __future__ import annotations

from typing import Dict, List

GREEN = "\033[92m"
BLUE = "\033[94m"
BOLD = "\033[1m"
END = "\033[0m"


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
              for i, h in enumerate(headers)]
    def fmt(row):
        return "  ".join(str(c).ljust(w) for c, w in zip(row, widths))
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])


def print_ap_category_table(per_cat: Dict[str, float], title: str = "AP per category") -> str:
    rows = [[name, f"{ap:.2f}"] for name, ap in sorted(per_cat.items())]
    out = f"{BOLD}{title}{END}\n" + _table(["category", "AP"], rows)
    print(out)
    return out


def print_ap_analysis_table(results: Dict[str, dict]) -> str:
    """AP3D@15/25/50 + near/med/far per dataset (logperf.py:44-68)."""
    headers = ["dataset", "AP2D", "AP3D", "AP3D@15", "AP3D@25", "AP3D@50", "near", "med", "far"]
    rows = []
    for name, r in results.items():
        if not isinstance(r, dict) or "AP3D" not in r:
            continue
        rows.append([
            name,
            f"{r.get('AP2D', -1):.2f}", f"{r.get('AP3D', -1):.2f}",
            f"{r.get('AP3D@15', -1):.2f}", f"{r.get('AP3D@25', -1):.2f}",
            f"{r.get('AP3D@50', -1):.2f}",
            f"{r.get('AP3D_near', -1):.2f}", f"{r.get('AP3D_med', -1):.2f}",
            f"{r.get('AP3D_far', -1):.2f}",
        ])
    out = f"{BOLD}3D AP analysis{END}\n" + _table(headers, rows)
    print(out)
    return out


def print_omni_summary(results: Dict[str, dict]) -> str:
    headers = ["dataset", "AP2D", "AP3D"]
    rows = [
        [name, f"{r.get('AP2D', -1):.2f}", f"{r.get('AP3D', -1):.2f}"]
        for name, r in results.items()
        if isinstance(r, dict) and "AP2D" in r
    ]
    out = f"{BOLD}{GREEN}Omni3D summary{END}\n" + _table(headers, rows)
    print(out)
    return out
