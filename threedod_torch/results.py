"""Training curves from a run's ``metrics.json``: the port's counterpart of
``tools/results.py`` (results.py and VisualiseGT.py's log plots of the
reference, which read ``log.txt``; the trainers write JSON lines).

    python -m threedod_torch.results [--metrics output/metrics.json]
        [--keys total_loss lr] [--out-dir output/plots]

Each key of ``--keys``, and every ``.../AP2D`` and ``.../AP3D`` key the rows
hold (sorted), is drawn against the iteration by ``vis/plot.py`` into
``<out-dir>/<key with / as _>.png``; ``metrics.csv`` holds every row's
iteration and the keys' values, as the JAX tool writes it where matplotlib
is missing. Host work only. ``run(args)`` returns {key: (iterations,
values)}.
"""
from __future__ import annotations

import argparse
import json
import os

from .vis.plot import Plot


def load_metrics(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--metrics", default="output/metrics.json")
    ap.add_argument("--keys", nargs="*", default=["total_loss", "lr"])
    ap.add_argument("--out-dir", default="output/plots")
    return ap


def run(args) -> dict:
    rows = load_metrics(args.metrics)
    if not rows:
        print("no metrics found")
        return {}
    os.makedirs(args.out_dir, exist_ok=True)
    keys = list(args.keys) + sorted({k for r in rows for k in r if k.endswith("/AP2D") or k.endswith("/AP3D")})
    series = {}
    for key in keys:
        xs = [r["iteration"] for r in rows if key in r]
        ys = [r[key] for r in rows if key in r]
        if not xs:
            continue
        p = Plot(600, 400, title=key, xlabel="iteration", ylabel=key)
        p.line(xs, ys, (31, 119, 180))
        fname = os.path.join(args.out_dir, key.replace("/", "_") + ".png")
        p.save(fname)
        series[key] = (xs, ys)
        print(f"wrote {fname}")
    out = os.path.join(args.out_dir, "metrics.csv")
    with open(out, "w") as f:
        f.write("iteration," + ",".join(keys) + "\n")
        for r in rows:
            f.write(str(r["iteration"]) + "," + ",".join(str(r.get(k, "")) for k in keys) + "\n")
    print(f"wrote {out}")
    return series


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
