"""MABO values from a proposal evaluation's results: the port's counterpart
of ``tools/mabo_plots.py`` (tools/MABO_plots.py of the reference).

    python -m threedod_torch.mabo_plots --results output/synth_boxnet/results.json
        [--out-dir output/mabo_plots]

Prints every ``MABO_<score>`` value (best IoU3D over an object's proposals,
averaged over the objects) and, where the file holds
``combinations_mean``, the 26 score-combination ablations of
``models/boxer.COMBINATION_DEFS``, best first, as the JAX tool prints them;
draws the MABO values as horizontal bars (``vis/plot.py``) into
``mabo_scores.png`` and writes them, with the sorted ablations, to
``mabo_scores.json``. Host work only. ``run(args)`` returns that JSON's
object.
"""
from __future__ import annotations

import argparse
import json
import os

from .models.boxer import COMBINATION_DEFS
from .vis.plot import Plot


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", required=True, help="json from eval_boxes MABO run")
    ap.add_argument("--out-dir", default="output/mabo_plots")
    return ap


def run(args) -> dict:
    with open(args.results) as f:
        res = json.load(f)
    os.makedirs(args.out_dir, exist_ok=True)
    mabo_keys = sorted(k for k in res if k.startswith("MABO_"))
    print("MABO (best-overlap at N proposals, mean over GTs):")
    for k in mabo_keys:
        print(f"  {k[5:]:<14} {res[k]:.4f}")
    out = {"mabo": {k[5:]: res[k] for k in mabo_keys}, "combinations": []}
    if "combinations_mean" in res:
        print("26 score-combination ablations (MABO):")
        pairs = sorted(zip(COMBINATION_DEFS, res["combinations_mean"]), key=lambda x: -x[1])
        for parts, v in pairs:
            print(f"  {'*'.join(parts):<50} {v:.4f}")
        out["combinations"] = [["*".join(parts), v] for parts, v in pairs]
    if mabo_keys:
        p = Plot(700, 500, xlabel="MABO")
        p.barh([k[5:] for k in mabo_keys], [res[k] for k in mabo_keys])
        path = os.path.join(args.out_dir, "mabo_scores.png")
        p.save(path)
        print(f"wrote {path}")
    with open(os.path.join(args.out_dir, "mabo_scores.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
