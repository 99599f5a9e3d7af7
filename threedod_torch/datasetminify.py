"""Mini datasets: the port's counterpart of ``tools/datasetminify.py``
(datasetminify.py of the reference repository's root, :5-78).

    python -m threedod_torch.datasetminify --src datasets/Omni3D/synth_train.json
        [--out OUT.json] [--count 10] [--category NAME] [--image-ids ID ...]

Keeps the images listed by ``--image-ids``, else the first ``--count`` ids
(sorted) of the images holding a ``--category`` annotation, else the first
``--count`` images, with their annotations; every other key of the file is
kept as it is. ``--out`` defaults to the source's name with ``_mini``. JSON
only, on the host. Prints the written path.
"""
from __future__ import annotations

import argparse
import json


def minify_dataset(src_json: str, out_json: str, count: int = 10, category: str = "", image_ids=None) -> str:
    with open(src_json) as f:
        data = json.load(f)
    if image_ids:
        keep = set(image_ids)
    elif category:
        keep = set(sorted({a["image_id"] for a in data["annotations"] if a.get("category_name") == category})[:count])
    else:
        keep = {im["id"] for im in data["images"][:count]}
    data["images"] = [im for im in data["images"] if im["id"] in keep]
    data["annotations"] = [a for a in data["annotations"] if a["image_id"] in keep]
    with open(out_json, "w") as f:
        json.dump(data, f)
    return out_json


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--count", type=int, default=10)
    ap.add_argument("--category", default="")
    ap.add_argument("--image-ids", type=int, nargs="*", default=None)
    return ap


def main(argv=None) -> str:
    args = parser().parse_args(argv)
    out = minify_dataset(args.src, args.out or args.src.replace(".json", "_mini.json"), args.count, args.category,
                         args.image_ids)
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
