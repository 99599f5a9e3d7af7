"""GroundingDINO inference on a CUDA device (the detector that
``tools/generate_ground_segmentations.py`` of the JAX package runs to find
the "ground" box of each image).

    python -m threedod_torch.gdino_infer [--image-size 800]
        [--prompt-token-ids 101,2598,1012,102] [--weights model.pt]
        [--images batch.npy] [--device cuda]

The model is the tool's: Swin-T and BERT-base, 6 enhancer and 6 decoder
layers, 900 queries, bf16. ``--weights`` is a port state dict saved with
``torch.save`` (official checkpoint names; ``utils/convert_weights.py::
gdino_from_jax_variables`` makes one from JAX params); without it the weights
are seeded (``build_groundingdino``). ``--images`` is a float32 (B, H, W, 3)
array of RGB images already resized and normalised with the ImageNet mean and
std; without it one seeded normal image of ``--image-size`` squared is used.
The prompt's token ids (bert-base-uncased; "ground." by default) are taken
with a full mask, as the tool passes them. Every deformable attention runs
kernel K3: 12 launches a forward. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .models.gdino.model import GroundingDINO, best_box_for_prompt, build_groundingdino
from .ops import ms_deform

PROMPT_TOKEN_IDS = "101,2598,1012,102"  # [CLS] ground . [SEP]


def load_model(device: torch.device, state_dict=None, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
               **config) -> GroundingDINO:
    """The seeded model, or ``state_dict`` loaded strictly, on ``device``."""
    model = build_groundingdino(dtype=dtype, seed=seed, **config)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.eval().to(device)


def random_images(batch: int, size: int, seed: int = 0) -> np.ndarray:
    """Seeded stand-ins for normalised images, float32 (B, size, size, 3)."""
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)


def predict(model: GroundingDINO, images: np.ndarray, token_ids, device: torch.device):
    """float32 (B, H, W, 3) normalised images and one prompt's token ids ->
    (logits (B, Q, Lt), boxes (B, Q, 4) cxcywh, stage outputs) on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(device)
    ids = torch.as_tensor(token_ids, dtype=torch.long, device=device).reshape(1, -1).expand(x.shape[0], -1)
    with torch.inference_mode():
        return model(x, ids, torch.ones_like(ids, dtype=torch.bool))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image-size", type=int, default=800)
    ap.add_argument("--prompt-token-ids", default=PROMPT_TOKEN_IDS)
    ap.add_argument("--weights", default="")
    ap.add_argument("--images", default="", help="float32 (B, H, W, 3) .npy, resized and normalised")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.gdino_infer runs on a CUDA device; '{args.device}' is not available")
    sd = torch.load(args.weights, map_location="cpu", weights_only=True) if args.weights else None
    images = np.load(args.images) if args.images else random_images(1, args.image_size)
    ids = [int(t) for t in args.prompt_token_ids.split(",")]
    model = load_model(device, sd)
    before = ms_deform.LAUNCHES
    logits, boxes, _ = predict(model, images, ids, device)
    hw = torch.tensor([images.shape[1:3]] * images.shape[0], device=device)
    xyxy, score = best_box_for_prompt(logits.float(), boxes, hw)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device),
        "logits_shape": list(logits.shape),
        "boxes_shape": list(boxes.shape),
        "best_box_xyxy": xyxy[0].tolist(),
        "best_score": float(score[0]),
        "finite": bool(torch.isfinite(logits.float()).all() and torch.isfinite(boxes).all()),  # a full mask
        "ms_deform_launches": ms_deform.LAUNCHES - before,
    }))


if __name__ == "__main__":
    main()
