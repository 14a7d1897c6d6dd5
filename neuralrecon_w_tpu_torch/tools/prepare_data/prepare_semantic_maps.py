"""Semantic-map CLI, the port's copy of
``neuralrecon_w_tpu/tools/prepare_data/prepare_semantic_maps.py``
(reference tools/prepare_data/prepare_semantic_maps.py:1-50).

Usage:
    python -m neuralrecon_w_tpu_torch.tools.prepare_data.prepare_semantic_maps \\
        --root_dir <workspace> --backend {constant,segformer,torchvision} \\
        [--weights <local weights>] [--device cuda|cpu]

Every image of ``dense/images`` gets ``<out_path>/<name>.npz``: its (H, W)
int16 label map in ADE20K's 0-based ids (``datasets/mask_utils``), the
only contract downstream reads. The backends:

  * ``segformer``: a transformers SegFormer ADE20K checkpoint directory
    saved with ``save_pretrained`` (``config.json`` + ``model.safetensors``
    or ``pytorch_model.bin``, e.g. nvidia/segformer-b4-finetuned-ade-512-512),
    passed as --weights; its class indices are ADE20K's 0-based ids and are
    written as they are. Needs the ``transformers`` package.
  * ``torchvision``: deeplabv3-resnet101 with local weights (--weights, a
    state_dict path); its VOC labels are mapped onto the few ADE20K ids the
    pipeline masks on. Needs the ``torchvision`` package.
  * ``constant``: all-zero maps, for scenes trained without transient
    masking (RAY_MASK_LIST None). Chosen by name only.

Both networks infer on ``--device`` (default: the card). There is no
download path: the weights must be local.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

# torchvision's VOC ids -> ADE20K ids, for the classes the pipeline masks
_VOC_TO_ADE = {
    15: 12,  # person
    7: 20,   # car
    2: 127,  # bicycle
    14: 116,  # motorbike -> minibike
}
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--out_path", type=str, default="semantic_maps")
    parser.add_argument("--backend", type=str, default="constant",
                        choices=["constant", "segformer", "torchvision"])
    parser.add_argument("--weights", type=str, default=None,
                        help="local weights: a transformers SegFormer "
                             "checkpoint dir (--backend segformer) or a "
                             "torchvision deeplabv3 state_dict path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where segformer / torchvision infer: cuda or cpu")
    return parser.parse_args(argv)


def _normalised(img_np: np.ndarray, device):
    import torch

    x = torch.from_numpy(img_np.astype(np.float32).transpose(2, 0, 1) / 255.0)[None].to(device)
    mean = torch.tensor(_MEAN, device=device)[None, :, None, None]
    std = torch.tensor(_STD, device=device)[None, :, None, None]
    return (x - mean) / std


def _load_segformer(weights_dir: str, device):
    """Local-only SegFormer; returns infer(img (H, W, 3) uint8) -> (H, W) int16."""
    import torch

    try:
        from transformers import SegformerForSemanticSegmentation
    except ImportError as e:
        raise SystemExit(
            "--backend segformer needs the transformers package (not present "
            "in this environment); use --backend constant") from e
    if not weights_dir or not os.path.isdir(weights_dir):
        raise SystemExit(
            "--backend segformer needs --weights pointing at a local "
            "SegFormer checkpoint directory (config.json + "
            "model.safetensors), e.g. a save_pretrained() dump of "
            "nvidia/segformer-b4-finetuned-ade-512-512"
        )
    model = SegformerForSemanticSegmentation.from_pretrained(
        weights_dir, local_files_only=True).to(device).eval()

    def infer(img_np: np.ndarray) -> np.ndarray:
        h, w = img_np.shape[:2]
        with torch.no_grad():
            logits = model(pixel_values=_normalised(img_np, device)).logits  # (1, C, h/4, w/4)
            logits = torch.nn.functional.interpolate(
                logits, size=(h, w), mode="bilinear", align_corners=False)
            cls = logits[0].argmax(0).cpu().numpy()
        # SegFormer's ADE20K head indexes classes 0..149: mask_utils' ids, and
        # the raw mmseg ids the reference saves (prepare_semantic_maps.py:46-50)
        return cls.astype(np.int16)

    return infer


def _load_deeplab(weights: str | None, device):
    """torchvision deeplabv3-resnet101; returns infer as _load_segformer's."""
    import torch

    try:
        from torchvision.models.segmentation import deeplabv3_resnet101
    except ImportError as e:
        raise SystemExit(
            "--backend torchvision needs the torchvision package "
            "(not present in this environment); use --backend segformer "
            "with local ADE20K weights or --backend constant"
        ) from e
    model = deeplabv3_resnet101(weights=None, num_classes=21)
    if weights:
        model.load_state_dict(torch.load(weights, map_location="cpu"))
    model = model.to(device).eval()

    def infer(img_np: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            voc = model(_normalised(img_np, device))["out"][0].argmax(0).cpu().numpy()
        sem = np.zeros_like(voc, dtype=np.int16)
        for voc_id, ade_id in _VOC_TO_ADE.items():
            sem[voc == voc_id] = ade_id
        return sem

    return infer


def main(argv=None):
    args = get_opts(argv)
    img_dir = os.path.join(args.root_dir, "dense/images")
    out_dir = os.path.join(args.root_dir, args.out_path)
    os.makedirs(out_dir, exist_ok=True)

    images = sorted(glob.glob(os.path.join(img_dir, "*")))
    infer = None
    if args.backend == "segformer":
        infer = _load_segformer(args.weights, args.device)
    elif args.backend == "torchvision":
        infer = _load_deeplab(args.weights, args.device)

    from PIL import Image as PILImage

    for path in images:
        name = os.path.basename(path).split(".")[0]
        img = PILImage.open(path).convert("RGB")
        w, h = img.size
        sem = np.zeros((h, w), np.int16) if infer is None else infer(np.asarray(img))
        np.savez_compressed(os.path.join(out_dir, f"{name}.npz"), sem)
    print(f"wrote {len(images)} semantic maps to {out_dir} ({args.backend})")
    return out_dir


if __name__ == "__main__":
    main()
