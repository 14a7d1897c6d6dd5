"""View selection and transient filtering for the split table, the port's
copy of ``neuralrecon_w_tpu/tools/prepare_data/filters.py`` (reference
tools/prepare_data/dataset_filter_utils.py:98-205):

  * ROI selection: the share of a view's rays that pass within the scene
    sphere (perpendicular distance below the radius, and the camera inside
    the sphere or looking toward it), on a strided pixel grid, in numpy on
    the host (a few thousand rays a view);
  * transient filtering: views whose static share (by their ADE20K
    semantic map) is at most the threshold are dropped;
  * NIMA aesthetic scoring, optional (the reference ships it disabled,
    prepare_data_split.py:41), on the port's own VGG16 trunk
    (``training/lpips.vgg16_features``), so it needs no torchvision.
"""

from __future__ import annotations

import os

import numpy as np

from ...datasets.colmap import read_cameras_binary, read_images_binary
from ...datasets.mask_utils import get_label_id_mapping
from ...datasets.phototourism import intrinsics_from_camera
from ...datasets.rays import get_ray_directions, get_rays

DEFAULT_TRANSIENT_OBJECTS = ["person", "car", "bicycle", "minibike", "tree"]


def roi_percent(rays_o: np.ndarray, rays_d: np.ndarray, origin, radius: float) -> float:
    """Share of rays that meet the scene sphere
    (reference dataset_filter_utils.py:170-181)."""
    origin = np.asarray(origin, np.float64)
    cam2orig = origin - rays_o
    dot = np.sum(cam2orig * rays_d, axis=-1, keepdims=True)
    proj = dot * rays_d
    dist_ray = np.linalg.norm(cam2orig - proj, axis=-1)
    dist_cam = np.linalg.norm(cam2orig, axis=-1)
    in_roi = ((radius > dist_cam) | (dot[:, 0] > 0)) & (dist_ray < radius)
    return float(np.count_nonzero(in_roi) / len(in_roi))


def view_selection(
    root_dir: str,
    scene_origin,
    scene_radius: float,
    roi_threshold: float = 0.5,
    min_observation: int = -1,
    subsample: int = 8,
) -> list:
    """Sorted names of the views whose ROI share reaches the threshold
    (reference view_selection, dataset_filter_utils.py:98-185). The share
    does not depend on the resolution, so it is taken on every
    ``subsample``-th pixel."""
    sparse = os.path.join(root_dir, "dense/sparse")
    imdata = read_images_binary(os.path.join(sparse, "images.bin"))
    camdata = read_cameras_binary(os.path.join(sparse, "cameras.bin"))

    keep = []
    for im in imdata.values():
        if min_observation > 0 and len(im.point3D_ids[im.point3D_ids != -1]) < min_observation:
            continue
        K = intrinsics_from_camera(camdata[im.camera_id], 1)
        h, w = int(K[1, 2] * 2), int(K[0, 2] * 2)
        Ks = K.copy()
        Ks[:2] /= subsample
        dirs = get_ray_directions(max(h // subsample, 2), max(w // subsample, 2), Ks)
        R = im.qvec2rotmat()
        t = im.tvec.reshape(3, 1)
        c2w = np.linalg.inv(
            np.concatenate([np.concatenate([R, t], 1), [[0, 0, 0, 1]]], 0)
        )[:3]
        c2w = c2w.copy()
        c2w[:, 1:3] *= -1
        rays_o, rays_d = get_rays(dirs, c2w)
        if roi_percent(rays_o, rays_d, scene_origin, scene_radius) >= roi_threshold:
            keep.append(im.name)
    return sorted(keep)


def filter_transient(
    root_dir: str,
    image_names: list,
    semantic_map_path: str = "semantic_maps",
    transient_objects: list | None = None,
    static_threshold: float = 0.6,
) -> list:
    """Drop the views dominated by transient classes (reference
    filter_image_based_on_transient_percent, dataset_filter_utils.py:186-205);
    a view without a semantic map is kept."""
    transient_objects = transient_objects or DEFAULT_TRANSIENT_OBJECTS
    lid = get_label_id_mapping()
    ids = [lid[name] for name in transient_objects]
    keep = []
    for name in image_names:
        path = os.path.join(root_dir, semantic_map_path, f"{name.split('.')[0]}.npz")
        if not os.path.exists(path):
            keep.append(name)
            continue
        sem = np.load(path)["arr_0"]
        static = np.ones(sem.shape, bool)
        for i in ids:
            static[sem == i] = False
        if static.mean() > static_threshold:
            keep.append(name)
    return keep


def nima_model(num_classes: int = 10):
    """NIMA over VGG16 (reference NIMA, dataset_filter_utils.py:19-40):
    ``features`` at torchvision's module indices, then ``classifier`` =
    ReLU, Dropout(0.75), Linear(25088, 10), Softmax; a NIMA state dict
    (``features.*``, ``classifier.2.*``) loads with strict=True."""
    from torch import nn

    from ...training.lpips import vgg16_features

    class NIMA(nn.Module):
        def __init__(self):
            super().__init__()
            self.features = vgg16_features()
            self.classifier = nn.Sequential(
                nn.ReLU(), nn.Dropout(p=0.75), nn.Linear(25088, num_classes),
                nn.Softmax(dim=1))

        def forward(self, x):
            return self.classifier(self.features(x).flatten(1))

    return NIMA()


def nima_filter(root_dir: str, image_names: list, ckpt_path: str,
                threshold: float = 4.0, batch: int = 16, device=None) -> list:
    """NIMA aesthetic filter (reference NIMA_filter,
    dataset_filter_utils.py:41-96): keeps the views whose mean predicted
    score (1-10) exceeds ``threshold``. ``ckpt_path``: a NIMA state dict
    (or ``{"model": state_dict}``) from local storage. Runs on ``device``
    (default: the card)."""
    import torch
    from PIL import Image as PILImage

    from ...device import default_device

    device = default_device(device)
    model = nima_model()
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model.load_state_dict(state.get("model", state))
    model = model.to(device).eval()

    mean = torch.tensor([0.485, 0.456, 0.406], device=device)[None, :, None, None]
    std = torch.tensor([0.229, 0.224, 0.225], device=device)[None, :, None, None]
    grades = torch.arange(1, 11, dtype=torch.float32, device=device)
    scores = {}
    with torch.no_grad():
        for i in range(0, len(image_names), batch):
            names = image_names[i:i + batch]
            x = np.stack([np.asarray(PILImage.open(os.path.join(root_dir, "dense/images", n))
                                     .convert("RGB").resize((224, 224)), np.float32)
                          for n in names]).transpose(0, 3, 1, 2) / 255.0
            p = model((torch.from_numpy(x).to(device) - mean) / std)
            scores.update(zip(names, (p * grades).sum(dim=1).tolist()))
    return [n for n in image_names if scores[n] > threshold]


def write_split_tsv(root_dir: str, image_names: list, num_test: int = 10,
                    seed: int = 0) -> str:
    """Write the <scene>.tsv split table: the first num_test views of a
    seeded shuffle are 'test' (reference prepare_data_split.py:53-62; the
    id column is a running index, the loaders take ids from images.bin)."""
    scene = os.path.basename(os.path.normpath(root_dir))
    if num_test >= len(image_names):
        raise ValueError(
            f"num_test={num_test} but only {len(image_names)} images passed "
            "filtering — every image would land in the test split"
        )
    names = list(np.random.RandomState(seed).permutation(image_names))
    path = os.path.join(root_dir, f"{scene}.tsv")
    with open(path, "w") as f:
        f.write("filename\tid\tsplit\tdataset\n")
        for i, name in enumerate(names):
            split = "test" if i < num_test else "train"
            f.write(f"{name}\t{i}\t{split}\t{scene}\n")
    return path
