"""Phototourism workspace loading and per-image ray building, on the host
in numpy (``neuralrecon_w_tpu/datasets/phototourism.py``).

  * the workspace: ``<root>/dense/<sfm>/{cameras,images,points3D}.bin``,
    ``<root>/dense/images/*``, ``<root>/config.yaml``, ``<root>/*.tsv``
    (the split table) and ``<root>/semantic_maps/<name>.npz``; image ids
    come from images.bin, not the tsv's id column (reference
    phototourism.py:326-334);
  * near / far per image from the SFM points' depth percentiles 0.1 / 99.9
    (reference phototourism.py:427-446);
  * SFM keypoint depth and confidence rasterised per pixel (reference
    get_colmap_depth, phototourism.py:150-209);
  * near / far replaced by the SFM voxel grid's intersections, and the
    rays that miss it dropped, through the port's DDA on the device it is
    given (``ops/ray_voxel.grid_near_far``; reference near_far_voxel,
    phototourism.py:236-314);
  * depth-supervised rays oversampled to a target share (reference
    phototourism.py:659-678).

Ray record layout (12 columns with semantics, 11 without):
  [o(3) | d(3) | near | far | ts | label | depth | weight]
(reference phototourism.py:611-623).
"""

from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass

import numpy as np

from .colmap import points3d_arrays, read_cameras_binary, read_images_binary, \
    read_points3d_binary
from .rays import get_ray_directions, get_rays

# per-scene SFM source and depth oversampling the reference hardcodes
# (reference phototourism.py:82-93)
SCENE_DEFAULTS = {
    "brandenburg_gate": {"sfm_path": "../neuralsfm", "depth_percent": 0.2},
    "palacio_de_bellas_artes": {"sfm_path": "../neuralsfm", "depth_percent": 0.4},
    "lincoln_memorial": {"sfm_path": "sparse", "depth_percent": 0.0},
    "pantheon_exterior": {"sfm_path": "sparse", "depth_percent": 0.0},
}


def load_scene_config(root_dir: str) -> dict:
    """The workspace's ``config.yaml``: origin, radius, sfm2gt, eval_bbx,
    voxel_size, min_track_length."""
    import yaml

    with open(os.path.join(root_dir, "config.yaml")) as f:
        return yaml.safe_load(f)


def read_tsv(root_dir: str):
    """[(filename, split)] from the workspace's tsv."""
    paths = sorted(glob.glob(os.path.join(root_dir, "*.tsv")))
    if not paths:
        raise FileNotFoundError(f"no .tsv split table under {root_dir}")
    rows = []
    with open(paths[0]) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            if row.get("filename"):
                rows.append((row["filename"], row.get("split", "train")))
    return rows


def intrinsics_from_camera(cam, img_downscale: int) -> np.ndarray:
    """3x3 K rescaled for downsampling; the original size is twice the
    principal point (reference phototourism.py:352-391)."""
    K = np.zeros((3, 3), dtype=np.float32)
    if cam.model == "PINHOLE":
        fx, fy, cx, cy = cam.params[:4]
    elif cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        f = cam.params[0]
        fx, fy, cx, cy = f, f, cam.params[1], cam.params[2]
    else:
        raise NotImplementedError(f"unsupported camera model {cam.model}")
    img_w, img_h = int(cx * 2), int(cy * 2)
    w_, h_ = img_w // img_downscale, img_h // img_downscale
    K[0, 0] = fx * w_ / img_w
    K[1, 1] = fy * h_ / img_h
    K[0, 2] = cx * w_ / img_w
    K[1, 2] = cy * h_ / img_h
    K[2, 2] = 1
    return K


@dataclass
class SceneMeta:
    """A parsed workspace, everything but the pixels."""

    root_dir: str
    sfm_path: str
    scene_config: dict
    img_ids: list  # tsv order, resolved through images.bin
    img_ids_train: list
    img_ids_test: list
    image_paths: dict  # id -> filename
    Ks: dict  # id -> (3, 3) downscaled intrinsics
    poses: dict  # id -> (3, 4) c2w, right-up-back
    w2c: dict  # id -> (4, 4)
    nears: dict
    fars: dict
    imdata: dict  # id -> colmap Image
    points3d: dict
    img_downscale: int


def load_scene_meta(root_dir: str, img_downscale: int = 1, sfm_path: str | None = None,
                    scene_origin=None, scene_radius=None) -> SceneMeta:
    """Parse the COLMAP workspace (reference read_meta, phototourism.py:317-462)."""
    scene_config = load_scene_config(root_dir)
    scene_name = os.path.basename(os.path.normpath(root_dir))
    if sfm_path is None:
        sfm_path = SCENE_DEFAULTS.get(scene_name, {}).get("sfm_path", "sparse")

    sparse_dir = os.path.join(root_dir, "dense", sfm_path)
    imdata = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    camdata = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    points3d = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))

    img_path_to_id = {v.name: v.id for v in imdata.values()}
    img_ids, image_paths, splits = [], {}, {}
    for filename, split in read_tsv(root_dir):
        if filename not in img_path_to_id:
            continue
        id_ = img_path_to_id[filename]
        img_ids.append(id_)
        image_paths[id_] = filename
        splits[id_] = split

    Ks, poses, w2c = {}, {}, {}
    bottom = np.array([[0, 0, 0, 1.0]])
    for id_ in img_ids:
        im = imdata[id_]
        Ks[id_] = intrinsics_from_camera(camdata[im.camera_id], img_downscale)
        w2c_m = np.concatenate([np.concatenate([im.qvec2rotmat(), im.tvec.reshape(3, 1)], 1),
                                bottom], 0)
        w2c[id_] = w2c_m
        c2w = np.linalg.inv(w2c_m)[:3].copy()
        c2w[:, 1:3] *= -1  # right-down-front -> right-up-back
        poses[id_] = c2w

    xyz_world = np.array([p.xyz for p in points3d.values()])
    xyz_h = np.concatenate([xyz_world, np.ones((len(xyz_world), 1))], -1)
    nears, fars = {}, {}
    for id_ in img_ids:
        if scene_origin is not None:
            so_h = np.concatenate([np.asarray(scene_origin), np.ones(1)])
            z = (w2c[id_] @ so_h)[2]
            nears[id_] = z - scene_radius * 1.5
            fars[id_] = z + scene_radius * 1.5
        else:
            z = (xyz_h @ w2c[id_].T)[:, 2]
            z = z[z > 0]
            nears[id_] = np.percentile(z, 0.1)
            fars[id_] = np.percentile(z, 99.9)

    return SceneMeta(
        root_dir=root_dir, sfm_path=sfm_path, scene_config=scene_config, img_ids=img_ids,
        img_ids_train=[i for i in img_ids if splits[i] != "test"],
        img_ids_test=[i for i in img_ids if splits[i] == "test"],
        image_paths=image_paths, Ks=Ks, poses=poses, w2c=w2c, nears=nears, fars=fars,
        imdata=imdata, points3d=points3d, img_downscale=img_downscale,
    )


def load_image(meta: SceneMeta, id_: int) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], downscaled with LANCZOS."""
    from PIL import Image as PILImage

    img = PILImage.open(os.path.join(meta.root_dir, "dense/images",
                                     meta.image_paths[id_])).convert("RGB")
    if meta.img_downscale > 1:
        w, h = img.size
        img = img.resize((w // meta.img_downscale, h // meta.img_downscale), PILImage.LANCZOS)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_semantic_map(meta: SceneMeta, id_: int, shape_hw,
                      semantic_map_path: str = "semantic_maps") -> np.ndarray:
    """(H, W) int labels, nearest-resized to the image's shape
    (reference phototourism.py:594-609)."""
    name = meta.image_paths[id_].split(".")[0]
    arr = np.load(os.path.join(meta.root_dir, semantic_map_path, f"{name}.npz"))["arr_0"]
    return nearest_resize(arr, shape_hw)


def nearest_resize(arr: np.ndarray, shape_hw) -> np.ndarray:
    h, w = shape_hw
    src_h, src_w = arr.shape[:2]
    if (src_h, src_w) == (h, w):
        return arr
    ri = np.clip(np.round(np.arange(h) * (src_h / h)).astype(np.int64), 0, src_h - 1)
    ci = np.clip(np.round(np.arange(w) * (src_w / w)).astype(np.int64), 0, src_w - 1)
    return arr[ri][:, ci]


def sfm_depth_raster(meta: SceneMeta, id_: int, img_w: int, img_h: int):
    """Per-pixel SFM keypoint depth and confidence maps (reference
    get_colmap_depth, phototourism.py:150-209): the depth along the ray
    (z-depth times the direction's norm), weight 2 * exp(-(err /
    mean_err)^2), 0 where no keypoint lands."""
    im = meta.imdata[id_]
    xyz, err, _ = points3d_arrays(meta.points3d)

    valid = im.point3D_ids != -1
    p3d_ids = im.point3D_ids[valid]
    pix = np.round(im.xys[valid] / meta.img_downscale).astype(np.int64)
    perr = err[p3d_ids]

    inb = (pix[:, 0] >= 0) & (pix[:, 0] < img_w) & (pix[:, 1] >= 0) & (pix[:, 1] < img_h)
    pix, p3d_ids, perr = pix[inb], p3d_ids[inb], perr[inb]

    depth_map = np.zeros((img_h, img_w), np.float32)
    weight_map = np.zeros((img_h, img_w), np.float32)
    if len(p3d_ids):
        # the reference projects with the sign-flipped (right-down-front)
        # pose inverse, which is w2c
        cam = (meta.w2c[id_] @ np.concatenate([xyz[p3d_ids], np.ones((len(p3d_ids), 1))],
                                              -1).T)[:3]
        depth_map[pix[:, 1], pix[:, 0]] = cam[2]
        weight_map[pix[:, 1], pix[:, 0]] = 2.0 * np.exp(-((perr / perr.mean()) ** 2))

        K = meta.Ks[id_]
        j, i = np.meshgrid(np.arange(img_h, dtype=np.float32),
                           np.arange(img_w, dtype=np.float32), indexing="ij")
        dirs = np.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1], np.ones_like(i)], -1)
        depth_map *= np.linalg.norm(dirs, axis=-1)
    return depth_map, weight_map


def build_image_rays(meta: SceneMeta, id_: int, with_semantics: bool = True,
                     semantic_map_path: str = "semantic_maps"):
    """Every ray and rgb of one image in the record layout (reference
    phototourism.py:539-636): (rays (N, 12 | 11), rgbs (N, 3))."""
    img = load_image(meta, id_)
    img_h, img_w = img.shape[:2]
    rgbs = img.reshape(-1, 3)

    rays_o, rays_d = get_rays(get_ray_directions(img_h, img_w, meta.Ks[id_]), meta.poses[id_])
    n = len(rays_o)

    depth_map, weight_map = sfm_depth_raster(meta, id_, img_w, img_h)
    cols = [
        rays_o.astype(np.float32),
        rays_d.astype(np.float32),
        np.full((n, 1), meta.nears[id_], np.float32),
        np.full((n, 1), meta.fars[id_], np.float32),
        np.full((n, 1), float(id_), np.float32),
    ]
    if with_semantics:
        sem = load_semantic_map(meta, id_, (img_h, img_w), semantic_map_path)
        cols.append(sem.reshape(-1, 1).astype(np.float32))
    cols.append(depth_map.reshape(-1, 1))
    cols.append(weight_map.reshape(-1, 1))
    return np.concatenate(cols, axis=1), rgbs


def apply_voxel_near_far(rays: np.ndarray, rgbs: np.ndarray, meta: SceneMeta,
                         chunk: int = 262144, device=None):
    """Near / far replaced by voxel-band intersections and the rays that
    miss the SFM grid dropped (reference phototourism.py:638-657): which
    rays are kept from the expand=1 / radius=1 grid, near / far from the
    expand=2 / radius=1.5 grid. The DDA runs on ``device`` (default: the
    card)."""
    import torch

    from ..device import default_device
    from ..ops.ray_voxel import device_grid_from_host, grid_near_far
    from ..ops.voxel_grid import grid_from_sfm_points

    device = default_device(device)
    sc = meta.scene_config
    vs = float(sc["voxel_size"])
    tight = grid_from_sfm_points(sc, meta.points3d, sc["min_track_length"], vs, expand=1,
                                 radius=1.0)
    wide = grid_from_sfm_points(sc, meta.points3d, sc["min_track_length"], vs, expand=2,
                                radius=1.5)
    d_tight = device_grid_from_host(tight, device)
    d_wide = device_grid_from_host(wide, device)

    valid_all, near_all, far_all = [], [], []
    with torch.no_grad():
        for i in range(0, len(rays), chunk):
            o = torch.from_numpy(np.ascontiguousarray(rays[i:i + chunk, 0:3])).to(device)
            d = torch.from_numpy(np.ascontiguousarray(rays[i:i + chunk, 3:6])).to(device)
            _, _, v1 = grid_near_far(d_tight, tight.level, o, d)
            nr, fr, _ = grid_near_far(d_wide, wide.level, o, d)
            valid_all.append(v1.cpu().numpy())
            near_all.append(nr.cpu().numpy())
            far_all.append(fr.cpu().numpy() + vs)
    valid = np.concatenate(valid_all)
    rays = rays.copy()
    rays[:, 6] = np.concatenate(near_all)
    rays[:, 7] = np.concatenate(far_all)
    return rays[valid], rgbs[valid]


def oversample_depth_rays(rays, rgbs, depth_percent: float, rng: np.random.RandomState):
    """The ray set padded with copies of depth-supervised rays until their
    share reaches ``depth_percent``, then shuffled (reference
    phototourism.py:659-678)."""
    if depth_percent <= 0:
        return rays, rgbs
    valid = rays[:, -2] > 0
    n_valid = int(valid.sum())
    n = len(rays)
    if n_valid == 0:
        return rays, rgbs
    pad = int(np.ceil((depth_percent * n - n_valid) / (1.0 - depth_percent)))
    if pad <= 0:
        return rays, rgbs
    pad_ind = rng.randint(0, n_valid, size=pad)
    perm = rng.permutation(n + pad)
    rays = np.concatenate([rays, rays[valid][pad_ind]], axis=0)[perm]
    rgbs = np.concatenate([rgbs, rgbs[valid][pad_ind]], axis=0)[perm]
    return rays, rgbs
