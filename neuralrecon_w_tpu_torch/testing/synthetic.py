"""A synthetic COLMAP workspace around an analytic shape
(``neuralrecon_w_tpu/testing/synthetic.py``), the same files as the JAX
package writes for the same arguments: posed pinhole cameras on a ring,
images rendered by ray-shape intersection with Lambert shading, COLMAP
binary models whose 3D points sit on the surface with consistent 2D
tracks, the scene's config.yaml, the tsv split and semantic maps. The
port's tests and ``chip_smoke.py`` write their workspaces with it.
"""

from __future__ import annotations

import os

import numpy as np

from ..datasets.colmap import (
    Camera,
    Image,
    Point3D,
    rotmat2qvec,
    write_cameras_binary,
    write_images_binary,
    write_points3d_binary,
)


def sphere_sdf(pts: np.ndarray, radius: float = 1.0) -> np.ndarray:
    return np.linalg.norm(pts, axis=-1) - radius


# offsets/radii (units of the scene radius) of the non-convex "blobs"
# shape: a union of three overlapping spheres with concave creases
_BLOBS = (
    (np.array([0.0, 0.0, 0.0]), 1.0),
    (np.array([0.75, 0.0, 0.25]), 0.6),
    (np.array([-0.45, 0.55, -0.3]), 0.5),
)


def blobs_sdf(pts: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Union-of-spheres SDF (exact outside, lower bound inside creases)."""
    d = np.full(pts.shape[:-1], np.inf)
    for c, r in _BLOBS:
        d = np.minimum(d, np.linalg.norm(pts - c * radius, axis=-1) - r * radius)
    return d


def scene_sdf(pts: np.ndarray, shape: str, radius: float = 1.0) -> np.ndarray:
    return (blobs_sdf if shape == "blobs" else sphere_sdf)(pts, radius)


def sample_surface(shape: str, n: int, radius: float = 1.0, seed: int = 0
                   ) -> np.ndarray:
    """n points uniform-ish on the shape's surface (for SFM keypoints and
    GT evaluation clouds)."""
    rs = np.random.RandomState(seed)
    if shape != "blobs":
        v = rs.randn(n, 3)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return v * radius
    spheres = [(c * radius, r * radius) for c, r in _BLOBS]
    areas = np.array([r * r for _, r in spheres])
    picks = rs.choice(len(spheres), size=4 * n, p=areas / areas.sum())
    v = rs.randn(4 * n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = np.stack([spheres[i][0] + v[k] * spheres[i][1]
                    for k, i in enumerate(picks)])
    # keep only points on the union boundary (not inside another sphere)
    keep = blobs_sdf(pts, radius) > -1e-6 * radius
    pts = pts[keep]
    if len(pts) < n:  # extremely unlikely at 4x oversampling
        return np.concatenate([pts, sample_surface("sphere", n - len(pts),
                                                   radius, seed + 1)])
    return pts[:n]


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, 0.0, 1.0])):
    """COLMAP w2c (right-down-front): camera +z looks at target."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # world -> cam rows
    t = -R @ eye
    return R, t


def _render_sphere_image(K, R, t, w, h, radius, light=np.array([0.3, 0.2, 0.9])):
    """Analytic ray-traced sphere on a sky background. Returns (h, w, 3)
    uint8 and the per-pixel hit depth (along-ray, camera frame)."""
    j, i = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dirs_cam = np.stack(
        [(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1], np.ones_like(i, float)], -1
    )
    dirs_w = dirs_cam @ R  # R^T == cam->world
    o = (-R.T @ t).reshape(1, 1, 3)
    d = dirs_w / np.linalg.norm(dirs_w, axis=-1, keepdims=True)

    b = 2.0 * np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - radius**2
    disc = b * b - 4 * c
    hit = disc > 0
    t_hit = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, 0.0)
    hit &= t_hit > 0

    pts = o + d * t_hit[..., None]
    n = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-9)
    lam = np.clip(n @ (light / np.linalg.norm(light)), 0.1, 1.0)
    base = np.array([0.8, 0.45, 0.3])
    sky = np.array([0.5, 0.65, 0.9])
    img = np.where(hit[..., None], lam[..., None] * base, sky[None, None, :])
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), np.where(hit, t_hit, 0.0), hit


def _render_sdf_image(K, R, t, w, h, radius, shape,
                      light=np.array([0.3, 0.2, 0.9])):
    """Sphere-traced render of an analytic SDF shape; same contract as
    _render_sphere_image (uint8 image, along-ray depth, hit mask)."""
    j, i = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dirs_cam = np.stack(
        [(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1], np.ones_like(i, float)], -1
    )
    dirs_w = dirs_cam @ R
    o = (-R.T @ t).reshape(1, 1, 3)
    d = dirs_w / np.linalg.norm(dirs_w, axis=-1, keepdims=True)

    t_hit = np.zeros((h, w))
    for _ in range(96):
        pts = o + d * t_hit[..., None]
        dist = scene_sdf(pts, shape, radius)
        t_hit = t_hit + np.maximum(dist, 0.0) * 0.95
        t_hit = np.minimum(t_hit, 1e3)
    pts = o + d * t_hit[..., None]
    hit = (scene_sdf(pts, shape, radius) < 1e-3 * radius) & (t_hit > 1e-3)

    eps = 1e-4 * radius
    n = np.stack([
        scene_sdf(pts + np.eye(3)[k] * eps, shape, radius)
        - scene_sdf(pts - np.eye(3)[k] * eps, shape, radius)
        for k in range(3)
    ], axis=-1)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    lam = np.clip(n @ (light / np.linalg.norm(light)), 0.1, 1.0)
    base = np.array([0.8, 0.45, 0.3])
    sky = np.array([0.5, 0.65, 0.9])
    img = np.where(hit[..., None], lam[..., None] * base, sky[None, None, :])
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), np.where(hit, t_hit, 0.0), hit


def make_synthetic_scene(
    root_dir: str,
    n_images: int = 8,
    n_test: int = 2,
    img_wh: tuple = (40, 30),
    sphere_radius: float = 1.0,
    cam_dist: float = 3.0,
    n_points: int = 300,
    seed: int = 0,
    scene_name: str | None = None,
    with_semantics: bool = True,
    shape: str = "sphere",
    appearance_jitter: float = 0.0,
    transient_occluders: bool = False,
) -> dict:
    """Write a full workspace under root_dir; returns scene metadata.

    The two "in the wild" axes (the reason NeuS-W exists — reference
    lightning_modules/neuconw_system.py:74-78, 348-355):
      * ``appearance_jitter`` > 0 varies illumination per image: the
        light direction, a per-channel color gain and an exposure factor
        are each jittered per image — the photometric chaos of internet
        photo collections that the appearance embedding must absorb.
      * ``transient_occluders`` paints an opaque block of random size /
        color / position over every other TRAIN image, labeled
        ``person`` (ADE20K id 12) in its semantic map — the pedestrians
        / vehicles that RAY_MASK_LIST must keep out of the geometry.
        Occluders are view-inconsistent by construction (a different
        rectangle per image), held-out test views stay clean.
    """
    rs = np.random.RandomState(seed)
    w, h = img_wh
    os.makedirs(os.path.join(root_dir, "dense/sparse"), exist_ok=True)
    os.makedirs(os.path.join(root_dir, "dense/images"), exist_ok=True)
    if with_semantics:
        os.makedirs(os.path.join(root_dir, "semantic_maps"), exist_ok=True)
    scene_name = scene_name or os.path.basename(os.path.normpath(root_dir))

    f = 0.8 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    cameras = {1: Camera(1, "PINHOLE", w, h, np.array([f, f, w / 2, h / 2]))}

    # surface points with per-point jitter as "reconstruction error"
    pts_world = sample_surface(shape, n_points, sphere_radius, seed)
    n_points = len(pts_world)
    pt_err = np.abs(rs.randn(n_points)) * 0.5 + 0.2

    images = {}
    tracks = {pid: ([], []) for pid in range(1, n_points + 1)}
    from PIL import Image as PILImage

    names = []
    appearance_log = {}
    occluder_log = {}
    base_light = np.array([0.3, 0.2, 0.9])
    for idx in range(n_images):
        ang = 2 * np.pi * idx / n_images
        eye = np.array(
            [np.cos(ang) * cam_dist, np.sin(ang) * cam_dist, 0.6 + 0.2 * np.sin(3 * ang)]
        )
        R, t = _look_at(eye, np.zeros(3))

        rs_img = np.random.RandomState(seed * 1009 + 17 * idx + 3)
        light = base_light
        gain = np.ones(3)
        if appearance_jitter > 0:
            light = base_light + appearance_jitter * rs_img.randn(3)
            light = light / np.linalg.norm(light)
            gain = np.clip(
                (1.0 + 0.4 * appearance_jitter * rs_img.randn(3))
                * 2.0 ** (appearance_jitter * rs_img.randn()),
                0.3, 2.5,
            )
        appearance_log[idx] = {"light": light.tolist(), "gain": gain.tolist()}

        if shape == "sphere":
            img, _, hit = _render_sphere_image(K, R, t, w, h, sphere_radius, light)
        else:
            img, _, hit = _render_sdf_image(K, R, t, w, h, sphere_radius, shape, light)
        if appearance_jitter > 0:
            img = np.clip(img.astype(np.float64) * gain, 0, 255).astype(np.uint8)

        transient = np.zeros((h, w), bool)
        is_train = idx < n_images - n_test
        if transient_occluders and is_train and idx % 2 == 0:
            bw = rs_img.randint(w // 5, w // 2)
            bh = rs_img.randint(h // 4, (2 * h) // 3)
            x0 = rs_img.randint(0, w - bw)
            y0 = rs_img.randint(0, h - bh)
            transient[y0 : y0 + bh, x0 : x0 + bw] = True
            img = img.copy()
            img[transient] = rs_img.randint(0, 256, 3, np.uint8)
            occluder_log[idx] = [int(x0), int(y0), int(bw), int(bh)]

        name = f"img_{idx:03d}.jpg"
        names.append(name)
        PILImage.fromarray(img).save(
            os.path.join(root_dir, "dense/images", name), quality=95
        )
        if with_semantics:
            # pixels that miss the sphere are "sky" (ADE20K id 2) — like
            # real semantic maps, so the mask BCE carves empty space;
            # painted occluders are "person" (id 12), the canonical
            # RAY_MASK_LIST transient class
            sem = np.where(hit, 0, 2).astype(np.int16)
            sem[transient] = 12
            np.savez_compressed(
                os.path.join(root_dir, "semantic_maps", f"img_{idx:03d}.npz"), sem
            )

        # project points for keypoints/tracks
        cam_pts = (R @ pts_world.T + t[:, None]).T
        z = cam_pts[:, 2]
        uv = (K @ cam_pts.T).T
        uv = uv[:, :2] / uv[:, 2:3]
        vis = (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        # only front-facing, unoccluded points
        if shape == "sphere":
            vis &= np.sum((pts_world - eye) * pts_world, axis=-1) < 0
        else:
            eps = 1e-4 * sphere_radius
            nrm = np.stack([
                scene_sdf(pts_world + np.eye(3)[k] * eps, shape, sphere_radius)
                - scene_sdf(pts_world - np.eye(3)[k] * eps, shape, sphere_radius)
                for k in range(3)
            ], axis=-1)
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
            vis &= np.sum((pts_world - eye) * nrm, axis=-1) < 0
            # occlusion: march from the camera toward each point and
            # require the first surface hit to be at the point itself
            seg = pts_world - eye
            seg_len = np.linalg.norm(seg, axis=-1)
            d_seg = seg / np.maximum(seg_len[:, None], 1e-9)
            t_m = np.zeros(len(pts_world))
            for _ in range(96):
                p = eye[None, :] + d_seg * t_m[:, None]
                t_m = t_m + np.maximum(
                    scene_sdf(p, shape, sphere_radius), 0.0) * 0.95
                t_m = np.minimum(t_m, seg_len)
            vis &= t_m > seg_len - 1e-2 * sphere_radius
        xys, p3d_ids = [], []
        img_id = idx + 1
        for pid0 in np.nonzero(vis)[0]:
            xys.append(uv[pid0])
            p3d_ids.append(pid0 + 1)
            tracks[pid0 + 1][0].append(img_id)
            tracks[pid0 + 1][1].append(len(xys) - 1)
        images[img_id] = Image(
            img_id, rotmat2qvec(R), t, 1, name,
            np.asarray(xys).reshape(-1, 2), np.asarray(p3d_ids, np.int64),
        )

    points3d = {}
    for pid in range(1, n_points + 1):
        img_ids, p2d = tracks[pid]
        if not img_ids:
            continue
        points3d[pid] = Point3D(
            pid, pts_world[pid - 1], np.array([128, 128, 128], np.uint8),
            float(pt_err[pid - 1]), np.asarray(img_ids, np.int32),
            np.asarray(p2d, np.int32),
        )

    write_cameras_binary(cameras, os.path.join(root_dir, "dense/sparse/cameras.bin"))
    write_images_binary(images, os.path.join(root_dir, "dense/sparse/images.bin"))
    write_points3d_binary(points3d, os.path.join(root_dir, "dense/sparse/points3D.bin"))

    # tsv split: last n_test images held out
    with open(os.path.join(root_dir, f"{scene_name}.tsv"), "w") as fh:
        fh.write("filename\tid\tsplit\tdataset\n")
        for idx, name in enumerate(names):
            split = "test" if idx >= n_images - n_test else "train"
            fh.write(f"{name}\t{idx}\t{split}\t{scene_name}\n")

    # scene config.yaml (reference README.md:104-118 schema)
    import yaml

    bbx = 1.5 * sphere_radius
    scene_config = {
        "name": scene_name,
        "origin": [0.0, 0.0, 0.0],
        "radius": float(cam_dist * 1.2),
        "eval_bbx": [[-bbx, -bbx, -bbx], [bbx, bbx, bbx]],
        "eval_bbx_detail": [[-bbx / 2, -bbx / 2, -bbx / 2], [bbx / 2, bbx / 2, bbx / 2]],
        "voxel_size": float(sphere_radius / 4),
        "min_track_length": 2,
        "sfm2gt": np.eye(4).tolist(),
    }
    with open(os.path.join(root_dir, "config.yaml"), "w") as fh:
        yaml.safe_dump(scene_config, fh)

    # persist the injected corruption ground truth so post-hoc probes
    # can run from the workspace alone
    if appearance_jitter > 0 or transient_occluders:
        import json

        with open(os.path.join(root_dir, "wild_info.json"), "w") as fh:
            json.dump({"appearance": appearance_log,
                       "occluders": occluder_log,
                       "jitter": appearance_jitter, "seed": seed}, fh)

    return {
        "scene_config": scene_config,
        "sphere_radius": sphere_radius,
        "shape": shape,
        "n_points": len(points3d),
        "names": names,
        "appearance": appearance_log,
        "occluders": occluder_log,
    }
