"""PyTorch port, the data-preparation tools: PFM I/O, pre_process, the view
selection and transient filters, the split table, the semantic maps and
the NIMA filter, each against the JAX package's on the same seeded inputs
(the NIMA filter against an independent plain-torch forward)."""

import os
import shutil

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.datasets import mask_utils as jax_mask_utils  # noqa: E402
from neuralrecon_w_tpu.tools import pre_process as jax_pre  # noqa: E402
from neuralrecon_w_tpu.tools.prepare_data import filters as jax_filters  # noqa: E402
from neuralrecon_w_tpu.tools.prepare_data import prepare_data_split as jax_split  # noqa: E402
from neuralrecon_w_tpu.tools.prepare_data import prepare_semantic_maps as jax_sem  # noqa: E402
from neuralrecon_w_tpu.utils import pfm as jax_pfm  # noqa: E402
from neuralrecon_w_tpu_torch.datasets import colmap  # noqa: E402
from neuralrecon_w_tpu_torch.datasets import mask_utils  # noqa: E402
from neuralrecon_w_tpu_torch.datasets.mask_utils import get_label_id_mapping  # noqa: E402
from neuralrecon_w_tpu_torch.testing import make_synthetic_scene  # noqa: E402
from neuralrecon_w_tpu_torch.tools import pre_process  # noqa: E402
from neuralrecon_w_tpu_torch.tools.prepare_data import (  # noqa: E402
    filters,
    prepare_data_split,
    prepare_semantic_maps,
)
from neuralrecon_w_tpu_torch.utils import pfm  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ATOL = 1e-12


def chip_smoke():
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    return cs


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """tests/test_cli_tools.py's workspace (6 views of 40x30) as a raw
    COLMAP layout, one view turned away from the scene."""
    base = tmp_path_factory.mktemp("prep")
    ws = str(base / "sphere_scene")
    os.makedirs(ws)
    make_synthetic_scene(ws, n_images=6, n_test=1, img_wh=(40, 30), n_points=250)
    src = str(base / "raw_scene")
    turned = chip_smoke().write_raw_layout(ws, src, turn_every=4)
    return ws, src, turned


def records(path):
    return [(im.id, im.qvec.tolist(), im.tvec.tolist(), im.camera_id, im.name, im.xys.tolist(),
             im.point3D_ids.tolist()) for im in colmap.read_images_binary(path).values()]


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_configs_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            np.testing.assert_allclose(np.asarray(b[k], np.float64), np.asarray(a[k], np.float64),
                                       rtol=0, atol=CONFIG_ATOL, err_msg=k)


def test_label_lookups_match_jax():
    """The id -> name table and the names -> ids lookup the filters use."""
    assert mask_utils.get_id_label_mapping() == jax_mask_utils.get_id_label_mapping()
    names = ["person", "car", "bicycle", "minibike", "tree", "sky"]
    assert mask_utils.get_class_ids_from_labels(names) == \
        jax_mask_utils.get_class_ids_from_labels(names) == [12, 20, 127, 116, 4, 2]
    with pytest.raises(KeyError):
        mask_utils.get_class_ids_from_labels(["no such class"])


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 3)], ids=["grey", "colour"])
def test_pfm_round_trips_with_jax(tmp_path, shape):
    """A map written by either package reads back exactly through the other."""
    img = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jax_pfm.save_pfm(str(tmp_path / "j.pfm"), img, scale=2.5)
    pfm.save_pfm(str(tmp_path / "p.pfm"), img, scale=2.5)
    assert (tmp_path / "j.pfm").read_bytes() == (tmp_path / "p.pfm").read_bytes()
    for got, scale in (pfm.read_pfm(str(tmp_path / "j.pfm")),
                       jax_pfm.read_pfm(str(tmp_path / "p.pfm"))):
        assert scale == 2.5 and got.dtype == np.float32
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("split", ["none", "a#b"])
def test_pre_process_matches_jax(raw, tmp_path, split):
    """pre_process.main from both packages on the same raw layout (no colmap
    binary here: the copy branch): equal file lists, config.yaml dicts within
    1e-12, equal images.bin records; with --split "a#b" two workspaces from
    two image folders, their names prefixed."""
    _, src, _ = raw
    if split == "a#b":
        src = str(tmp_path / "grouped")
        shutil.copytree(raw[1], src)
        ims = colmap.read_images_binary(os.path.join(src, "sparse/0/images.bin"))
        for k, im in enumerate(sorted(ims.values(), key=lambda m: m.id)):
            group = "ab"[k % 2]
            os.makedirs(os.path.join(src, "images", group), exist_ok=True)
            os.rename(os.path.join(src, "images", im.name),
                      os.path.join(src, "images", group, im.name))
            im.name = f"{group}/{im.name}"
        colmap.write_images_binary(ims, os.path.join(src, "sparse/0/images.bin"))
    outs = {}
    for name, main in (("jax", jax_pre.main), ("port", pre_process.main)):
        outs[name] = main(["--src", src, "--dest", str(tmp_path / name), "--split", split])
    assert [os.path.basename(p) for p in outs["port"]] == [os.path.basename(p)
                                                           for p in outs["jax"]]
    assert len(outs["port"]) == (2 if split == "a#b" else 1)
    for j, p in zip(outs["jax"], outs["port"]):
        assert tree(p) == tree(j)
        with open(os.path.join(j, "config.yaml")) as f, open(os.path.join(p, "config.yaml")) as g:
            assert_configs_equal(yaml.safe_load(f), yaml.safe_load(g))
        assert records(os.path.join(p, "dense/sparse/images.bin")) == records(
            os.path.join(j, "dense/sparse/images.bin"))
    if split == "a#b":
        names = [r[4] for r in records(os.path.join(outs["port"][0], "dense/sparse/images.bin"))]
        assert any(n.startswith("a_") for n in names) and any(n.startswith("b/") for n in names)


def test_roi_percent_matches_jax():
    rng = np.random.default_rng(3)
    o = rng.standard_normal((500, 3)) * 2
    d = rng.standard_normal((500, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for origin, radius in (([0.1, -0.2, 0.3], 1.0), ([0, 0, 0], 2.5), ([1, 1, 1], 0.2)):
        got = filters.roi_percent(o, d, origin, radius)
        assert got == jax_filters.roi_percent(o, d, origin, radius)
    assert 0 < filters.roi_percent(o, d, [0, 0, 0], 1.0) < 1


@pytest.fixture(scope="module")
def workspace(raw, tmp_path_factory):
    """The raw layout through pre_process, with semantic maps: one view
    person-dominated, one half person (kept at the default threshold)."""
    _, src, _ = raw
    ws = pre_process.main(["--src", src, "--dest", str(tmp_path_factory.mktemp("ws"))])[0]
    prepare_semantic_maps.main(["--root_dir", ws, "--backend", "constant", "--device", "cpu"])
    names = sorted(os.listdir(os.path.join(ws, "dense/images")))
    person = get_label_id_mapping()["person"]
    for name, frac in ((names[1], 0.9), (names[2], 0.3)):
        path = os.path.join(ws, "semantic_maps", name.split(".")[0] + ".npz")
        sem = np.load(path)["arr_0"]
        sem.reshape(-1)[: int(frac * sem.size)] = person
        np.savez_compressed(path, sem)
    return ws, names


def test_view_selection_and_filters_match_jax(raw, workspace, tmp_path):
    """view_selection drops the turned view, filter_transient the
    person-dominated one; both lists equal JAX's, and write_split_tsv's
    table is byte-equal."""
    ws, names = workspace
    with open(os.path.join(ws, "config.yaml")) as f:
        sc = yaml.safe_load(f)
    kept = filters.view_selection(ws, sc["origin"], sc["radius"])
    assert kept == jax_filters.view_selection(ws, sc["origin"], sc["radius"])
    assert sorted(set(names) - set(kept)) == raw[2] != []
    static = filters.filter_transient(ws, kept)
    assert static == jax_filters.filter_transient(ws, kept)
    assert names[1] not in static and names[2] in static and len(static) == len(kept) - 1
    tsv = filters.write_split_tsv(ws, static, num_test=2)
    want = open(tsv, "rb").read()
    jax_filters.write_split_tsv(ws, static, num_test=2)
    assert open(tsv, "rb").read() == want
    with pytest.raises(ValueError, match="num_test"):
        filters.write_split_tsv(ws, static, num_test=len(static))


def test_prepare_data_split_matches_jax(workspace):
    ws, _ = workspace
    path = jax_split.main(["--root_dir", ws, "--num_test", "2"])
    want = open(path, "rb").read()
    os.remove(path)
    assert prepare_data_split.main(["--root_dir", ws, "--num_test", "2"]) == path
    assert open(path, "rb").read() == want
    assert want.count(b"\ttest\t") == 2


def semantic_maps(root, rel):
    out = os.path.join(root, rel)
    return {f: np.load(os.path.join(out, f))["arr_0"] for f in sorted(os.listdir(out))}


@pytest.mark.parametrize("backend", ["constant", "segformer"])
def test_semantic_maps_match_jax(raw, tmp_path, backend):
    """Both backends on the CPU: the same npz arrays (int16, ADE20K's 0-based
    ids); segformer on tests/test_cli_tools.py's tiny random checkpoint."""
    ws = raw[0]
    extra = []
    if backend == "segformer":
        transformers = pytest.importorskip("transformers")
        cfg = transformers.SegformerConfig(
            num_channels=3, num_encoder_blocks=2, depths=[1, 1], sr_ratios=[4, 2],
            hidden_sizes=[8, 16], num_attention_heads=[1, 2], decoder_hidden_size=16,
            num_labels=150)
        torch.manual_seed(0)
        wdir = str(tmp_path / "segformer_ckpt")
        transformers.SegformerForSemanticSegmentation(cfg).save_pretrained(wdir)
        extra = ["--weights", wdir]
    jax_sem.main(["--root_dir", ws, "--backend", backend, "--out_path", f"j_{backend}", *extra])
    prepare_semantic_maps.main(["--root_dir", ws, "--backend", backend, "--out_path",
                                f"p_{backend}", "--device", "cpu", *extra])
    want, got = semantic_maps(ws, f"j_{backend}"), semantic_maps(ws, f"p_{backend}")
    assert list(got) == list(want) and len(got) == 6
    for k in want:
        assert got[k].dtype == np.int16 and got[k].shape == (30, 40)
        np.testing.assert_array_equal(got[k], want[k])
    if backend == "segformer":
        assert len(np.unique(np.concatenate([v.ravel() for v in got.values()]))) > 1


def test_semantic_maps_missing_packages_exit(raw, monkeypatch):
    """segformer without transformers and torchvision without torchvision
    stop with the JAX tool's SystemExit, never falling back."""
    import builtins

    real = builtins.__import__

    def no_pkgs(name, *a, **k):
        if name.split(".")[0] in ("transformers", "torchvision"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pkgs)
    for backend, pkg in (("segformer", "transformers"), ("torchvision", "torchvision")):
        with pytest.raises(SystemExit, match=pkg):
            prepare_semantic_maps.main(["--root_dir", raw[0], "--backend", backend,
                                        "--out_path", "none", "--device", "cpu"])


def nima_state_dict(seed=0):
    """A random NIMA state dict in torchvision's layout: VGG16
    ``features.{0,2,5,...}`` and ``classifier.2``, scaled to keep the
    activations alive through the 13 convs."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in filters.nima_model().state_dict().items():
        fan_in = int(np.prod(p.shape[1:])) if p.dim() > 1 else 1
        scale = np.sqrt(2.0 / fan_in) if p.dim() > 1 else 0.05
        sd[name] = torch.randn(p.shape, generator=g) * scale
    return sd


def nima_plain(sd, x):
    """NIMA's forward from the state dict alone: VGG16's convs at torchvision's
    indices, 2x2 pools after 3, 8, 15, 22 and 29, the classifier's linear,
    softmax."""
    import torch.nn.functional as F

    for i in range(31):
        if f"features.{i}.weight" in sd:
            x = F.relu(F.conv2d(x, sd[f"features.{i}.weight"], sd[f"features.{i}.bias"],
                                padding=1))
        elif i in (4, 9, 16, 23, 30):
            x = F.max_pool2d(x, 2, 2)
    return torch.softmax(F.linear(x.flatten(1), sd["classifier.2.weight"],
                                  sd["classifier.2.bias"]), dim=1)


def test_nima_filter_matches_plain_forward(workspace, tmp_path):
    """The NIMA state dict loads strictly into the port's VGG16 trunk; the
    filter's scores equal the plain forward's (1e-5) and it keeps the views
    scoring above the threshold, with no torchvision."""
    from PIL import Image

    ws, names = workspace
    names = names[:3]
    sd = nima_state_dict()
    path = str(tmp_path / "nima.pth")
    torch.save({"model": sd}, path)
    mean = torch.tensor([0.485, 0.456, 0.406])[None, :, None, None]
    std = torch.tensor([0.229, 0.224, 0.225])[None, :, None, None]
    x = torch.from_numpy(np.stack([
        np.asarray(Image.open(os.path.join(ws, "dense/images", n)).convert("RGB")
                   .resize((224, 224)), np.float32) for n in names]).transpose(0, 3, 1, 2) / 255.0)
    with torch.no_grad():
        want = (nima_plain(sd, (x - mean) / std) * torch.arange(1, 11)).sum(1).numpy()
        model = filters.nima_model()
        model.load_state_dict(sd, strict=True)
        got = (model.eval()((x - mean) / std) * torch.arange(1, 11)).sum(1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    order = np.argsort(want)
    assert want[order[1]] - want[order[0]] > 1e-3, want
    threshold = float(want[order[0]] + want[order[1]]) / 2
    kept = filters.nima_filter(ws, names, path, threshold=threshold, batch=2, device="cpu")
    assert kept == [n for n, s in zip(names, want) if s > threshold]
    assert len(kept) == 2
