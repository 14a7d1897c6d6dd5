"""PyTorch port, data parallelism (``neuralrecon_w_tpu_torch/parallel``):
the padding helpers against the JAX package's; two ranks over gloo on the
CPU, started by ``parallel.mesh.spawn``, against one rank and against the
JAX package over ``make_mesh(2)``: the sweeps, one training step on the
halves of a fixed batch whose halves differ in every count the loss
divides by, and the split validation render."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.parallel import make_mesh  # noqa: E402
from neuralrecon_w_tpu.parallel import mesh as jax_mesh  # noqa: E402
from neuralrecon_w_tpu.parallel import sweep as jax_sweep  # noqa: E402
from neuralrecon_w_tpu.rendering import render_config_from_cfg as jax_render_config  # noqa: E402
from neuralrecon_w_tpu.rendering.renderer import SceneInfo as JaxSceneInfo  # noqa: E402
from neuralrecon_w_tpu.training import init_state as jax_init_state  # noqa: E402
from neuralrecon_w_tpu.training import jit_train_step  # noqa: E402
from neuralrecon_w_tpu.training import loss_config_from_cfg as jax_loss_config  # noqa: E402
from neuralrecon_w_tpu.training import make_optimizer as jax_make_optimizer  # noqa: E402
from neuralrecon_w_tpu.training import make_train_step as jax_make_train_step  # noqa: E402
from neuralrecon_w_tpu_torch import config  # noqa: E402
from neuralrecon_w_tpu_torch.datasets.mask_utils import get_label_id_mapping  # noqa: E402
from neuralrecon_w_tpu_torch.parallel import mesh  # noqa: E402
from neuralrecon_w_tpu_torch.parallel.sweep import sharded_rgb_sweep, sharded_sdf_sweep  # noqa: E402
from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo  # noqa: E402
from neuralrecon_w_tpu_torch.testing import ranks  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax, params_from_jax  # noqa: E402
from neuralrecon_w_tpu_torch.training.losses import loss_config_from_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.training.schedule import make_optimizer  # noqa: E402
from neuralrecon_w_tpu_torch.training.step import make_train_step  # noqa: E402
from test_torch_sdf_mlp import live_field_params  # noqa: E402
from test_training import tiny_cfg  # noqa: E402

torch.set_num_threads(2)

LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5  # tests/test_training.py:test_jit_train_step_multidevice's
# the reduced gradient against JAX's on the CPU: read at 7.2e-7 at most,
# on gradients up to 3.5 (halving them moves some by 1.75)
GRAD_ATOL = 5e-6
SWEEP_ATOL = 1e-5
N_RAYS = 64
LID = get_label_id_mapping()


@pytest.mark.parametrize("n,k", [(0, 1), (1, 2), (7, 2), (8, 2), (9, 4), (100, 8)])
def test_pad_to_multiple_matches_jax(n, k):
    assert mesh.pad_to_multiple(n, k) == jax_mesh.pad_to_multiple(n, k)


@pytest.mark.parametrize("shape,n_dev,pad", [((5,), 2, 0.0), ((8, 3), 4, 0.0), ((7, 2, 3), 4, -1.0),
                                             ((1, 3), 8, 2.5), ((0, 3), 2, 0.0)])
def test_split_for_devices_matches_jax(shape, n_dev, pad):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    got, n = mesh.split_for_devices(x, n_dev, pad)
    want, n_want = jax_mesh.split_for_devices(x, n_dev, pad)
    assert n == n_want and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,world", [(10, 2), (11, 2), (1, 4), (0, 2), (9, 3)])
def test_rank_blocks_cover_the_set(n, world):
    """The sweep's blocks (``_sweep_multihost``'s per = ceil(n / W)) tile
    [0, n) in rank order, one length for every rank."""
    blocks = [mesh.rank_block(_Rank(r, world), n) for r in range(world)]
    per = blocks[0][1]
    assert all(b[1] == per for b in blocks) and per * world >= n
    covered = np.concatenate([np.arange(lo, min(lo + per, n)) for lo, _ in blocks])
    np.testing.assert_array_equal(covered, np.arange(n))


def _Rank(rank, world, n_local=None):
    """A stand-in group: a rank's ``DataGroup`` with no process group."""
    return mesh.DataGroup(world, rank, rank, world if n_local is None else n_local, 1, 0,
                          torch.device("cpu"), "gloo", None)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_rays_is_jax_data_split(world):
    """A rank's slice of a batch is JAX's P(DATA_AXIS) shard of it."""
    batch = {"rays": np.arange(16 * 3, dtype=np.float32).reshape(16, 3),
             "ts": np.arange(16, dtype=np.int32)}
    m = make_mesh(world)
    sharded = jax_mesh.shard_rays(m, {k: jnp.asarray(v) for k, v in batch.items()})
    for r in range(world):
        got = mesh.shard_rays(_Rank(r, world), batch)
        for k in batch:
            shard = sorted(sharded[k].addressable_shards, key=lambda s: s.index[0].start)[r]
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_rays(_Rank(0, world), {"ts": np.arange(world * 4 + 1)})


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads a rank: the spawned ranks read it at start-up."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        yield


def run_ranks(fn, spec, tmp_path, suffix, n=2):
    out = str(tmp_path / ("rank{rank}" + suffix))
    mesh.spawn(fn, n, (n, mesh.free_coordinator(), spec, out))
    return [out.format(rank=r) for r in range(n)]


def parallel_cfg():
    """tiny_cfg with every batch-dependent loss term on (mesh mask, ray
    mask, SFM depth, floor normal), float32, PERTURB 0."""
    cfg = tiny_cfg()
    n = cfg.NEUCONW
    n.MESH_MASK_LIST = ["sky"]
    n.RAY_MASK_LIST = ["person"]
    n.DEPTH_LOSS = True
    n.FLOOR_NORMAL = True
    n.PERTURB = 0.0
    cfg.TPU.FIELD_DTYPE = "float32"
    cfg.TPU.FUSED_SAMPLER_SDF = False  # JAX side: the jnp sampler on the CPU
    return cfg


def uneven_batch(seed=0):
    """N_RAYS rays whose halves differ in masked rays (2 / 12 'person'),
    rays outside the 1.2 sphere (0 / 8), rays with SFM depth and floor rays."""
    rs = np.random.RandomState(seed)
    n, h = N_RAYS, N_RAYS // 2
    o = rs.randn(n, 3).astype(np.float32) * 0.1 + np.array([0, 0, 2], np.float32)
    o[h:h + 8] += np.array([0, 4.0, 0], np.float32)  # parallel to the axis, far off it
    d = -o
    d[h:h + 8] = [0, 0, -1]
    d += rs.randn(n, 3).astype(np.float32) * 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    weight = np.zeros((n, 1), np.float32)
    weight[:24] = 1.0
    weight[h:h + 4] = 1.0
    rays = np.concatenate([o, d, np.full((n, 1), 0.5), np.full((n, 1), 4.0),
                           np.full((n, 1), 2.0), weight], 1).astype(np.float32)
    labels = np.zeros(n, np.int32)
    labels[:2] = LID["person"]
    labels[2:6] = LID["sky"]
    labels[6:12] = LID["road"]
    labels[h + 8:h + 20] = LID["person"]
    labels[h + 20:h + 22] = LID["sky"]
    labels[h + 22] = LID["road"]
    return {"rays": rays, "ts": rs.randint(0, 8, n).astype(np.int32), "labels": labels,
            "rgbs": rs.rand(n, 3).astype(np.float32)}


def port_setup(cfg):
    fc = config.field_config_from_cfg(cfg)
    rcfg = config.render_config_from_cfg(cfg)
    mask_ids = tuple(LID[x] for x in cfg.NEUCONW.RAY_MASK_LIST)
    return fc, rcfg, loss_config_from_cfg(cfg), mask_ids


SCENE = (np.zeros(3), np.asarray(2.5), np.eye(4))  # tests/test_training.py:scene


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """One step from one live initialisation: the JAX step jitted over
    make_mesh(2) on the whole batch (and its gradient), the port on two
    gloo ranks on its halves, and the port's one-rank loss on each half."""
    tmp = tmp_path_factory.mktemp("step")
    cfg = parallel_cfg()
    jfc = jax_field_config(cfg)
    opt, _ = jax_make_optimizer(cfg, 2048, total_steps=0)
    params = live_field_params(jax_init_field(jax.random.PRNGKey(0), jfc))
    state0 = jax_init_state(jax.random.PRNGKey(0), jfc, opt)._replace(params=params)
    batch = uneven_batch()
    ray_mask_ids = tuple(LID[x] for x in cfg.NEUCONW.RAY_MASK_LIST)
    step = jax_make_train_step(jfc, jax_render_config(cfg), jax_loss_config(cfg), opt, 10,
                               ray_mask_ids)
    scene = JaxSceneInfo(*(jnp.asarray(v, jnp.float32) for v in SCENE))
    s_j, aux_j = jit_train_step(step, make_mesh(2), donate=False)(
        state0, scene, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1),
        None, None)
    # the gradient of the global batch's loss over the same mesh: an
    # optimiser that makes no update and keeps the gradient as its state
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    grad_step = jax_make_train_step(jfc, jax_render_config(cfg), jax_loss_config(cfg), keep, 10,
                                    ray_mask_ids)
    s_g, _ = jit_train_step(grad_step, make_mesh(2), donate=False)(
        jax_init_state(jax.random.PRNGKey(0), jfc, keep)._replace(params=params), scene,
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1), None, None)
    want = {"loss": float(aux_j["loss"]),
            "params": params_from_jax(jax.tree.map(np.asarray, s_j.params)),
            "grads": params_from_jax(jax.tree.map(np.asarray, s_g.opt_state))}

    fc, rcfg, lcfg, mask_ids = port_setup(cfg)
    np_params = jax.tree.map(np.asarray, params)
    spec = {"fc": fc, "rcfg": rcfg, "lcfg": lcfg, "anneal_end": 10, "mask_ids": mask_ids,
            "optimizer": make_optimizer(cfg, 2048)[0], "batch": batch, "scene": SCENE,
            "device": "cpu", "state_dict": field_from_jax(np_params, fc, "cpu").state_dict()}
    got = [torch.load(p, weights_only=False) for p in run_ranks(ranks.step_rank, spec, tmp, ".pt")]

    halves = []
    for r in range(2):
        model = field_from_jax(np_params, fc, "cpu")
        one = make_train_step(fc, rcfg, lcfg, 10, mask_ids)
        part = {k: torch.from_numpy(v[r * N_RAYS // 2:(r + 1) * N_RAYS // 2])
                for k, v in batch.items()}
        loss, _ = one.loss_fn(model, SceneInfo(*(torch.as_tensor(v, dtype=torch.float32)
                                                 for v in SCENE)),
                              part, None, 0.0, None, None)
        halves.append(float(loss.detach()))
    return want, got, halves


def test_uneven_batch_halves_differ_in_every_count():
    """The fixed batch's halves differ in every count the loss divides by
    (masked-in rays, relaxed samples, SFM depth, floor rays), so a step
    that divided by its own half's counts could not pass the step test."""
    from neuralrecon_w_tpu_torch.rendering.renderer import render_rays
    from neuralrecon_w_tpu_torch.training.losses import batch_counts
    from neuralrecon_w_tpu_torch.training.step import ray_mask_from_labels

    cfg = parallel_cfg()
    fc, rcfg, _, mask_ids = port_setup(cfg)
    model = field_from_jax(jax.tree.map(np.asarray, jax_init_field(
        jax.random.PRNGKey(0), jax_field_config(cfg))), fc, "cpu")
    batch = uneven_batch()
    counts = []
    for r in range(2):
        part = {k: torch.from_numpy(v[r * N_RAYS // 2:(r + 1) * N_RAYS // 2])
                for k, v in batch.items()}
        with torch.no_grad():
            res = render_rays(model, fc, rcfg, SceneInfo(*(torch.as_tensor(v, dtype=torch.float32)
                                                           for v in SCENE)),
                              part["rays"], part["ts"], part["labels"], None, 0.0,
                              ray_mask=ray_mask_from_labels(part["labels"], mask_ids))
        counts.append(batch_counts(res).numpy())
    a, b = counts
    assert (a[:4] != b[:4]).all() and a[4] == b[4] == N_RAYS // 2, (a, b)


def test_two_rank_step_matches_jax_mesh(step_runs):
    """The global-batch loss and the update of the JAX step over a 2-device
    mesh, from the reduced gradient of two gloo ranks; both ranks' new
    parameters bit for bit equal."""
    want, got, _ = step_runs
    for g in got:
        assert abs(g["aux"]["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (
            g["aux"]["loss"], want["loss"])
    a, b = got
    assert a["aux"] == b["aux"]
    assert set(a["params"]) == set(b["params"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["grads"].get(k, torch.zeros(0)), b["grads"].get(k, torch.zeros(0)))
    assert set(want["params"]) == set(a["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(a["params"][k].numpy(), v.numpy(), atol=PARAM_ATOL,
                                   err_msg=k)


def assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=GRAD_ATOL, err_msg=k)


def test_two_rank_reduced_gradient_matches_jax_mesh(step_runs):
    """Each rank's gradient after the SUM all-reduce is the gradient of the
    JAX loss over make_mesh(2) on the whole batch. Adam's first update does
    not see the gradient's scale; this comparison does."""
    want, got, _ = step_runs
    for g in got:
        assert_grads_close(g["grads"], want["grads"])


def test_averaged_gradient_is_not_the_global_gradient(step_runs):
    """The negative control: the ranks' gradients averaged (an AVG
    all-reduce, half the SUM) miss the tolerance the reduced gradient holds."""
    want, got, _ = step_runs
    with pytest.raises(AssertionError):
        assert_grads_close({k: 0.5 * v for k, v in got[0]["grads"].items()}, want["grads"])


def test_mean_of_rank_losses_is_not_the_global_loss(step_runs):
    """The negative control: DistributedDataParallel's form, the mean of the
    two halves' own losses, misses the tolerance the global loss holds."""
    want, _, halves = step_runs
    mean = sum(halves) / 2
    assert abs(mean - want["loss"]) > 10 * LOSS_RTOL * abs(want["loss"]), (mean, want["loss"])


@pytest.fixture(scope="module")
def live_model():
    cfg = parallel_cfg()
    jfc = jax_field_config(cfg)
    params = live_field_params(jax_init_field(jax.random.PRNGKey(2), jfc))
    fc, rcfg, _, _ = port_setup(cfg)
    model = field_from_jax(jax.tree.map(np.asarray, params), fc, "cpu")
    return cfg, jfc, params, fc, rcfg, model.eval().requires_grad_(False)


def test_two_rank_sweeps_match_one_rank_and_jax_mesh(live_model, tmp_path):
    """Both sweeps split over two ranks (several macro batches each, the
    last block short): equal to the port's one-rank sweep and within
    SWEEP_ATOL of the JAX package's over make_mesh(2)."""
    cfg, jfc, params, fc, _, model = live_model
    pts = (np.random.default_rng(1).random((1003, 3)) * 2.4 - 1.2).astype(np.float32)
    view = np.array([0.0, 0.0, 1.0], np.float32)
    spec = {"fc": fc, "state_dict": model.state_dict(), "pts": pts, "chunk": 128, "macro": 256,
            "device": "cpu", "view_dir": view, "a_index": 3}
    got = [np.load(p) for p in run_ranks(ranks.sweep_rank, spec, tmp_path, ".npz")]
    one_sdf = sharded_sdf_sweep(model, fc, pts, 128, "cpu", macro=256)
    one_rgb = sharded_rgb_sweep(model, fc, pts, view, 3, 128, "cpu", macro=256)
    for g in got:
        np.testing.assert_array_equal(g["sdf"], one_sdf)
        np.testing.assert_array_equal(g["rgb"], one_rgb)
    m = make_mesh(2)
    np.testing.assert_allclose(one_sdf, jax_sweep.sharded_sdf_sweep(params, jfc, pts, m, 128),
                               atol=SWEEP_ATOL)
    np.testing.assert_allclose(one_rgb, jax_sweep.sharded_rgb_sweep(params, jfc, pts, view, 3, m,
                                                                    128), atol=SWEEP_ATOL)


def test_two_rank_render_image_matches_one_rank(live_model, tmp_path):
    """render_image split over two ranks (each chunk halved, the last one
    padded) equals the one-rank render on every rank; a chunk that does not
    divide over the ranks raises, as validation.py:78-80 does."""
    from neuralrecon_w_tpu_torch.training.step import make_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    _, _, _, fc, rcfg, model = live_model
    batch = uneven_batch(seed=3)
    wh = (8, 7)  # 56 rays: one full chunk of 32 and one padded
    rays, ts = batch["rays"][:56], batch["ts"][:56]
    labels = np.zeros(56, np.int32)
    scene = SceneInfo(*(torch.as_tensor(v, dtype=torch.float32) for v in SCENE))
    spec = {"fc": fc, "rcfg": rcfg, "state_dict": model.state_dict(), "rays": rays, "ts": ts,
            "labels": labels, "wh": wh, "chunk": 32, "scene": SCENE, "device": "cpu"}
    got = [np.load(p) for p in run_ranks(ranks.render_rank, spec, tmp_path, ".npz")]
    want = render_image(make_render_fn(fc, rcfg), model, scene, rays, ts, labels, wh, 32)
    for g in got:
        for k in ("color", "depth", "normal"):
            assert g[k].shape == want[k].shape
            np.testing.assert_array_equal(g[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        render_image(make_render_fn(fc, rcfg), model, scene, rays, ts, labels, wh, 32,
                     group=_Rank(0, 3))


def test_device_pool_shards_are_the_jax_mesh_blocks():
    """DeviceRayPool(shard=(i, n)): the first (rows // n) * n rows in
    contiguous blocks, a batch's share from each, each shard its own
    permutation, every row of a shard once an epoch; shard (0, 1) is the
    unsharded pool, stream and all."""
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool

    rs = np.random.RandomState(0)
    rows = np.concatenate([rs.rand(101, 8), np.arange(101)[:, None] % 7,
                           np.arange(101)[:, None] % 5, rs.rand(101, 2)], 1).astype(np.float32)
    pool = RayPool(rows, rs.rand(101, 3).astype(np.float32))
    whole = DeviceRayPool(pool, "cpu", seed=3)
    same = DeviceRayPool(pool, "cpu", seed=3, shard=(0, 1))
    for _ in range(5):
        torch.testing.assert_close(whole.next_batch(20)["rays"], same.next_batch(20)["rays"],
                                   rtol=0, atol=0)
    shards = [DeviceRayPool(pool, "cpu", seed=3, shard=(i, 4)) for i in range(4)]
    assert all(s.n == 25 for s in shards)
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(s.data["rays"].numpy(), pool.rays[i * 25:(i + 1) * 25])
        seen = np.concatenate([s.next_batch(20)["rays"].numpy() for _ in range(5)])
        assert len(seen) == 25 and len(np.unique(seen[:, 0])) == 25
    assert not torch.equal(shards[0]._perm, shards[1]._perm)
    with pytest.raises(ValueError, match="does not divide over 4 shards"):
        shards[0].next_batch(10)
    with pytest.raises(ValueError, match="unsharded"):
        shards[0].take_scan_window(20, 2)
