"""The port's training data (roma_tpu_torch.datasets) against the JAX
package's, on the byte-accurate MegaDepth and ScanNet fixture trees
(tests/fixtures_realformat.py): for one seed, every item, every transform,
the scene weights, the weighted index stream and the loader's batches are
equal bit for bit (tolerance 0: np.array_equal). Also the loader's rank
slices, its early stop and error path, and ``to_device``."""
import numpy as np
import pytest
import torch

from fixtures_realformat import make_megadepth_fixture, make_scannet_fixture
from PIL import Image

from roma_tpu.datasets import loader as jax_loader
from roma_tpu.datasets import megadepth as jax_mega
from roma_tpu.datasets import scannet as jax_scannet
from roma_tpu.datasets import transforms as jax_T
from roma_tpu_torch.datasets import loader, megadepth, scannet
from roma_tpu_torch.datasets import transforms as T

SCENES = ("0001", "0002", "0121")  # 0121 is on LoFTR's ignore list


@pytest.fixture(scope="module")
def mega_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mega")
    for s in SCENES:
        make_megadepth_fixture(root, scene=s)
    return str(root)


@pytest.fixture(scope="module")
def scannet_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    make_scannet_fixture(root, scene_id=0)
    make_scannet_fixture(root, scene_id=1)
    return str(root)


def assert_items_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _augs(pkg, kind):
    if kind == "plain":
        return {}
    return dict(shake_t=8, use_horizontal_flip_aug=True, random_eraser=pkg.RandomErasing(p=0.6),
                colorjiggle=pkg.ColorJiggle(), use_randaug=True, randaug_params={"num_ops": 3})


@pytest.mark.parametrize("kind", ["plain", "augmented"])
def test_megadepth_items_equal_jax(mega_root, kind):
    """Two passes over every pair of a scene, so the flips, shakes and
    erasures of several draws are compared; normalize off in the augmented
    case, as the Tiny recipe reads it."""
    info = np.load(f"{mega_root}/prep_scene_info/0001.npy", allow_pickle=True).item()
    kw = dict(ht=56, wt=70, seed=3, normalize=kind == "plain", scene_name="0001.npy")
    j = jax_mega.MegadepthScene(mega_root, info, **kw, **_augs(jax_T, kind))
    t = megadepth.MegadepthScene(mega_root, info, **kw, **_augs(T, kind))
    assert len(t) == len(j) == 3 and t.scene_name == j.scene_name
    for idx in [0, 1, 2, 2, 1, 0]:
        assert_items_equal(t[idx], j[idx])


def test_megadepth_overlaps_sizes_and_pair_cap_equal_jax(mega_root):
    info = np.load(f"{mega_root}/prep_scene_info/0002.npy", allow_pickle=True).item()
    for kw in (dict(min_overlap=0.5), dict(min_overlap=0.35, max_overlap=0.6), dict(max_num_pairs=2, seed=5)):
        j, t = jax_mega.MegadepthScene(mega_root, info, **kw), megadepth.MegadepthScene(mega_root, info, **kw)
        assert np.array_equal(t.pairs, j.pairs) and np.array_equal(t.overlaps, j.overlaps), kw
    for rank in range(4):
        kw = dict(ht=60, wt=90, randomize_size=True, rank=rank)
        j, t = jax_mega.MegadepthScene(mega_root, info, **kw), megadepth.MegadepthScene(mega_root, info, **kw)
        assert (t.ht, t.wt) == (j.ht, j.wt)
    assert [(megadepth.MegadepthScene(mega_root, info, ht=60, wt=90, randomize_size=True, rank=r).ht)
            for r in range(3)] == [60, 64, 90]


@pytest.mark.parametrize("split", ["train", "train_loftr", "custom"])
def test_megadepth_builder_and_weights_equal_jax(mega_root, split):
    kw = dict(split=split, min_overlap=0.45, ht=42, wt=56)
    if split == "custom":
        kw["scene_names"] = ["0002.npy", "0001.npy", "0121.npy"]
    jb, tb = jax_mega.MegadepthBuilder(mega_root), megadepth.MegadepthBuilder(mega_root)
    j, t = jb.build_concat(**kw), tb.build_concat(**kw)
    assert [d.scene_name for d in t.datasets] == [d.scene_name for d in j.datasets]
    assert "0121" not in " ".join(d.scene_name for d in t.datasets)
    assert len(t) == len(j) > 0
    wj, wt = jax_mega.MegadepthBuilder.weight_scenes(j, 0.75), megadepth.MegadepthBuilder.weight_scenes(t, 0.75)
    assert wt.dtype == wj.dtype and np.array_equal(wt, wj)
    for i in range(len(t)):
        assert_items_equal(t[i], j[i])
    with pytest.raises(FileNotFoundError):  # the test scenes are not in the fixture, on either side
        tb.build_scenes(split="test_loftr")
    with pytest.raises(ValueError):
        tb.build_scenes(split="nope")
    assert megadepth.MegadepthBuilder(mega_root, loftr_ignore=False).build_concat(split="train").datasets.__len__() == 3


@pytest.mark.parametrize("flip", [False, True])
def test_scannet_items_equal_jax(scannet_root, flip):
    """The port reads the depth PNG with PIL, the JAX package with OpenCV."""
    kw = dict(split="train", ht=48, wt=64, use_horizontal_flip_aug=flip, seed=1)
    j = jax_scannet.ScanNetBuilder(scannet_root).build_concat(**kw)
    t = scannet.ScanNetBuilder(scannet_root).build_concat(**kw)
    assert len(t) == len(j) == 4  # two scenes, the stem-15 pair filtered out of each
    for i in [0, 1, 2, 3, 3, 0]:
        assert_items_equal(t[i], j[i])
    wj = jax_scannet.ScanNetBuilder.weight_scenes(j, 0.75)
    assert np.array_equal(scannet.ScanNetBuilder.weight_scenes(t, 0.75), wj)


def test_transforms_equal_jax():
    rs = np.random.RandomState(0)
    depth = rs.uniform(1, 5, (37, 53)).astype(np.float32)
    for mode in ("bilinear", "nearest-exact"):
        assert np.array_equal(T.resize_depth(depth, 20, 31, mode), jax_T.resize_depth(depth, 20, 31, mode))
    assert np.array_equal(T.resize_depth(depth, 37, 53), depth)
    pil = Image.fromarray((rs.rand(37, 53, 3) * 255).astype(np.uint8))
    assert np.array_equal(T.resize_image(pil, 28, 42), jax_T.resize_image(pil, 28, 42))
    im = rs.rand(28, 42, 3).astype(np.float32)
    assert np.array_equal(T.normalize_image(im), jax_T.normalize_image(im))
    for tx, ty in ((3, -2), (-5, 4), (0, 0)):
        assert np.array_equal(T.translate(im, tx, ty), jax_T.translate(im, tx, ty))
    K = np.array([[30.0, 0, 21], [0, 30, 14], [0, 0, 1]], np.float32)
    d = rs.rand(28, 42).astype(np.float32)
    for a, b in zip(T.horizontal_flip_pair(im, im[::-1], d, d[::-1], K, K, 42),
                    jax_T.horizontal_flip_pair(im, im[::-1], d, d[::-1], K, K, 42)):
        assert np.array_equal(a, b)
    H = T.random_perspective_matrix(np.random.RandomState(4), 28, 42)
    assert np.array_equal(H, jax_T.random_perspective_matrix(np.random.RandomState(4), 28, 42))
    assert np.array_equal(T.warp_perspective(im, H), jax_T.warp_perspective(im, H))
    assert np.array_equal(T.warp_perspective(d, H), jax_T.warp_perspective(d, H))
    for seed in range(4):  # RandomErasing's draws, both branches
        a = T.RandomErasing(p=0.7)(np.random.RandomState(seed), im, d)
        b = jax_T.RandomErasing(p=0.7)(np.random.RandomState(seed), im, d)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert np.array_equal(T.ColorJiggle(p=0.8)(np.random.RandomState(seed), im),
                              jax_T.ColorJiggle(p=0.8)(np.random.RandomState(seed), im))
        pa, pb = T.rand_augment_pair(np.random.RandomState(seed), pil, pil.rotate(3))
        qa, qb = jax_T.rand_augment_pair(np.random.RandomState(seed), pil, pil.rotate(3))
        assert np.array_equal(np.asarray(pa), np.asarray(qa)) and np.array_equal(np.asarray(pb), np.asarray(qb))


def test_weighted_sample_indices_equal_jax():
    w = np.random.RandomState(0).uniform(0.01, 1, 500).astype(np.float32)
    w[:7] = 0  # a zero weight is never drawn while others remain
    for seed, n in ((0, 1), (1, 37), (2, 493)):
        t = loader.weighted_sample_indices(np.random.RandomState(seed), w, n)
        j = jax_loader.weighted_sample_indices(np.random.RandomState(seed), w, n)
        assert np.array_equal(t, j) and len(set(t.tolist())) == n
        assert n == 493 or not set(t.tolist()) & set(range(7))


@pytest.fixture(scope="module")
def mega_concat(mega_root):
    kw = dict(split="train", min_overlap=0.01, ht=28, wt=42, shake_t=4, use_horizontal_flip_aug=True)
    return (megadepth.MegadepthBuilder(mega_root).build_concat(**kw),
            jax_mega.MegadepthBuilder(mega_root).build_concat(**kw))


def test_loader_batches_equal_jax(mega_concat):
    """num_workers=1: a scene's draws happen in index order on both sides."""
    t_ds, j_ds = mega_concat
    w = megadepth.MegadepthBuilder.weight_scenes(t_ds, 0.75)
    idx = loader.weighted_sample_indices(np.random.RandomState(0), w, len(t_ds))
    tb = list(loader.DataLoader(t_ds, idx, 2, num_workers=1))
    jb = list(jax_loader.DataLoader(j_ds, idx, 2, num_workers=1))
    assert len(tb) == len(jb) == len(t_ds) // 2 == 3
    for a, b in zip(tb, jb):
        assert_items_equal(a, b)
        assert a["im_A"].shape == (2, 28, 42, 3) and a["im_A_depth"].shape == (2, 28, 42)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_loader_rank_slices_are_disjoint_and_complete(world):
    class Items:
        def __getitem__(self, i):
            return {k: np.full((1,), i, np.float32) for k in loader.BATCH_KEYS}

    idx = np.random.RandomState(world).permutation(30)
    seen = []
    for rank in range(world):
        ld = loader.DataLoader(Items(), idx, 2, num_workers=2, rank=rank, world_size=world)
        jl = jax_loader.DataLoader(Items(), idx, 2, process_index=rank, process_count=world)
        assert np.array_equal(ld.indices, jl.indices) and np.array_equal(ld.indices, idx[rank::world])
        got = [int(v) for b in ld for v in b["im_A"][:, 0]]
        assert got == ld.indices[: len(ld) * 2].tolist()
        seen.append(set(ld.indices.tolist()))
    assert set().union(*seen) == set(range(30)) and sum(map(len, seen)) == 30


def test_loader_stops_early_and_raises_decode_errors():
    class Items:
        def __getitem__(self, i):
            if i == 7:
                raise OSError("corrupt file")
            return {k: np.zeros(2, np.float32) for k in loader.BATCH_KEYS}

    it = iter(loader.DataLoader(Items(), np.arange(6), 1, num_workers=2, prefetch=1))
    next(it)
    it.close()  # the producer, blocked on a full queue, stops
    got = []
    with pytest.raises(OSError, match="corrupt"):
        for b in loader.DataLoader(Items(), np.arange(10), 2, num_workers=2):
            got.append(b)
    assert len(got) == 3  # the batches before the failing one


def test_to_device_on_the_cpu():
    batch = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2], "b": np.ones((2, 2), np.int64)}
    out = loader.to_device(batch, "cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in out.values())
    assert np.array_equal(out["a"].numpy(), batch["a"]) and out["b"].dtype == torch.int64
