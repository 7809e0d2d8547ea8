"""The port's data modules against the JAX package's.

`data/autoaugment.py` (the port's numpy copy) bit for bit on one
`np.random.default_rng` seed; the loaders (CIFAR-10/100 pickles, STL-10
binaries, rotated-MNIST `.amat`, an ImageFolder tree, all written by the
test) `np.array_equal`, with equal missing-dataset errors;
`image_batch_iterator` in every augmentation policy and
`imagenet_batch_iterator` with the draws given (`jax.random` replaced by
numpy draws on the JAX side, the port's draw functions by the same draws),
within 1e-5; `synthetic_image_batch` on the JAX function's own draws
within 1e-6.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from equiadapt_tpu.data import autoaugment as jaa
from equiadapt_tpu.data import images as jimg
from equiadapt_tpu.data import synthetic as jsyn
from equiadapt_tpu.utils.config import Config as JConfig
from equiadapt_tpu_torch.data import autoaugment as taa
from equiadapt_tpu_torch.data import images as timg
from equiadapt_tpu_torch.data import synthetic as tsyn
from equiadapt_tpu_torch.utils.config import Config as TConfig
from torch_port_cpu import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoaugment_equals_jax_bit_for_bit(seed):
    batch = np.random.default_rng(100 + seed).integers(
        0, 256, (16, 32, 32, 3), dtype=np.uint8)
    ours = taa.autoaugment_cifar10(np.random.default_rng(seed), batch)
    ref = jaa.autoaugment_cifar10(np.random.default_rng(seed), batch)
    assert ours.dtype == np.uint8 and np.array_equal(ours, ref)
    assert not np.array_equal(ours, batch)


def _write_cifar10(root, rng, n=4):
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.integers(0, 256, (n, 3 * 32 * 32), dtype=np.uint8)
        with open(d / fname, "wb") as f:
            pickle.dump({b"data": data, b"labels": list(rng.integers(0, 10, n))}, f)


def _write_cifar100(root, rng, n=3):
    d = root / "cifar-100-python"
    d.mkdir(parents=True)
    for fname in ("train", "test"):
        data = rng.integers(0, 256, (n, 3 * 32 * 32), dtype=np.uint8)
        with open(d / fname, "wb") as f:
            pickle.dump({b"data": data,
                         b"fine_labels": list(rng.integers(0, 100, n))}, f)


def _write_stl10(root, rng, n=3):
    d = root / "stl10_binary"
    d.mkdir(parents=True)
    for split in ("train", "test"):
        rng.integers(0, 256, n * 3 * 96 * 96, dtype=np.uint8).tofile(d / f"{split}_X.bin")
        rng.integers(1, 11, n, dtype=np.uint8).tofile(d / f"{split}_y.bin")


def _write_rotated_mnist(root, rng, n=3):
    root.mkdir(parents=True, exist_ok=True)
    for name in ("train_valid", "test"):
        rows = np.concatenate([rng.uniform(size=(n, 784)),
                               rng.integers(0, 10, (n, 1))], axis=1)
        np.savetxt(root / f"mnist_all_rotation_normalized_float_{name}.amat", rows)


WRITERS = {"cifar10": _write_cifar10, "cifar100": _write_cifar100,
           "stl10": _write_stl10, "rotated_mnist": _write_rotated_mnist}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_loaders_equal_jax(name, tmp_path):
    WRITERS[name](tmp_path, np.random.default_rng(len(name)))
    loader = f"load_{name}"
    ours = getattr(timg, loader)(str(tmp_path))
    ref = getattr(jimg, loader)(str(tmp_path))
    for o, r in zip(ours, ref):
        assert set(o) == set(r) == {"image", "label"}
        for key in o:
            assert o[key].dtype == r[key].dtype
            assert np.array_equal(o[key], r[key])


@pytest.mark.parametrize("loader", ["load_cifar10", "load_cifar100", "load_stl10",
                                    "load_rotated_mnist", "imagenet_index"])
def test_missing_dataset_errors_equal_jax(loader, tmp_path):
    args = (str(tmp_path),) + (("train",) if loader == "imagenet_index" else ())
    with pytest.raises(FileNotFoundError) as ours:
        getattr(timg, loader)(*args)
    with pytest.raises(FileNotFoundError) as ref:
        getattr(jimg, loader)(*args)
    assert str(ours.value) == str(ref.value)


@pytest.fixture
def image_folder(tmp_path):
    """An ImageFolder tree: 3 classes, train and val, odd sizes and aspects
    (PNG, so the decode is exact)."""
    rng = np.random.default_rng(7)
    for split in ("train", "val"):
        for c, cls in enumerate(("n02", "n01", "n03")):
            d = tmp_path / split / cls
            d.mkdir(parents=True)
            for i in range(3):
                h, w = 20 + 7 * i + c, 31 - 5 * i + 2 * c
                arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.png")
            (d / "notes.txt").write_text("not an image")
    return tmp_path


def test_imagenet_index_equal_jax(image_folder):
    ours = timg.imagenet_index(str(image_folder), "train")
    ref = jimg.imagenet_index(str(image_folder), "train")
    assert ours[0] == ref[0] and ours[2] == ref[2] == ["n01", "n02", "n03"]
    assert np.array_equal(ours[1], ref[1])


@pytest.mark.parametrize("split", ["train", "val"])
def test_imagenet_batches_equal_jax(split, image_folder, monkeypatch):
    seed = 123457
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval, *a, **k: jnp.asarray(seed))
    monkeypatch.setattr(timg, "_host_seed", lambda generator: seed)
    kw = dict(split=split, batch_size=4, image_size=16, num_workers=2)
    ref = list(jimg.imagenet_batch_iterator(jax.random.key(0), str(image_folder), **kw))
    ours = list(timg.imagenet_batch_iterator(torch.Generator(), str(image_folder),
                                             device="cpu", **kw))
    assert len(ours) == len(ref) == (2 if split == "train" else 3)
    for o, r in zip(ours, ref):
        assert o["image"].dtype == torch.float32
        assert np.array_equal(o["image"].numpy(), np.asarray(r["image"]))
        assert np.array_equal(o["label"].numpy(), np.asarray(r["label"]))


class _Draws:
    """Numpy draws handed to both packages: the epoch's order and
    AutoAugment seed, each batch's flips and rotation elements, each
    rand_augment round's ops and magnitudes."""

    def __init__(self, seed, n, batch, num_batches, num_rotations):
        rng = np.random.default_rng(seed)
        self.order = rng.permutation(n)
        self.aa_seed = int(rng.integers(0, 2**31 - 1))
        self.flips = [rng.uniform(size=batch) < 0.5 for _ in range(num_batches)]
        self.rots = [rng.integers(0, num_rotations, batch) for _ in range(num_batches)]
        self.ops = [rng.integers(0, 6, batch) for _ in range(2 * num_batches)]
        self.mags = [rng.uniform(-0.5, 0.5, batch).astype(np.float32)
                     for _ in range(2 * num_batches)]

    def patch_jax(self, monkeypatch, angles):
        flips, rots, ops, mags = (iter(self.flips), iter(self.rots),
                                  iter(self.ops), iter(self.mags))

        def randint(key, shape, minval, maxval, *a, **k):
            return jnp.asarray(self.aa_seed if shape == () else next(ops))

        monkeypatch.setattr(jax.random, "permutation",
                            lambda key, n, *a, **k: jnp.asarray(self.order))
        monkeypatch.setattr(jax.random, "randint", randint)
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p=0.5, shape=None: jnp.asarray(next(flips)))
        monkeypatch.setattr(jax.random, "choice",
                            lambda key, a, shape=(), *x, **k: jnp.asarray(angles[next(rots)]))
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape=(), *a, **k: jnp.asarray(next(mags)))

    def patch_port(self, monkeypatch):
        batches = iter(zip(self.flips, self.rots))
        rounds = iter(zip(self.ops, self.mags))
        monkeypatch.setattr(timg, "_epoch_draws", lambda gen, n, shuffle: (
            self.order if shuffle else np.arange(n), self.aa_seed))
        monkeypatch.setattr(timg, "_batch_draws", lambda gen, b, nr: tuple(
            torch.from_numpy(a) for a in next(batches)))
        monkeypatch.setattr(timg, "_rand_augment_draws", lambda gen, b, m: tuple(
            torch.from_numpy(a) for a in next(rounds)))


@pytest.mark.parametrize("augment,dataset_name", [
    ("none", "cifar10"), ("flip", "cifar10"), ("rotation", "cifar10"),
    ("autoaugment", "cifar10"), ("autoaugment", None)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_image_batch_iterator_equals_jax(augment, dataset_name, shuffle, monkeypatch):
    rng = np.random.default_rng(3)
    n, batch, nr = 10, 4, 8
    raw = rng.uniform(size=(n, 12, 12, 3)).astype(np.float32)
    data = {"image": jimg._normalize(raw, "cifar10").astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}
    draws = _Draws(5, n, batch, 10, nr)
    angles = np.linspace(0.0, 360.0, nr + 1, dtype=np.float32)[:nr]
    kw = dict(augment=augment, num_rotations=nr, shuffle=shuffle,
              dataset_name=dataset_name)
    draws.patch_jax(monkeypatch, angles)
    ref = list(jimg.image_batch_iterator(jax.random.key(0), data, batch, **kw))
    draws.patch_port(monkeypatch)
    ours = list(timg.image_batch_iterator(torch.Generator(), data, batch,
                                          device="cpu", **kw))
    assert len(ours) == len(ref) == n // batch
    for o, r in zip(ours, ref):
        assert o["image"].dtype == torch.float32 and o["image"].shape == (batch, 12, 12, 3)
        np.testing.assert_allclose(o["image"].numpy(), np.asarray(r["image"]),
                                   rtol=0, atol=1e-5)
        assert np.array_equal(o["label"].numpy(), np.asarray(r["label"]))


def test_get_image_dataset_splits_equal_jax(tmp_path, monkeypatch):
    """The dispatch of a config: the train split shuffled and flipped, the
    test split in order and unaugmented; an unknown name's error."""
    _write_cifar10(tmp_path, np.random.default_rng(9), n=8)
    args = [f"dataset.data_path={tmp_path}", "dataset.dataset_name=cifar10",
            "dataset.augment=flip", "experiment.batch_size=4"]
    jcfg, tcfg = JConfig().override(*args), TConfig().override(*args)
    draws = _Draws(11, 40, 4, 10, 4)
    draws.patch_jax(monkeypatch, np.zeros(4, np.float32))
    draws.patch_port(monkeypatch)
    for split, count in (("train", 3), ("test", 2)):
        ref = list(jimg.get_image_dataset(jcfg, jax.random.key(0), 3, split=split))
        ours = list(timg.get_image_dataset(tcfg, torch.Generator(), 3, split=split,
                                           device="cpu"))
        assert len(ours) == len(ref) == count
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o["image"].numpy(), np.asarray(r["image"]),
                                       rtol=0, atol=1e-6)
            assert np.array_equal(o["label"].numpy(), np.asarray(r["label"]))
    bad = ["dataset.dataset_name=svhn"]
    with pytest.raises(ValueError) as ours:
        next(timg.get_image_dataset(TConfig().override(*bad), torch.Generator(), 1))
    with pytest.raises(ValueError) as ref:
        next(jimg.get_image_dataset(JConfig().override(*bad), jax.random.key(0), 1))
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("size,channels", [(16, 3), (9, 1)])
def test_synthetic_image_batch_on_jax_draws(size, channels):
    """The formula on the JAX function's own labels and noise. The two
    packages' `linspace(-1, 1, size)` grids differ in the last float32 bits
    (XLA multiplies by a rounded reciprocal), and sin(3 f x) + cos(2 f y)
    multiplies a grid difference by up to 5 f, f <= num_classes: the bar is
    1e-6 plus that."""
    key = jax.random.key(4)
    ref = jsyn.synthetic_image_batch(key, 6, size=size, channels=channels,
                                     num_classes=7)
    k1, k2, _ = jax.random.split(key, 3)
    labels = np.asarray(jax.random.randint(k1, (6,), 0, 7))
    noise = 0.1 * np.asarray(jax.random.normal(k2, (6, size, size, channels)))
    assert np.array_equal(labels, np.asarray(ref["label"]))
    grid_diff = np.abs(np.asarray(jnp.linspace(-1, 1, size))
                       - torch.linspace(-1, 1, size).numpy()).max()
    assert grid_diff <= 2.4e-7  # two ulps of 1
    ours = tsyn._blob_images(torch.from_numpy(labels.copy()), torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref["image"]), rtol=0,
                               atol=1e-6 + 5 * 7 * grid_diff)


def test_synthetic_batches_from_a_generator():
    """Shapes, dtypes, the generator's device, reproducible draws, and the
    point-cloud formula on given draws."""
    a = tsyn.synthetic_image_batch(torch.Generator().manual_seed(1), 5, size=8,
                                   channels=2, num_classes=3)
    b = tsyn.synthetic_image_batch(torch.Generator().manual_seed(1), 5, size=8,
                                   channels=2, num_classes=3)
    assert a["image"].shape == (5, 8, 8, 2) and a["image"].dtype == torch.float32
    assert a["label"].dtype == torch.int64 and int(a["label"].max()) < 3
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    it = list(tsyn.batch_iterator(torch.Generator().manual_seed(2),
                                  tsyn.synthetic_pointcloud_batch, 2, batch=3,
                                  num_points=5, num_classes=4))
    assert len(it) == 2 and it[0]["points"].shape == (3, 5, 3)
    assert not torch.equal(it[0]["points"], it[1]["points"])
    g = torch.Generator().manual_seed(3)
    labels = torch.randint(0, 4, (3,), generator=g)
    pts = torch.randn(3, 5, 3, generator=g)
    got = tsyn.synthetic_pointcloud_batch(torch.Generator().manual_seed(3), 3,
                                          num_points=5, num_classes=4)
    scale = np.stack([1.0 + labels.numpy(), np.ones(3), 1.0 / (1.0 + labels.numpy())], -1)
    np.testing.assert_allclose(got["points"].numpy(),
                               pts.numpy() * scale[:, None, :] * 0.3, rtol=1e-6)
