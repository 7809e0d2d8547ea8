"""Image dataset loaders: CIFAR-10/100, rotated MNIST, STL-10, ImageNet.

Counterpart of `equiadapt_tpu/data/images.py`. The loaders read local files
only (no downloads): the cifar-10/100 python pickles, the rotated-MNIST
`.amat` files and the STL-10 binaries under `data_path`, and raise the JAX
package's `FileNotFoundError` otherwise. They return the same NHWC float32
numpy arrays, normalised with each dataset's mean and std. The batch
iterators yield torch tensors on `device`; their random draws come from a
`torch.Generator` (`generator`), and the flip and rotation augmentations
run on the device (`ops.warp`). AutoAugment and the ImageNet decoders stay
host-side numpy and PIL, as in the JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from equiadapt_tpu_torch.ops.warp import group_angles, hflip, rotate

Tensor = torch.Tensor

__all__ = [
    "load_cifar10",
    "load_cifar100",
    "load_stl10",
    "load_rotated_mnist",
    "imagenet_index",
    "imagenet_batch_iterator",
    "image_batch_iterator",
    "get_image_dataset",
    "rand_augment",
    "DATASET_STATS",
]

DATASET_STATS = {
    # (mean, std) per channel, matching the reference transforms
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
    "cifar100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
    "stl10": ((0.4467, 0.4398, 0.4066), (0.2603, 0.2566, 0.2713)),
    "rotated_mnist": ((0.1307,), (0.3081,)),
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def _normalize(x: np.ndarray, name: str) -> np.ndarray:
    mean, std = DATASET_STATS[name]
    return (x - np.asarray(mean)) / np.asarray(std)


def load_cifar10(data_path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The cifar-10-batches-py pickles: (train, test) dicts of NHWC float32
    images and int32 labels."""
    root = os.path.join(data_path, "cifar-10-batches-py")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"CIFAR-10 not found at {root}; this environment cannot download "
            "datasets — place the python-version batches there or use "
            "dataset.dataset_name=synthetic"
        )

    def _load(files):
        xs, ys = [], []
        for fname in files:
            with open(os.path.join(root, fname), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.append(np.asarray(d[b"labels"]))
        x = np.concatenate(xs).astype(np.float32) / 255.0
        return {"image": _normalize(x, "cifar10").astype(np.float32),
                "label": np.concatenate(ys).astype(np.int32)}

    train = _load([f"data_batch_{i}" for i in range(1, 6)])
    test = _load(["test_batch"])
    return train, test


def load_cifar100(data_path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """cifar-100-python pickles (train/test files, 'fine_labels')."""
    root = os.path.join(data_path, "cifar-100-python")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"CIFAR-100 not found at {root}; no network egress — place the "
            "python-version pickles there or use synthetic data"
        )

    def _load(fname):
        with open(os.path.join(root, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        x = x.astype(np.float32) / 255.0
        return {"image": _normalize(x, "cifar100").astype(np.float32),
                "label": np.asarray(d[b"fine_labels"]).astype(np.int32)}

    return _load("train"), _load("test")


def load_stl10(data_path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """STL-10 binary files (train_X.bin/train_y.bin/test_X.bin/test_y.bin)."""
    root = os.path.join(data_path, "stl10_binary")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"STL-10 not found at {root}; no network egress — place the "
            "binary files there or use synthetic data"
        )

    def _load(xf, yf):
        x = np.fromfile(os.path.join(root, xf), np.uint8)
        # column-major 96x96x3 per STL-10 spec
        x = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1).astype(np.float32) / 255.0
        y = np.fromfile(os.path.join(root, yf), np.uint8).astype(np.int32) - 1
        return {"image": _normalize(x, "stl10").astype(np.float32), "label": y}

    return _load("train_X.bin", "train_y.bin"), _load("test_X.bin", "test_y.bin")


def load_rotated_mnist(data_path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The .amat rotated-MNIST files (28 x 28 pixels and a label a row)."""
    train_f = os.path.join(
        data_path, "mnist_all_rotation_normalized_float_train_valid.amat"
    )
    test_f = os.path.join(data_path, "mnist_all_rotation_normalized_float_test.amat")
    if not (os.path.isfile(train_f) and os.path.isfile(test_f)):
        raise FileNotFoundError(
            f"rotated MNIST .amat files not found under {data_path}"
        )

    def _load(path):
        raw = np.loadtxt(path, dtype=np.float32)
        x = raw[:, :-1].reshape(-1, 28, 28, 1)
        y = raw[:, -1].astype(np.int32)
        return {"image": _normalize(x, "rotated_mnist").astype(np.float32), "label": y}

    return _load(train_f), _load(test_f)


def imagenet_index(data_path: str, split: str):
    """ImageFolder-style index of `data_path/{split}/<class>/<image>` files:
    (paths, int32 labels, classes), classes the sorted directory names."""
    root = os.path.join(data_path, split)
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"ImageNet split not found at {root}; this environment cannot "
            "download datasets — place ImageFolder-layout data there "
            "(train/<wnid>/*.JPEG) or use dataset.dataset_name=synthetic"
        )
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    paths, labels = [], []
    exts = (".jpeg", ".jpg", ".png", ".bmp", ".webp")
    for li, cls in enumerate(classes):
        for fname in sorted(os.listdir(os.path.join(root, cls))):
            if fname.lower().endswith(exts):
                paths.append(os.path.join(root, cls, fname))
                labels.append(li)
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    return paths, np.asarray(labels, np.int32), classes


def _imagenet_decode_train(path: str, image_size: int, rng: np.random.Generator) -> np.ndarray:
    """RandomResizedCrop(size, bilinear) + ToTensor semantics: random area in
    [0.08, 1] and aspect in [3/4, 4/3] (log-uniform), 10 attempts, then
    torchvision's centre-crop fallback."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        W, H = im.size
        area = W * H
        for _ in range(10):
            target_area = area * rng.uniform(0.08, 1.0)
            aspect = np.exp(rng.uniform(np.log(3.0 / 4.0), np.log(4.0 / 3.0)))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if 0 < w <= W and 0 < h <= H:
                left = int(rng.integers(0, W - w + 1))
                top = int(rng.integers(0, H - h + 1))
                im = im.resize(
                    (image_size, image_size), Image.BILINEAR,
                    box=(left, top, left + w, top + h),
                )
                break
        else:
            # clamp to the nearest allowed aspect ratio, then centre crop
            in_ratio = W / H
            if in_ratio < 3.0 / 4.0:
                w, h = W, int(round(W / (3.0 / 4.0)))
            elif in_ratio > 4.0 / 3.0:
                w, h = int(round(H * (4.0 / 3.0))), H
            else:
                w, h = W, H
            left, top = (W - w) // 2, (H - h) // 2
            im = im.resize(
                (image_size, image_size), Image.BILINEAR,
                box=(left, top, left + w, top + h),
            )
        return np.asarray(im, np.float32) / 255.0


def _imagenet_decode_eval(path: str, image_size: int) -> np.ndarray:
    """Resize(shorter -> 256 * size/224, bilinear) + CenterCrop(size)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        W, H = im.size
        short = int(round(256 * image_size / 224))
        if W <= H:
            nw, nh = short, int(round(H * short / W))
        else:
            nw, nh = int(round(W * short / H)), short
        im = im.resize((nw, nh), Image.BILINEAR)
        left, top = (nw - image_size) // 2, (nh - image_size) // 2
        im = im.crop((left, top, left + image_size, top + image_size))
        return np.asarray(im, np.float32) / 255.0


def _host_seed(generator: torch.Generator) -> int:
    """A seed in [0, 2^31 - 1) for a host-side numpy generator."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator,
                             device=generator.device))


def imagenet_batch_iterator(
    generator: torch.Generator,
    data_path: str,
    split: str = "train",
    batch_size: int = 256,
    image_size: int = 224,
    num_batches: Optional[int] = None,
    num_workers: int = 8,
    device="cuda",
) -> Iterator[Dict[str, Tensor]]:
    """Streaming ImageNet batches: a shuffled (train) ImageFolder traversal,
    per-image RandomResizedCrop + flip (train) or resize + centre crop
    (val), ImageNet normalisation, decoded by a thread pool one batch
    ahead of the caller (PIL releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    paths, labels, _ = imagenet_index(data_path, split)
    n = len(paths)
    train = split == "train"
    seed = _host_seed(generator)
    host_rng = np.random.default_rng(seed)
    order = host_rng.permutation(n) if train else np.arange(n)
    total = n // batch_size if train else (n + batch_size - 1) // batch_size
    if num_batches is not None:
        total = min(total, num_batches)

    def _decode(args):
        i, path = args
        if train:
            img_rng = np.random.default_rng(seed ^ (i * 2654435761))
            img = _imagenet_decode_train(path, image_size, img_rng)
            if img_rng.random() < 0.5:  # RandomHorizontalFlip(0.5)
                img = img[:, ::-1, :]
        else:
            img = _imagenet_decode_eval(path, image_size)
        return _normalize(img, "imagenet").astype(np.float32)

    def _submit(pool, b):
        idx = order[b * batch_size: (b + 1) * batch_size]
        fut = pool.map(_decode, [(int(i), paths[i]) for i in idx])
        return fut, idx

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = _submit(pool, 0) if total else None
        for b in range(total):
            fut, idx = pending
            nxt = _submit(pool, b + 1) if b + 1 < total else None
            imgs = list(fut)
            pending = nxt
            yield {
                "image": torch.from_numpy(np.stack(imgs)).to(device),
                "label": torch.from_numpy(labels[idx]).to(device),
            }


_DATA_CACHE: Dict[tuple, tuple] = {}


def get_image_dataset(cfg, generator: torch.Generator, num_batches: int,
                      split: str = "train",
                      device="cuda") -> Iterator[Dict[str, Tensor]]:
    """Dataset dispatch: dataset_name -> loader + batch iterator.
    split="train" shuffles and augments; split="test" serves the held-out
    split in order with no augmentation. In-memory datasets are cached per
    (name, path) across epochs; ImageNet streams."""
    name = cfg.dataset.dataset_name
    bs = cfg.experiment.batch_size
    train_split = split == "train"
    if name == "imagenet":
        yield from imagenet_batch_iterator(
            generator, cfg.dataset.data_path, "train" if train_split else "val",
            bs, image_size=cfg.dataset.image_size, num_batches=num_batches,
            device=device,
        )
        return
    loaders = {
        "cifar10": load_cifar10,
        "cifar100": load_cifar100,
        "stl10": load_stl10,
        "rotated_mnist": load_rotated_mnist,
    }
    if name not in loaders:
        raise ValueError(
            f"unknown dataset '{name}' (expected one of "
            f"{sorted(loaders) + ['imagenet', 'synthetic']})"
        )
    key = (name, cfg.dataset.data_path)
    if key not in _DATA_CACHE:
        _DATA_CACHE[key] = loaders[name](cfg.dataset.data_path)
    train, test = _DATA_CACHE[key]
    it = image_batch_iterator(
        generator, train if train_split else test, bs,
        augment=cfg.dataset.augment if train_split else "none",
        num_rotations=cfg.canonicalization.network_hyperparams.num_rotations,
        shuffle=train_split,
        dataset_name=name,
        device=device,
    )
    for i, batch in enumerate(it):
        if i >= num_batches:
            break
        yield batch


def _rand_augment_draws(generator: torch.Generator, batch: int,
                        magnitude: float) -> Tuple[Tensor, Tensor]:
    """One round's op index in [0, 6) and magnitude in [-m, m) per image."""
    dev = generator.device
    op = torch.randint(0, 6, (batch,), generator=generator, device=dev)
    m = (torch.rand(batch, generator=generator, device=dev) * 2.0 - 1.0) * magnitude
    return op, m


def rand_augment(generator: torch.Generator, images: Tensor, num_ops: int = 2,
                 magnitude: float = 0.5) -> Tensor:
    """RandAugment-style policy (the AutoAugment option for datasets without
    normalisation stats): per image, `num_ops` rounds, each applying one of
    {identity, hflip, rotate, brightness, contrast, solarize} with a random
    magnitude m in [-magnitude, magnitude) (rotate by 60 m degrees, border
    fill)."""
    B = images.shape[0]
    x = images
    for _ in range(num_ops):
        op, m = _rand_augment_draws(generator, B, magnitude)
        op, m = op.to(x.device), m.to(x.device, x.dtype)
        mb = m[:, None, None, None]
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        candidates = torch.stack([
            x,
            hflip(x),
            rotate(x, m * 60.0, padding_mode="border"),
            x + mb,  # brightness
            (x - mean) * (1 + mb) + mean,  # contrast
            torch.where(x > torch.abs(mb), -x, x),  # solarize
        ])
        x = candidates[op, torch.arange(B, device=x.device)]
    return x


def _epoch_draws(generator: torch.Generator, n: int,
                 shuffle: bool) -> Tuple[np.ndarray, int]:
    """An epoch's sample order and the seed of its AutoAugment generator."""
    order = (torch.randperm(n, generator=generator, device=generator.device)
             .cpu().numpy() if shuffle else np.arange(n))
    return order, _host_seed(generator)


def _batch_draws(generator: torch.Generator, batch: int,
                 num_rotations: int) -> Tuple[Tensor, Tensor]:
    """A batch's flips (bool, p = 0.5) and rotation-element indices in
    [0, num_rotations)."""
    dev = generator.device
    flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    idx = torch.randint(0, num_rotations, (batch,), generator=generator, device=dev)
    return flip, idx


def image_batch_iterator(
    generator: torch.Generator,
    data: Dict[str, np.ndarray],
    batch_size: int,
    augment: str = "none",
    num_rotations: int = 4,
    shuffle: bool = True,
    dataset_name: Optional[str] = None,
    device="cuda",
) -> Iterator[Dict[str, Tensor]]:
    """Epoch iterator with the reference's augmentation policies: 'none',
    'flip', 'rotation' (flip, then a random C_n element, border fill) and
    'autoaugment' (torchvision's CIFAR10 AutoAugment policy, host-side on
    uint8, when dataset_name gives the normalisation stats to round-trip
    through; `rand_augment` on the device otherwise, after the flip).
    Yields {"image": (B, H, W, C) float32, "label": (B,) int64} on
    `device`."""
    n = data["image"].shape[0]
    order, aa_seed = _epoch_draws(generator, n, shuffle)
    aa_rng = np.random.default_rng(aa_seed)
    for i in range(n // batch_size):
        idx = order[i * batch_size: (i + 1) * batch_size]
        img_np = data["image"][idx]
        lab = torch.from_numpy(data["label"][idx].astype(np.int64)).to(device)
        if augment == "autoaugment" and dataset_name in DATASET_STATS:
            # AutoAugment works on uint8 before normalisation (torchvision's
            # transform order): denormalise, augment, renormalise
            from equiadapt_tpu_torch.data.autoaugment import autoaugment_cifar10

            mean, std = DATASET_STATS[dataset_name]
            raw = np.clip(
                (img_np * np.asarray(std) + np.asarray(mean)) * 255.0, 0, 255
            ).astype(np.uint8)
            raw = autoaugment_cifar10(aa_rng, raw)
            img_np = _normalize(raw.astype(np.float32) / 255.0, dataset_name)
        img = torch.from_numpy(np.ascontiguousarray(img_np, np.float32)).to(device)
        if augment in ("flip", "rotation", "autoaugment"):
            flip, rot = _batch_draws(generator, batch_size, num_rotations)
            img = torch.where(flip.to(device)[:, None, None, None], hflip(img), img)
            if augment == "rotation":
                ang = group_angles(num_rotations, device=device)[rot.to(device)]
                img = rotate(img, ang, padding_mode="border")
            elif augment == "autoaugment" and dataset_name not in DATASET_STATS:
                img = rand_augment(generator, img)
        yield {"image": img, "label": lab}
