"""ImageNet data pipeline: the port's copy of ``adalog_tpu.data.imagenet``.

Replaces the reference's torchvision ImageFolder + timm transform stack
(utils/datasets.py): directory scanning, PIL decode, timm-equivalent eval
preprocessing (resize shorter side to size/crop_pct with bicubic, center crop,
normalize with the model's mean/std — what resolve_data_config/create_transform
produced for these models, datasets.py:125-130), a threaded prefetching batch
iterator producing NHWC float32 numpy, and the seeded in-memory calibration
subset (np.random.permutation of the train set, datasets.py:62-71).

Every cast and rounding is the JAX package's, so for the same files, seed
and decoder every array yielded here equals that package's bit for bit
(tests/test_torch_data.py). The native C++ decoder (data/native_loader.py)
is built at first use; without g++ or libjpeg the pipeline decodes with PIL.
"""

from __future__ import annotations

import os
import threading
import queue
from typing import Iterator, List, Optional, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:                      # pragma: no cover
    Image = None

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """ImageFolder protocol: root/<class_name>/<image>; classes sorted."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return paths, labels, classes


def load_eval_image(path: str, img_size: int, crop_pct: float,
                    mean, std, interpolation: str = "bicubic") -> np.ndarray:
    """timm eval transform, reproduced to the PIXEL:
    Resize(floor(size/crop_pct)) -> CenterCrop(size) -> /255 -> normalize.

    Exact integer semantics matter (a half-pixel difference silently shifts
    every accuracy number):
      - scale_size uses math.floor (timm transforms_factory.py
        transforms_imagenet_eval: int(math.floor(img_size / crop_pct))) —
        224/0.9 models resize to 248, NOT round()'s 249;
      - the aspect side uses int() TRUNCATION (torchvision F.resize int-size
        path: ``int(size * h / w)``);
      - the center-crop offset uses Python round() (banker's) per
        torchvision F.center_crop ``int(round((h - th) / 2.0))``.
    Validated bit-for-bit on bundled real JPEGs (tests/test_transform_parity).
    Returns (H, W, 3) float32."""
    import math
    scale_size = int(math.floor(img_size / crop_pct))
    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w <= h:
        nw, nh = scale_size, int(h * scale_size / w)
    else:
        nh, nw = scale_size, int(w * scale_size / h)
    resample = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
                "nearest": Image.NEAREST}[interpolation]
    img = img.resize((nw, nh), resample)
    left = int(round((nw - img_size) / 2.0))
    top = int(round((nh - img_size) / 2.0))
    img = img.crop((left, top, left + img_size, top + img_size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def load_train_image(path: str, img_size: int, mean, std,
                     rng: np.random.Generator,
                     interpolation: str = "bicubic",
                     color_jitter: float = 0.4) -> np.ndarray:
    """timm training transform (what the reference's calibration set actually
    uses: datasets.py:62-71 preloads train_set items, whose transform is
    create_transform(is_training=True), datasets.py:126-127): random resized
    crop (scale 0.08-1.0, ratio 3/4-4/3), horizontal flip p=0.5, color jitter
    0.4. Bit-exact parity with the torch RNG stream is impossible across
    frameworks; this reproduces the same augmentation distribution with a
    seeded numpy Generator."""
    from PIL import ImageEnhance

    img = Image.open(path).convert("RGB")
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(0.08, 1.0)
        log_r = rng.uniform(np.log(3 / 4), np.log(4 / 3))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            img = img.crop((left, top, left + cw, top + ch))
            break
    else:  # fallback: center crop of the shorter side
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        img = img.crop((left, top, left + side, top + side))
    resample = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
                "nearest": Image.NEAREST}[interpolation]
    img = img.resize((img_size, img_size), resample)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if color_jitter:
        for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                    ImageEnhance.Color):
            img = enh(img).enhance(
                1.0 + float(rng.uniform(-color_jitter, color_jitter)))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


class ImageNetLoader:
    """Loader factory bound to one model's preprocessing spec."""

    def __init__(self, root: str, spec, val_batch_size: int = 200,
                 num_workers: int = 4):
        self.root = root
        self.spec = spec
        self.val_batch_size = val_batch_size
        self.num_workers = max(1, num_workers)
        self._train: Optional[Tuple[List[str], List[int]]] = None
        self._val: Optional[Tuple[List[str], List[int]]] = None

    @property
    def img_size(self) -> int:
        return self.spec.cfg.img_size

    def _split(self, name: str):
        paths, labels, _ = scan_image_folder(os.path.join(self.root, name))
        return paths, labels

    def _load(self, path: str) -> np.ndarray:
        s = self.spec
        return load_eval_image(path, self.img_size, s.crop_pct, s.mean, s.std,
                               getattr(s, "interpolation", "bicubic"))

    def _load_batch(self, paths) -> np.ndarray:
        """Native C++ decode pipeline where it builds, PIL else."""
        from adalog_tpu_torch.data import native_loader
        s = self.spec
        if native_loader.available() and \
                getattr(s, "interpolation", "bicubic") == "bicubic" and all(
                p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            out = native_loader.batch_load(
                list(paths), self.img_size, s.crop_pct, s.mean, s.std,
                n_threads=self.num_workers)
            if out is not None:
                return out
        return np.stack([self._load(p) for p in paths])

    def _batches(self, paths, labels, batch_size) -> Iterator:
        """Threaded decode + batch assembly; yields (images NHWC, labels)."""
        n = len(paths)
        order = range(0, n, batch_size)
        q: "queue.Queue" = queue.Queue(maxsize=4)

        def worker():
            for st in order:
                ed = min(n, st + batch_size)
                imgs = self._load_batch(paths[st:ed])
                q.put((imgs, np.asarray(labels[st:ed], np.int32)))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    def val_loader(self) -> Iterator:
        if self._val is None:
            self._val = self._split("val")
        return self._batches(*self._val, self.val_batch_size)

    def calib_batches(self, num: int, batch_size: int, seed: int = 3,
                      augment: bool = True) -> List[np.ndarray]:
        """Seeded permutation of the TRAIN set, preloaded in memory
        (datasets.py:62-71 semantics, same np.random seeding).

        augment=True applies the timm TRAINING transform, matching the
        reference's in-memory calib set (its train_set carries
        create_transform(is_training=True)); augment=False uses the
        deterministic eval transform instead.
        """
        if self._train is None:
            self._train = self._split("train")
        paths, labels = self._train
        np.random.seed(seed)
        inds = np.random.permutation(len(paths))[:num]
        if augment:
            s = self.spec
            arng = np.random.default_rng(seed)
            imgs = np.stack([
                load_train_image(paths[i], self.img_size, s.mean, s.std, arng,
                                 getattr(s, "interpolation", "bicubic"))
                for i in inds])
        else:
            imgs = self._load_batch([paths[i] for i in inds])
        self._last_calib_labels = np.asarray([labels[i] for i in inds],
                                             np.int32)
        return [imgs[st:st + batch_size]
                for st in range(0, num, batch_size)]

    def calib_labels(self, batch_size: int):
        """Labels matching the last calib_batches() call, batched the same way
        (the reference validates on the calibration set after reconstruction,
        test_quant.py:236-238)."""
        lbl = self._last_calib_labels
        return [lbl[st:st + batch_size]
                for st in range(0, len(lbl), batch_size)]


class SyntheticLoader:
    """Deterministic stand-in when no ImageNet is on disk: seeded gaussian
    images + labels. Used by tests and hardware benchmarks."""

    def __init__(self, spec, val_batch_size: int = 200, n_val: int = 1000,
                 num_classes: int = 1000, seed: int = 0):
        self.spec = spec
        self.val_batch_size = val_batch_size
        self.n_val = n_val
        self.num_classes = num_classes
        self.seed = seed

    def _gen(self, rng, n):
        s = self.spec.cfg.img_size
        return rng.standard_normal((n, s, s, 3)).astype(np.float32)

    def val_loader(self):
        rng = np.random.default_rng(self.seed)
        for st in range(0, self.n_val, self.val_batch_size):
            n = min(self.val_batch_size, self.n_val - st)
            yield self._gen(rng, n), rng.integers(
                0, self.num_classes, n).astype(np.int32)

    def calib_batches(self, num: int, batch_size: int, seed: int = 3):
        rng = np.random.default_rng(seed)
        imgs = self._gen(rng, num)
        self._last_calib_labels = rng.integers(
            0, self.num_classes, num).astype(np.int32)
        return [imgs[st:st + batch_size] for st in range(0, num, batch_size)]

    def calib_labels(self, batch_size: int):
        lbl = self._last_calib_labels
        return [lbl[st:st + batch_size]
                for st in range(0, len(lbl), batch_size)]
