"""The port's data pipeline (adalog_tpu_torch.data) and validation metrics
(adalog_tpu_torch.utils.metrics) against adalog_tpu on the CPU.

The same files and seeds go through both packages; every array the port's
pipeline yields must equal the JAX package's bit for bit: the eval transform
on the bundled real JPEGs (and timm's transform, reimplemented in
tests/test_transform_parity.py), the augmented calibration batches, the
ImageFolder loaders, the synthetic loader, and the native C++ decoder where
it builds (both packages' bindings then load the one library the port
builds, since the JAX package's own build writes into its tree). Metrics:
``validate`` on the same logits and labels gives equal top-1/top-5 counts,
tied rows included (jax.lax.top_k breaks ties toward the lower index), and
the same loss within 1e-6 relative.
"""

import io
import logging
import os

import numpy as np
import jax.numpy as jnp
import pytest
from PIL import Image

from adalog_tpu.data import imagenet as J
from adalog_tpu.data import native_loader as j_native
from adalog_tpu.utils import metrics as j_metrics
from adalog_tpu_torch.data import imagenet as P
from adalog_tpu_torch.data import native_loader as p_native
from adalog_tpu_torch.utils import metrics as p_metrics
from test_transform_parity import timm_eval_oracle

DATA = os.path.join(os.path.dirname(__file__), "data")
JPEGS = sorted(f for f in os.listdir(DATA) if f.endswith(".jpg"))
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
SIZES = [(224, 0.9), (224, 0.875), (384, 1.0)]


class Spec:
    class cfg:
        img_size = 48
    crop_pct = 0.9
    mean, std = MEAN, STD


def _synth_jpeg(rng, h, w, path):
    img = (np.clip(np.cumsum(rng.standard_normal((h, w, 3)), axis=0) * 8
                   + 128, 0, 255)).astype(np.uint8)
    Image.fromarray(img).save(path, format="JPEG", quality=95)
    return path


@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(0)
    shapes = [(96, 128), (128, 96), (75, 101)]
    for split in ("train", "val"):
        for cls in ("cat", "dog", "eel"):
            d = tmp_path / split / cls
            d.mkdir(parents=True)
            for i, (h, w) in enumerate(shapes):
                _synth_jpeg(rng, h, w, str(d / f"img{i}.jpg"))
    return str(tmp_path)


@pytest.fixture
def pil_only(monkeypatch):
    """Both packages decode with PIL."""
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(p_native, "available", lambda: False)


@pytest.fixture
def native_both(monkeypatch):
    """Both packages' bindings on the library the port builds; skips where
    g++ or libjpeg is missing."""
    if not p_native.available():
        pytest.skip("the native decoder does not build here")
    monkeypatch.setattr(j_native, "_LIB_PATH", p_native.lib_path())
    monkeypatch.setattr(j_native, "_lib", None)
    assert j_native.available()


@pytest.mark.parametrize("jpg", JPEGS)
@pytest.mark.parametrize("img_size,crop_pct", SIZES)
def test_eval_transform_bitwise(jpg, img_size, crop_pct):
    path = os.path.join(DATA, jpg)
    ours = P.load_eval_image(path, img_size, crop_pct, MEAN, STD, "bicubic")
    np.testing.assert_array_equal(
        ours, J.load_eval_image(path, img_size, crop_pct, MEAN, STD,
                                "bicubic"))
    np.testing.assert_array_equal(
        ours, timm_eval_oracle(path, img_size, crop_pct, MEAN, STD))


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_eval_transform_other_interpolations(interp):
    path = os.path.join(DATA, JPEGS[0])
    np.testing.assert_array_equal(
        P.load_eval_image(path, 64, 0.875, MEAN, STD, interp),
        J.load_eval_image(path, 64, 0.875, MEAN, STD, interp))


@pytest.mark.parametrize("jpg", JPEGS)
def test_train_transform_bitwise(jpg):
    """The seeded augmentation (random resized crop, flip, colour jitter)
    draws the same numbers and makes the same pixels."""
    path = os.path.join(DATA, jpg)
    rp, rj = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        np.testing.assert_array_equal(
            P.load_train_image(path, 64, MEAN, STD, rp),
            J.load_train_image(path, 64, MEAN, STD, rj))


def test_scan_image_folder(image_dir):
    root = os.path.join(image_dir, "val")
    got = P.scan_image_folder(root)
    assert got == J.scan_image_folder(root)
    paths, labels, classes = got
    assert classes == ["cat", "dog", "eel"] and labels == [0] * 3 + [1] * 3 \
        + [2] * 3 and len(paths) == 9


def _loaders(image_dir, batch=4, workers=2):
    return (P.ImageNetLoader(image_dir, Spec, val_batch_size=batch,
                             num_workers=workers),
            J.ImageNetLoader(image_dir, Spec, val_batch_size=batch,
                             num_workers=workers))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (xp, yp), (xj, yj) in zip(got, want):
        np.testing.assert_array_equal(xp, xj)
        np.testing.assert_array_equal(yp, yj)
        assert xp.dtype == np.float32 and yp.dtype == np.int32


def test_val_loader_bitwise_pil(image_dir, pil_only):
    p, j = _loaders(image_dir)
    got = list(p.val_loader())
    _assert_batches_equal(got, list(j.val_loader()))
    assert [b[0].shape[0] for b in got] == [4, 4, 1]
    assert got[0][0].shape[1:] == (48, 48, 3)


def test_val_loader_bitwise_native(image_dir, native_both):
    p, j = _loaders(image_dir)
    _assert_batches_equal(list(p.val_loader()), list(j.val_loader()))


@pytest.mark.parametrize("augment", [True, False])
def test_calib_batches_bitwise(image_dir, pil_only, augment):
    p, j = _loaders(image_dir, workers=1)
    got = p.calib_batches(num=6, batch_size=4, seed=3, augment=augment)
    want = j.calib_batches(num=6, batch_size=4, seed=3, augment=augment)
    assert [b.shape for b in got] == [(4, 48, 48, 3), (2, 48, 48, 3)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p.calib_labels(4), j.calib_labels(4)):
        np.testing.assert_array_equal(a, b)
    again = p.calib_batches(num=6, batch_size=4, seed=3, augment=augment)
    np.testing.assert_array_equal(got[0], again[0])


def test_calib_augmentation_changes_pixels(image_dir, pil_only):
    p, _ = _loaders(image_dir, workers=1)
    aug = p.calib_batches(num=4, batch_size=4, seed=3, augment=True)
    det = p.calib_batches(num=4, batch_size=4, seed=3, augment=False)
    assert not np.allclose(aug[0], det[0])


def test_synthetic_loader_bitwise():
    class Tiny:
        class cfg:
            img_size = 32

    p = P.SyntheticLoader(Tiny, val_batch_size=8, n_val=20, num_classes=10,
                          seed=4)
    j = J.SyntheticLoader(Tiny, val_batch_size=8, n_val=20, num_classes=10,
                          seed=4)
    got = list(p.val_loader())
    assert [b[0].shape[0] for b in got] == [8, 8, 4]
    _assert_batches_equal(got, list(j.val_loader()))
    for a, b in zip(p.calib_batches(12, 5, seed=2),
                    j.calib_batches(12, 5, seed=2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p.calib_labels(5), j.calib_labels(5)):
        np.testing.assert_array_equal(a, b)


def test_native_decode_matches_jax_binding(native_both, tmp_path):
    rng = np.random.default_rng(5)
    path = _synth_jpeg(rng, 96, 128, str(tmp_path / "x.jpg"))
    with open(path, "rb") as f:
        data = f.read()
    got = p_native.decode_preprocess(data, 64, 0.875, MEAN, STD)
    np.testing.assert_array_equal(
        got, j_native.decode_preprocess(data, 64, 0.875, MEAN, STD))
    rgb = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(
        p_native.preprocess_rgb8(rgb, 64, 0.875, MEAN, STD),
        j_native.preprocess_rgb8(rgb, 64, 0.875, MEAN, STD))


@pytest.mark.parametrize("jpg", JPEGS)
def test_native_batch_load_matches_timm_oracle(native_both, jpg):
    """Same geometry as timm's transform; the float resampling may differ
    from PIL's u8 stages by the JAX package's documented tolerance."""
    path = os.path.join(DATA, jpg)
    out = p_native.batch_load([path], 224, 0.9, MEAN, STD, n_threads=2)[0]
    np.testing.assert_array_equal(
        out, j_native.batch_load([path], 224, 0.9, MEAN, STD,
                                 n_threads=2)[0])
    golden = timm_eval_oracle(path, 224, 0.9, MEAN, STD)
    diff = np.abs((golden - out) * np.asarray(STD, np.float32) * 255.0)
    assert diff.max() < 3.0 and diff.mean() < 0.3, (diff.max(), diff.mean())


def test_native_build_is_keyed_by_source(native_both):
    path = p_native.lib_path()
    assert os.path.exists(path) and path.startswith(p_native.BUILD_DIR)
    assert p_native.build() == path          # built once, reused


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _logit_batches(kind, seed=0, n=(16, 16, 7), classes=10):
    rng = np.random.default_rng(seed)
    out = []
    for m in n:
        if kind == "ties":          # every row has tied classes
            x = rng.integers(0, 3, (m, classes)).astype(np.float32)
        else:
            x = rng.standard_normal((m, classes)).astype(np.float32)
        hi = classes + 3 if kind == "out_of_range" else classes
        out.append((x, rng.integers(0, hi, m).astype(np.int32)))
    return out


@pytest.mark.parametrize("kind", ["random", "ties", "out_of_range"])
@pytest.mark.parametrize("print_freq", [1, 10])
def test_validate_matches_jax(kind, print_freq, caplog):
    import torch

    batches = _logit_batches(kind)
    with caplog.at_level(logging.INFO):
        got = p_metrics.validate(iter(batches), torch.as_tensor, print_freq)
    want = j_metrics.validate(iter(batches), jnp.asarray, print_freq)
    assert got[1:] == want[1:]
    if kind == "out_of_range":
        assert np.isnan(got[0]) and np.isnan(want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    lines = [r.getMessage() for r in caplog.records]
    assert sum(m.startswith("Test: [") for m in lines) == \
        len(range(0, 3, print_freq))
    assert any(m.startswith(" * Prec@1") for m in lines)
    assert any(m.startswith(" * 39 images in") for m in lines)


def test_tied_row_counts_toward_lower_index():
    """A row of equal logits: top-1 is class 0 and top-5 classes 0-4, as
    jax.lax.top_k orders ties."""
    import torch

    logits = np.zeros((4, 8), np.float32)
    logits[3, 6] = 1.0                      # a clear winner: class 6
    labels = np.asarray([0, 4, 5, 6], np.int32)
    got = p_metrics.batch_metrics(torch.as_tensor(logits),
                                  torch.as_tensor(labels)).tolist()
    want = j_metrics._batch_metrics(jnp.asarray(logits), jnp.asarray(labels))
    assert got[1:] == [2.0, 3.0] == [float(want[1]), float(want[2])]
    np.testing.assert_allclose(got[0], float(want[0]), rtol=1e-6)


def test_average_meter():
    m = p_metrics.AverageMeter()
    assert m.avg == 0.0
    m.update(2.0, 3)
    m.update(4.0, 1)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 10.0, 4, 2.5)


def test_native_build_failure_keeps_the_compiler_tail(monkeypatch, caplog):
    """A failed build leaves decoding to PIL and keeps why: the error's
    first line and the tail of the compiler's output, also in the log."""
    lines = [f"adalog_data.cpp:{i}: note: context line" for i in range(50)]
    err = "\n".join(["adalog_data.cpp: g++ failed (1):"] + lines
                    + ["fatal error: jpeglib.h: No such file or directory"])

    def fail():
        raise RuntimeError(err)

    monkeypatch.setattr(p_native, "build", fail)
    monkeypatch.setattr(p_native, "_tried", False)
    monkeypatch.setattr(p_native, "_lib", None)
    monkeypatch.setattr(p_native, "_reason", None)
    with caplog.at_level(logging.INFO, logger="adalog_tpu_torch"):
        assert not p_native.available()
    why = p_native.unavailable_reason().splitlines()
    assert why[0] == "adalog_data.cpp: g++ failed (1):"
    assert why[-1] == "fatal error: jpeglib.h: No such file or directory"
    assert len(why) == 1 + p_native.ERROR_TAIL_LINES
    assert "jpeglib.h: No such file" in caplog.text
