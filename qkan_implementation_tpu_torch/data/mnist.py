"""MNIST / digits loading for the classification pipeline.

Counterpart of ``qkan_implementation_tpu.data.mnist``, numpy only.  The
loader resolves, in order:

1. raw MNIST idx files (train-images-idx3-ubyte etc.) under ``root``;
2. an ``mnist.npz`` (Keras-style: x_train/y_train/x_test/y_test) under
   ``root``;
3. the UCI handwritten digits (1797 8x8 images, 10 classes) as a
   stand-in, flagged in the returned metadata.

The digits corpus is ``digits.csv.gz`` beside this module: scikit-learn's
copy of the UCI optdigits test set (its ``sklearn/datasets/data/
digits.csv.gz``, 64 pixel values 0-16 and the label on each line), read
here with numpy so that ``load_digits()`` is never needed; the arrays
equal ``sklearn.datasets.load_digits()``'s.

Images are flattened and scaled to [0, 1] like the reference's
``.reshape(-1, 784).float() / 255`` (fixed_kan_tests.py:325).
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DIGITS_CSV = Path(__file__).with_name("digits.csv.gz")


def _load_digits():
    """(pixels [1797, 64] float64 in 0..16, labels [1797] int64)."""
    data = np.loadtxt(_DIGITS_CSV, delimiter=",")
    return data[:, :-1], data[:, -1].astype(np.int64)


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(root: Path, names: list[str]) -> Path | None:
    for name in names:
        for cand in (root / name, root / (name + ".gz")):
            if cand.exists():
                return cand
    return None


def _bilinear_upsample(imgs: np.ndarray, size: int = 28) -> np.ndarray:
    """[N, s, s] -> [N, size, size] bilinear (align-corners) upsampling."""
    s = imgs.shape[1]
    xs = np.linspace(0.0, s - 1.0, size)
    i0 = np.floor(xs).astype(int)
    i1 = np.minimum(i0 + 1, s - 1)
    f = xs - i0
    rows = (
        imgs[:, i0, :] * (1.0 - f)[None, :, None]
        + imgs[:, i1, :] * f[None, :, None]
    )
    return (
        rows[:, :, i0] * (1.0 - f)[None, None, :]
        + rows[:, :, i1] * f[None, None, :]
    )


def _augment(x_img: np.ndarray, y: np.ndarray, target: int, seed: int):
    """Grow a [N, s, s] image set to ``target`` samples with random +/-2 px
    shifts and mild noise (zero-filled edges).  Returns ([target, s, s],
    [target])."""
    rng = np.random.default_rng(seed)
    n = len(x_img)
    idx = rng.integers(0, n, target - n)
    extra = x_img[idx].copy()
    shifts = rng.integers(-2, 3, (len(extra), 2))
    for i, (dy, dx) in enumerate(shifts):
        img = np.roll(extra[i], (dy, dx), axis=(0, 1))
        if dy > 0:
            img[:dy] = 0.0
        elif dy < 0:
            img[dy:] = 0.0
        if dx > 0:
            img[:, :dx] = 0.0
        elif dx < 0:
            img[:, dx:] = 0.0
        extra[i] = img
    extra = np.clip(
        extra + rng.normal(0, 0.02, extra.shape), 0.0, 1.0
    )
    return (
        np.concatenate([x_img, extra]),
        np.concatenate([y, y[idx]]),
    )


def load_digits_784(
    train: bool = True, augment_to: int | None = None, seed: int = 0
):
    """The MNIST-shaped stand-in built from the committed corpus: the
    digits (real 8x8 handwritten-digit scans) bilinearly upsampled
    to 28x28 = 784 features, optionally augmented (shift/noise) to
    ``augment_to`` training samples.

    This is NOT MNIST -- results are labeled 'digits-784' (or
    'digits-784-aug') so they are never presented as MNIST accuracies
    (VERDICT r1: benchmark provenance).  It does exercise the reference's
    exact workload shape [784, 32, 16, 16, 10] on real image data
    (fixed_kan_tests.py:293-410).
    """
    pixels, y = _load_digits()
    imgs = pixels.reshape(-1, 8, 8) / 16.0  # [N, 8, 8]
    n_train = int(0.8 * len(imgs))
    if train:
        imgs, y = imgs[:n_train], y[:n_train]
    else:
        imgs, y = imgs[n_train:], y[n_train:]
    source = "digits-784"
    if train and augment_to and augment_to > len(imgs):
        imgs, y = _augment(imgs, y, augment_to, seed)
        source = "digits-784-aug"
    up = _bilinear_upsample(imgs, 28)
    return up.reshape(-1, 784), y, {"source": source, "image_dim": 784}


def load_mnist(root: str | None = None, train: bool = True):
    """Load (x [N, D] in [0,1], y [N] int labels, meta dict).

    ``meta['source']`` is 'mnist-idx', 'mnist-npz', or 'digits'.
    """
    roots = [Path(root)] if root else [Path("./data"), Path("./data/MNIST/raw")]
    for r in roots:
        if not r.exists():
            continue
        img_name = (
            ["train-images-idx3-ubyte", "train-images.idx3-ubyte"]
            if train
            else ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"]
        )
        lbl_name = (
            ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"]
            if train
            else ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"]
        )
        img_path = _find(r, img_name)
        lbl_path = _find(r, lbl_name)
        if img_path and lbl_path:
            x = _read_idx(img_path).reshape(-1, 784).astype(np.float64) / 255.0
            y = _read_idx(lbl_path).astype(np.int64)
            return x, y, {"source": "mnist-idx", "image_dim": 784}
        npz = r / "mnist.npz"
        if npz.exists():
            data = np.load(npz)
            split = "train" if train else "test"
            x = data[f"x_{split}"].reshape(-1, 784).astype(np.float64) / 255.0
            y = data[f"y_{split}"].astype(np.int64)
            return x, y, {"source": "mnist-npz", "image_dim": 784}

    # stand-in: the digits corpus (8x8), deterministic split
    pixels, y = _load_digits()
    x = pixels / 16.0
    n_train = int(0.8 * len(x))
    if train:
        x, y = x[:n_train], y[:n_train]
    else:
        x, y = x[n_train:], y[n_train:]
    return x, y, {"source": "digits", "image_dim": 64}


def to_one_hot(labels: np.ndarray, num_classes: int = 10) -> np.ndarray:
    """One-hot targets, like the reference's scatter_ (fixed_kan_tests.py:330)."""
    out = np.zeros((len(labels), num_classes), dtype=np.float64)
    out[np.arange(len(labels)), labels] = 1.0
    return out


def sample_train_subset(x, y, train_size: int, seed: int = 0):
    """Random permutation subset (fixed_kan_tests.py:323-325)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))[:train_size]
    return x[idx], y[idx]
