"""Dataset builders (numpy), the port of the JAX package's
``data/datasets.py``.

``regression_dataset`` is the reference workload: sklearn
``make_regression(n_samples=16, n_features=2, noise=1, random_state=42)``
(dataParallelTraining_NN_MPI.py:72), globally standardized.  The port
carries its own numpy copy of that generator (``make_regression``, the
same draws from ``np.random.RandomState`` in the same order), so the
reference job needs no sklearn on the GPU machine; the tests hold it
equal to sklearn's.  ``digits_dataset`` reads ``digits.csv.gz`` beside
this module, a copy of the file sklearn's ``load_digits`` reads (the UCI
optical-digits test set, bundled with scikit-learn under its BSD-3
licence), so it needs no sklearn either; the tests hold it equal to
``load_digits``.  MNIST/CIFAR-10/LM builders read real data under
``data_dir`` when present and otherwise make deterministic synthetic
stand-ins of the right shapes.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import DataConfig

Arrays = Dict[str, np.ndarray]


def standardize(x: np.ndarray) -> np.ndarray:
    """Global z-score over axis 0."""
    mean = x.mean(axis=0, keepdims=True)
    std = x.std(axis=0, keepdims=True)
    return (x - mean) / np.where(std == 0.0, 1.0, std)


def make_regression(n_samples: int, n_features: int, noise: float,
                    seed: int, n_informative: int = 10
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn's ``make_regression`` with its defaults (one target, bias 0,
    no effective rank, shuffled): standard-normal X, a ground truth of
    ``100 * U(0, 1)`` on the informative features, Gaussian noise, then
    the sample and feature shuffles — the same draws in the same order."""
    rng = np.random.RandomState(seed)
    n_informative = min(n_features, n_informative)
    x = rng.standard_normal(size=(n_samples, n_features))
    truth = np.zeros((n_features, 1))
    truth[:n_informative, :] = 100 * rng.uniform(size=(n_informative, 1))
    y = np.dot(x, truth)
    if noise > 0.0:
        y += rng.normal(scale=noise, size=y.shape)
    rows = np.arange(n_samples)
    rng.shuffle(rows)
    x, y = x[rows], y[rows]
    cols = np.arange(n_features)
    rng.shuffle(cols)
    x[:, :] = x[:, cols]
    return x, np.squeeze(y)


def regression_dataset(n_samples: int = 16, n_features: int = 2,
                       noise: float = 1.0, seed: int = 42,
                       do_standardize: bool = True) -> Arrays:
    """The reference's dataset (reference :72), X globally standardized."""
    x, y = make_regression(n_samples, n_features, noise, seed)
    x = x.astype(np.float32)
    y = y.astype(np.float32).reshape(-1, 1)
    if do_standardize:
        x = standardize(x)
    return {"x": x, "y": y}


DIGITS_CSV = Path(__file__).with_name("digits.csv.gz")


def digits_dataset(seed: int = 0, do_standardize: bool = True) -> Arrays:
    """sklearn ``load_digits``: 1797 real 8x8 digit images, x (N, 64)
    float32, y (N,) int32, rows shuffled by ``seed``.  Each CSV row is
    the 64 pixels, then the label."""
    d = np.loadtxt(DIGITS_CSV, delimiter=",")
    x = d[:, :-1].astype(np.float32)
    y = d[:, -1].astype(np.int32)
    if do_standardize:
        x = standardize(x)
    order = np.random.default_rng(seed).permutation(len(x))
    return {"x": x[order], "y": y[order]}


def _load_idx_images(path: Path) -> Optional[np.ndarray]:
    """Minimal IDX reader for locally present MNIST files."""
    import gzip
    import struct

    opener = gzip.open if path.suffix == ".gz" else open
    try:
        with opener(path, "rb") as f:
            magic, = struct.unpack(">I", f.read(4))
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            data = np.frombuffer(f.read(), dtype=np.uint8)
            return data.reshape(dims)
    except (OSError, ValueError):
        return None


def mnist_dataset(data_dir: Optional[str] = None, seed: int = 0,
                  n_samples: int = 60_000) -> Arrays:
    """Real MNIST if idx files exist under data_dir, else synthetic with
    identical shapes: x (N, 784) float32, y (N,) int32 in [0, 10)."""
    if data_dir:
        d = Path(data_dir)
        imgs = _load_idx_images(d / "train-images-idx3-ubyte.gz") \
            if (d / "train-images-idx3-ubyte.gz").exists() else \
            _load_idx_images(d / "train-images-idx3-ubyte")
        labs = _load_idx_images(d / "train-labels-idx1-ubyte.gz") \
            if (d / "train-labels-idx1-ubyte.gz").exists() else \
            _load_idx_images(d / "train-labels-idx1-ubyte")
        if imgs is not None and labs is not None:
            x = imgs.reshape(imgs.shape[0], -1).astype(np.float32) / 255.0
            return {"x": x, "y": labs.astype(np.int32)}
    rng = np.random.default_rng(seed)
    x = rng.random((n_samples, 784), dtype=np.float32)
    y = rng.integers(0, 10, size=n_samples).astype(np.int32)
    return {"x": x, "y": y}


def cifar10_dataset(data_dir: Optional[str] = None, seed: int = 0,
                    n_samples: int = 50_000) -> Arrays:
    """CIFAR-10 NHWC: x (N, 32, 32, 3) float32, y (N,) int32."""
    if data_dir:
        d = Path(data_dir) / "cifar-10-batches-py"
        if d.exists():
            import pickle

            xs, ys = [], []
            for i in range(1, 6):
                with open(d / f"data_batch_{i}", "rb") as f:
                    batch = pickle.load(f, encoding="bytes")
                xs.append(batch[b"data"])
                ys.append(batch[b"labels"])
            x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return {"x": x.astype(np.float32) / 255.0,
                    "y": np.concatenate(ys).astype(np.int32)}
    rng = np.random.default_rng(seed)
    x = rng.random((n_samples, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 10, size=n_samples).astype(np.int32)
    return {"x": x, "y": y}


def lm_dataset(seq_len: int = 128, vocab_size: int = 256, seed: int = 0,
               n_samples: int = 2048, data_dir: Optional[str] = None) -> Arrays:
    """Next-token LM data: x (N, T) int32 tokens, y (N, T) int32 shifted
    targets, from a local text file when present, else a seeded stream."""
    text_path = None
    if data_dir:
        for name in ("wiki.train.tokens", "wikitext-2/wiki.train.tokens",
                     "train.txt"):
            p = Path(data_dir) / name
            if p.exists():
                text_path = p
                break
    if text_path is not None:
        raw = np.frombuffer(text_path.read_bytes(), dtype=np.uint8)
        tokens = (raw % vocab_size).astype(np.int32)
    else:
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, vocab_size,
                              size=n_samples * (seq_len + 1)).astype(np.int32)
    n = min(n_samples, len(tokens) // (seq_len + 1))
    tokens = tokens[: n * (seq_len + 1)].reshape(n, seq_len + 1)
    return {"x": tokens[:, :-1].copy(), "y": tokens[:, 1:].copy()}


def text_dataset(text_file: str, seq_len: int = 128, vocab_size: int = 256,
                 n_samples: Optional[int] = None) -> Arrays:
    """Byte-level next-token windows over a local text file:
    non-overlapping (seq_len + 1)-byte windows, x/y shifted by one; vocabs
    under 256 fold bytes by modulo."""
    p = Path(text_file)
    if not p.exists():
        raise FileNotFoundError(f"--text_file {text_file!r} does not exist")
    raw = np.frombuffer(p.read_bytes(), dtype=np.uint8).astype(np.int32)
    tokens = raw if vocab_size >= 256 else raw % vocab_size
    n_avail = len(tokens) // (seq_len + 1)
    if n_avail == 0:
        raise ValueError(
            f"{text_file}: {len(tokens)} bytes < one window of "
            f"seq_len+1={seq_len + 1}")
    n = min(n_samples, n_avail) if n_samples else n_avail
    tokens = tokens[: n * (seq_len + 1)].reshape(n, seq_len + 1)
    return {"x": tokens[:, :-1].copy(), "y": tokens[:, 1:].copy()}


def train_val_split(data: Arrays, val_fraction: float,
                    seed: int = 0) -> Tuple[Arrays, Arrays]:
    """Deterministic shuffled train/validation split, the same on every
    rank."""
    if not 0.0 <= val_fraction < 1.0:
        raise ValueError(f"val_fraction must be in [0, 1), got {val_fraction}")
    n = next(iter(data.values())).shape[0]
    n_val = int(round(n * val_fraction))
    if n_val == 0:
        return data, {}
    if n_val >= n:
        raise ValueError(
            f"val_fraction={val_fraction} leaves no training samples (n={n})")
    perm = np.random.default_rng(seed).permutation(n)
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    train = {k: v[train_idx] for k, v in data.items()}
    val = {k: v[val_idx] for k, v in data.items()}
    return train, val


def build_dataset(cfg: DataConfig, data_dir: Optional[str] = None) -> Arrays:
    data_dir = data_dir or os.environ.get("NNPT_DATA_DIR")
    if cfg.dataset == "regression":
        return regression_dataset(cfg.n_samples or 16, cfg.n_features,
                                  cfg.noise, cfg.seed, cfg.standardize)
    if cfg.dataset == "wide_regression":
        return regression_dataset(cfg.n_samples or 1_000_000, cfg.n_features,
                                  cfg.noise, cfg.seed, cfg.standardize)
    if cfg.dataset == "digits":
        return digits_dataset(cfg.seed, cfg.standardize)
    if cfg.dataset == "mnist":
        return mnist_dataset(data_dir, cfg.seed,
                             n_samples=cfg.n_samples or 60_000)
    if cfg.dataset == "cifar10":
        return cifar10_dataset(data_dir, cfg.seed,
                               n_samples=cfg.n_samples or 50_000)
    if cfg.dataset == "lm":
        return lm_dataset(cfg.seq_len, cfg.vocab_size, cfg.seed,
                          n_samples=cfg.n_samples or 2048, data_dir=data_dir)
    if cfg.dataset == "text":
        if not cfg.text_file:
            raise ValueError("dataset='text' needs --text_file")
        return text_dataset(cfg.text_file, cfg.seq_len, cfg.vocab_size,
                            n_samples=cfg.n_samples)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
