"""The quality bars of the repo's ``quality.py``, trained through the port.

``quality.py`` imports the JAX package and trains it; this module holds
the same four configurations for the port's ``Trainer`` and the same
pass rules, for the CPU tests (``tests/test_torch_quality.py``) and the
card (``chip_smoke.py`` phase 14):

* ``toy``: the reference's own workload, its 2->3->1 MLP on its
  16-sample regression, lr 0.01, momentum 0.9, 2000 epochs, full batch,
  no shuffle (``quality.py:43-51``), against the plain-torch loop
  ``quality.py:57-72`` re-expresses the reference with.  Pass:
  final MSE <= 1.1 x the reference's + 0.02 (``quality.py:84``).  Both
  start from the same weights, the reference loop's ``torch.manual_seed``
  draw: this workload is an init lottery (unnormalised targets, lr 0.01
  with momentum 0.9), which the plain loop itself loses on most seeds, so
  two independent draws would compare luck, not training;
* ``digits``: sklearn's 1797 real 8x8 images, 30 epochs of Adam; pass:
  held-out accuracy >= 0.95 (``quality.py:96-103``);
* ``docs_lm`` and ``docs_lm_modern``: the byte LM on the repo's ``*.md``
  corpus, plain and modern (RoPE, SwiGLU, 2 of 4 KV heads); pass:
  held-out perplexity under the corpus's unigram perplexity, recomputed
  from the corpus as ``quality.py:136-139`` does (``quality.py:116-177``).

``quality.py`` trains on an 8-device mesh.  The port trains in one
process on the whole global batch, which takes the same global-mean
gradient.
"""

from __future__ import annotations

import math
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .config import DataConfig, ModelConfig, TrainConfig
from .data.datasets import regression_dataset
from .train.state import TrainState
from .train.trainer import Trainer
from .utils.platform import DeviceLike

REPO = Path(__file__).resolve().parent.parent
TOY_EPOCHS = 2000


def toy_config() -> TrainConfig:
    return TrainConfig(lr=0.01, momentum=0.9, nepochs=TOY_EPOCHS,
                       full_batch=True, shuffle=False, log_every=0,
                       data=DataConfig(dataset="regression"),
                       model=ModelConfig())


def reference_toy(epochs: int = TOY_EPOCHS, seed: int = 0
                  ) -> Tuple[float, List[Dict[str, torch.Tensor]]]:
    """The reference's loop in plain torch on the host (``nn.Sequential``
    MLP, ``torch.optim.SGD`` with momentum, full-batch MSE): its final MSE
    and its initial weights as the port's parameter tree."""
    d = regression_dataset()
    x = torch.tensor(d["x"], dtype=torch.float32)
    y = torch.tensor(d["y"], dtype=torch.float32)
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.ReLU(),
                                torch.nn.Linear(3, 1))
    init = [{"w": model[i].weight.detach().T.clone(),
             "b": model[i].bias.detach().clone()} if i != 1 else {}
            for i in range(3)]
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    loss_fn = torch.nn.MSELoss()
    for _ in range(epochs):
        opt.zero_grad()
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
    return float(loss.item()), init


def toy_passes(ours: float, theirs: float) -> bool:
    return ours <= 1.1 * theirs + 0.02


def run_toy(device: DeviceLike = None) -> Dict[str, Any]:
    theirs, init = reference_toy()
    trainer = Trainer(toy_config(), device=device)
    trainer.state = TrainState.from_params(
        [{k: v.to(trainer.device) for k, v in layer.items()}
         for layer in init], trainer.optimizer)
    ours = float(trainer.fit()["final_loss"])
    return {"config": "toy_regression_mse", "framework_final_mse": ours,
            "reference_final_mse": theirs, "epochs": TOY_EPOCHS,
            "pass": bool(toy_passes(ours, theirs))}


def digits_config() -> TrainConfig:
    return TrainConfig(
        lr=3e-3, nepochs=30, batch_size=128, full_batch=False,
        optimizer="adam", loss="cross_entropy", log_every=0, eval_every=30,
        data=DataConfig(dataset="digits", val_fraction=0.2),
        model=ModelConfig(arch="mlp", in_features=64, hidden=(64, 32),
                          out_features=10))


def run_digits(device: DeviceLike = None) -> Dict[str, Any]:
    res = Trainer(digits_config(), device=device).fit()
    acc = float(res.get("val_accuracy", 0.0))
    return {"config": "digits_real_data_accuracy", "val_accuracy": acc,
            "val_loss": float(res.get("val_loss", float("nan"))),
            "target": 0.95, "pass": bool(acc >= 0.95)}


def docs_corpus() -> bytes:
    return b"".join(p.read_bytes() for p in sorted(REPO.glob("*.md")))


def unigram_ppl(corpus: bytes) -> float:
    """The perplexity of the corpus's own byte frequencies."""
    counts = np.bincount(np.frombuffer(corpus, np.uint8), minlength=256)
    probs = counts[counts > 0] / counts.sum()
    return math.exp(-(probs * np.log(probs)).sum())


def docs_lm_config(text_file: str, modern: bool = False) -> TrainConfig:
    return TrainConfig(
        lr=3e-3, nepochs=6, batch_size=64, full_batch=False,
        optimizer="adam", loss="cross_entropy", log_every=0, eval_every=6,
        data=DataConfig(dataset="text", text_file=text_file, seq_len=128,
                        val_fraction=0.1),
        model=ModelConfig(arch="transformer", n_layers=2, d_model=64,
                          n_heads=4, d_ff=192 if modern else 256,
                          vocab_size=256, max_seq_len=128,
                          **(dict(pos_encoding="rope",
                                  ffn_activation="swiglu",
                                  n_kv_heads=2) if modern else {})))


def run_docs_lm(device: DeviceLike = None, modern: bool = False
                ) -> Dict[str, Any]:
    corpus = docs_corpus()
    bar = unigram_ppl(corpus)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "corpus.txt"
        path.write_bytes(corpus)
        res = Trainer(docs_lm_config(str(path), modern), device=device).fit()
    ppl = float(res.get("val_ppl", float("inf")))
    return {"config": ("docs_text_lm_perplexity_modern_stack" if modern
                       else "docs_text_lm_perplexity"),
            "val_ppl": ppl, "unigram_ppl_bar": bar,
            "corpus_bytes": len(corpus), "pass": bool(ppl < bar)}
