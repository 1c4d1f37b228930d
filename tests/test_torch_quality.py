"""The port trained to ``quality.py``'s bars, on the CPU, through
``neural_networks_parallel_training_with_mpi_tpu_torch.quality`` (the
same four configurations and pass rules; ``quality.py`` imports the JAX
package and stays as it is).

* the toy regression by ``quality.py:84``'s rule against the plain-torch
  reference loop, both from the loop's own initial weights;
* digits: held-out accuracy >= 0.95;
* the byte LM on the repo's ``*.md``, plain and modern: held-out
  perplexity under the corpus's unigram perplexity.  About 30 s each on
  the CPU, so marked slow; the card trains both in ``chip_smoke.py``'s
  phase 14.

``quality.py`` trains on an 8-device mesh.  The port trains in one
process on the whole global batch, which takes the same global-mean
gradient.
"""

import math

import pytest

from neural_networks_parallel_training_with_mpi_tpu_torch import quality

pytestmark = pytest.mark.torch_port


def test_toy_regression_reaches_the_reference_mse():
    rec = quality.run_toy(device="cpu")
    assert math.isfinite(rec["framework_final_mse"])
    assert rec["pass"], rec


def test_toy_rule_fails_a_model_that_predicts_the_mean():
    """The rule has teeth: the mean predictor's MSE (the targets'
    variance, about 2508 here) fails it."""
    theirs, _ = quality.reference_toy(epochs=1)
    assert not quality.toy_passes(theirs, 0.2918)


def test_digits_reaches_95_percent():
    rec = quality.run_digits(device="cpu")
    assert rec["pass"], rec


def test_unigram_bar():
    """Four equally frequent bytes: perplexity 4; the repo's corpus sits
    between that and the 256 of uniform bytes."""
    assert quality.unigram_ppl(b"abcd" * 100) == pytest.approx(4.0)
    assert 4.0 < quality.unigram_ppl(quality.docs_corpus()) < 256.0


@pytest.mark.slow
@pytest.mark.parametrize("modern", [False, True], ids=["plain", "modern"])
def test_docs_lm_beats_the_unigram_perplexity(modern):
    rec = quality.run_docs_lm(device="cpu", modern=modern)
    assert rec["pass"], rec
