"""The port's hang watchdog (``utils/watchdog.py``, ``--hang_timeout``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_watchdog_interop.py``: quiet while patted, fires on
a stall (the hard exit injected), never fires unarmed, suspended phases
do not count, off when the timeout is 0; the trainer's rule that
``--hang_timeout`` needs ``log_every > 0``, with JAX's message; and the
CLI with ``--faults peer_hang@N``: the loop stalls, the watchdog dumps
every thread's stack and the process exits 42.
"""

import os
import pathlib
import subprocess
import sys
import time

import pytest

from neural_networks_parallel_training_with_mpi_tpu.config import (
    TrainConfig as JaxTrainConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import (
    make_mesh,
)
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu.utils.watchdog import (
    HangWatchdog as JaxHangWatchdog,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    TrainConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.watchdog import (
    HangWatchdog,
)

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent
CLASSES = [HangWatchdog, JaxHangWatchdog]
IDS = ["port", "jax"]


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_watchdog_quiet_on_progress(cls):
    fired = []
    with cls(0.4, _exit=fired.append) as wd:
        for _ in range(8):
            wd.pat()
            time.sleep(0.05)
    assert fired == []


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_watchdog_fires_on_stall(cls, capfd):
    fired = []
    with cls(0.2, _exit=fired.append) as wd:
        wd.pat()
        time.sleep(0.6)
    assert fired == [42]
    assert "HANG DETECTED" in capfd.readouterr().err


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_watchdog_unarmed_and_suspended(cls):
    """No pat yet: never fires (the first step builds and captures); a
    suspended phase longer than the timeout does not count."""
    fired = []
    with cls(0.2, _exit=fired.append):
        time.sleep(0.5)
    with cls(0.2, _exit=fired.append) as wd:
        wd.pat()
        with wd.suspended():
            time.sleep(0.5)
        wd.pat()
    assert fired == []


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_watchdog_disabled_is_noop(cls):
    with cls(0, _exit=lambda c: pytest.fail("fired")) as wd:
        assert wd._thread is None
        wd.pat()


def test_hang_timeout_needs_log_every_as_jax():
    """The lag-1 loss read is the loop's only blocking point on the card
    too: --hang_timeout without log_every is refused with JAX's
    message."""
    import jax

    with pytest.raises(ValueError) as want:
        JaxTrainer(JaxTrainConfig(hang_timeout=5.0, log_every=0),
                   mesh=make_mesh(JaxTrainConfig().mesh,
                                  devices=jax.devices("cpu")[:1]))
    with pytest.raises(ValueError) as got:
        Trainer(TrainConfig(hang_timeout=5.0, log_every=0), device="cpu")
    assert str(got.value) == str(want.value)


def test_cli_peer_hang_exits_42_with_stacks():
    """The reference toy job with --hang_timeout 1 and a host hang at step
    3: the watchdog (armed at the first pat) dumps the threads' stacks and
    exits 42 within a few poll periods."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env.pop("NNPT_FAULTS", None)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m",
         "neural_networks_parallel_training_with_mpi_tpu_torch",
         "--platform", "cpu", "--n_samples", "32", "--batch_size", "8",
         "--no-full-batch", "--nepochs", "4", "--hang_timeout", "1",
         "--faults", "peer_hang@3"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO))
    secs = time.monotonic() - t0
    assert proc.returncode == 42, proc.stderr[-2000:]
    assert "injected peer_hang at step 3" in proc.stderr
    assert "HANG DETECTED" in proc.stderr
    # faulthandler's dump: every thread, the main one wedged in the fault
    assert "most recent call first" in proc.stderr
    assert "in apply" in proc.stderr
    assert secs < 60
