"""The port stands alone: no module of it, and not ``chip_smoke.py``,
imports JAX or the JAX package, or loads a module of either by file
path; importing it (the observability modules, the autopilot, the
control-plane driver, the chaos campaigns and the port's tools included)
loads no JAX; its entry points default to the GPU and refuse to run
quietly on the CPU.  The repository's ``tools/``, which loads the JAX
package's stdlib-only modules by path, is not part of the port; the
port's own ``tools/`` is."""

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "neural_networks_parallel_training_with_mpi_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "neural_networks_parallel_training_with_mpi_tpu")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not (_imported_roots(path) & set(FORBIDDEN))


# ways to run a module's code without an import statement
_PATH_LOADERS = ("spec_from_file_location", "SourceFileLoader",
                 "run_path", "import_module", "exec(", "__import__(\"jax",
                 "__import__('jax")


# the port's modules that load the port's own stdlib-only modules by
# file path, as the JAX package's chaos campaign does: utils/chaos.py (its
# ``python -S`` children, and the package when it was itself loaded by
# path), tools/chaos_campaign.py (chaos.py, so the lite plan needs no
# torch), and the ckpt_manifest fallback of the two modules those
# children load.  Each builds its paths from its own ``__file__``;
# tests/test_torch_chaos.py reads the paths a campaign really loads.
FILE_LOADERS = {"utils/chaos.py", "tools/chaos_campaign.py",
                "train/resilience.py", "serve/wal.py"}
_JAX_PKG_NAME = re.compile(r"neural_networks_parallel_training_with_mpi_tpu"
                           r"(?!_torch)")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_loaded_by_file_path(path):
    """No loader outside :data:`FILE_LOADERS`, so a path into the JAX
    package (``chip_smoke.py`` names the TPU kernels' file in its report)
    cannot become a module; inside them, the JAX package is not named at
    all."""
    text = path.read_text()
    rel = path.relative_to(PORT).as_posix() if PORT in path.parents else ""
    if rel in FILE_LOADERS:
        assert [w for w in _PATH_LOADERS if w in text]
        assert not _JAX_PKG_NAME.search(text)
    else:
        assert not [w for w in _PATH_LOADERS if w in text]


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import neural_networks_parallel_training_with_mpi_tpu_torch"
            ".serve, neural_networks_parallel_training_with_mpi_tpu_torch"
            ".interop, neural_networks_parallel_training_with_mpi_tpu_torch"
            ".cli, neural_networks_parallel_training_with_mpi_tpu_torch"
            ".train.trainer\n"
            "from neural_networks_parallel_training_with_mpi_tpu_torch.train "
            "import telemetry, trace\n"
            "from neural_networks_parallel_training_with_mpi_tpu_torch.utils "
            "import chaos, compile_ledger, goodput, jsonl, profiling, "
            "sketches\n"
            "from neural_networks_parallel_training_with_mpi_tpu_torch.serve "
            "import autopilot, ctrlplane_driver\n"
            "from neural_networks_parallel_training_with_mpi_tpu_torch.tools "
            "import chaos_campaign, serve_fleet\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_the_gpu(tmp_path):
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        DecodeServer, Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch import cli
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        InprocReplica, Scheduler, ServeConfig, TPGenerateReplica,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve.fleet import (
        worker_main,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        TrainConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (
        world_setup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.platform import (
        resolve_device,
    )

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        Transformer(TransformerConfig())
    # the serving entry points, over a model built on the CPU
    model = Transformer(TransformerConfig(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeServer(model, params)
    for role in ("unified", "prefill", "decode"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Scheduler(model, params, ServeConfig(role=role))
    # the fleet's replicas and its worker process (--platform gpu default)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InprocReplica(Scheduler(model, params, ServeConfig()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPGenerateReplica(model, params, LocalTensorGroup(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker_main(["--worker", "--layers", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        world_setup()
    for platform in ("auto", "gpu"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--nepochs", "1", "--platform", platform])
    # the control loop's entry points: the driver, a fleet chaos scenario
    # and the port's tools, each before any process starts
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        ctrlplane_driver,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.tools import (
        chaos_campaign, serve_fleet,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        chaos,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctrlplane_driver.main(["--out", os.devnull])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.run_scenario({"name": "f", "kind": "fleet", "mode": "kill"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_fleet.main(["--replicas", "1"])
    plan = chaos.load_plan("full")
    plan["scenarios"] = [sc for sc in plan["scenarios"]
                         if sc.get("mode") == "ctrlplane"]
    plan_file = tmp_path / "ctrlplane-plan.json"
    plan_file.write_text(json.dumps(plan))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos_campaign.main([str(plan_file), "--repeat", "1", "--quiet"])


def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(tmp_path):
    """On a machine without a GPU, and alone in a directory, the chip
    smoke test exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        env = _clean_env()
        if cwd == tmp_path:
            env.pop("PYTHONPATH")
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
