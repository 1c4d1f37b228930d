"""The port's sliced training state (``parallel.tensor_parallel``'s rules
and ``StateLayout``) against the JAX package, on the CPU.

The rules equal JAX's ``param_specs`` leaf for leaf (tensor and fsdp
dims) on the grid of JAX's ``tests/test_tensor_parallel.py``
(``data=2 x tensor=4``, ``data=2 x tensor=2 x fsdp=2``, ``fsdp=8``) for
the transformer and the MLP; each rank's share of the flagship's state
under ``--tp 4`` and ``--tp 2`` counted from the tensors a rank holds
(on the meta device: no bytes); snapshots of a sliced run over gloo
ranks are the dense arrays, bitwise those of the whole-state run of the
same job, and restore under another tp / fsdp bitwise.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.config import MeshConfig
from neural_networks_parallel_training_with_mpi_tpu.models.registry import (
    build_model as jax_build_model,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    tensor_parallel as jtp,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models import core
from neural_networks_parallel_training_with_mpi_tpu_torch.models.registry import (
    build_model,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    tensor_parallel as tp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
    LocalTensorGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (
    leaves,
)
from torch_fsdp_child import LM, MLP, spawn

pytestmark = pytest.mark.torch_port

GRID = [MeshConfig(data=2, tensor=4), MeshConfig(data=2, tensor=2, fsdp=2),
        MeshConfig(data=1, fsdp=8)]


def _leaf_spec(spec):
    def dim(axis):
        dims = [i for i, a in enumerate(spec) if a == axis]
        return dims[0] if dims else None

    return tp.LeafSpec(dim("tensor"), dim("fsdp"))


@pytest.mark.parametrize("flags", [LM, LM + ["--n_kv_heads", "2"],
                                   LM + ["--vocab_size", "63"], MLP,
                                   ["--dataset", "regression"]],
                         ids=["transformer", "gqa", "odd_vocab", "mlp",
                              "reference"])
@pytest.mark.parametrize("mesh_cfg", GRID, ids=["d2t4", "d2t2f2", "f8"])
def test_rules_equal_jax_param_specs_on_the_grid(flags, mesh_cfg):
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    mesh = make_mesh(mesh_cfg, devices=jax.devices("cpu")[:8])
    jmodel = jax_build_model(jcfg.model)
    want = jax.tree_util.tree_map(
        _leaf_spec, jtp.param_specs(jmodel, jmodel.init(jprng.init_key(0)),
                                    mesh),
        is_leaf=lambda x: isinstance(x, P))
    model = build_model(config_from_args(build_argparser().parse_args(
        flags)).model, device="cpu")
    got = tp.param_specs(model, model.init(torch.Generator().manual_seed(0)),
                         mesh_cfg.tensor, mesh_cfg.fsdp)
    leaf = lambda x: isinstance(x, tp.LeafSpec)  # noqa: E731
    assert jax.tree_util.tree_structure(got, is_leaf=leaf) == \
        jax.tree_util.tree_structure(want, is_leaf=leaf)
    assert jax.tree_util.tree_leaves(got, is_leaf=leaf) == \
        jax.tree_util.tree_leaves(want, is_leaf=leaf)


class _Rank:
    """A process group's rank as the layout reads it, for slicing only."""

    pg = None

    def __init__(self, size, rank):
        self.size, self.rank = size, rank


FLAGSHIP = ["--dataset", "lm", "--seq_len", "1024", "--vocab_size", "32768",
            "--n_layers", "12", "--d_model", "1024", "--n_heads", "16",
            "--d_ff", "4096", "--ffn_activation", "gelu"]


@pytest.mark.parametrize("tensor,want", [(4, 80_837_632), (2, 126_996_480)])
def test_flagship_share_per_rank(monkeypatch, tensor, want):
    """Under ``--tp 4`` a rank holds 80,837,632 of the flagship's
    219,314,176 param values (the 12 layers' qkv / ff_in / attn_out /
    ff_out slices and the head's vocab slice, beside the whole
    embeddings and norms), and each Adam slot as many again: 0.97 GB of
    f32 params + mu + nu against 2.63 GB whole.  Counted from the tensors
    each rank's layout holds, on the meta device."""
    def meta(shape, *args, **kw):
        return torch.empty(shape, device="meta")

    monkeypatch.setattr(core, "_uniform", meta)
    monkeypatch.setattr(core, "_normal", meta)
    cfg = config_from_args(build_argparser().parse_args(FLAGSHIP))
    model = build_model(cfg.model, device="cpu")
    params = model.init(torch.Generator())
    whole = sum(x.numel() for x in leaves(params))
    assert whole == 219_314_176
    adam = optim.adam(1e-3, steps=1)
    for r in range(tensor):
        lay = tp.state_layout(model, params, _Rank(tensor, r))
        held = lay.local(params)
        mu_nu = [x for x in leaves(adam.init(held)) if x.dim()]
        assert sum(x.numel() for x in leaves(held)) == want
        assert sum(x.numel() for x in mu_nu) == 2 * want
    assert 12 * want / 1e9 == pytest.approx(0.97 if tensor == 4 else 1.52,
                                            abs=0.005)
    assert 12 * whole / 1e9 == pytest.approx(2.63, abs=0.005)


def _snapshot(path, step):
    """A snapshot's arrays in its leaf order (the step first)."""
    snap = dict(ckpt._snapshot_dirs(pathlib.Path(path)))[step]
    with np.load(snap / "state.npz") as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]


def _arrays(state):
    """A live state's leaves in the snapshot's order."""
    return [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
            for _, t in ckpt.flatten(state)]


def _port(flags, **kw):
    return Trainer(config_from_args(build_argparser().parse_args(flags)),
                   device="cpu", **kw)


@pytest.fixture(scope="module")
def sliced_snapshots(tmp_path_factory):
    """Two jobs over 4 gloo ranks that save: ``--tp 2 --fsdp 2`` and ``--dp
    2 --tp 2``, each from the seeded init."""
    tmp = tmp_path_factory.mktemp("tp_state")
    jobs = {}
    for name, extra in (("tp2_fsdp2", ["--tp", "2", "--fsdp", "2"]),
                        ("dp2_tp2", ["--dp", "2", "--tp", "2"])):
        jobs[name] = {"flags": LM + extra + [
            "--checkpoint_dir", str(tmp / name)], "fit": True}
    outs = spawn(str(tmp), 4, jobs)
    return tmp, outs


def test_sliced_snapshot_is_the_whole_state_layouts(sliced_snapshots,
                                                    tmp_path):
    """The ``--dp 2 --tp 2`` gloo run's snapshot (gathered from the ranks'
    slices) holds the dense arrays of its final state: its params are
    bitwise those the ranks gathered; it records ``qkv_tp`` 1 and the
    mesh; and the whole-state layout (a ``LocalTensorGroup(2)`` trainer)
    restores it and writes it again bitwise."""
    tmp, outs = sliced_snapshots
    ck = str(tmp / "dp2_tp2")
    meta = ckpt.read_meta(ck)
    assert meta["qkv_tp"] == 1
    assert meta["saved_world"]["mesh"]["tensor"] == 2
    step = meta["step"]
    t = _port(LM + ["--tp", "2", "--resume", "--checkpoint_dir", ck],
              tensor_group=LocalTensorGroup(2))
    t.init_state()
    assert t.maybe_resume() == step
    gathered = dict(jax.tree_util.tree_flatten_with_path(
        outs[0]["dp2_tp2"]["params"])[0])
    mine = dict(jax.tree_util.tree_flatten_with_path(
        tree_to_numpy(t.state.params))[0])
    assert gathered.keys() == mine.keys()
    for k, v in gathered.items():
        np.testing.assert_array_equal(mine[k], v)
    t.cfg = dataclasses.replace(t.cfg, checkpoint_dir=str(tmp_path))
    t.save(final=True)
    for a, b in zip(_snapshot(tmp_path, step), _snapshot(ck, step)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra,groups", [
    ([], {}), (["--tp", "4"], {"tensor_group": LocalTensorGroup(4)}),
    (["--tp", "2"], {"tensor_group": LocalTensorGroup(2)})],
    ids=["dense", "tp4_local", "tp2_local"])
def test_sliced_snapshot_restores_at_another_tp_fsdp(sliced_snapshots,
                                                     extra, groups):
    """The ``--tp 2 --fsdp 2`` ranks' snapshot restores into a dense, a
    ``--tp 4`` and a ``--tp 2`` trainer: params and every Adam slot
    bitwise the snapshot's arrays."""
    tmp, _ = sliced_snapshots
    ck = str(tmp / "tp2_fsdp2")
    step = ckpt.read_meta(ck)["step"]
    t = _port(LM + extra + ["--resume", "--checkpoint_dir", ck], **groups)
    t.init_state()
    assert t.maybe_resume() == step
    want = _snapshot(ck, step)
    got = _arrays(t.state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
