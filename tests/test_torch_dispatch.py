"""The port's multi-step dispatch (``--steps_per_dispatch k``) against its
k = 1 loop and against the JAX package's ``--steps_per_dispatch``.

On the CPU a dispatch is k eager steps (the CUDA-graph replay of the card
is checked by ``chip_smoke.py`` phase 16), so the port's k > 1 trajectory
must equal its k = 1 trajectory bitwise: the same batches in the same
order, the same ops.  Against the JAX package (``lax.scan`` over k staged
batches, ``tests/test_dispatch.py``), from the same initial weights: the
MLP within the DP parity tolerance of the port's tests (1e-5 rtol and
atol: f32 on both sides, summation order only); the LM with Adam within
the tolerance JAX's own k = 2 LM tests use against k = 1 (atol 1e-3, rtol
1e-2: Adam's grad / sqrt(v) turns f32 summation noise in near-zero
second moments into visible steps), its losses within 1e-5.  Also: the
optimizer's device scalars bitwise against the Python-float update, the
checkpoint crossing rule, a resume in the middle of a group and the
refusals.
"""

import dataclasses
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    DataConfig, ModelConfig, TrainConfig, build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (
    MULTI_PROCESS_DISPATCH, ShardedLoader,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.mlp import MLP
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import schedules
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    distributed,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (
    LocalSeqGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
    trainer as trainer_mod,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (
    leaves,
)

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
# JAX's own k = 2 against k = 1 LM tolerance (tests/test_dispatch.py)
ADAM_TOL = dict(rtol=1e-2, atol=1e-3)


def _flat(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_close(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def _fit(cfg, **kw):
    tr = trainer_mod.Trainer(cfg, device="cpu", **kw)
    res = tr.fit()
    return tr, res


def _params(tr):
    return [p.detach().clone() for p in leaves(tr.state.params)]


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the reference MLP on JAX's own dispatch configuration
# ---------------------------------------------------------------------------

def _mlp_cfg(**kw):
    """tests/test_dispatch.py's ``_base_cfg``: the reference 2-3-1 MLP, 16
    samples, batch 5 -> 4 steps per epoch, k 3 -> groups of 3 + 1."""
    cfg = dict(lr=0.01, momentum=0.9, nepochs=2, batch_size=5,
               full_batch=False, shuffle=True, log_every=0,
               data=DataConfig(dataset="regression"), model=ModelConfig())
    cfg.update(kw)
    return TrainConfig(**cfg)


def test_k3_is_k1_bitwise_on_the_reference_mlp():
    tr1, r1 = _fit(_mlp_cfg())
    tr3, r3 = _fit(_mlp_cfg(steps_per_dispatch=3))
    assert r1["steps"] == r3["steps"] == 8
    _assert_bitwise(_params(tr1), _params(tr3))
    assert r1["final_loss"] == r3["final_loss"]


def test_k3_matches_jax_k3_on_the_reference_mlp(monkeypatch, capsys):
    jcfg = jconfig.TrainConfig(
        lr=0.01, momentum=0.9, nepochs=2, batch_size=5, full_batch=False,
        shuffle=True, log_every=0,
        data=jconfig.DataConfig(dataset="regression"),
        model=jconfig.ModelConfig(), mesh=jconfig.MeshConfig(data=8),
        steps_per_dispatch=3)
    jt = JaxTrainer(jcfg)
    jt.init_state()
    init = jax.device_get(jt.state.params)
    jres = jt.fit()
    # the frameworks' random streams differ: start from JAX's init
    monkeypatch.setattr(MLP, "init",
                        lambda self, gen: tree_from_jax(init, "cpu"))
    tr, res = _fit(_mlp_cfg(steps_per_dispatch=3))
    assert res["steps"] == jres["steps"] == 8
    _assert_close(tree_to_numpy(tr.state.params),
                  jax.device_get(jt.state.params), **TOL)
    np.testing.assert_allclose(res["final_loss"], jres["final_loss"], **TOL)


# ---------------------------------------------------------------------------
# the LM: Adam, the fused chunked CE, flash attention
# ---------------------------------------------------------------------------

def _lm_flags(k, **over):
    """24 samples of T 32 in batches of 8 -> 3 steps per epoch, 2 epochs;
    k 2 -> groups of 2 + 1 per epoch."""
    flags = dict(dataset="lm", seq_len=32, n_samples=24, batch_size=8,
                 nepochs=2, optimizer="adam", lr=3e-3, attention="flash",
                 ce_chunk=8, vocab_size=64, n_layers=2, d_model=32,
                 n_heads=4, d_ff=64, steps_per_dispatch=k)
    flags.update(over)
    return ["--no-full-batch"] + [f"--{a}={b}" for a, b in flags.items()]


def _losses(path):
    import json

    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if "loss" in r}


def test_lm_adam_ce_chunk_k2_is_k1_bitwise(tmp_path):
    runs = {}
    for k in (1, 2):
        m = tmp_path / f"m{k}.jsonl"
        cfg = config_from_args(build_argparser().parse_args(
            _lm_flags(k, metrics_jsonl=m)))
        tr, res = _fit(cfg)
        runs[k] = (_params(tr), res, _losses(m))
    (p1, r1, l1), (p2, r2, l2) = runs[1], runs[2]
    assert r1["steps"] == r2["steps"] == 6
    _assert_bitwise(p1, p2)
    # each dispatch logs its last step: steps 2, 3, 5, 6 at k 2
    assert sorted(l2) == [2, 3, 5, 6]
    assert all(l2[s] == l1[s] for s in l2)


def test_lm_adam_ce_chunk_k2_matches_jax_k2(monkeypatch, mesh1):
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        _lm_flags(2)))
    jt = JaxTrainer(jcfg, mesh=mesh1)
    jt.init_state()
    init = jax.device_get(jt.state.params)
    jres = jt.fit()
    cfg = config_from_args(build_argparser().parse_args(_lm_flags(2)))
    monkeypatch.setattr(Transformer, "init", lambda self, gen:
                        params_from_jax(init, self.cfg, "cpu"))
    tr, res = _fit(cfg)
    assert res["steps"] == jres["steps"] == 6
    np.testing.assert_allclose(res["final_loss"], jres["final_loss"], **TOL)
    _assert_close(tree_to_numpy(tr.state.params),
                  jax.device_get(jt.state.params), **ADAM_TOL)


def test_striped_flash_local_group_k2_is_k1_bitwise():
    runs = {}
    for k in (1, 2):
        cfg = config_from_args(build_argparser().parse_args(
            _lm_flags(k, attention="striped_flash", sp=2)))
        tr, res = _fit(cfg, seq_group=LocalSeqGroup(2))
        runs[k] = (_params(tr), res)
    assert runs[1][1]["steps"] == runs[2][1]["steps"] == 6
    _assert_bitwise(runs[1][0], runs[2][0])
    assert runs[1][1]["final_loss"] == runs[2][1]["final_loss"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _snapshots(d):
    return sorted(int(n.split("-")[1]) for n in os.listdir(d)
                  if n.startswith("ckpt-"))


def test_checkpoint_crossing_saves_at_3_4_7_8(tmp_path):
    """tests/test_dispatch.py's case: checkpoint_every 2 with k 3;
    dispatches end at steps 3, 4 (the epoch's tail), 7, 8, and each
    crosses a multiple of 2."""
    cfg = _mlp_cfg(steps_per_dispatch=3, checkpoint_every=2,
                   checkpoint_dir=str(tmp_path), checkpoint_keep=10)
    _, res = _fit(cfg)
    assert res["steps"] == 8
    assert _snapshots(tmp_path) == [3, 4, 7, 8]


def test_resume_in_the_middle_of_a_group_is_bitwise(tmp_path):
    """A snapshot at step 2 (mid-epoch), resumed with k 3: the first
    group is the epoch's steps 3-4, then 5-7 and 8; the result equals the
    uninterrupted k 1 run bitwise."""
    straight, _ = _fit(_mlp_cfg())
    ck = str(tmp_path / "ck")
    _fit(_mlp_cfg(nepochs=1, checkpoint_every=2, checkpoint_dir=ck,
                  checkpoint_keep=10))
    assert _snapshots(ck) == [2, 4]
    shutil.rmtree(os.path.join(ck, "ckpt-4"))
    tr, res = _fit(_mlp_cfg(steps_per_dispatch=3, checkpoint_dir=ck,
                            checkpoint_keep=10, resume=True))
    assert res["steps"] == 8
    assert _snapshots(ck) == [2, 8]
    _assert_bitwise(_params(straight), _params(tr))


def test_epoch_groups_are_the_epoch_batches_in_one_copy_per_leaf():
    data = {"x": np.arange(26 * 3, dtype=np.float32).reshape(26, 3),
            "y": np.arange(26, dtype=np.int64)}
    loader = ShardedLoader(data, 4, device="cpu", seed=3, prefetch=0)
    want = list(loader.epoch(1, start_step=1))
    got, sizes, rows = [], [], []
    for group, n, r in loader.epoch_groups(1, 4, start_step=1):
        assert len(group) == n
        # one tensor per leaf behind every batch of the group
        assert len({b["x"].untyped_storage().data_ptr()
                    for b in group}) == 1
        got += group
        sizes.append(n)
        rows.append(r)
    assert sizes == [4, 2] and rows == [16, 6]   # the last batch: 2 rows
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert torch.equal(g[k], w[k])


# ---------------------------------------------------------------------------
# the optimizer's device scalars
# ---------------------------------------------------------------------------

def _python_float_update(name, lr, grads, params, state):
    """The update with the scheduled lr and Adam's bias corrections as
    Python floats, the formulas as the optimizer writes them."""
    count = state["count"]
    lr_t = float(lr(count))
    p = params
    if name == "sgd":
        buf = state["buf"]
        torch._foreach_mul_(buf, 0.9)
        torch._foreach_add_(buf, grads)
        step = buf
    else:
        wd, decoupled = (0.01, True) if name == "adamw" else (0.0, False)
        mu, nu = state["mu"], state["nu"]
        t = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(0.9) ** t)
        bc2 = float(np.float32(1) - np.float32(0.999) ** t)
        torch._foreach_mul_(mu, 0.9)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - 0.9))
        g2 = torch._foreach_mul(grads, 1 - 0.999)
        torch._foreach_mul_(g2, grads)
        torch._foreach_mul_(nu, 0.999)
        torch._foreach_add_(nu, g2)
        step = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        torch._foreach_div_(step, den)
        if wd and decoupled:
            torch._foreach_add_(step, torch._foreach_mul(p, wd))
    upd = torch._foreach_mul([s.float() for s in step], lr_t)
    torch._foreach_sub_(p, upd)
    state["count"] = count + 1


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_device_scalars_are_the_python_floats_bitwise(name):
    lr = schedules.make("cosine", 3e-3, total_steps=7, warmup_steps=2,
                        min_lr=1e-4)
    opt = optim.make(name, lr, momentum=0.9)
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,), (7,)]
    params = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
              for s in shapes]
    ref = [p.clone() for p in params]
    state = opt.init(params)
    ref_state = {"count": 0, "buf": [torch.zeros_like(p) for p in ref],
                 "mu": [torch.zeros_like(p) for p in ref],
                 "nu": [torch.zeros_like(p) for p in ref]}
    for _ in range(7):
        grads = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                 for s in shapes]
        scal = optim.device_scalars(opt.scalars(state.count), params[0])
        params, state = opt.update(grads, state, params, scal)
        _python_float_update(name, lr, grads, ref, ref_state)
        _assert_bitwise(params, ref)
    assert state.count == ref_state["count"] == 7
    # the scalars are f32 values of the Python ones
    vals = opt.scalars(3)
    assert vals.dtype == np.float32
    assert vals[0] == np.float32(lr(3))


# ---------------------------------------------------------------------------
# refusals and the flag
# ---------------------------------------------------------------------------

def test_multi_process_dispatch_raises_the_jax_message(monkeypatch):
    """The JAX loader's words, for a torchrun world of more than one
    process: at the Trainer, and at the loader."""
    with open(os.path.join(os.path.dirname(jconfig.__file__), "data",
                           "loader.py")) as f:
        # the JAX source's adjacent string literals, joined
        jax_loader = re.sub(r'"\s*\n\s*"', "", f.read())
    assert f'"{MULTI_PROCESS_DISPATCH}"' in jax_loader
    world = distributed.World(0, 2, torch.device("cpu"))
    monkeypatch.setattr(trainer_mod, "world_setup", lambda *a, **kw: world)
    with pytest.raises(NotImplementedError) as e:
        trainer_mod.Trainer(_mlp_cfg(steps_per_dispatch=2), device="cpu")
    assert str(e.value) == MULTI_PROCESS_DISPATCH
    loader = ShardedLoader({"x": np.zeros((8, 2))}, 2, rank=0,
                           world_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match="single-host"):
        next(loader.epoch_groups(0, 2))


def test_steps_per_dispatch_accepted_other_unported_flags_refused():
    cfg = config_from_args(build_argparser().parse_args(
        ["--steps_per_dispatch", "4"]))
    assert cfg.steps_per_dispatch == 4
    trainer_mod.refuse_unported(cfg)
    tr = trainer_mod.Trainer(cfg, device="cpu")
    assert tr.k_dispatch == 4 and tr.multi_step is not None
    assert "steps_per_dispatch" not in trainer_mod._UNPORTED
    base = TrainConfig()
    for field, flag in trainer_mod._UNPORTED.items():
        default = getattr(base, field)
        if isinstance(default, bool):
            value = not default
        elif isinstance(default, (int, float)):
            value = default + 2
        else:
            value = "x"
        with pytest.raises(NotImplementedError, match=flag):
            trainer_mod.refuse_unported(
                dataclasses.replace(cfg, **{field: value}))
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        trainer_mod.Trainer(dataclasses.replace(cfg, steps_per_dispatch=0),
                            device="cpu")
