"""The port's replica-consistency primitives against the JAX package's, on
the CPU: ``ops/fingerprint.py`` (the digest kernel's plain version, which
a CPU tensor takes) against JAX's ``Fingerprinter`` bitwise, and
``utils/consistency.py`` (digest verdicts, the localization core, heal,
the replica-0-referenced debug API) against ``utils/consistency.py`` of
the JAX package.

The digests are integers mod 2**32: compared exactly.  The advisory f32
fold is compared at 1e-6 relative (its summation order differs).  The
kernel itself runs on the card (``chip_smoke.py`` phase 21 holds it
bitwise to this plain version at the flagship's full training state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu.utils import (
    consistency as jcons,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    faults as jfaults,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
    fingerprint as fp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    consistency as cons,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    faults,
)

pytestmark = pytest.mark.torch_port

H0 = fp.FNV_BASIS


def _rng(seed=0):
    return np.random.default_rng(seed)


def _jax_digest(mesh, tree):
    """JAX's chained digest and fold of a replicated tree (device 0's)."""
    rep = {k: jax.device_put(v, NamedSharding(mesh, P()))
           for k, v in tree.items()}
    f = jcons.Fingerprinter(rep, mesh)
    d, fo = jcons.Fingerprinter.fetch(f.compute(rep))
    assert not jcons.digests_differ(d)
    return int(d[0]), float(fo[0])


def _torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


_LEAVES = {
    "float32": lambda r: r.standard_normal((37, 65)).astype(np.float32),
    "bfloat16": lambda r: np.asarray(jnp.asarray(
        r.standard_normal((300,)), jnp.bfloat16)),
    "int32": lambda r: r.integers(-2**31, 2**31 - 1, (77,),
                                  dtype=np.int64).astype(np.int32),
    "scalar_int32": lambda r: np.asarray(7, np.int32),
    "float16": lambda r: r.standard_normal((5, 9)).astype(np.float16),
}


@pytest.mark.parametrize("dtype", sorted(_LEAVES))
def test_plain_leaf_digest_equals_jax(mesh8, dtype):
    """One leaf: JAX's chained digest is h0 * 16777619 + s mod 2**32, so
    its per-leaf sum s is recovered and held to the port's exactly."""
    leaf = _LEAVES[dtype](_rng(1))
    want, want_fold = _jax_digest(mesh8, {"a": leaf})
    digests, folds = fp.fingerprint([_torch(leaf)])
    s = int(digests[0])
    assert (H0 * fp.FNV_PRIME + s) & fp.MASK32 == want
    assert int(digests[-1]) == want
    np.testing.assert_allclose(float(folds[-1]), want_fold, rtol=1e-6)


def test_chained_digest_equals_jax_in_its_leaf_order(mesh8):
    r = _rng(2)
    tree = {k: f(r) for k, f in _LEAVES.items()}
    want, want_fold = _jax_digest(mesh8, tree)
    # JAX flattens dict keys sorted
    got, folds = fp.fingerprint([_torch(tree[k]) for k in sorted(tree)])
    assert int(got[-1]) == want
    assert fp.chain(got[:-1].tolist()) == want
    np.testing.assert_allclose(float(folds[-1]), want_fold, rtol=1e-6)


def test_a_large_leaf_spanning_many_chunks_equals_jax(mesh8):
    """A leaf of 2.5 kernel chunks (the kernel's block boundaries)."""
    leaf = _rng(3).standard_normal((fp.CHUNK * 5 // 2,)).astype(np.float32)
    want, _ = _jax_digest(mesh8, {"a": leaf})
    assert int(fp.fingerprint([_torch(leaf)])[0][-1]) == want


@pytest.mark.parametrize("dtype,bit", [
    ("float32", 0), ("float32", 12), ("float32", 23), ("float32", 30),
    ("float32", 31), ("bfloat16", 0), ("bfloat16", 15), ("int32", 31),
    ("int32", 5)])
def test_a_single_flipped_bit_is_always_detected(dtype, bit):
    """Any single bit, at any element: the odd position factor makes the
    change to the sum nonzero mod 2**32."""
    leaf = _torch(_LEAVES[dtype](_rng(4)))
    base = int(fp.fingerprint([leaf])[0][-1])
    n = leaf.numel()
    for elem in (0, 1, n // 2, n - 1):
        bad = leaf.clone()
        faults.flip_bit_in_shard(bad, 0, bit, elem=elem)
        assert int(fp.fingerprint([bad])[0][-1]) != base, (elem, bit)


def test_a_nan_is_detected_and_identical_nans_agree():
    x = torch.ones(8, 8)
    y = x.clone()
    y[3, 3] = float("nan")
    z = y.clone()
    dx, dy, dz = (int(fp.fingerprint([t])[0][-1]) for t in (x, y, z))
    assert dx != dy and dy == dz


def test_fingerprint_refuses_mixed_devices_and_unknown_types():
    with pytest.raises(ValueError, match="unsupported dtype"):
        fp.fingerprint([torch.zeros(3, dtype=torch.complex64)])
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp.fingerprint([torch.zeros(3, device="meta")])


def test_fingerprinter_compute_fetch_skips_host_ints_and_sharded_opt():
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )

    state = TrainState(3, {"w": torch.ones(4, 4)},
                       {"m": torch.zeros(4, 4)})
    f = cons.Fingerprinter(state)
    assert f.paths == [".params['w']", ".opt_state['m']"]
    assert cons.Fingerprinter(state, sharded_opt=True).paths == [
        ".params['w']"]
    d, folds = cons.Fingerprinter.fetch(f.compute(state))
    assert d.dtype == np.uint32 and d.shape == (1,)
    want = fp.chain(f.leaf_digests(state).tolist())
    assert int(d[0]) == want
    assert folds[0] == 1.0   # |x[::64]| of the ones: one element


# ------------------------------------------------------------- verdicts


_MATRICES = [
    np.full((2, 4), 7, np.uint32),
    np.array([[7, 7, 7, 7], [7, 7, 9, 7]], np.uint32),
    np.array([[7, 7], [7, 7], [9, 9]], np.uint32),
    np.array([[7, 7], [9, 9]], np.uint32),
    np.array([[9, 9], [7, 7], [7, 7]], np.uint32),
    np.array([[7, 8], [9, 9], [7, 7]], np.uint32),
    np.array([[5], [6], [5], [6]], np.uint32),
    np.array([3, 3, 4, 3], np.uint32),
]


@pytest.mark.parametrize("i", range(len(_MATRICES)))
def test_digest_report_verdicts_equal_jax(i):
    mat = _MATRICES[i]
    assert cons.digest_report(mat) == jcons.digest_report(mat)
    assert cons.digests_differ(mat.reshape(-1)) == \
        jcons.digests_differ(mat.reshape(-1))


def test_digest_report_random_matrices_equal_jax():
    r = _rng(5)
    for _ in range(200):
        mat = r.integers(0, 3, (r.integers(1, 5), r.integers(1, 5))
                         ).astype(np.uint32)
        assert cons.digest_report(mat) == jcons.digest_report(mat)


# ------------------------------------------- localization, heal, debug API


def _replicas(n=4, shape=(8, 8), value=3.0):
    return [{"w": torch.full(shape, value), "ok": torch.full((4,), value)}
            for _ in range(n)]


def test_localize_names_leaf_replica_and_count(mesh8):
    """The pure core on per-leaf digests; the same verdict as JAX's
    ``divergence_report`` on the same data as 8 device shards."""
    reps = _replicas(8)
    faults.flip_bit_in_shard(reps[6]["w"], 0, 9)
    rep = cons.divergence_report(reps)
    assert list(rep) == ["['w']"]
    r = rep["['w']"]
    assert r["shards"] == [6] and r["reference_shard"] == 0
    assert r["n_bad_elements"] == 1 and 0 < r["max_abs_diff"] < 1e-3
    assert r["devices"] == ["replica6"]
    base = jax.device_put(jnp.full((8, 8), 3.0), NamedSharding(mesh8, P()))
    jrep = jcons.divergence_report(
        {"w": jfaults.flip_bit_in_shard(base, 6, 9),
         "ok": jax.device_put(jnp.full((4,), 3.0),
                              NamedSharding(mesh8, P()))})
    (jr,) = jrep.values()
    assert (jr["shards"], jr["reference_shard"], jr["n_bad_elements"]) == (
        r["shards"], r["reference_shard"], r["n_bad_elements"])
    assert jr["max_abs_diff"] == r["max_abs_diff"]


def test_majority_vote_convicts_corrupt_replica_zero():
    reps = _replicas(4)
    faults.flip_bit_in_shard(reps[0]["w"], 0, 9)
    r = cons.divergence_report(reps)["['w']"]
    assert r["shards"] == [0] and r["reference_shard"] != 0


def test_localize_fetches_only_the_diverged_leaves():
    names = ["a", "b", "c"]
    mat = np.array([[1, 2, 3], [1, 2, 4], [1, 2, 3]], np.uint32)
    fetched = []

    def fetch(j):
        fetched.append(j)
        return [torch.tensor([0.0]), torch.tensor([1.0]),
                torch.tensor([0.0])]

    rep = cons.localize(names, mat, fetch, ["x", "y", "z"])
    assert fetched == [2] and list(rep) == ["c"]
    assert rep["c"]["shards"] == [1] and rep["c"]["devices"] == ["y"]
    assert rep["c"]["max_abs_diff"] == 1.0


def test_heal_replication_restores_bitwise_in_place():
    reps = _replicas(4)
    keep = reps[2]["w"]
    ok_before = reps[2]["ok"]
    faults.flip_bit_in_shard(reps[2]["w"], 0, 20)
    healed, rep = cons.heal_replication(reps)
    assert list(rep) == ["['w']"]
    assert cons.check_replicas(healed) == {}
    assert healed[2]["w"] is keep and healed[2]["ok"] is ok_before
    assert torch.equal(healed[2]["w"], healed[0]["w"])


def test_nan_poisoned_replica_reported_diverged():
    reps = _replicas(3)
    reps[1]["w"][3, 3] = float("nan")
    div = cons.replica_divergence(reps)
    assert div["['w']"] == float("inf") and div["['ok']"] == 0.0
    with pytest.raises(AssertionError, match="replica divergence"):
        cons.assert_replicated(reps)


def test_identically_nan_replicas_are_lockstep():
    reps = _replicas(3)
    for r in reps:
        r["w"][0, 0] = float("nan")
    assert cons.check_replicas(reps) == {}
    assert cons.divergence_report(reps) == {}


def test_bfloat16_divergence_reports_magnitude():
    reps = [{"w": torch.full((4, 4), 1.0, dtype=torch.bfloat16)}
            for _ in range(3)]
    reps[2]["w"][0, 0] = 1.0078125   # one bf16 ulp above 1
    div = cons.replica_divergence(reps)
    assert div["['w']"] == pytest.approx(0.0078125)
    r = cons.divergence_report(reps)["['w']"]
    assert r["n_bad_elements"] == 1 and r["shards"] == [2]


def test_integer_leaf_divergence_is_infinite():
    reps = [{"c": torch.tensor(3, dtype=torch.int32)} for _ in range(3)]
    reps[1]["c"] += 1
    assert cons.replica_divergence(reps)["['c']"] == float("inf")
    r = cons.divergence_report(reps)["['c']"]
    assert r["shards"] == [1] and r["n_bad_elements"] == 1


def test_cross_report_names_the_diverged_nodes():
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (  # noqa: E501
        distributed,
    )

    gathered = {"a": np.array([[1], [1], [1], [1]], np.uint32),
                "b": np.array([[1], [1], [2], [2]], np.uint32)}
    rep = distributed.cross_report(gathered, local=2)
    assert list(rep) == ["b"] and rep["b"]["processes"] == [1]
    assert distributed.cross_host_report({"b": np.zeros(1)}) == {}


def test_leaf_paths_are_jax_keystr_names():
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )

    tree = TrainState(0, {"b": [torch.zeros(1), {"w": torch.zeros(1)}],
                          "a": torch.zeros(1)}, None)
    jtree = {"params": {"b": [np.zeros(1), {"w": np.zeros(1)}],
                        "a": np.zeros(1)}}
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jtree)[0]]
    got = [n for n, _ in cons.replicated_leaves(tree)]
    assert got == [w.replace("['params']", ".params") for w in want]
