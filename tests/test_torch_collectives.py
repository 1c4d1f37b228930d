"""The port's collectives (``parallel.collectives``) against the JAX
package's, on the CPU: every case of ``tests/test_collectives.py``
(pmean, psum, broadcast_from, ppermute_ring, all_gather, reduce_scatter,
axis_index) plus ``all_to_all`` and its gradient, over a local group of 8
(one process) and over 4 gloo ranks (``ProcessExpertGroup``, one process
each, spawned once for the module), each held to JAX's function on a
``data`` mesh of as many fake CPU devices with the same numpy inputs.
Exact: every case moves or sums a few small integers.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu.config import MeshConfig
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    collectives as jcoll,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    collectives as coll,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (
    LocalExpertGroup,
)
from torch_expert_child import spawn

pytestmark = pytest.mark.torch_port

CASES = ("pmean", "psum", "broadcast", "ppermute", "all_gather",
         "reduce_scatter", "axis_index", "all_to_all")


def inputs(n):
    rng = np.random.default_rng(n)
    return {
        "x": np.arange(n, dtype=np.float32).reshape(n, 1, 1),
        "rs": np.tile(np.arange(n, dtype=np.float32), (1, 1)),
        "a2a": rng.integers(-5, 5, (n, n * 2, 3)).astype(np.float32),
        "a2a_ct": rng.integers(-3, 3, (n, 2, n * 3)).astype(np.float32),
    }


def jax_member_outputs(case, n):
    """Each member's output of JAX's collective on an n-device mesh."""
    mesh = make_mesh(MeshConfig(data=n), devices=jax.devices("cpu")[:n])
    inp = inputs(n)

    def per_member(fn, x):
        out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("data"),),
                                    out_specs=P("data"),
                                    check_vma=False))(x)
        return np.asarray(out).reshape((n, -1) + np.shape(out)[1:])[:, 0]

    x = inp["x"]
    if case == "pmean":
        return per_member(lambda v: jcoll.pmean(v, "data"), x)
    if case == "psum":
        return per_member(lambda v: jcoll.psum(v, "data"),
                          np.ones((n, 1, 2), np.float32))
    if case == "broadcast":
        return per_member(lambda v: jcoll.broadcast_from(v, "data", src=3),
                          x)
    if case == "ppermute":
        return per_member(lambda v: jcoll.ppermute_ring(v, "data", shift=1),
                          x)
    if case == "all_gather":
        return per_member(lambda v: jcoll.all_gather(v[0], "data")[None],
                          x)
    if case == "reduce_scatter":
        rs = np.broadcast_to(inp["rs"], (n,) + inp["rs"].shape)
        return per_member(lambda v: jcoll.reduce_scatter(
            v[0], "data", scatter_axis=1)[None], rs)
    if case == "axis_index":
        return per_member(lambda v: jcoll.axis_index("data").reshape(
            1, 1).astype(np.float32), np.zeros((n, 1), np.float32))[:, 0]

    def a2a(v, ct):
        y = jcoll.all_to_all(v[0], "data", split_axis=0, concat_axis=1)
        return (y * ct[0]).sum(), y

    def grads(v, ct):
        g, y = jax.grad(lambda vv: a2a(vv, ct), has_aux=True)(v)
        return y[None], g

    y, g = jax.jit(jax.shard_map(grads, mesh=mesh,
                                 in_specs=(P("data"), P("data")),
                                 out_specs=(P("data"), P("data")),
                                 check_vma=False))(inp["a2a"], inp["a2a_ct"])
    return np.asarray(y), np.asarray(g)


def local_outputs(case, n):
    """Each rank's output of the port's collective over a local group."""
    g = LocalExpertGroup(n)
    inp = inputs(n)
    xs = [torch.tensor(v) for v in inp["x"]]
    if case == "pmean":
        return np.stack([t.numpy() for t in coll.pmean(xs, g)])
    if case == "psum":
        return np.stack([t.numpy() for t in coll.psum(
            [torch.ones(1, 2) for _ in range(n)], g)])
    if case == "broadcast":
        return np.stack([t.numpy() for t in coll.broadcast_from(xs, g, 3)])
    if case == "ppermute":
        return np.stack([t.numpy() for t in coll.ppermute_ring(xs, g, 1)])
    if case == "all_gather":
        return np.stack([t.numpy() for t in coll.all_gather(xs, g)])
    if case == "reduce_scatter":
        return np.stack([t.numpy() for t in coll.reduce_scatter(
            [torch.tensor(inp["rs"]) for _ in range(n)], g, 1)])
    if case == "axis_index":
        assert coll.axis_size(g) == n
        return np.asarray(coll.axis_index(g), np.float32)
    a = [torch.tensor(v, requires_grad=True) for v in inp["a2a"]]
    ys = coll.all_to_all(a, g, split_axis=0, concat_axis=1)
    sum((y * torch.tensor(c)).sum() for y, c in zip(ys, inp["a2a_ct"])
        ).backward()
    return (np.stack([y.detach().numpy() for y in ys]),
            np.stack([t.grad.numpy() for t in a]))


@pytest.fixture(scope="module")
def gloo_outputs(tmp_path_factory):
    outs = spawn(str(tmp_path_factory.mktemp("coll")), 4,
                 {"collectives": inputs(4)})
    return [o["collectives"] for o in outs]


def _gloo(outs, case):
    if case == "axis_index":
        assert [o["axis_size"] for o in outs] == [4] * 4
        return np.asarray([o["axis_index"][0] for o in outs], np.float32)
    if case == "all_to_all":
        return (np.stack([o[case][0] for o in outs]),
                np.stack([o[case][1] for o in outs]))
    return np.stack([o[case] for o in outs])


def _check(got, want):
    if isinstance(want, tuple):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.reshape(a.shape))
    else:
        np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("case", CASES)
def test_local_group_collective_matches_jax(case):
    _check(local_outputs(case, 8), jax_member_outputs(case, 8))


@pytest.mark.parametrize("case", CASES)
def test_gloo_ranks_collective_matches_jax(gloo_outputs, case):
    _check(_gloo(gloo_outputs, case), jax_member_outputs(case, 4))


def test_reference_expectations():
    """tests/test_collectives.py's closed forms over the local group."""
    np.testing.assert_array_equal(local_outputs("pmean", 8).ravel(),
                                  np.full(8, 3.5))
    np.testing.assert_array_equal(local_outputs("broadcast", 8).ravel(),
                                  np.full(8, 3.0))
    np.testing.assert_array_equal(local_outputs("ppermute", 8).ravel(),
                                  [7, 0, 1, 2, 3, 4, 5, 6])
    np.testing.assert_array_equal(local_outputs("reduce_scatter", 8).ravel(),
                                  8.0 * np.arange(8))
    np.testing.assert_array_equal(local_outputs("axis_index", 8),
                                  np.arange(8))
