"""The port's load generator and dense ``DecodeServer`` against the JAX
package's.

* ``make_requests`` is bitwise the JAX stream across seeds, streams and
  the ``long_prefill`` mix.
* ``run_closed_loop`` on the port's scheduler gives the JAX run's
  ``tokens_sha256`` and counters, with the prefix cache off and on;
  ``sweep_loads`` at two loads (with ``prewarm``) the same per row.  The
  wall-clock fields (tokens/s, TTFT, ITL) are left out.
* ``DecodeServer`` gives the JAX server's greedy tokens: plain, int8 KV
  cache, chunked prefill, scan_layers, GQA, staggered admission.
"""

import functools

import jax
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.models.serve import (
    DecodeServer as JaxDecodeServer,
)
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.serve import (
    Scheduler as JaxScheduler,
    ServeConfig as JaxServeConfig,
    make_requests as jax_make_requests,
    run_closed_loop as jax_run_closed_loop,
    sweep_loads as jax_sweep_loads,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
    DecodeServer,
    Transformer,
    TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
    MIXES,
    Scheduler,
    ServeConfig,
    make_requests,
    run_closed_loop,
    sweep_loads,
)
from test_torch_serve import SMALL, _blocking, _models

pytestmark = pytest.mark.torch_port

V = SMALL["vocab_size"]
# the row's fields that do not read the wall clock
COUNTED = ("clients", "requests", "tokens_out", "ticks", "admitted",
           "rejected", "evicted", "submit_retries", "deadline_missed",
           "blocks_in_use_peak", "blocks_in_use_mean", "tokens_sha256",
           "shared_prefix_len", "shared_fraction", "shared_requests",
           "prefix_cache", "mix")


def _counted(row):
    return {k: row[k] for k in COUNTED if k in row}


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=7, prompt_lens=(1, 9), max_new=(1, 4)),
    dict(seed=3, stream=2), dict(seed=1, shared_prefix_len=6,
                                 shared_fraction=0.5),
    dict(seed=5, mix="long_prefill"),
], ids=["seed0", "seed7", "stream2", "shared", "long_prefill"])
def test_make_requests_bitwise_jax(kw):
    args = (5, 3)
    assert make_requests(*args, vocab_size=V, **kw) == \
        jax_make_requests(*args, vocab_size=V, **kw)


def test_mixes_match_jax():
    from neural_networks_parallel_training_with_mpi_tpu.serve.loadgen import (
        MIXES as JAX_MIXES,
    )

    assert MIXES == JAX_MIXES


LOAD_CFG = dict(slots=3, num_blocks=40, block_size=4, prefill_chunk=8)
LOAD = dict(vocab_size=V, prompt_lens=(2, 14), max_new=(2, 9), seed=4,
            shared_prefix_len=8, shared_fraction=0.5)


def _port_sched(**kw):
    _, _, model, params = _models()
    return Scheduler(model, params, ServeConfig(**LOAD_CFG, **kw),
                     device="cpu")


def _jax_sched(**kw):
    jm, jp, _, _ = _models()
    return _blocking(JaxScheduler(jm, jp, JaxServeConfig(**LOAD_CFG, **kw)))


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_run_closed_loop_matches_jax(prefix_cache):
    port = run_closed_loop(_port_sched(prefix_cache=prefix_cache), 3, 3,
                           **LOAD)
    want = jax_run_closed_loop(_jax_sched(prefix_cache=prefix_cache), 3, 3,
                               **LOAD)
    assert _counted(port) == _counted(want)
    assert port["requests"] == 9 and port["tokens_per_sec"] > 0
    for key in ("ttft_ms_p50", "itl_ms_p99", "ttft_ms_p50_shared",
                "ttft_ms_p99_unique"):
        assert port[key] is not None and port[key] >= 0
    if prefix_cache:
        assert port["prefix_cache"]["prefix_hits"] > 0


def test_sweep_loads_matches_jax():
    kw = dict(vocab_size=V, prompt_lens=(2, 12), max_new=(2, 6), seed=2)
    port = sweep_loads(_port_sched, [1, 3], 2, **kw)
    want = jax_sweep_loads(_jax_sched, [1, 3], 2, **kw)
    assert [_counted(r) for r in port] == [_counted(r) for r in want]
    assert [r["clients"] for r in port] == [1, 3]


# ---------------------------------------------------------------------------
# the dense DecodeServer
# ---------------------------------------------------------------------------

def _blocking_dense(srv):
    """The JAX server's programs, each waited for before the host moves
    on (the CPU race ``_blocking`` describes)."""
    for attr in ("_prefill", "_insert", "_step"):
        fn = getattr(srv, attr)
        setattr(srv, attr,
                lambda *a, _fn=fn: jax.block_until_ready(_fn(*a)))
    return srv


@functools.lru_cache(maxsize=None)
def _dense_models(**over):
    jm = JaxTransformer(JaxConfig(**SMALL, **over))
    jp = jm.init(prng.init_key(0))
    model = Transformer(TransformerConfig(**SMALL, **over), device="cpu")
    params = params_from_jax(jax.device_get(jp), model.cfg, "cpu")
    return jm, jp, model, params


def _serve(srv, script):
    """``script``: a list of (prompt, max_new) submits, or ``None`` for a
    step; then step until every request finished.  Returns the tokens in
    submit order."""
    rids = []
    for item in script:
        if item is None:
            srv.step()
        else:
            rid = srv.submit(list(item[0]), max_new_tokens=item[1])
            assert rid is not None
            rids.append(rid)
    for _ in range(200):
        if all(srv.done(r) for r in rids):
            break
        srv.step()
    return [srv.result(r) for r in rids]


STAGGERED = [([1, 2, 3], 12), None, None, ([7, 8], 6), None,
             ([5, 9, 11, 13], 9), ([4, 5, 6], 1)]
BUCKETS = [([1], 5), ([1, 2, 3, 4, 5], 5), ([3] * 9, 5), ([7] * 17, 5)]


@pytest.mark.parametrize("case", [
    ("plain", {}, {}, STAGGERED),
    ("kv_quant", {}, dict(kv_quant=True), STAGGERED),
    ("chunked", {}, dict(prefill_chunk=3), BUCKETS),
    ("scan_layers", dict(scan_layers=True), {}, STAGGERED[:4]),
    ("gqa", dict(n_kv_heads=2), {}, STAGGERED[:4]),
], ids=lambda c: c[0])
def test_decode_server_tokens_match_jax(case):
    _, model_kw, srv_kw, script = case
    jm, jp, model, params = _dense_models(**model_kw)
    want = _serve(_blocking_dense(JaxDecodeServer(jm, jp, slots=4,
                                                  **srv_kw)), script)
    srv = DecodeServer(model, params, slots=4, device="cpu", **srv_kw)
    if srv_kw.get("kv_quant"):
        assert srv.caches[0]["k"].dtype == torch.int8
    assert _serve(srv, script) == want
    assert srv.live() == 0


def test_decode_server_slots_and_stale_rids():
    _, _, model, params = _dense_models()
    srv = DecodeServer(model, params, slots=2, device="cpu",
                       sync_per_step=True)
    a = srv.submit([1], max_new_tokens=4)
    b = srv.submit([2], max_new_tokens=20)
    assert srv.submit([3], max_new_tokens=4) is None      # pool full
    with pytest.raises(KeyError):
        srv.done(42)
    while not srv.done(a):
        srv.step()
    c = srv.submit([3], max_new_tokens=4)                 # a's slot
    assert c is not None and srv.live() == 2
    while not (srv.done(b) and srv.done(c)):
        srv.step()
    for rid in (a, b, c):
        srv.result(rid)
    with pytest.raises(KeyError):
        srv.done(a)
    with pytest.raises(ValueError):
        srv.submit([], max_new_tokens=2)
    with pytest.raises(ValueError):
        srv.submit([1] * 60, max_new_tokens=8)
