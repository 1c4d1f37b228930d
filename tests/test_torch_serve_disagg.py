"""The port's disaggregated serving against the JAX package's: the
prefill -> decode block handoff, the roles, drain and the load report.

* Port to port: a ``role="prefill"`` scheduler's exports injected into a
  ``role="decode"`` scheduler give the JAX unified scheduler's greedy
  tokens, over the ragged, prefix-cache and int8-KV scenarios of
  ``test_torch_serve.py`` with both attention impls; both allocators
  drain and the handoffs are counted.
* Across packages: a payload exported by one package imports into the
  other and decodes to the same tokens; the geometries are equal and the
  exported rows agree (f32 pools within 1e-5).
* Refusals: a geometry mismatch, an export before prefill completes, an
  inject on a full server (None, nothing used).
* Drain: ``drain``/``quiesce``/``tokens_at_risk`` give the JAX
  scheduler's descriptors at the same tick (the port of
  ``test_serve_sched.py``'s drain tests), and readmission reproduces the
  tokens; ``load_report`` has the JAX keys and ``now`` values.

Every JAX scheduler runs through ``_blocking`` (its CPU serving race,
ROADMAP Queue C "Context").
"""

import base64
import functools

import numpy as np
import pytest

from neural_networks_parallel_training_with_mpi_tpu.serve import (
    Scheduler as JaxScheduler,
    ServeConfig as JaxServeConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
    Scheduler,
    ServeConfig,
)
from test_torch_serve import SCENARIOS, _blocking, _jax_reference, _models

pytestmark = pytest.mark.torch_port

DISAGG = ("ragged", "prefix_cache", "kv_quant")


class VClock:
    """A virtual clock the tests advance once per tick."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt=0.001):
        self.t += dt


def _port(cfg, **kw):
    _, _, model, params = _models()
    return Scheduler(model, params, ServeConfig(**{**cfg, **kw}),
                     device="cpu")


def _jax(cfg, now_fn=None, **kw):
    jm, jp, _, _ = _models()
    extra = {} if now_fn is None else {"now_fn": now_fn}
    return _blocking(JaxScheduler(jm, jp, JaxServeConfig(**{**cfg, **kw}),
                                  **extra))


def _pump(pre, dec, requests, max_ticks=5000):
    """Submit ``requests`` to ``pre``; move its handoffs into ``dec``
    (an inject that returns None is retried on the next pass) until every
    request finished on one side.  Returns the tokens in request order."""
    rids = [pre.submit(p, n) for p, n in requests]
    assert all(r is not None for r in rids)
    dec_of, waiting, out = {}, [], {}
    for _ in range(max_ticks):
        for rid in pre.tick():
            out[rid] = pre.result(rid)          # finished at prefill
        waiting += pre.take_handoffs()
        for h in list(waiting):
            got = dec.inject(h["payload"], slo_ms=h["slo_ms"])
            if got is not None:
                dec_of[got] = h["rid"]
                waiting.remove(h)
        for rid in dec.tick():
            out[dec_of[rid]] = dec.result(rid)
        if len(out) == len(rids):
            return [out[r] for r in rids]
    raise AssertionError(f"not drained: {len(out)}/{len(rids)} done")


@pytest.mark.parametrize("attn_impl", ["gathered", "fused"])
@pytest.mark.parametrize("name", DISAGG)
def test_disagg_tokens_match_jax_unified(name, attn_impl):
    cfg, requests = SCENARIOS[name]
    pre = _port(cfg, attn_impl=attn_impl, role="prefill")
    dec = _port(cfg, attn_impl=attn_impl, role="decode")
    got = _pump(pre, dec, requests)
    want, _ = _jax_reference(name)
    assert got == want
    pre.server.allocator.assert_drained()
    dec.server.allocator.assert_drained()
    # every request here decodes more than one token: all crossed
    assert pre.handed_off == dec.injected == len(requests)
    assert pre.server.handoffs_exported == len(requests)
    assert dec.server.handoffs_imported == len(requests)
    assert pre.completed == 0 and dec.completed == len(requests)
    snap = dec.snapshot()
    assert snap["injected"] == len(requests) and snap["handed_off"] == 0
    if name == "prefix_cache":
        # the import registers each prompt's blocks: later injects of
        # the same prefix find them in the decode side's index
        assert len(dec.server.prefix) > 0


def _export_one(sched, prompt, n):
    """Run one request through a prefill-role scheduler; its payload."""
    rid = sched.submit(prompt, n)
    assert rid is not None
    for _ in range(200):
        sched.tick()
        hs = sched.take_handoffs()
        if hs:
            assert [h["rid"] for h in hs] == [rid]
            return hs[0]
    raise AssertionError("no handoff")


def _rows(payload, layer, name, dtype, shape_tail):
    raw = base64.b64decode(payload["layers"][layer][name])
    return np.frombuffer(raw, dtype).reshape((-1,) + shape_tail)


def _decode_one(sched, payload):
    rid = sched.inject(payload)
    assert rid is not None
    sched.run_until_drained()
    return sched.result(rid)


@pytest.mark.parametrize("name", DISAGG)
def test_payload_crosses_between_the_packages(name):
    """JAX -> port and port -> JAX: the payload decodes to the JAX unified
    tokens; geometries equal; the rows of the prompt's positions agree
    (f32 within 1e-5; int8 codes within one step, scales within 1e-5)."""
    cfg, requests = SCENARIOS[name]
    want, _ = _jax_reference(name)
    jpre = _jax(cfg, role="prefill")
    ppre = _port(cfg, role="prefill")
    _, _, model, _ = _models()
    c = model.cfg
    for (prompt, n), ref in zip(requests, want):
        jh = _export_one(jpre, prompt, n)
        ph = _export_one(ppre, prompt, n)
        jp, pp = jh["payload"], ph["payload"]
        assert pp["geom"] == jp["geom"]
        assert {k: pp[k] for k in ("v", "prompt", "max_new", "first_token",
                                   "n_blocks")} == \
            {k: jp[k] for k in ("v", "prompt", "max_new", "first_token",
                                "n_blocks")}
        p = len(prompt)
        for li in range(c.n_layers):
            assert set(pp["layers"][li]) == set(jp["layers"][li])
            for nm in jp["layers"][li]:
                if nm.endswith("_scale"):
                    dt, tail, tol = np.float32, (c.kv_heads,), 1e-5
                else:
                    dt = np.int8 if cfg.get("kv_quant") else np.float32
                    tail = (c.kv_heads, c.head_dim)
                    tol = 1 if cfg.get("kv_quant") else 1e-5
                a = _rows(jp, li, nm, dt, tail)[:p].astype(np.float64)
                b = _rows(pp, li, nm, dt, tail)[:p].astype(np.float64)
                np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                           err_msg=f"layer {li} {nm}")
        # each package decodes the other's payload to the reference
        assert _decode_one(_port(cfg, role="decode"), jp) == ref
        assert _decode_one(_jax(cfg, role="decode"), pp) == ref


def test_geometry_mismatch_and_malformed_payloads_raise():
    cfg, requests = SCENARIOS["ragged"]
    prompt, n = requests[0]
    payload = _export_one(_port(cfg, role="prefill"), prompt, n)["payload"]
    dec = _port(cfg, role="decode")
    for geom in (dict(payload["geom"], block_size=8),
                 dict(payload["geom"], kv_quant=True),
                 dict(payload["geom"], dtype="bfloat16")):
        with pytest.raises(ValueError, match="geometry mismatch"):
            dec.inject(dict(payload, geom=geom))
    # a quantized server refuses a plain payload the same way
    with pytest.raises(ValueError, match="geometry mismatch"):
        _port(cfg, role="decode", kv_quant=True).inject(payload)
    short = [dict(rec, k=base64.b64encode(
        base64.b64decode(rec["k"])[:-4]).decode("ascii"))
        for rec in payload["layers"]]
    with pytest.raises(ValueError, match="bytes"):
        dec.inject(dict(payload, layers=short))
    with pytest.raises(ValueError, match="blocks"):
        dec.inject(dict(payload, n_blocks=payload["n_blocks"] + 1))
    # nothing above used a slot or a block
    assert dec.server.free_slots() == cfg["slots"]
    dec.server.allocator.assert_drained()
    assert dec.injected == 0


def test_export_before_prefill_completes_raises():
    cfg, _ = SCENARIOS["ragged"]
    srv = _port(cfg).server
    rid = srv.try_admit(list(range(1, 12)), 4)
    assert not srv.prefill_step(rid, 4)          # 4 of 11 prefilled
    assert srv.prefill_remaining(rid) == 7
    with pytest.raises(ValueError, match="prefill incomplete"):
        srv.export_stream(rid)
    while not srv.prefill_step(rid, 4):
        pass
    assert srv.prefill_remaining(rid) == 0
    assert srv.export_stream(rid)["n_blocks"] == srv.blocks_for(11)
    assert srv.live() == 1


def test_inject_on_a_full_server_returns_none_and_uses_nothing():
    cfg, requests = SCENARIOS["ragged"]
    pre = _port(cfg, role="prefill")
    payloads = [_export_one(pre, p, n)["payload"] for p, n in requests[:3]]
    # no free slot: slots=2 both taken
    dec = _port(cfg, role="decode")
    assert dec.inject(payloads[0]) is not None
    assert dec.inject(payloads[1]) is not None
    before = (dec.server.free_blocks, dec.in_flight(), dec.injected,
              dec.server.handoffs_imported)
    assert dec.inject(payloads[2]) is None
    assert (dec.server.free_blocks, dec.in_flight(), dec.injected,
            dec.server.handoffs_imported) == before
    # a free slot but too few blocks: the 11-token prompt takes 3 of the
    # 5 blocks, so a second copy of it does not fit
    tight = _port(cfg, role="decode", num_blocks=6)
    assert tight.inject(payloads[0]) is not None
    free = tight.server.free_blocks
    assert free == 2 and tight.server.free_slots() == 1
    assert tight.inject(payloads[0]) is None
    assert tight.server.free_blocks == free and tight.in_flight() == 1
    tight.run_until_drained()
    tight.server.allocator.assert_drained()


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_unified_submit_on_a_role_scheduler(role):
    cfg, requests = SCENARIOS["ragged"]
    sched = _port(cfg, role=role, attn_impl="fused")
    rids = [sched.submit(p, n, unified=True) for p, n in requests]
    sched.run_until_drained()
    want, _ = _jax_reference("ragged")
    assert [sched.result(r) for r in rids] == want
    assert sched.handed_off == 0 and sched.take_handoffs() == []
    sched.server.allocator.assert_drained()
    assert sched.stats(rids[0]).unified


def test_single_token_request_finishes_on_the_prefill_side():
    cfg, _ = SCENARIOS["ragged"]
    pre = _port(cfg, role="prefill")
    rid = pre.submit([3, 4, 5], 1)
    pre.run_until_drained()
    assert pre.handed_off == 0 and len(pre.result(rid)) == 4
    pre.server.allocator.assert_drained()


# ---------------------------------------------------------------------------
# drain / quiesce / tokens_at_risk against the JAX scheduler
# ---------------------------------------------------------------------------

DRAIN_CFG = dict(slots=2, num_blocks=17, block_size=16, prefill_chunk=8,
                 queue_depth=8)


def _both(cfg, **kw):
    jc, pc = VClock(), VClock()
    return (_jax(cfg, now_fn=jc, **kw), jc,
            Scheduler(*_models()[2:], ServeConfig(**cfg, **kw),
                      now_fn=pc, device="cpu"), pc)


def _tick(pairs):
    for sched, clock in pairs:
        sched.tick()
        clock.advance()


def test_drain_descriptors_match_jax():
    """``test_drain_returns_inflight_with_consumed_state`` on both
    packages: the same descriptors, tokens at risk and counters."""
    js, jc, ps, pc = _both(DRAIN_CFG)
    out = []
    for sched, clock in ((js, jc), (ps, pc)):
        done_rid = sched.submit([1, 2, 3], 2)
        mid_rid = sched.submit(list(range(1, 21)), 8)
        for _ in range(40):
            sched.tick()
            clock.advance()
            if sched.done(done_rid):
                break
        queued_rid = sched.submit([7, 8, 9], 4)
        sched.tick()
        clock.advance()
        risk = sched.tokens_at_risk()
        drained = sched.quiesce()
        assert sched.in_flight() == 0 and sched.pending() == 0
        assert [d["rid"] for d in drained] == [mid_rid, queued_rid]
        assert sched.result(done_rid)[:3] == [1, 2, 3]
        out.append((drained, risk, sched.tick_no))
        sched.close()
    assert out[1] == out[0]
    (jd, jrisk, _), _ = out
    assert jrisk > 0 and jd[0]["prefilled"] + jd[0]["generated"] > 0


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_drain_readmission_reproduces_tokens(prefix_cache):
    """Drained mid-decode on both packages at the same tick: the same
    descriptors and tokens at risk; readmitted on a fresh port scheduler
    the requests give the JAX unified scheduler's tokens."""
    cfg = dict(slots=4, num_blocks=33, block_size=16, prefill_chunk=8,
               queue_depth=8, prefix_cache=prefix_cache)
    shared = list(range(1, 17))
    subs = [([3, 1, 4, 1, 5], 12), (list(range(2, 14)), 14),
            ([9, 2, 6], 10), (shared + [40, 41], 6), (shared + [50], 6)]
    ref = _jax(dict(cfg, queue_depth=16))
    ref_rids = [ref.submit(p, n) for p, n in subs]
    ref.run_until_drained()
    want = [ref.result(r) for r in ref_rids]
    js, jc, ps, pc = _both(cfg)
    got = []
    for sched, clock in ((js, jc), (ps, pc)):
        for p, n in subs:
            assert sched.submit(p, n) is not None
        for _ in range(6):
            sched.tick()
            clock.advance()
        assert any(sched.server.active)
        got.append((sched.tokens_at_risk(), sched.drain()))
        sched.server.allocator.assert_drained()
    assert got[1] == got[0]
    drained = got[1][1]
    assert len(drained) == len(subs)
    fresh = _port(cfg)
    rid2 = [fresh.submit(d["prompt"], d["max_new"], slo_ms=d["slo_ms"])
            for d in drained]
    fresh.run_until_drained()
    assert [fresh.result(r) for r in rid2] == want
    fresh.server.allocator.assert_drained()


def test_drain_hands_back_untaken_handoffs():
    cfg, requests = SCENARIOS["ragged"]
    js, jc, ps, pc = _both(cfg, role="prefill")
    out = []
    for sched, clock in ((js, jc), (ps, pc)):
        for p, n in requests:
            sched.submit(p, n)
        for _ in range(7):
            sched.tick()
            clock.advance()
        assert sched.handed_off > 0
        out.append((sched.load_report()["now"]["handoffs_ready"],
                    sched.quiesce()))
    assert out[1] == out[0]
    assert len(out[1][1]) == len(requests)


def test_load_report_matches_jax():
    cfg, requests = SCENARIOS["prefix_cache"]
    js, jc, ps, pc = _both(cfg, role="decode", default_slo_ms=50.0)
    reps = []
    for sched, clock in ((js, jc), (ps, pc)):
        for p, n in requests:
            sched.submit(p, n)
        for _ in range(9):
            sched.tick()
            clock.advance()
        reps.append(sched.load_report())
    jrep, prep = reps
    assert set(prep) == set(jrep)
    assert prep["now"] == jrep["now"]
    assert prep["now"]["role"] == "decode"
    assert prep["role"] == jrep["role"] == "serve-decode"
    assert prep["counters"] == jrep["counters"]
    assert prep["sketches"] == jrep["sketches"]
    for sched in (js, ps):
        sched.quiesce()
