"""The port's chaos campaigns (``utils/chaos.py`` and
``tools/chaos_campaign.py``) against the JAX package's.

``load_plan`` of both builtins and of a JSON file, ``check_invariants``
and ``canonical_digest`` over the same result dicts equal JAX's.  The
port's ``stub_crash`` and ``stub_router_kill`` scenarios (supervised
stdlib ``python -S`` children, no device) run once each: every invariant
holds and their ``canonical`` dicts equal those of JAX's
``chaos.run_scenario`` on the same scenario and seed.  The files they
load (in process, and the paths handed to their children) all lie in the
port's package.  The whole ``lite`` plan with ``--repeat 2`` through the
port's ``chaos_campaign`` under ``python -S`` is ``slow``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from neural_networks_parallel_training_with_mpi_tpu.utils import (
    chaos as jchaos,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import chaos

pytestmark = pytest.mark.torch_port

PORT_PKG = os.path.dirname(os.path.dirname(os.path.abspath(chaos.__file__)))
JAX_PKG = os.path.dirname(os.path.dirname(os.path.abspath(jchaos.__file__)))
TOOL = os.path.join(PORT_PKG, "tools", "chaos_campaign.py")


@pytest.mark.parametrize("name", ["lite", "full"])
def test_builtin_plans_equal_jax(name):
    assert chaos.load_plan(name) == jchaos.load_plan(name)
    plan = chaos.load_plan(name)
    plan["scenarios"].clear()          # a deep copy: the builtin is intact
    assert chaos.BUILTIN_PLANS[name]["scenarios"]


def test_json_plan_equal_jax(tmp_path):
    p = tmp_path / "mine.json"
    p.write_text(json.dumps({"scenarios": [
        {"name": "stub_crash", "kind": "stub", "fault": "crash"}]}))
    got, want = chaos.load_plan(str(p)), jchaos.load_plan(str(p))
    assert got == want
    assert got["name"] == "mine.json" and got["seed"] == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"name": "x"}))
    for mod in (chaos, jchaos):
        with pytest.raises(ValueError, match="scenarios"):
            mod.load_plan(str(bad))


RESULTS = [
    {"name": "a", "invariants": {"x": True, "y": False, "z": False},
     "canonical": {"tokens_sha256": "ab", "actions": [["scale_out",
                                                       "replica-1"]]}},
    {"name": "b", "invariants": {"x": True},
     "canonical": {"events": {"w0": [["launch"], ["exit", 0]]},
                   "invariants": {"x": True}}},
    {"name": "c", "invariants": {}, "canonical": {}},
]


def test_check_invariants_and_digest_equal_jax():
    for r in RESULTS:
        assert chaos.check_invariants(r) == jchaos.check_invariants(r)
    assert chaos.check_invariants(RESULTS[0]) == ["a: y", "a: z"]
    assert chaos.canonical_digest(RESULTS) == \
        jchaos.canonical_digest(RESULTS)
    assert chaos.canonical_digest(RESULTS[:2]) != \
        chaos.canonical_digest(RESULTS)


def test_fleet_scenario_takes_its_platform():
    with pytest.raises(ValueError, match="platform"):
        chaos.run_scenario({"name": "f", "kind": "fleet", "mode": "kill"},
                           platform="tpu")


@pytest.fixture(scope="module")
def port_stub_runs():
    """The port's stub_crash and stub_router_kill, with every file path
    they load recorded: in this process (``spec_from_file_location``)
    and in their children (the ``.py`` arguments of each child's
    command)."""
    plan = chaos.load_plan("lite")
    scs = {sc["name"]: sc for sc in plan["scenarios"]}
    loaded = []
    real_spec = importlib.util.spec_from_file_location

    def spy(name, location, *a, **k):
        loaded.append(str(location))
        return real_spec(name, location, *a, **k)

    chaos._cache.clear()
    importlib.util.spec_from_file_location = spy
    try:
        mods = chaos._mods()
        real_child = mods["res"].ChildSpec

        def child(*a, **k):
            spec = real_child(*a, **k)
            loaded.extend(c for c in spec.cmd if c.endswith(".py"))
            return spec

        mods["res"].ChildSpec = child
        try:
            out = {name: chaos.run_scenario(scs[name], seed=plan["seed"])
                   for name in ("stub_crash", "stub_router_kill")}
        finally:
            mods["res"].ChildSpec = real_child
    finally:
        importlib.util.spec_from_file_location = real_spec
        chaos._cache.clear()
    return out, loaded, scs, plan["seed"]


@pytest.mark.parametrize("name", ["stub_crash", "stub_router_kill"])
def test_stub_scenario_canonical_equals_jax(port_stub_runs, name):
    out, _, scs, seed = port_stub_runs
    got = out[name]
    assert got["problems"] == []
    assert got["invariants"] and all(got["invariants"].values())
    want = jchaos.run_scenario(scs[name], seed=seed)
    assert want["problems"] == []
    assert got["canonical"] == want["canonical"]
    assert chaos.canonical_digest([got]) == jchaos.canonical_digest([want])


def test_chaos_loads_no_file_of_the_jax_package(port_stub_runs):
    _, loaded, _, _ = port_stub_runs
    assert loaded
    for path in loaded:
        real = os.path.realpath(path)
        assert not real.startswith(JAX_PKG + os.sep), path
    pkg_files = {os.path.relpath(os.path.realpath(p), PORT_PKG)
                 for p in loaded
                 if os.path.realpath(p).startswith(PORT_PKG + os.sep)}
    assert {"utils/jsonl.py", "utils/goodput.py", "train/resilience.py",
            "train/trace.py", "serve/wal.py"} <= pkg_files
    # what is not in the package is the scenarios' own child scripts
    others = [p for p in loaded
              if not os.path.realpath(p).startswith(PORT_PKG + os.sep)]
    assert all(os.path.basename(p) in ("chaos_child.py", "wal_child.py")
               for p in others), others


def test_campaign_tool_refuses_a_plan_with_a_bad_platform():
    proc = subprocess.run([sys.executable, "-S", TOOL, "lite",
                           "--platform", "tpu"], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 2 and "platform" in proc.stderr


@pytest.mark.slow
def test_lite_campaign_under_python_S_repeat_2(tmp_path):
    """The port's tool, file-path loading the port's ``chaos.py``, runs
    the ``lite`` plan twice under ``python -S`` (no torch): exit 0, every
    invariant held, equal digests, and the digest of JAX's tool."""
    out = tmp_path / "campaign.json"
    proc = subprocess.run(
        [sys.executable, "-S", TOOL, "lite", "--repeat", "2", "--json",
         str(out)], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "all invariants held" in proc.stdout
    doc = json.loads(out.read_text())
    assert doc["invariants_ok"] and doc["determinism"]["reproducible"]
    assert len(doc["determinism"]["digests"]) == 2
    want = jchaos.run_campaign(jchaos.load_plan("lite"), repeat=1)
    assert doc["determinism"]["digests"][0] == \
        want["determinism"]["digests"][0]
