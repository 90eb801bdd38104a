"""Replica placement and the replica pool of the port, on the CPU.

`["cpu"] * k` stands in for k devices (a device may repeat, as in
parallel/mesh.py): the service's answers are equal at 1, 2 and 4
replicas and to the single-device service; a replica that fails is
quarantined and its work re-routed with the JAX package's degrade hop,
decided by fault keys; the device scope steers the engines' device;
without a card the pool and the engines raise unless the CPU is asked
for. The pool's lock names are the JAX package's, which the lock
witness and the concurrency analysis read.
"""

import json

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import pluss_sampler_optimization_torch.config as TC
from pluss_sampler_optimization_torch import service as TS
from pluss_sampler_optimization_torch.analysis import concurrency as t_conc
from pluss_sampler_optimization_torch.parallel import placement
from pluss_sampler_optimization_torch.runtime import faults as t_faults
from pluss_sampler_optimization_torch.sampler.sampled import resolve_device
from pluss_sampler_optimization_tpu.analysis import concurrency as j_conc


REQUESTS = [
    {"id": "a", "model": "gemm", "n": 12, "engine": "sampled", "ratio": 0.3,
     "seed": 1},
    {"id": "b", "model": "syrk", "n": 10, "engine": "sampled", "ratio": 0.3,
     "seed": 2},
    {"id": "c", "model": "gemm", "n": 8, "engine": "oracle"},
    {"id": "d", "model": "trmm", "n": 10, "engine": "exact"},
    {"id": "e", "model": "2mm", "n": 10, "engine": "sampled", "ratio": 0.3,
     "seed": 3, "runtime": "v2"},
]


def _answers(svc):
    tickets = [svc.submit(TS.parse_request_line(json.dumps(d)))
               for d in REQUESTS]
    return [svc.result(t) for t in tickets]


@pytest.fixture(scope="module")
def single():
    with TS.AnalysisService(device="cpu") as svc:
        return [r.mrc_digest for r in _answers(svc)]


@pytest.mark.parametrize("count", [1, 2, 4])
def test_replica_counts_answer_equally(count, single):
    with TS.AnalysisService(replicas=TC.ReplicaConfig(count=count),
                            device=["cpu"] * count) as svc:
        got = _answers(svc)
        stats = svc.executor.stats()
    assert [r.mrc_digest for r in got] == single
    assert all(r.ok and not r.degraded for r in got)
    assert {r.replica_id for r in got} <= set(range(count))
    assert stats["replicas"]["count"] == count
    assert stats["max_workers"] >= count


def test_one_named_device_repeats_once_per_replica(single):
    """A single device serves `count` replicas on itself (the CLI's
    --device cpu --replicas 2)."""
    with TS.AnalysisService(replicas=2, device="cpu") as svc:
        got = _answers(svc)
        snap = svc.executor.stats()["replicas"]
    assert snap["count"] == 2 and [r.mrc_digest for r in got] == single


def test_quarantine_reroutes_by_fault_key(single):
    """replica_dispatch fails replica 0's first pickup of each trace id:
    the work re-routes to replica 1 with the JAX package's degrade hop,
    and the answer is the same bytes."""
    t_faults.install(TC.FaultConfig(seed=0, rules=(
        {"site": "replica_dispatch", "kind": "raise", "p": 1.0,
         "match": {"replica": 0}},)))
    try:
        with TS.AnalysisService(replicas=2, device=["cpu", "cpu"],
                                resilience=TC.ResilienceConfig(
                                    breaker_probation_s=300.0)) as svc:
            got = _answers(svc)
            snap = svc.executor.stats()["replicas"]
    finally:
        t_faults.uninstall()
    assert [r.mrc_digest for r in got] == single
    assert all(r.replica_id == 1 for r in got)
    hops = [h for r in got for h in r.degraded]
    assert hops and all(h["from"] == "replica:0" and h["to"] == "replica:1"
                        for h in hops)
    assert snap["replicas"][0]["breaker"] == "open"


def test_device_scope_steers_the_engines():
    assert placement.active_device() is None
    with placement.device_scope(["cpu", "cpu"], replica_id=3) as devs:
        assert devs == [torch.device("cpu")] * 2
        assert placement.active_replica_id() == 3
        assert resolve_device(None) == torch.device("cpu")
        assert placement.place([1, 2]).device == torch.device("cpu")
        with placement.device_scope(["cpu"], replica_id=4):
            assert placement.active_replica_id() == 4
        assert placement.active_replica_id() == 3
    assert placement.active_device() is None


def test_without_a_card_nothing_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusals of a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.ReplicaPool(TC.ReplicaConfig(count=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with TS.AnalysisService() as svc:  # CUDA implied: the engine raises
        r = svc.analyze(TS.AnalysisRequest(model="gemm", n=8,
                                           engine="sampled"))
    assert not r.ok and "no CUDA device" in r.error


def test_warmup_from_ledger_warms_every_replica(tmp_path):
    led = str(tmp_path / "l.jsonl")
    with TS.AnalysisService(device="cpu", ledger_path=led) as svc:
        _answers(svc)
    with TS.AnalysisService(replicas=2, device=["cpu", "cpu"],
                            ledger_path=led) as svc:
        # three sampled fingerprints, once per replica
        assert svc.warm_from_ledger(8) == 6
        assert svc.warm_from_ledger(8) == 0  # structure-keyed: done


def test_lock_names_are_the_jax_packages():
    """The witness names locks by their make_lock/make_condition names,
    the static analysis by class and attribute: the port's scanned
    modules hold the JAX package's locks at the same paths, and one of
    their own, the kernel build store's (runtime/telemetry.py)."""
    def locks(conc):
        return {(lk["id"], lk["path"].split("/", 1)[1])
                for lk in conc.analyze_files().inventory["locks"]}

    assert locks(t_conc) == locks(j_conc) | {
        ("telemetry._build_lock", "runtime/telemetry.py")}
