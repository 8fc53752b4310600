"""PyTorch port: ``repro_torch.runtime`` (``fault``, ``chaos``) against
the reference's ``repro.runtime``.

The cases of ``tests/test_runtime.py`` (injector fire-once semantics,
straggler EMA/warmup/threshold, elastic remesh edge cases, the restart
loop's resume logic and forward-progress budget reset, backoff jitter,
the circuit-breaker state machine) and the fault and ``ElasticPlan``
cases of ``tests/test_substrate.py``, run against the port; then parity
with the reference over seeded random inputs: the same
``backoff_delays`` values (the same jitter stream), the same
``CircuitBreaker`` transitions, the same ``StragglerMonitor`` flags and
EMA, the same restart traces, and the same ``ChaosPlan`` firing and
``ChaosReport.summary()``.  JAX is not needed: the reference modules are
plain Python.
"""
import numpy as np
import pytest

from repro_torch.runtime.chaos import ChaosPlan, ChaosReport, FaultEvent
from repro_torch.runtime.fault import (CircuitBreaker, ElasticPlan,
                                       FailureInjector, StepFailure,
                                       StragglerMonitor, backoff_delays,
                                       run_with_restarts)


class TestFailureInjector:
    def test_fires_once_per_step(self):
        inj = FailureInjector(fail_at={3: "boom"})
        with pytest.raises(StepFailure, match="boom"):
            inj.check(3)
        inj.check(3)                    # second visit: already fired
        assert inj.fired == {3}

    def test_only_configured_steps_fire(self):
        inj = FailureInjector(fail_at={2: "a", 5: "b"})
        for step in (0, 1, 3, 4, 6):
            inj.check(step)
        with pytest.raises(StepFailure, match="a"):
            inj.check(2)
        with pytest.raises(StepFailure, match="b"):
            inj.check(5)


class TestStragglerMonitor:
    def test_first_record_seeds_ema_without_flagging(self):
        mon = StragglerMonitor(threshold=2.0, warmup=0)
        assert not mon.record(0, 5.0)   # seeds EMA, never a straggler
        assert mon.ema == 5.0

    def test_warmup_suppresses_flags(self):
        mon = StragglerMonitor(threshold=2.0, warmup=5)
        assert not mon.record(0, 0.1)
        # 10x the EMA, but still inside warmup (n <= warmup)
        assert not mon.record(1, 1.0)

    def test_threshold_and_ema_freeze_on_straggler(self):
        mon = StragglerMonitor(ema_alpha=0.5, threshold=2.0, warmup=1)
        for i in range(4):
            assert not mon.record(i, 0.1)
        ema_before = mon.ema
        assert mon.record(4, 0.1 * 2.0 + 0.01)   # just over threshold*EMA
        # the straggler sample must NOT drag the EMA up (that would let a
        # slow regime mask itself)
        assert mon.ema == ema_before
        assert len(mon.events) == 1
        ev = mon.events[0]
        assert ev["step"] == 4 and ev["ema"] == ema_before

    def test_subthreshold_updates_ema(self):
        mon = StragglerMonitor(ema_alpha=0.5, threshold=2.0, warmup=0)
        mon.record(0, 0.1)
        mon.record(1, 0.2)              # below 2x, folds into EMA
        assert mon.ema == pytest.approx(0.15)
        assert mon.events == []

    def test_callback_invoked(self):
        seen = []
        mon = StragglerMonitor(threshold=2.0, warmup=1,
                               on_straggler=lambda s, t, e:
                               seen.append((s, t, e)))
        for i in range(3):
            mon.record(i, 0.1)
        mon.record(3, 1.0)
        assert len(seen) == 1 and seen[0][0] == 3


class TestElasticPlan:
    def test_full_mesh(self):
        plan = ElasticPlan(global_batch=256)
        full = plan.remesh(256, 16)
        assert full["mesh_shape"] == (16, 16)
        assert full["per_shard_batch"] == 16

    def test_non_power_of_two_model_parallel_degrades(self):
        # 12 devices, mp=5: 5 does not divide 12, degrade 5 -> 2
        plan = ElasticPlan(global_batch=120)
        out = plan.remesh(12, 5)
        assert out["mesh_shape"] == (6, 2)
        assert out["per_shard_batch"] == 20

    def test_model_parallel_degrades_to_one(self):
        plan = ElasticPlan(global_batch=7)
        out = plan.remesh(7, 4)         # 4 -> 2 -> 1 (7 is prime)
        assert out["mesh_shape"] == (7, 1)
        assert out["per_shard_batch"] == 1

    def test_small_global_batch_clamps_to_one(self):
        # data shards (8) exceed the global batch (2): per-shard batch
        # clamps to 1 instead of going to 0
        plan = ElasticPlan(global_batch=2)
        out = plan.remesh(8, 1)
        assert out["mesh_shape"] == (8, 1)
        assert out["per_shard_batch"] == 1

    def test_indivisible_batch_rejected(self):
        plan = ElasticPlan(global_batch=100)
        with pytest.raises(AssertionError):
            plan.remesh(8, 1)           # 100 % 8 != 0 and 8 % 100 != 0


class TestRunWithRestarts:
    def test_resume_step_logic(self):
        """on_restart's return value is the resume step; work is not
        re-done past the restored point."""
        inj = FailureInjector(fail_at={3: "boom", 7: "boom2"})
        seen = []

        def step(i):
            inj.check(i)
            seen.append(i)

        done, restarts = run_with_restarts(
            step, start_step=0, total_steps=10,
            on_restart=lambda at: max(seen[-1] + 1 if seen else 0, 0))
        assert done == 10 and restarts == 2
        assert sorted(set(seen)) == list(range(10))

    def test_restart_without_callback_retries_same_step(self):
        inj = FailureInjector(fail_at={2: "x"})
        seen = []

        def step(i):
            inj.check(i)
            seen.append(i)

        done, restarts = run_with_restarts(step, start_step=0,
                                           total_steps=4)
        assert done == 4 and restarts == 1
        assert seen == [0, 1, 2, 3]     # step 2 re-ran after the failure

    def test_sporadic_failures_do_not_exhaust_budget(self):
        """Regression: the restart budget resets on forward progress, so
        a long run with MORE total recoverable failures than
        ``max_restarts`` still completes (it used to raise spuriously)."""
        # one failure every 10 steps: 10 failures total, budget 2
        inj = FailureInjector(fail_at={s: "flake" for s in range(5, 100, 10)})
        last = [-1]

        def step(i):
            inj.check(i)
            last[0] = i

        done, restarts = run_with_restarts(
            step, start_step=0, total_steps=100, max_restarts=2,
            on_restart=lambda at: last[0] + 1)
        assert done == 100
        assert restarts == 10           # total count is still reported

    def test_no_progress_still_exhausts_budget(self):
        """A failure loop stuck at one step must still raise once the
        consecutive budget is spent — the reset only rewards progress."""
        calls = [0]

        def step(i):
            if i == 3:
                calls[0] += 1
                raise StepFailure("stuck")

        with pytest.raises(StepFailure, match="stuck"):
            run_with_restarts(step, start_step=0, total_steps=5,
                              max_restarts=3,
                              on_restart=lambda at: 3)
        assert calls[0] == 4            # initial try + 3 budgeted restarts


class TestBackoff:
    def test_exponential_growth_and_cap(self):
        ds = [backoff_delays(a, base=0.1, factor=2.0, cap=0.5)
              for a in range(5)]
        assert ds == [0.1, 0.2, 0.4, 0.5, 0.5]

    def test_jitter_is_deterministic_and_bounded(self):
        d1 = [backoff_delays(a, base=0.1, jitter=0.5,
                             rng=np.random.default_rng(42))
              for a in range(4)]
        d2 = [backoff_delays(a, base=0.1, jitter=0.5,
                             rng=np.random.default_rng(42))
              for a in range(4)]
        assert d1 == d2                 # same seed -> same jitter
        for a, d in enumerate(d1):
            nominal = min(2.0, 0.1 * 2.0 ** a)
            assert 0.5 * nominal <= d <= 1.5 * nominal


class TestCircuitBreaker:
    def test_trips_after_consecutive_failures_only(self):
        br = CircuitBreaker(failure_threshold=3, cooldown=1.0)
        br.record_failure(0.0)
        br.record_failure(0.1)
        br.record_success(0.2)          # resets the consecutive count
        br.record_failure(0.3)
        br.record_failure(0.4)
        assert br.state == "closed" and br.trips == 0
        br.record_failure(0.5)
        assert br.state == "open" and br.trips == 1

    def test_half_open_probe_recovers(self):
        br = CircuitBreaker(failure_threshold=1, cooldown=1.0)
        br.record_failure(0.0)
        assert br.state == "open"
        assert not br.allow(0.5)        # cooling down
        assert br.allow(1.1)            # -> half-open, one probe admitted
        assert br.state == "half-open"
        br.record_success(1.2)
        assert br.state == "closed" and br.recoveries == 1
        assert br.allow(1.3)

    def test_half_open_failure_reopens(self):
        br = CircuitBreaker(failure_threshold=1, cooldown=1.0)
        br.record_failure(0.0)
        assert br.allow(1.5)            # probe
        br.record_failure(1.6)
        assert br.state == "open"
        assert not br.allow(2.0)        # cooldown restarted at 1.6
        assert br.allow(2.7)

    def test_transitions_recorded(self):
        br = CircuitBreaker(failure_threshold=1, cooldown=0.5)
        br.record_failure(0.0)
        br.allow(0.6)
        br.record_success(0.7)
        assert [(t["from"], t["to"]) for t in br.transitions] == \
            [("closed", "open"), ("open", "half-open"),
             ("half-open", "closed")]


# ---------------------------------------------------------------------------
# tests/test_substrate.py's fault cases

class TestSubstrateFault:
    def test_run_with_restarts(self):
        inj = FailureInjector(fail_at={3: "boom", 7: "boom2"})
        seen = []

        def step(i):
            inj.check(i)
            seen.append(i)

        def on_restart(step_at_fail):
            return max(seen[-1] + 1 if seen else 0, 0)

        done, restarts = run_with_restarts(step, start_step=0,
                                           total_steps=10,
                                           on_restart=on_restart)
        assert done == 10 and restarts == 2
        assert sorted(set(seen)) == list(range(10))

    def test_straggler_monitor(self):
        mon = StragglerMonitor(threshold=2.0, warmup=2)
        for i in range(8):
            assert not mon.record(i, 0.1)
        assert mon.record(8, 0.5)
        assert len(mon.events) == 1

    def test_elastic_plan(self):
        plan = ElasticPlan(global_batch=256)
        assert plan.remesh(256, 16)["mesh_shape"] == (16, 16)
        degraded = plan.remesh(128, 16)
        assert degraded["mesh_shape"][0] * degraded["mesh_shape"][1] == 128


class TestChaos:
    def test_each_fault_fires_once(self):
        plan = ChaosPlan(device_loss_at={2: 4}, nan_at={1},
                         straggle_at={3: 5.0})
        assert plan.device_loss(2) == 4 and plan.device_loss(2) is None
        assert plan.device_loss(1) is None
        assert plan.corrupts(1) and not plan.corrupts(1)
        assert plan.straggle(3) == 5.0 and plan.straggle(3) == 0.0

    def test_report_metrics(self):
        rep = ChaosReport(seg_wall_s=[1.0, 2.0, 3.0],
                          ckpt_save_s=[0.1, 0.3])
        rep.events += [FaultEvent("corruption", 1, 4, 4, 4, 0.5),
                       FaultEvent("corruption", 3, 4, 4, 2, 0.7)]
        assert rep.checkpoint_overhead_pct() == pytest.approx(15.0)
        assert rep.iters_lost() == 6 and rep.iters_lost("straggler") == 0
        assert rep.summary()["faults"]["corruption"] == {
            "count": 2, "iters_lost": 6, "recover_s": 0.7}
        assert ChaosReport().checkpoint_overhead_pct() == 0.0


# ---------------------------------------------------------------------------
# parity with the reference over seeded random inputs

SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
def test_backoff_matches_reference(seed):
    from repro.runtime import fault as rf
    rng = np.random.default_rng(seed)
    kw = dict(base=float(rng.uniform(0.01, 0.2)),
              factor=float(rng.uniform(1.5, 3.0)),
              cap=float(rng.uniform(0.5, 4.0)),
              jitter=float(rng.uniform(0.0, 0.9)))
    ours = [backoff_delays(a, rng=np.random.default_rng(seed), **kw)
            for a in range(8)]
    ref = [rf.backoff_delays(a, rng=np.random.default_rng(seed), **kw)
           for a in range(8)]
    assert ours == ref
    g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
    assert [backoff_delays(a, rng=g1, **kw) for a in range(8)] == \
        [rf.backoff_delays(a, rng=g2, **kw) for a in range(8)]
    assert [backoff_delays(a) for a in range(8)] == \
        [rf.backoff_delays(a) for a in range(8)]


@pytest.mark.parametrize("seed", SEEDS)
def test_breaker_transitions_match_reference(seed):
    from repro.runtime import fault as rf
    rng = np.random.default_rng(seed)
    kw = dict(failure_threshold=int(rng.integers(1, 4)),
              cooldown=float(rng.uniform(0.05, 0.5)))
    ours, ref = CircuitBreaker(**kw), rf.CircuitBreaker(**kw)
    now = 0.0
    for _ in range(200):
        now += float(rng.exponential(0.05))
        op = int(rng.integers(3))
        if op == 0:
            assert ours.allow(now) == ref.allow(now)
        elif op == 1:
            ours.record_success(now)
            ref.record_success(now)
        else:
            ours.record_failure(now)
            ref.record_failure(now)
        assert ours.state == ref.state
    assert ours.transitions == ref.transitions
    assert (ours.trips, ours.recoveries, ours.consecutive_failures,
            ours.opened_at) == (ref.trips, ref.recoveries,
                                ref.consecutive_failures, ref.opened_at)


@pytest.mark.parametrize("seed", SEEDS)
def test_straggler_flags_match_reference(seed):
    from repro.runtime import fault as rf
    rng = np.random.default_rng(seed)
    kw = dict(ema_alpha=float(rng.uniform(0.05, 0.5)),
              threshold=float(rng.uniform(1.5, 3.0)),
              warmup=int(rng.integers(0, 5)))
    walls = rng.lognormal(mean=-2.0, sigma=0.6, size=300)
    walls[rng.integers(0, 300, size=10)] *= 10.0
    ours, ref = StragglerMonitor(**kw), rf.StragglerMonitor(**kw)
    flags = [(ours.record(i, float(w)), ref.record(i, float(w)))
             for i, w in enumerate(walls)]
    assert all(a == b for a, b in flags) and any(a for a, _ in flags)
    assert ours.events == ref.events and ours.ema == ref.ema


@pytest.mark.parametrize("seed", SEEDS)
def test_run_with_restarts_matches_reference(seed):
    from repro.runtime import fault as rf
    rng = np.random.default_rng(seed)
    fail_at = {int(s): "x" for s in rng.integers(0, 40, size=6)}

    def drive(mod):
        inj = mod.FailureInjector(fail_at=dict(fail_at))
        trace = []

        def step(i):
            inj.check(i)
            trace.append(i)

        out = mod.run_with_restarts(
            step, start_step=0, total_steps=40, max_restarts=2,
            on_restart=lambda at: max(0, at - int(rng_r.integers(0, 3))))
        return out, trace

    from repro_torch.runtime import fault as pf
    rng_r = np.random.default_rng(seed + 100)
    ours = drive(pf)
    rng_r = np.random.default_rng(seed + 100)
    assert ours == drive(rf)


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_matches_reference(seed):
    from repro.runtime import chaos as rc
    rng = np.random.default_rng(seed)
    kw = dict(device_loss_at={int(rng.integers(0, 6)): 2},
              nan_at={int(s) for s in rng.integers(0, 6, size=2)},
              straggle_at={int(rng.integers(0, 6)): 100.0})
    ours, ref = ChaosPlan(**kw), rc.ChaosPlan(**kw)
    visits = [int(s) for s in rng.integers(0, 6, size=30)]
    assert [(ours.device_loss(s), ours.corrupts(s), ours.straggle(s))
            for s in visits] == \
        [(ref.device_loss(s), ref.corrupts(s), ref.straggle(s))
         for s in visits]
    reps = ChaosReport(), rc.ChaosReport()
    for rep, ev in zip(reps, (FaultEvent, rc.FaultEvent)):
        g = np.random.default_rng(seed)
        rep.restarts, rep.segments_run = 3, 12
        rep.seg_wall_s += [float(v) for v in g.random(12)]
        rep.ckpt_save_s += [float(v) for v in g.random(12) / 10]
        rep.straggler_flags.append(4)
        rep.events += [ev("device-loss", 2, 4, 2, 0, 0.25),
                       ev("corruption", 6, 2, 2, 10, 0.5),
                       ev("straggler", 4, 2, 2, 0, 0.0)]
    assert reps[0].summary() == reps[1].summary()
