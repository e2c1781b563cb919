"""The port's host-process tuning (``avede_tpu_torch/utils/system.py``)
against the JAX package's ``avede_tpu/utils/system.py`` on the same
settings: the GC thresholds set inside ``optimized_context`` and
restored after it, and ``ResourceMonitor`` recording host memory
pressure into its package's metrics monitor, collecting garbage above
its high-water mark and stopping."""

import gc
import time

import pytest


def _packages():
    from avede_tpu.utils import metrics as jmetrics
    from avede_tpu.utils import system as jsystem

    from avede_tpu_torch.utils import metrics as tmetrics
    from avede_tpu_torch.utils import system as tsystem

    return {"jax": (jsystem, jmetrics), "port": (tsystem, tmetrics)}


def test_optimized_context_matches_jax():
    jsystem, tsystem = _packages()["jax"][0], _packages()["port"][0]
    before = gc.get_threshold()
    try:
        gc.set_threshold(123, 9, 9)
        inside = {}
        for name, module in (("jax", jsystem), ("port", tsystem)):
            with module.optimized_context():
                inside[name] = gc.get_threshold()
            assert gc.get_threshold() == (123, 9, 9)
        assert inside["port"] == inside["jax"] == (700, 10, 10)
        with pytest.raises(RuntimeError):
            with tsystem.optimized_context():
                raise RuntimeError("restored on the way out too")
        assert gc.get_threshold() == (123, 9, 9)
    finally:
        gc.set_threshold(*before)


def _wait_for_pressure(metrics) -> dict:
    deadline = time.time() + 3.0
    while time.time() < deadline:
        ops = metrics.get_monitor().summary()["operations"]
        if "host_memory_pressure" in ops:
            return ops["host_memory_pressure"]
        time.sleep(0.02)
    return {}


@pytest.mark.parametrize("high_water", [0.0, 2.0])
def test_resource_monitor_matches_jax(monkeypatch, high_water):
    """Both monitors at a 0.02 s interval: each records the pressure
    into its own package's monitor, collects garbage on every sample
    when the mark is 0 and never when it is above 1, and stops."""
    packages = _packages()
    tsystem = packages["port"][0]
    monkeypatch.setattr(tsystem.ResourceMonitor, "INTERVAL_S", 0.02)
    monkeypatch.setattr(tsystem.ResourceMonitor, "HIGH_WATER", high_water)
    collected = []
    monkeypatch.setattr(gc, "collect", lambda *a: collected.append(1) or 0)
    for name, (module, metrics) in packages.items():
        monkeypatch.setattr(metrics, "_MONITOR", None)
        mon = (module.ResourceMonitor(interval_s=0.02, high_water=high_water)
               if name == "jax" else module.ResourceMonitor())
        collected.clear()
        mon.start()
        assert mon.start() is mon          # a second start is a no-op
        try:
            rec = _wait_for_pressure(metrics)
        finally:
            mon.stop()
        assert mon._thread is None
        assert rec.get("count_total", 0) >= 1, name
        assert 0.0 <= rec["p50_seconds"] <= 1.0
        assert bool(collected) == (high_water == 0.0), name
