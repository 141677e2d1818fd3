"""The port's ``utils/profiling`` against the JAX package's (as
tests/test_core.py's TestProfiling holds the JAX one): ``StepTimer``'s
laps and summary keys, and ``trace`` with ``annotate`` inside writing its
trace and table."""

import os

import jax.numpy as jnp
import pytest
import torch

from libclsph_tpu.utils import profiling as jprofiling
from libclsph_tpu_torch.utils import profiling
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("value", [lambda i: torch.tensor(float(i)), float],
                         ids=["tensor", "number"])
def test_step_timer_matches_jax(value):
    t, j = profiling.StepTimer(), jprofiling.StepTimer()
    for i in range(3):
        t.lap(value(i))
        j.lap(jnp.float32(i))
    s, js = t.summary(), j.summary()
    assert set(s) == set(js)
    assert s["count"] == js["count"] == 3 == len(t.laps)
    assert s["mean_ms"] >= 0.0 and s["max_ms"] >= s["median_ms"] >= s["min_ms"]
    assert s["p90_ms"] <= s["max_ms"]
    assert profiling.StepTimer().summary() == jprofiling.StepTimer().summary() == {"count": 0}


def test_wait_for_returns_the_value():
    assert profiling.wait_for(torch.tensor(2.5)) == 2.5
    assert profiling.wait_for(3) == 3.0


def test_trace_writes_trace_and_table(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("phase"):
            (torch.ones(8) * 2).sum()
    assert sorted(os.listdir(tmp_path)) == sorted([profiling.TABLE_FILE, profiling.TRACE_FILE])
    assert "phase" in (tmp_path / profiling.TABLE_FILE).read_text()
    assert any(e.key == "phase" for e in prof.key_averages())
    assert os.path.getsize(tmp_path / profiling.TRACE_FILE) > 0
