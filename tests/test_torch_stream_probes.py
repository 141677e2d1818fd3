"""The stream probes, ``experiments/torch_force_kernel_bisect.py`` and
``experiments/torch_nl_kernel_variants.py``, on the CPU at 4,096
particles (their 1M runs are ``chip_smoke.py``'s phase 13): their
records, the facts they check on the way (each stream and its sums
against their plain versions, failing on a disagreement; the stream's
accel mode bit for bit against ``forces_q128_c32`` on the bisect's
lists; the planes' sums equal to the staged ones), the lines they time
with the work their bounds count, and their command lines,
which print the record as the last line. A CPU run has no device time;
the bounds are the card's, computed from this run's inputs."""

import json
import os
import sys

import pytest

from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import kernel_bounds  # noqa: E402
import torch_force_kernel_bisect  # noqa: E402
import torch_nl_kernel_variants  # noqa: E402

N = 4096
BISECT_LINES = {"index_select", "gather_stream", "gather_stream planes",
                "forces_c32_stream sums", "forces_c32_stream planes",
                "forces_c32_stream no cull", "forces_c32_stream test",
                "forces_c32_stream count=0", "forces_q128_c32", "forces_c32_stream accel",
                "density_c32 groups 1"}
VARIANT_LINES = {"gather_stream", "gather_stream planes", "forces_c32_stream sums",
                 "forces_c32_stream planes", "asm e2e density_c32 groups 1",
                 "asm e2e forces_q128_c32"}


def _check_lines(rec, names):
    assert set(rec["lines"]) == names
    for name, line in rec["lines"].items():
        assert line["ms"] > 0 and line["device_ms"] is None
        assert line["bound_ms"] > 0 and line["bound_by"] in ("bytes", "operations")
        assert (line["bound_ms"], line["bound_by"]) == kernel_bounds.bound(line["bytes"],
                                                                           line["ops"])
        # the stream kernels' lines carry their plain version's time: none
        # on the CPU, where the kernel's line is the plain version
        assert ("plain_ms" in line) == (name.startswith(("gather_stream", "forces_c32_stream"))
                                        and name != "forces_c32_stream count=0")
        assert line.get("plain_ms") is None
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["flags"] == 0 and rec["planes_equal_staged"]
    assert rec["sums_err_vs_plain"] == 0.0  # the CPU's kernel is the plain version
    assert 0 < rec["live_bytes"] <= rec["stream_bytes"]
    assert rec["pairs_in_support"] > N  # more than the self pairs


def test_bisect_probe_record():
    rec = torch_force_kernel_bisect.run(N, "cpu", reps=1)
    _check_lines(rec, BISECT_LINES)
    assert rec["bit_equal_to_forces_q128_c32"]
    assert rec["live_bytes"] == rec["live_slots"] * 32 * 48
    assert rec["max_sub"] == 128 and rec["max_hit"] == 96 and rec["refine"] == "exact"
    assert set(rec["split"]) == {"feed", "test", "terms"} and rec["split_clock"] == "ms"
    assert rec["launches"]["gather_stream"][0] == 0  # the CPU launches no kernel
    assert "dot modes" in rec["not_ported"]


def test_variants_probe_record():
    rec = torch_nl_kernel_variants.run(N, "cpu", reps=1)
    _check_lines(rec, VARIANT_LINES)
    assert rec["refine"] == "aabb" and rec["max_sub"] == 192 and not rec["compacted"]
    assert set(rec["counterparts"]) <= set(rec["lines"])
    assert set(rec["served_by"].values()) <= set(rec["lines"])


@pytest.mark.parametrize("probe", [torch_force_kernel_bisect, torch_nl_kernel_variants],
                         ids=["bisect", "variants"])
def test_probe_main_prints_its_record_last(probe, capsys):
    assert probe.main(["--device", "cpu", "--n", "2048", "--reps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n"] == 2048 and rec["lines"]


def test_stream_lines_fail_on_a_disagreement(monkeypatch):
    """The probes hold the stream and its sums against their plain
    versions before timing: a wrapper that strays fails the probe."""
    from libclsph_tpu_torch.ops.kernels import stream

    s = torch_force_kernel_bisect.setup(2048, "cpu")
    good_gather, good_sums = stream.gather_stream, stream.forces_c32_stream

    def bad_gather(*args):
        out = good_gather(*args)
        out[0, 0, 0] += 1.0
        return out

    def bad_sums(*args, **kw):
        out = good_sums(*args, **kw)
        return out if kw.get("out") == "test" else out * 1.001

    monkeypatch.setattr(stream, "gather_stream", bad_gather)
    with pytest.raises(RuntimeError, match="gather_stream staged"):
        torch_force_kernel_bisect.stream_lines(s, 1, full=False)
    monkeypatch.setattr(stream, "gather_stream", good_gather)
    monkeypatch.setattr(stream, "forces_c32_stream", bad_sums)
    with pytest.raises(RuntimeError, match="forces_c32_stream sums"):
        torch_force_kernel_bisect.stream_lines(s, 1, full=False)


def test_stream_bounds_count_the_pairs_each_mode_needs():
    """The sums and the fused kernel are charged FORCE_OPS for each pair
    inside the support only, the test mode PAIR_TEST_OPS for each of them;
    only the no-cull mode is charged a test for every pair of a query with
    a live candidate."""
    import torch

    f8 = torch.zeros(256, 8)
    dens, real = torch.zeros(256), torch.ones(256, dtype=torch.bool)
    cand, count = torch.zeros(2, 4, dtype=torch.int32), torch.tensor([3, 1], dtype=torch.int32)
    live, pairs_in = int(count.sum()) * 32, 1000
    work = kernel_bounds.stream_works(f8, dens, real, cand, count, live, pairs_in)
    for name in ("forces_c32_stream sums", "forces_c32_stream planes",
                 "forces_c32_stream accel", "forces_q128_c32"):
        assert work[name][1] == pairs_in * kernel_bounds.FORCE_OPS
    assert work["forces_c32_stream test"][1] == pairs_in * kernel_bounds.PAIR_TEST_OPS
    assert work["forces_c32_stream no cull"][1] == (
        live * 128 * kernel_bounds.PAIR_TEST_OPS
        + pairs_in * (kernel_bounds.FORCE_OPS - kernel_bounds.PAIR_TEST_OPS))
    assert work["forces_c32_stream sums"][0] == (256 * 32 + 2 * 4 + live * 48 + 256 * 40)
    assert work["gather_stream"][0] == 256 * 32 + 2 * 4 * 4 + 2 * 4 + 2 * 4 * 32 * 48
