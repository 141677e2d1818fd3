"""Every traffic file names an entry the harness has, and a frame
traffic an export whose files the judge reads back."""

import json
import os

from conftest import ROOT

TRAFFIC = os.path.join(ROOT, "benchmark", "traffic")


def test_traffic_entries_and_exports():
    """``export`` is ``geo`` (the default where absent): the harness writes
    ``.bgeo`` for ``bgeo``, which ``reference/geo.read`` cannot read back,
    and writes ``.geo`` for any other value."""
    names = sorted(n for n in os.listdir(TRAFFIC) if n.endswith(".json"))
    assert names
    for name in names:
        with open(os.path.join(TRAFFIC, name)) as f:
            body = json.load(f)
        assert body["entry"] in ("substeps", "frames"), name
        if body["entry"] == "frames":
            assert body.get("export", "geo") == "geo", name
            assert body["segment_frames"] >= 1 and body["checked_exports"] >= 1, name
