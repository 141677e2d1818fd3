"""The CLI runs the 16-wide force path (``--no-force-sub8``,
``--no-density-sub16``) on the tiny cube and refuses the 16-granular
tables at 128 query rows with the JAX package's reason.
"""

import os

from libclsph_tpu_torch import cli
from test_torch_tier2 import _tiny_root
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_cli_refuses_unported_tables_with_the_message(capsys, tmp_path, monkeypatch):
    """--no-force-sub8 and --no-density-sub16 (which drops force_sub8, as
    the JAX CLI does) run the 16-wide force path and write frames; the
    16-granular tables at 128 query rows are refused with the JAX
    package's reason."""
    root = _tiny_root(tmp_path)
    monkeypatch.chdir(tmp_path)
    for flag in ("--no-force-sub8", "--no-density-sub16"):
        out = f"out{flag}_"
        rc = cli.main(["water", "tiny", "cube", out, "--device", "cpu", "--root", str(root),
                       flag])
        assert rc == 0, capsys.readouterr().err
        frames = sorted(os.listdir(tmp_path / f"{out}frames"))
        assert len(frames) == 4 and frames[0] == "frame0000001.geo"
    rc = cli.main(["water", "tiny", "cube", "out_", "--device", "cpu",
                   "--force-query-rows", "128"])
    assert rc == -1
    assert "force_query_rows" in capsys.readouterr().err
