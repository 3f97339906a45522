"""The port's `parquet-tool scan --slo-ms`, as tests/test_controller.py's
TestScanSloGate pins the reference's: the elastic-SLO controller attached,
one report line, a non-zero exit when the p99 consumer wait breaks the
SLO, and the same verdict in the --json line. The scan delivers to the CPU
here (--cpu); on the card it delivers to CUDA."""

import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

N_FILES = 4
ROWS = 900
ROW_GROUP = 150


@pytest.fixture(scope="module")
def pattern(tmp_path_factory):
    d = tmp_path_factory.mktemp("ctl_cli_shards")
    rng = np.random.default_rng(3)
    for i in range(N_FILES):
        t = pa.table({"x": pa.array(rng.integers(0, 1 << 40, ROWS).astype(np.int64))})
        pq.write_table(t, str(d / f"s-{i:02d}.parquet"), row_group_size=ROW_GROUP)
    return str(d / "s-*.parquet")


class TestScanSloGate:
    def test_generous_slo_passes(self, pattern, capsys):
        from parquet_tpu_torch.tools.parquet_tool import main as tool_main

        rc = tool_main(["scan", pattern, "--cpu", "--slo-ms", "60000"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "slo held" in out

    def test_impossible_slo_fails_with_one_line_report(self, pattern, capsys):
        from parquet_tpu_torch.tools.parquet_tool import main as tool_main

        rc = tool_main(
            ["scan", pattern, "--cpu", "--slo-ms", "0.000001", "--json"]
        )
        out = capsys.readouterr().out
        assert rc != 0
        [line] = [ln for ln in out.splitlines() if "slo VIOLATED" in ln]
        assert "p99 wait" in line
        # the --json artifact carries the same verdict
        blob = next(
            json.loads(ln) for ln in out.splitlines() if ln.startswith("{")
        )
        assert blob["slo"]["held"] is False
        assert blob["rows"] == N_FILES * ROWS
