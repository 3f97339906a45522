"""The port's `parquet-tool debug` against a port daemon, as
tests/test_observatory.py's TestDebugCLI pins the reference's: `--vars`
snapshots the daemon (its pid is this process's). The flight recorder,
the tenant table and the sampling profiler are cut with the obs package:
the daemon answers each view with a typed 501 not_ported, which the tool
prints and exits 1 on (as the reference's tool does on any HTTP error)."""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

from parquet_tpu_torch.serve import ScanServer, ServeConfig  # noqa: E402
from parquet_tpu_torch.tools.parquet_tool import main as tool_main  # noqa: E402

ROWS = 3000
ROW_GROUP = 1000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("debug_cli_corpus")
    rng = np.random.default_rng(5)
    t = pa.table({
        "id": pa.array(np.arange(ROWS, dtype=np.int64)),
        "v": pa.array(rng.standard_normal(ROWS).astype(np.float64)),
        "name": pa.array([f"n{i % 13}" for i in range(ROWS)]),
    })
    pq.write_table(t, str(d / "a.parquet"), row_group_size=ROW_GROUP)
    return d


@pytest.fixture()
def server(corpus):
    s = ScanServer(ServeConfig(port=0, root=str(corpus), cache_mb=16, device="cpu"))
    with s.start_background():
        yield s


class TestDebugCLI:
    def test_debug_vars(self, server, capsys):
        assert tool_main(["debug", server.url, "--vars"]) == 0
        out = capsys.readouterr().out
        doc = json.loads(out)
        assert doc["pid"] == os.getpid()
        # a bare host:port works as the base URL too
        assert tool_main(["debug", server.url.removeprefix("http://"), "--vars"]) == 0
        assert json.loads(capsys.readouterr().out)["pid"] == os.getpid()

    @pytest.mark.parametrize("argv", [[], ["--slow"], ["--id", "r1"], ["--id", "r1", "--trace"],
                                      ["--tenants"]], ids=lambda a: " ".join(a) or "list")
    def test_cut_views_print_the_typed_501(self, server, capsys, argv):
        assert tool_main(["debug", server.url, *argv]) == 1
        cap = capsys.readouterr()
        assert cap.out == ""
        assert cap.err.startswith("debug: not_ported: /v1/debug/")
        assert "parquet_tpu_torch does not port" in cap.err

    def test_profile_live_prints_the_typed_501(self, server, capsys):
        assert tool_main(["profile", "--live", server.url, "--seconds", "0.2"]) == 1
        err = capsys.readouterr().err
        assert err.startswith("profile: not_ported: /v1/debug/profile is not served")

    def test_trace_without_id_is_a_message(self, server, capsys):
        assert tool_main(["debug", server.url, "--trace"]) == 1
        assert "--trace requires --id" in capsys.readouterr().err

    def test_unreachable_daemon_is_a_message(self, capsys):
        rc = tool_main(["profile", "--live", "http://127.0.0.1:9", "--seconds", "0.1"])
        assert rc == 1 and "cannot reach" in capsys.readouterr().err
