"""The port's `parquet-tool debug` against a port daemon, as
tests/test_observatory.py's TestDebugCLI pins the reference's: `--vars`
snapshots the daemon (its pid is this process's). The flight-recorder
views, the tenant table and `profile --live` hold the port's tool on the
port's daemon against the reference's tool on the reference's daemon,
after the same request on each (both recorders and ledgers emptied
first): the same exit code, the same output with ids, times and numbers
masked (a record's keys for --id)."""

import json
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

from parquet_tpu_torch.obs.cost import LEDGER as PLEDGER  # noqa: E402
from parquet_tpu_torch.obs.recorder import RECORDER as PRECORDER  # noqa: E402
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


@pytest.fixture()
def reference(corpus):
    """The reference's daemon on the same corpus."""
    jserve = pytest.importorskip("parquet_tpu.serve")
    s = jserve.ScanServer(jserve.ServeConfig(port=0, root=str(corpus), cache_mb=16))
    with s.start_background():
        yield s


def jax_tool_main(argv):
    from parquet_tpu.tools.parquet_tool import main

    return main(argv)


def debug_run(tool, server, argv, capsys):
    """Empty the package's recorder and ledger, record one /v1/plan request
    under the id r1, then run `debug URL argv`: (rc, stdout, stderr)."""
    import urllib.request

    if tool is tool_main:
        rec, ledger = PRECORDER, PLEDGER
    else:
        from parquet_tpu.obs.cost import LEDGER as ledger
        from parquet_tpu.obs.recorder import RECORDER as rec
    rec.__init__(rec.config)
    ledger.reset()
    req = urllib.request.Request(server.url + "/v1/plan?paths=a.parquet",
                                 headers={"X-Request-Id": "r1"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.status == 200
    capsys.readouterr()
    rc = tool(["debug", server.url, *argv])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def masked(text: str) -> str:
    """Output with hex ids, times and numbers masked, and the column
    padding that their widths set collapsed."""
    text = re.sub(r"\b[0-9a-f]{16,32}\b", "<id>", text)
    text = re.sub(r"\d+(\.\d+)?(e-?\d+)?", "0", text)
    return re.sub(r"[ \t]+", " ", text)


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
    def test_cut_views_print_the_typed_501(self, server, reference, capsys, argv):
        got, want = (debug_run(tool, s, argv, capsys)
                     for tool, s in ((tool_main, server), (jax_tool_main, reference)))
        assert got[0] == want[0]
        if argv[:2] == ["--id", "r1"] and "--trace" not in argv:
            assert got[0] == 0 and set(json.loads(got[1])) == set(json.loads(want[1]))
        else:
            assert masked(got[1]) == masked(want[1]) and masked(got[2]) == masked(want[2])

    def test_profile_live_prints_the_typed_501(self, server, reference, capsys):
        got, want = (
            (tool(["profile", "--live", s.url, "--seconds", "0.2"]), capsys.readouterr())
            for tool, s in ((tool_main, server), (jax_tool_main, reference))
        )
        assert got[0] == want[0] == 0
        # collapsed stacks: `lane;frame;... count` a line, on both
        for out in (got[1].out, want[1].out):
            lines = out.splitlines()
            assert lines and all(re.fullmatch(r"\S.* \d+", ln) for ln in lines)

    def test_trace_without_id_is_a_message(self, server, capsys):
        assert tool_main(["debug", server.url, "--trace"]) == 1
        assert "--trace requires --id" in capsys.readouterr().err

    def test_unreachable_daemon_is_a_message(self, capsys):
        rc = tool_main(["profile", "--live", "http://127.0.0.1:9", "--seconds", "0.1"])
        assert rc == 1 and "cannot reach" in capsys.readouterr().err
