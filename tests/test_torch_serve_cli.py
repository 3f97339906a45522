"""The port's `parquet-tool serve` and `route` as child processes, as
tests/test_serve.py's TestServeCLI pins the reference's daemon: started as
`python -m parquet_tpu_torch.tools.parquet_tool serve --cpu --port 0`, its
`serve: listening on URL` line parsed, a request answered, SIGTERM drained
with `serve: drained, bye` and exit 0; the router in front of it answers
the same /v1/query body; `scan --filters` shares the daemon's spec parser.
Without --cpu on a host without CUDA the daemon exits 1 before it binds."""

import json
import os
import select
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
WATCHDOG_S = 30.0  # every blocking wait in this file is bounded by this
ROWS_A, ROWS_B = 2400, 1800
ROW_GROUP = 800
QUERY = {"paths": "*.parquet", "aggregates": ["count", ["sum", "id"], ["min", "id"]],
         "filters": [["id", ">=", 1000]]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two files, several row groups each, ids globally sorted so min/max
    statistics can prune whole groups (tests/test_serve.py's corpus)."""
    d = tmp_path_factory.mktemp("serve_cli_corpus")
    rng = np.random.default_rng(7)
    rows = {"a.parquet": (0, ROWS_A), "b.parquet": (ROWS_A, ROWS_B)}
    for name, (base, n) in rows.items():
        t = pa.table({
            "id": pa.array(np.arange(base, base + n, dtype=np.int64)),
            "v": pa.array(rng.standard_normal(n).astype(np.float64)),
            "name": pa.array([f"n{i % 13}" for i in range(n)]),
        })
        pq.write_table(t, str(d / name), row_group_size=ROW_GROUP)
    return d


def _start(args, tmp_path, name, env=None):
    """The tool as a child process; (proc, its first stdout line). Its
    stderr goes to a file (the first stdout line is the one scripts parse)."""
    err = open(tmp_path / f"{name}.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "parquet_tpu_torch.tools.parquet_tool", *args],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=err, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
    )
    err.close()
    ready, _, _ = select.select([proc.stdout], [], [], WATCHDOG_S)
    line = proc.stdout.readline() if ready else ""
    return proc, line


def _stop(proc):
    """SIGTERM, then (exit code, the rest of stdout). The rest is read from
    the same buffered reader the first line came from (communicate() would
    read the pipe past lines that reader already holds)."""
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=WATCHDOG_S)
    return rc, proc.stdout.read()


def _kill(*procs):
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=5)


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=WATCHDOG_S).read()


class TestServeCLI:
    def test_serve_daemon_subprocess_sigterm(self, corpus, tmp_path):
        proc = None
        try:
            proc, line = _start(["serve", "--cpu", "--port", "0", "--root", str(corpus)],
                                tmp_path, "serve")
            assert line.startswith("serve: listening on http://"), (
                line, (tmp_path / "serve.err").read_text()[-2000:])
            url = line.split()[-1]
            got = _post(url, "/v1/scan", {"paths": "a.parquet", "limit": 2})
            assert got.count(b"\n") == 2
            rc, out = _stop(proc)
            assert rc == 0
            assert out.splitlines()[-1] == "serve: drained, bye"
            assert f"serve: root {corpus}" in out
        finally:
            _kill(proc)

    def test_query_through_daemon_and_router_equals_run_local_query(self, corpus, tmp_path):
        from parquet_tpu_torch.serve import parse_query_request, render_query_body
        from parquet_tpu_torch.serve import run_local_query

        q = parse_query_request(json.dumps(dict(QUERY, paths=str(corpus / "*.parquet"))).encode())
        want = render_query_body(run_local_query(q.paths, q, device="cpu"))
        daemon = router = None
        try:
            daemon, line = _start(["serve", "--cpu", "--port", "0", "--root", str(corpus)],
                                  tmp_path, "serve")
            assert line.startswith("serve: listening on http://"), line
            url = line.split()[-1]
            assert _post(url, "/v1/query", QUERY) == want
            router, line = _start(["route", "--port", "0", "--replica", url], tmp_path, "route")
            assert line.startswith("serve: listening on http://"), (
                line, (tmp_path / "route.err").read_text()[-2000:])
            assert _post(line.split()[-1], "/v1/query", QUERY) == want
            outs = []
            for proc in (router, daemon):
                rc, out = _stop(proc)
                assert rc == 0
                assert out.splitlines()[-1] == "serve: drained, bye"
                outs.append(out)
            assert outs[0].splitlines()[0] == "serve: mesh router over 1 replica(s)"
        finally:
            _kill(router, daemon)

    def test_serve_without_cuda_and_without_cpu_exits_1(self, corpus, tmp_path):
        proc = None
        try:
            proc, line = _start(["serve", "--port", "0", "--root", str(corpus)], tmp_path,
                                "serve", env={"CUDA_VISIBLE_DEVICES": ""})
            assert line == ""
            assert proc.wait(timeout=WATCHDOG_S) == 1
            assert (tmp_path / "serve.err").read_text().strip().splitlines()[-1] == (
                "parquet-tool: CUDA is not available; pass --cpu")
        finally:
            _kill(proc)

    def test_scan_filters_json_shares_the_spec_parser(self, corpus, capsys):
        from parquet_tpu_torch.tools.parquet_tool import main as tool_main

        rc = tool_main(
            [
                "scan",
                str(corpus / "a.parquet"),
                "--cpu",
                "--columns",
                "id",
                "--filters",
                json.dumps([["id", "<", ROW_GROUP]]),
                "--json",
            ]
        )
        out = capsys.readouterr().out
        assert rc == 0
        doc = json.loads(out.strip().splitlines()[-1])
        assert doc["pruning"]["units_admitted"] == 1
        assert doc["pruning"]["units_pruned_stats"] == (
            doc["pruning"]["units_total"] - 1
        )
        assert doc["rows"] == ROW_GROUP
        # a bad spec fails with the shared parser's message, not a traceback
        rc = tool_main(
            [
                "scan",
                str(corpus / "a.parquet"),
                "--cpu",
                "--filters",
                json.dumps([["id", "~", 1]]),
            ]
        )
        err = capsys.readouterr().err
        assert rc == 1 and "unknown filter op" in err
        # --filter and --filters are mutually exclusive
        rc = tool_main(
            [
                "scan",
                str(corpus / "a.parquet"),
                "--cpu",
                "--filter",
                "id < 5",
                "--filters",
                "[]",
            ]
        )
        err = capsys.readouterr().err
        assert rc == 1 and "not both" in err
