"""The port's `parquet-tool lake`, as tests/test_lake.py's TestLakeCLI pins
the reference's: init, append, manifest (time travel with --gen), compact
with orphan reaping, and typed errors as messages, through
parquet_tpu_torch.tools.parquet_tool.main. The subcommand is a host path
(rows shredded and encoded on the host); it takes no --cpu."""

import json

import pytest

pytest.importorskip("torch")

from parquet_tpu_torch.tools.parquet_tool import main  # noqa: E402

SCHEMA = "message m { required int64 k; optional binary v (STRING); }"


class TestLakeCLI:
    def test_init_append_manifest_compact(self, tmp_path, capsys):
        tbl = str(tmp_path / "t")
        assert (
            main(["lake", "init", tbl, "--schema", SCHEMA, "--sort-key", "k"])
            == 0
        )
        src = tmp_path / "rows.jsonl"
        src.write_text('{"k": 2}\n{"k": 1}\n')
        assert main(["lake", "append", tbl, str(src)]) == 0
        src.write_text('{"k": 4}\n{"k": 3}\n')
        assert main(["lake", "append", tbl, str(src)]) == 0
        capsys.readouterr()
        assert main(["lake", "manifest", tbl, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["generation"] == 2 and len(doc["files"]) == 2
        assert (
            main(["lake", "compact", tbl, "--reap", "--reap-grace-s", "0"])
            == 0
        )
        capsys.readouterr()
        assert main(["lake", "manifest", tbl, "--gen", "3", "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert len(doc["files"]) == 1
        assert doc["files"][0]["rows"] == 4

    def test_errors_are_messages_not_tracebacks(self, tmp_path, capsys):
        assert main(["lake", "manifest", str(tmp_path / "nope")]) == 1
        err = capsys.readouterr().err
        assert "no table" in err and "Traceback" not in err

    def test_append_from_stdin_and_arrow_ipc_stays_cut(self, tmp_path, capsys, monkeypatch):
        import io

        tbl = str(tmp_path / "t")
        assert main(["lake", "init", tbl, "--schema", SCHEMA]) == 0
        stdin = type("S", (), {"buffer": io.BytesIO(b'{"k": 7, "v": "x"}\n')})()
        monkeypatch.setattr("sys.stdin", stdin)
        capsys.readouterr()
        assert main(["lake", "append", tbl]) == 0
        ack = json.loads(capsys.readouterr().out)
        assert ack["rows"] == 1 and ack["generation"] == 1
        # every input parses as jsonl, as the reference's lake append parses
        # it, whatever the file's suffix: an Arrow file's bytes are the
        # reference's jsonl parse error
        arrow = tmp_path / "rows.arrow"
        arrow.write_bytes(b"ARROW1\x00\x00")
        assert main(["lake", "append", tbl, str(arrow)]) == 1
        err = capsys.readouterr().err
        assert err == ("parquet-tool: lake: append: jsonl line 1 does not parse: "
                       "Expecting value: line 1 column 1 (char 0)\n")
        from parquet_tpu.tools.parquet_tool import main as jmain

        jtbl = str(tmp_path / "jt")
        assert jmain(["lake", "init", jtbl, "--schema", SCHEMA]) == 0
        capsys.readouterr()
        assert jmain(["lake", "append", jtbl, str(arrow)]) == 1
        assert capsys.readouterr().err == err
