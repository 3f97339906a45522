"""Command-line tools: parquet-tool (tools/parquet_tool.py) and
csv2parquet (tools/csv2parquet.py)."""
