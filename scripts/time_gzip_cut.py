#!/usr/bin/env python3
"""Time chip_smoke.py's six GZIP host writes of `taxi` on GZIP_GROUPS row
groups and on the whole file, to measure what the write-options phase
saves by taking GZIP_GROUPS groups.

    python3 scripts/time_gzip_cut.py [OUT.json]

The six writes are the phase's: a page-index write and a page-index-free
write, each serial fused, serial staged (PQT_FUSED_ENCODE=0) and
parallel, all GZIP, through chip_smoke.write_taxi on the generator's
columns. Each write is timed once on GZIP_GROUPS groups, then once on
all ROW_GROUPS groups, both first writes of their files, as in the
phase. Prints each write's seconds and the sums; the saving is the
whole file's sum less the cut's. Runs on the host; no card needed."""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from parquet_tpu_torch import parse_schema
    from parquet_tpu_torch.kernels.build import BUILD_ROOT

    schema = parse_schema(cs.TAXI_DSL)
    groups = cs.write_groups(cs.taxi_columns(cs.SEED))
    variants = (("serial fused", {}, {}), ("serial staged", {"PQT_FUSED_ENCODE": "0"}, {}),
                ("parallel", {}, {"parallel": True}))
    res = {"groups": cs.GZIP_GROUPS, "row_groups": cs.ROW_GROUPS, "writes": []}
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as d:
        for index in (True, False):
            for label, env, opts in variants:
                secs = {}
                for which, take in (("cut", groups[:cs.GZIP_GROUPS]), ("whole", groups)):
                    f = Path(d) / f"{which}-{index}-{label.replace(' ', '-')}.parquet"
                    t = time.perf_counter()
                    with cs.env_set(**env):
                        cs.write_taxi(f, schema, take, device=False, codec="gzip",
                                      write_page_index=index, **opts)
                    secs[which] = time.perf_counter() - t
                    f.unlink()
                res["writes"].append({"page_index": index, "way": label, **secs})
                print(f"page index {index}, {label}: {cs.GZIP_GROUPS} groups {secs['cut']} s, "
                      f"{cs.ROW_GROUPS} groups {secs['whole']} s", flush=True)
    cut = sum(w["cut"] for w in res["writes"])
    whole = sum(w["whole"] for w in res["writes"])
    res.update(cut_s=cut, whole_s=whole, saved_s=whole - cut)
    print(f"six GZIP writes: {cs.GZIP_GROUPS} groups {cut} s, {cs.ROW_GROUPS} groups {whole} s, "
          f"saved {whole - cut} s")
    if argv:
        Path(argv[0]).write_text(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
