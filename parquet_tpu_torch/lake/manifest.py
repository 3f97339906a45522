"""The lake table's snapshot manifest: generation-numbered, atomic, bounded.

A lake table is a directory:

    table/
      _lake/
        TABLE.json          # immutable identity: schema DSL + sort key
        CURRENT             # {"generation": N} — THE commit point
        gen-00000001.json   # one manifest per generation (file list +
        gen-00000002.json   #   per-file row/byte counts + sort-key range)
      data/
        ingest-*.parquet    # flush-committed append files
        compact-*.parquet   # compactor rewrites

Every metadata write goes through the LocalFileSink tmp+fsync+rename
contract, so readers NEVER observe a torn manifest: a generation file is
written durably first, then CURRENT is renamed over — the rename of
CURRENT is the single commit point. A crash between the two leaves an
unreferenced gen file (harmless; the next commit overwrites that slot or
moves past it), a crash before either leaves nothing.

open_snapshot(gen=None) pins one generation: the returned Snapshot's file
list never changes under the reader, which is what makes concurrent
append/compact/scan race-free on the happy path (the reader's size/mtime
and ETag generation checks stay as the typed backstop for out-of-band
rewrites). Generations are retained up to `retain` back from current —
time travel within the window is byte-identical because a data file is
unlinked ONLY when no retained generation references it (and only after
the dropping commit is durable). Orphan data/tmp files — a crash between
a compactor rewrite and its manifest commit — are reaped by
reap_orphans(), age-gated so in-flight writers are never raced.

Its counts are lake_counts() (lake_manifest_commits_total,
lake_files_unlinked_total, lake_orphans_reaped_total); a commit also sets
the lake_generation, lake_files and lake_rows gauges of the registry.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..core.schema import Schema
from ..schema.dsl import parse_schema, schema_to_string
from ..sink.sink import LocalFileSink
from ..utils import metrics as _metrics
from .counts import count as _count

__all__ = [
    "LakeError",
    "FileEntry",
    "Snapshot",
    "LakeManifest",
    "LakeTable",
    "is_lake_table",
    "manifest_ref_root",
]

_LAKE_DIR = "_lake"
_DATA_DIR = "data"
_CURRENT = "CURRENT"
_GEN_FMT = "gen-%08d.json"


class LakeError(RuntimeError):
    """Typed lake failure; `code` is the machine-readable taxonomy the
    serve layer maps onto ServeError codes."""

    def __init__(self, message: str, *, code: str = "lake_error"):
        super().__init__(message)
        self.code = code


def _check_rel(path: str) -> str:
    """Manifest file entries are table-relative POSIX paths; anything that
    could escape the table root is refused at both write and read time
    (a hand-edited manifest must not become a confinement escape)."""
    p = str(path).replace(os.sep, "/")
    if not p or p.startswith("/") or os.path.isabs(p):
        raise LakeError(
            f"manifest: absolute file path {path!r}", code="bad_manifest"
        )
    if any(seg in ("", "..") for seg in p.split("/")):
        raise LakeError(
            f"manifest: path {path!r} escapes the table root",
            code="bad_manifest",
        )
    return p


class FileEntry:
    """One data file of one generation: where it is (table-relative), how
    many rows/bytes it holds, and the sort-key range it covers (None when
    the table has no sort key)."""

    __slots__ = ("path", "rows", "bytes", "min_key", "max_key")

    def __init__(self, path, rows, nbytes, min_key=None, max_key=None):
        self.path = _check_rel(path)
        self.rows = int(rows)
        self.bytes = int(nbytes)
        self.min_key = min_key
        self.max_key = max_key

    def to_dict(self) -> dict:
        d = {"path": self.path, "rows": self.rows, "bytes": self.bytes}
        if self.min_key is not None:
            d["min_key"] = self.min_key
        if self.max_key is not None:
            d["max_key"] = self.max_key
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileEntry":
        try:
            return cls(
                d["path"], d["rows"], d["bytes"],
                d.get("min_key"), d.get("max_key"),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise LakeError(
                f"manifest: bad file entry {d!r}: {e}", code="bad_manifest"
            ) from None

    def __repr__(self):
        return f"FileEntry({self.path!r}, rows={self.rows}, bytes={self.bytes})"


class Snapshot:
    """One pinned generation: an immutable view of the table."""

    __slots__ = ("generation", "parent", "sort_key", "files", "created_unix")

    def __init__(self, generation, parent, sort_key, files, created_unix):
        self.generation = int(generation)
        self.parent = parent
        self.sort_key = sort_key
        self.files = tuple(files)
        self.created_unix = created_unix

    @property
    def total_rows(self) -> int:
        return sum(f.rows for f in self.files)

    @property
    def total_bytes(self) -> int:
        return sum(f.bytes for f in self.files)

    def paths(self, root) -> list:
        """Absolute data-file paths, in manifest order."""
        root = os.fspath(root)
        return [os.path.join(root, f.path) for f in self.files]

    def to_dict(self) -> dict:
        return {
            "generation": self.generation,
            "parent": self.parent,
            "sort_key": self.sort_key,
            "created_unix": self.created_unix,
            "files": [f.to_dict() for f in self.files],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Snapshot":
        try:
            gen = int(d["generation"])
        except (KeyError, TypeError, ValueError):
            raise LakeError(
                "manifest: no usable generation number", code="bad_manifest"
            ) from None
        return cls(
            gen,
            d.get("parent"),
            d.get("sort_key"),
            [FileEntry.from_dict(f) for f in d.get("files", [])],
            d.get("created_unix"),
        )


def _write_json_atomic(path: str, obj: dict) -> None:
    """tmp + fsync + rename through the sink contract: the destination is
    either the old bytes or the complete new document, never a prefix."""
    sink = LocalFileSink(path)
    try:
        sink.write((json.dumps(obj, indent=1) + "\n").encode())
        sink.close()
    except BaseException:
        sink.abort()
        raise


def _read_json(path: str):
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        raise LakeError(
            f"manifest: unreadable {path!r}: {e}", code="bad_manifest"
        ) from None


def is_lake_table(path) -> bool:
    """Does `path` look like a lake table root (a committed CURRENT)?"""
    try:
        return os.path.isfile(
            os.path.join(os.fspath(path), _LAKE_DIR, _CURRENT)
        )
    except (TypeError, ValueError):
        return False


def manifest_ref_root(path):
    """When `path` names a pinned manifest file (…/_lake/gen-N.json),
    return (table_root, generation); else None. This is how a scan spec
    pins one generation: pass the gen file instead of the table dir."""
    s = os.fspath(path)
    parent = os.path.dirname(s)
    name = os.path.basename(s)
    if (
        os.path.basename(parent) == _LAKE_DIR
        and name.startswith("gen-")
        and name.endswith(".json")
    ):
        gen_str = name[len("gen-"):-len(".json")]
        if gen_str.isdigit():
            return os.path.dirname(parent), int(gen_str)
    return None


class LakeManifest:
    """The generation log of one table. Thread-safe for one writing
    process (the daemon): commits serialize under an internal lock; any
    number of readers in any process pin snapshots lock-free."""

    def __init__(self, root, *, retain: int = 64, clock=time.time):
        if retain < 1:
            raise ValueError("manifest: retain must be >= 1")
        self.root = os.path.realpath(os.fspath(root))
        self.retain = int(retain)
        self._clock = clock
        self._lock = threading.Lock()
        self.lake_dir = os.path.join(self.root, _LAKE_DIR)
        self.data_dir = os.path.join(self.root, _DATA_DIR)

    # -- layout ----------------------------------------------------------------

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.lake_dir, _GEN_FMT % gen)

    def _current_path(self) -> str:
        return os.path.join(self.lake_dir, _CURRENT)

    def data_path(self, rel: str) -> str:
        return os.path.join(self.root, _check_rel(rel))

    def ensure_dirs(self) -> None:
        os.makedirs(self.lake_dir, exist_ok=True)
        os.makedirs(self.data_dir, exist_ok=True)

    # -- reads -----------------------------------------------------------------

    def current_generation(self) -> int:
        """The committed generation number; 0 = empty table (no commit)."""
        cur = _read_json(self._current_path())
        if cur is None:
            return 0
        try:
            return int(cur["generation"])
        except (KeyError, TypeError, ValueError):
            raise LakeError(
                f"manifest: corrupt CURRENT in {self.lake_dir!r}",
                code="bad_manifest",
            ) from None

    def generations(self) -> list:
        """Retained generation numbers on disk, ascending."""
        try:
            names = os.listdir(self.lake_dir)
        except FileNotFoundError:
            return []
        out = []
        for n in names:
            if n.startswith("gen-") and n.endswith(".json"):
                g = n[len("gen-"):-len(".json")]
                if g.isdigit():
                    out.append(int(g))
        return sorted(out)

    def open_snapshot(self, gen=None) -> Snapshot:
        """Pin one generation (default: current). Generation 0 is the
        empty table. A requested generation outside the retained window
        is a typed error — time travel is bounded by `retain`."""
        if gen is None:
            gen = self.current_generation()
        gen = int(gen)
        if gen == 0:
            return Snapshot(0, None, None, (), None)
        doc = _read_json(self._gen_path(gen))
        if doc is None:
            raise LakeError(
                f"manifest: generation {gen} is not retained "
                f"(have {self.generations() or 'none'})",
                code="no_such_generation",
            )
        snap = Snapshot.from_dict(doc)
        if snap.generation != gen:
            raise LakeError(
                f"manifest: {self._gen_path(gen)!r} claims generation "
                f"{snap.generation}", code="bad_manifest",
            )
        return snap

    # -- the one write path ----------------------------------------------------

    def commit(
        self, *, add=(), remove=(), sort_key=None, expect_generation=None,
    ) -> Snapshot:
        """Publish generation N+1 = current − `remove` + `add`, atomically.

        The gen file lands durably FIRST, then CURRENT renames over: a
        crash at any instant leaves the previous generation fully intact.
        After the commit point, generations older than the retention
        window are dropped, and any data file referenced ONLY by dropped
        generations is unlinked — never a file the new generation (or any
        retained one) still names, which is what keeps open_snapshot(k)
        byte-identical for every retained k across later compactions."""
        add = list(add)
        remove = {_check_rel(r) for r in remove}
        with self._lock:
            base_gen = self.current_generation()
            if expect_generation is not None and base_gen != expect_generation:
                raise LakeError(
                    f"manifest: concurrent commit (expected generation "
                    f"{expect_generation}, found {base_gen})",
                    code="commit_conflict",
                )
            base = self.open_snapshot(base_gen)
            have = {f.path for f in base.files}
            missing = remove - have
            if missing:
                raise LakeError(
                    f"manifest: cannot remove unreferenced {sorted(missing)}",
                    code="commit_conflict",
                )
            files = [f for f in base.files if f.path not in remove]
            for entry in add:
                if entry.path in have and entry.path not in remove:
                    raise LakeError(
                        f"manifest: {entry.path!r} already referenced",
                        code="commit_conflict",
                    )
                files.append(entry)
            self.ensure_dirs()
            new_gen = base_gen + 1
            snap = Snapshot(
                new_gen,
                base_gen or None,
                sort_key if sort_key is not None else base.sort_key,
                files,
                self._clock(),
            )
            _write_json_atomic(self._gen_path(new_gen), snap.to_dict())
            # THE commit point: readers switch generations on this rename
            _write_json_atomic(
                self._current_path(), {"generation": new_gen}
            )
            _count("lake_manifest_commits_total")
            _metrics.set_gauge("lake_generation", new_gen)
            _metrics.set_gauge("lake_files", len(files))
            _metrics.set_gauge("lake_rows", snap.total_rows)
            self._prune_retention(new_gen)
            return snap

    def _prune_retention(self, current_gen: int) -> None:
        """Drop generations older than the window; unlink data files no
        retained generation references. Runs AFTER the commit is durable
        (lock held). Every unlink is best-effort — a lost race with an
        external cleaner must not fail the commit that triggered it."""
        floor = current_gen - self.retain + 1
        drop = [g for g in self.generations() if g < floor]
        if not drop:
            return
        retained = set()
        for g in self.generations():
            if g >= floor:
                try:
                    retained.update(
                        f.path for f in self.open_snapshot(g).files
                    )
                except LakeError:
                    continue
        for g in drop:
            try:
                old = self.open_snapshot(g)
            except LakeError:
                old = None
            if old is not None:
                for f in old.files:
                    if f.path not in retained:
                        try:
                            os.unlink(self.data_path(f.path))
                            _count("lake_files_unlinked_total")
                        except OSError:
                            pass
            try:
                os.unlink(self._gen_path(g))
            except OSError:
                pass

    # -- crash hygiene ---------------------------------------------------------

    def reap_orphans(self, *, grace_s: float = 300.0) -> int:
        """Remove data-dir debris no retained generation references: sink
        tmp files (a writer that died mid-write) and committed-but-never-
        published parquet files (a crash between a rewrite and its
        manifest commit). Age-gated by `grace_s` so a file an in-flight
        writer is about to publish is never raced. Returns files removed;
        loses nothing — by definition nothing referenced is touched."""
        try:
            names = os.listdir(self.data_dir)
        except FileNotFoundError:
            return 0
        with self._lock:
            referenced = set()
            for g in self.generations():
                try:
                    referenced.update(
                        os.path.basename(f.path)
                        for f in self.open_snapshot(g).files
                    )
                except LakeError:
                    continue
            now = time.time()
            reaped = 0
            for name in names:
                if name in referenced:
                    continue
                is_tmp = name.startswith(".") and name.endswith(".tmp")
                if not (is_tmp or name.endswith(".parquet")):
                    continue
                path = os.path.join(self.data_dir, name)
                try:
                    if now - os.path.getmtime(path) < grace_s:
                        continue
                    os.unlink(path)
                    reaped += 1
                except OSError:
                    continue
            if reaped:
                _count("lake_orphans_reaped_total", reaped)
            return reaped


class LakeTable:
    """A table = identity (schema + sort key, immutable) + its manifest.

    create() writes _lake/TABLE.json once; open() reads it back. The
    schema is stored as DSL text (schema/dsl.py round-trips exactly), so
    a table is self-describing to any process with no side channel."""

    def __init__(self, root, schema: Schema, sort_key, manifest: LakeManifest):
        self.root = manifest.root
        self.schema = schema
        self.sort_key = sort_key
        self.manifest = manifest

    @staticmethod
    def _table_path(root) -> str:
        return os.path.join(os.fspath(root), _LAKE_DIR, "TABLE.json")

    @classmethod
    def create(
        cls, root, schema, *, sort_key=None, retain: int = 64,
        clock=time.time,
    ) -> "LakeTable":
        if isinstance(schema, str):
            schema = parse_schema(schema)
        if sort_key is not None:
            leaves = {c.path_str for c in schema.leaves}
            if sort_key not in leaves:
                raise LakeError(
                    f"lake: sort key {sort_key!r} is not a schema leaf "
                    f"(have {sorted(leaves)})", code="bad_schema",
                )
        manifest = LakeManifest(root, retain=retain, clock=clock)
        if os.path.exists(cls._table_path(manifest.root)):
            raise LakeError(
                f"lake: table already exists at {manifest.root!r}",
                code="table_exists",
            )
        manifest.ensure_dirs()
        _write_json_atomic(
            cls._table_path(manifest.root),
            {
                "schema": schema_to_string(schema),
                "sort_key": sort_key,
                "retain": int(retain),
                "created_unix": clock(),
            },
        )
        return cls(manifest.root, schema, sort_key, manifest)

    @classmethod
    def open(cls, root, *, clock=time.time) -> "LakeTable":
        manifest_root = os.path.realpath(os.fspath(root))
        doc = _read_json(cls._table_path(manifest_root))
        if doc is None:
            raise LakeError(
                f"lake: no table at {manifest_root!r} (missing "
                f"{_LAKE_DIR}/TABLE.json — create it first)",
                code="no_such_table",
            )
        try:
            schema = parse_schema(doc["schema"])
        except (KeyError, TypeError, ValueError) as e:
            raise LakeError(
                f"lake: corrupt TABLE.json at {manifest_root!r}: {e}",
                code="bad_manifest",
            ) from None
        manifest = LakeManifest(
            manifest_root, retain=int(doc.get("retain") or 64), clock=clock
        )
        return cls(manifest_root, schema, doc.get("sort_key"), manifest)

    def snapshot_paths(self, gen=None) -> list:
        """Absolute file paths of one pinned generation (default current)."""
        return self.manifest.open_snapshot(gen).paths(self.root)
