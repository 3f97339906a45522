"""Every public name of the JAX package resolves in the port.

For each `parquet_tpu/**.py`, read with `ast` (the reference is not
imported), the public module-level names (functions, classes, assigned
names; a package `__init__`'s imports too), each public class's public
methods and the `__all__` entries resolve on the port's module at the
same relative path; a name in the reference's `__all__` is in the port
module's `__all__`. The exceptions are written below, each beside its
reason, and each must still be missing from the port (a stale entry
fails): JAX-only names, the port's renames (whose new name must
resolve), and constants that stand for a reference function. The Arrow
surface (core/arrow_nested.py, FileReader.to_arrow) is the port's own,
without pyarrow.
"""

from __future__ import annotations

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = REPO / "parquet_tpu"

_DEVICE_OPS = ("bitpack_encode", "bss_transpose", "delta_block_encode",
               "delta_packed_decode", "dict_gather", "dict_indices", "expand_hybrid",
               "list_contains_mask", "list_layout", "mask_take", "masked_agg",
               "merge_mixed_bytes", "merge_mixed_numeric", "plain_bytearray_encode",
               "predicate_mask", "record_starts", "rle_hybrid_encode")

# (file, name) -> (reason, the port's name for a rename)
ALLOWED = {
    ("parallel/mesh.py", "make_decode_mesh"): ("JAX-only: builds a jax.sharding.Mesh", None),
    ("parallel/__init__.py", "make_decode_mesh"): ("JAX-only: builds a jax.sharding.Mesh", None),
    ("utils/trace.py", "jax_profile"): ("JAX-only: jax.profiler.trace; renamed",
                                       "torch_profile"),
    ("serve/executor.py", "pool_size"): ("constant: the pool's size", "SERVE_THREADS"),
    ("kernels/pipeline.py", "TpuDecodeStats"): ("renamed", "DecodeStats"),
    ("kernels/pipeline.py", "plan_chunk_tpu"): ("renamed", "plan_chunk_device"),
    ("kernels/pipeline.py", "read_chunk_tpu"): ("renamed", "read_chunk_device"),
    **{("kernels/device_ops.py", f"{k}_device"): ("renamed: the *_device suffix dropped", k)
       for k in _DEVICE_OPS},
}


def public_names(path: pathlib.Path) -> tuple[set, dict, list]:
    """(module-level public names, {class: public methods}, __all__)."""
    tree = ast.parse(path.read_text())
    init = path.name == "__init__.py"
    names, classes, all_ = set(), {}, []
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(n.name)
        elif isinstance(n, ast.ClassDef):
            names.add(n.name)
            classes[n.name] = {m.name for m in n.body
                               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                               and not m.name.startswith("_")}
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    all_ = [ast.literal_eval(e) for e in n.value.elts]
                elif isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
        elif init and isinstance(n, ast.ImportFrom):
            names.update(a.asname or a.name for a in n.names)
    public = {k for k in names if not k.startswith("_")}
    return public, {c: m for c, m in classes.items() if not c.startswith("_")}, all_


def port_module(rel: pathlib.PurePath) -> str:
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("parquet_tpu_torch",) + parts)


REF_FILES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def missing_in_port(rel: str) -> list:
    """(rel, name) of every public reference name the port lacks (None for
    a whole module)."""
    try:
        mod = importlib.import_module(port_module(pathlib.PurePosixPath(rel)))
    except ModuleNotFoundError:
        return [(rel, None)]
    public, classes, all_ = public_names(REF / rel)
    out = [(rel, n) for n in sorted(public | set(all_)) if not hasattr(mod, n)]
    for cls, methods in sorted(classes.items()):
        pc = getattr(mod, cls, None)
        if pc is not None:
            out += [(rel, f"{cls}.{m}") for m in sorted(methods) if not hasattr(pc, m)]
    port_all = getattr(mod, "__all__", None)
    if port_all is not None:
        out += [(rel, f"{n} (not in __all__)") for n in all_
                if hasattr(mod, n) and n not in port_all]
    return out


def test_the_reference_files_are_listed():
    assert len(REF_FILES) > 100 and "__init__.py" in REF_FILES


@pytest.mark.parametrize("rel", REF_FILES)
def test_every_public_name_resolves_in_the_port(rel):
    missing = missing_in_port(rel)
    unexplained = [m for m in missing if m not in ALLOWED]
    assert unexplained == [], f"{rel}: not in the port and not allowed: {unexplained}"
    for key in missing:
        _reason, new = ALLOWED[key]
        if new is not None:
            mod = importlib.import_module(port_module(pathlib.PurePosixPath(rel)))
            assert hasattr(mod, new), f"{key}: its port name {new} does not resolve"


def test_every_allowed_name_is_still_missing():
    missing = {m for rel in {k[0] for k in ALLOWED} for m in missing_in_port(rel)}
    assert set(ALLOWED) <= missing, sorted(set(ALLOWED) - missing, key=str)
    assert all(reason for reason, _new in ALLOWED.values())
