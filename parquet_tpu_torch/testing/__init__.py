"""Test-support tooling shipped with the package: byte-level fault
injection (faults.py), transport-level fault injection (flaky.py),
wire-level chaos for serve-mesh replicas (flaky_replica.py, chaos.py),
the range-GET stub (httpstub.py), synthetic files (synth.py), the
multi-rank driver (dist.py) and NumPy state shared with the reference's
tests (parity.py)."""

from .flaky import FlakySource  # noqa: F401
