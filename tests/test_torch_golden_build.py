"""The C++ golden oracle's library (golden/cpp) built once a test run,
before tests/unit/ is collected.

tests/unit/test_cpp_golden.py loads golden/cpp/libsgm_golden.so when it
is imported and skips its tests when that fails; golden/cpp_binding.py's
``_load`` runs ``make`` first when the library is missing or older than
its source.  Under pytest-xdist every worker imports every test module
while it collects, so on a fresh tree the workers ran ``make`` at the
same moment, and a worker that loaded the library while another's linker
was still writing it failed with "file too short" and skipped all of that
module's tests.

This module's name sorts, and pytest collects it, before tests/unit/.
Importing it runs ``make`` under an exclusive lock on the Makefile, so
the workers build one after another: the first builds, and each later one
finds the library up to date.  A tree without make or a C++ compiler
builds nothing here, as before.
"""

import fcntl
import shutil
import subprocess
from pathlib import Path

import pytest

GOLDEN_CPP = Path(__file__).resolve().parents[1] / "golden" / "cpp"


def build_golden_library() -> bool:
    """``make`` in golden/cpp under an exclusive lock on its Makefile;
    whether the build succeeded (False without make)."""
    if shutil.which("make") is None:
        return False
    with open(GOLDEN_CPP / "Makefile") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            done = subprocess.run(["make", "-C", str(GOLDEN_CPP)],
                                  capture_output=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return done.returncode == 0


BUILT = build_golden_library()


def test_golden_library_built_and_loads():
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no make or g++ on this machine: golden/cpp is not "
                    "built")
    assert BUILT
    from golden import cpp_binding
    lib = cpp_binding._load()
    assert hasattr(lib, "census_u64") and hasattr(lib, "aggregate_paths_2d")
