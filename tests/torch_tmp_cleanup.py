"""What a port test writes under its temporary directory goes when the test
ends.

pytest keeps the temporary directories of its last three runs, and some of
the port's tests write hundreds of megabytes there (SN154-HU and DN161-HU
checkpoints, stop-and-resume training runs, CLI epochs), enough for three
runs to fill a disk. A module that imports ``delete_tmp_path`` deletes each
test's ``tmp_path`` once the test is done with it; a module-scoped fixture
deletes its own directory with ``removed_after``. Neither changes what a
test checks.
"""

import contextlib
import shutil

import pytest

__all__ = ["delete_tmp_path", "removed_after"]


@pytest.fixture(autouse=True)
def delete_tmp_path(request):
    """Delete the test's ``tmp_path``, if it has one, after the test."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@contextlib.contextmanager
def removed_after(path):
    """Yield ``path`` and delete it when the block ends."""
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)
