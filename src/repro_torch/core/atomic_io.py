"""Crash-safe file commit primitives: the one write protocol.

A copy of ``repro.core.atomic_io`` (host-only code, copied so that the
port imports no module of the reference).  In the port it commits the
cold tier's blocks (:class:`repro_torch.core.storage.FileStorage`).

The protocol, for a single file::

    write temp file (same directory) -> fsync file -> rename over the
    target -> fsync the parent directory

and for a directory::

    populate temp dir -> fsync every file, then every dir (bottom-up)
    -> rename into place -> fsync the parent directory

A reader therefore sees either the complete old artifact or the complete
new one, never a torn or empty in-between, across both process crashes
(rename atomicity) and power loss (the fsyncs order data before the
rename that publishes it).

The low-level steps (:func:`fsync_file`, :func:`fsync_path`,
:func:`rename`, :func:`replace`) are module-level indirections on
purpose: a crash-injection test monkeypatches them to kill the process
at one step of the protocol and checks the old-or-new contract there.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile


# -- low-level steps (monkeypatch points for crash injection) ----------------

def fsync_file(f) -> None:
    """fsync an open file object (flush python buffers first)."""
    f.flush()
    os.fsync(f.fileno())


def fsync_path(path: str) -> None:
    """fsync a path by name — files AND directories (a directory fsync
    durably commits the rename/creation of its entries)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def rename(src: str, dst: str) -> None:
    os.rename(src, dst)


def replace(src: str, dst: str) -> None:
    os.replace(src, dst)


# -- single-file commit ------------------------------------------------------

def atomic_write_bytes(path: str, data: bytes) -> str:
    """Commit ``data`` to ``path`` with the full protocol: temp file in
    the same directory -> fsync -> rename over ``path`` -> fsync parent.
    A concurrent (or crashed) reader sees the old content or the new —
    never a truncated file."""
    path = os.fspath(path)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent,
                               prefix="." + os.path.basename(path) + ".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            fsync_file(f)
        replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    fsync_path(parent)
    return path


def atomic_write_text(path: str, text: str, encoding: str = "utf-8") -> str:
    return atomic_write_bytes(path, text.encode(encoding))


# -- directory commit --------------------------------------------------------

def fsync_tree(root: str) -> None:
    """fsync every file then every directory under ``root``, bottom-up
    (children before parents, so each directory fsync covers entries that
    are themselves already durable)."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for fn in filenames:
            fsync_path(os.path.join(dirpath, fn))
        fsync_path(dirpath)


def commit_dir(tmp_dir: str, final_dir: str) -> str:
    """Publish a fully-populated temp directory at ``final_dir``:
    fsync the tree -> (remove a pre-existing target) -> rename -> fsync
    the parent.  ``tmp_dir`` must live on the same filesystem as
    ``final_dir`` (same parent, by convention) for the rename to be
    atomic.

    NOTE the pre-existing-target removal is NOT crash-atomic (POSIX
    rename cannot replace a non-empty directory): callers that re-commit
    the same path and need old-or-new across a crash should version the
    directory name and publish via an :func:`atomic_write_text` pointer
    file instead (as the reference's ``repro.core.snapshot`` does).
    """
    fsync_tree(tmp_dir)
    if os.path.exists(final_dir):
        shutil.rmtree(final_dir)
    rename(tmp_dir, final_dir)
    fsync_path(os.path.dirname(os.path.abspath(final_dir)))
    return final_dir


@contextlib.contextmanager
def staged_dir(final_dir: str):
    """Context manager: yields a temp directory next to ``final_dir``;
    on clean exit commits it via :func:`commit_dir`, on error removes it
    (the target is untouched)."""
    final_dir = os.fspath(final_dir)
    parent = os.path.dirname(os.path.abspath(final_dir))
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent,
                           prefix="." + os.path.basename(final_dir) + ".tmp-")
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    commit_dir(tmp, final_dir)
