"""Durable file writes shared by every JSON/text sidecar producer.

Several layers persist artifacts mid-run — telemetry exports
(runtime/telemetry.py), bench evidence sidecars (bench.py), the MRC
file writer (runtime/report.py, the reference's
pluss_write_mrc_to_file), and the service result store
(service/cache.py). A process killed mid-`write()` must never leave a
truncated file behind: a half-written JSON poisons every later
consumer that parses it blind (the service cache would treat it as a
corrupt entry and recompute; the driver's artifact collectors would
just fail). The discipline is the standard one — write the full
payload to a uniquely-named temp file in the SAME directory, fsync,
then `os.replace` onto the final name, which POSIX guarantees is
atomic within a filesystem.
"""

from __future__ import annotations

import json
import os
import tempfile


def atomic_write_text(path: str, text: str) -> None:
    """Write `text` to `path` atomically (tmp + fsync + rename).

    The temp name is unique per call (mkstemp), so concurrent writers
    of the same path never interleave — last rename wins with either
    writer's complete content, never a mix.
    """
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj, indent: int | None = 1) -> None:
    """Serialize `obj` and write it atomically with a trailing newline.

    Floats round-trip exactly (json uses repr, the shortest string
    that parses back to the same double), so a record written here and
    re-loaded compares bit-identical — the service cache's warm-repeat
    contract depends on this.
    """
    atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")


def append_text_line(path: str, line: str) -> None:
    """Append one newline-terminated line durably (O_APPEND + fsync).

    The append-only consumers (the run ledger, runtime/obs/ledger.py)
    need the complement of atomic_write_text: many writers growing ONE
    file. A single os.write under O_APPEND is atomic with respect to
    concurrent appenders on POSIX local filesystems — two processes'
    rows never interleave — and a crash mid-write can at worst leave
    one truncated line at the tail, which every ledger reader already
    skips as invalid.
    """
    if not line.endswith("\n"):
        line += "\n"
    if "\n" in line[:-1]:
        raise ValueError("append_text_line takes exactly one line")
    data = line.encode()
    fd = os.open(
        os.fspath(path),
        os.O_WRONLY | os.O_CREAT | os.O_APPEND,
        0o644,
    )
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
