"""App utility layer (reference include/utils.h + include/dmlc/logging.h)."""
import os

from .log import alog, verbose_level
from .stopwatch import Stopwatch

__all__ = ["Stopwatch", "alog", "verbose_level", "write_atomic"]


def write_atomic(path: str, data: bytes) -> None:
    """THE durable-write discipline (one implementation — checkpoint
    links, workload traces, and replay artifacts all use it): write to
    a writer-unique tmp, fsync, rename. A crash mid-write leaves the
    previous file (or nothing), never a torn one; the mkstemp-unique
    tmp name keeps two concurrent writers of the same path from
    truncating each other's bytes (last rename wins with a COMPLETE
    file)."""
    import tempfile
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp",
        dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
