"""Task log capture with rotation (ref client/logmon/: the reference runs
a per-task logmon plugin process writing rotated FIFO-fed log files named
``<task>.<stream>.<n>``; here an in-process writer thread drains the
task's stdout/stderr pipes into the same rotated layout, honoring
LogConfig.max_files / max_file_size_mb).

The fs/logs API reads the newest index transparently; older indexes age
out FIFO as rotation proceeds."""

from __future__ import annotations

import os
import threading

CHUNK = 65536


def rotated_indexes(log_dir: str, prefix: str) -> list[int]:
    """Sorted indexes of the rotated files for one stream (single
    definition shared by the writer and the fs/logs reader)."""
    out = []
    try:
        for name in os.listdir(log_dir):
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                out.append(int(name[len(prefix):]))
    except OSError:
        pass
    return sorted(out)


class RotatingWriter:
    """Append-to-current-index writer with size-based rotation."""

    def __init__(self, log_dir: str, task: str, stream: str,
                 max_files: int = 10, max_file_size_mb: int = 10):
        self.log_dir = log_dir
        self.prefix = f"{task}.{stream}."
        self.max_files = max(1, max_files)
        self.max_bytes = max(1, max_file_size_mb) * 1024 * 1024
        os.makedirs(log_dir, exist_ok=True)
        self.index = self._newest_index()
        path = self._path(self.index)
        self._size = os.path.getsize(path) if os.path.exists(path) else 0
        self._fh = open(path, "ab")

    def _path(self, index: int) -> str:
        return os.path.join(self.log_dir, self.prefix + str(index))

    def _newest_index(self) -> int:
        indexes = rotated_indexes(self.log_dir, self.prefix)
        return indexes[-1] if indexes else 0

    def write(self, data: bytes):
        if self._size + len(data) > self.max_bytes and self._size > 0:
            self._rotate()
        self._fh.write(data)
        self._fh.flush()
        self._size += len(data)

    def _rotate(self):
        self._fh.close()
        self.index += 1
        self._fh = open(self._path(self.index), "ab")
        self._size = 0
        # FIFO reap: keep the newest max_files indexes
        floor = self.index - self.max_files + 1
        if floor > 0:
            try:
                for name in os.listdir(self.log_dir):
                    if name.startswith(self.prefix):
                        suffix = name[len(self.prefix):]
                        if suffix.isdigit() and int(suffix) < floor:
                            os.unlink(os.path.join(self.log_dir, name))
            except OSError:
                pass

    def close(self):
        try:
            self._fh.close()
        except OSError:
            pass


def start_copier(fd, writer: RotatingWriter) -> threading.Thread:
    """Drain a pipe fd into the writer until EOF (the logmon copy loop)."""

    def run():
        try:
            while True:
                data = os.read(fd, CHUNK)
                if not data:
                    break
                writer.write(data)
        except OSError:
            pass
        finally:
            try:
                os.close(fd)
            except OSError:
                pass
            writer.close()

    t = threading.Thread(target=run, daemon=True, name="logmon-fifo-pump")
    t.start()
    return t
