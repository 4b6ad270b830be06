"""Interactive exec sessions: process spawning (pipe or PTY) and the
frame bridge between a process and a duplex RPC stream.

This is the reference's ExecTaskStreaming surface
(plugins/drivers/proto/driver.proto:72-76, IO framing :295): stdin frames
flow from the remote peer into the process, stdout/stderr frames flow
back, and an exit frame ends the session. Drivers supply the process (in
the task's execution context — container, namespace, or task dir); this
module owns IO pumping so every driver behaves identically.

Frame shapes (msgpack-native, mirroring the proto's ExecTaskStreaming
IOOperation/Resize messages):
    in:  {"stdin": bytes} | {"eof": True} | {"resize": [rows, cols]}
    out: {"stdout": bytes} | {"stderr": bytes} | {"exit": int}
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Optional

CHUNK = 16 * 1024


class ExecProcess:
    """A spawned exec command with streaming IO. With ``tty`` the process
    runs on a pseudo-terminal (stdout/stderr merged, resize supported);
    otherwise on pipes."""

    def __init__(
        self,
        argv: list,
        cwd: Optional[str] = None,
        env: Optional[dict] = None,
        tty: bool = False,
    ):
        self.tty = tty
        self._master: Optional[int] = None
        if tty:
            import pty

            master, slave = pty.openpty()
            self._master = master
            try:
                self.proc = subprocess.Popen(
                    argv,
                    cwd=cwd,
                    env=env,
                    stdin=slave,
                    stdout=slave,
                    stderr=slave,
                    start_new_session=True,  # make it the pty's session leader
                )
            finally:
                os.close(slave)
        else:
            self.proc = subprocess.Popen(
                argv,
                cwd=cwd,
                env=env,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )

    # -- stdin ----------------------------------------------------------
    def write_stdin(self, data: bytes):
        if self.tty:
            os.write(self._master, data)
        elif self.proc.stdin is not None:
            self.proc.stdin.write(data)
            self.proc.stdin.flush()

    def close_stdin(self):
        if self.tty:
            return  # a pty has no independent stdin EOF; clients send ^D
        if self.proc.stdin is not None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass

    def resize(self, rows: int, cols: int):
        if not self.tty:
            return
        import fcntl
        import struct
        import termios

        fcntl.ioctl(
            self._master,
            termios.TIOCSWINSZ,
            struct.pack("HHHH", rows, cols, 0, 0),
        )

    # -- output ---------------------------------------------------------
    def output_frames(self):
        """Yield {"stdout"/"stderr": bytes} frames until the process
        exits, then {"exit": code}. PTY mode merges both into stdout."""
        if self.tty:
            while True:
                try:
                    data = os.read(self._master, CHUNK)
                except OSError:
                    break
                if not data:
                    break
                yield {"stdout": data}
            code = self.proc.wait()
            yield {"exit": code}
            return

        frames: list = []
        done = threading.Event()
        lock = threading.Lock()
        cv = threading.Condition(lock)

        def pump(fileobj, key):
            while True:
                data = fileobj.read1(CHUNK)
                if not data:
                    break
                with cv:
                    frames.append({key: data})
                    cv.notify()
            with cv:
                cv.notify()

        pumps = [
            threading.Thread(
                target=pump, args=(self.proc.stdout, "stdout"), daemon=True,
                name="exec-stdout-pump",
            ),
            threading.Thread(
                target=pump, args=(self.proc.stderr, "stderr"), daemon=True,
                name="exec-stderr-pump",
            ),
        ]
        for t in pumps:
            t.start()

        def waiter():
            self.proc.wait()
            for t in pumps:
                t.join(timeout=5)
            with cv:
                done.set()
                cv.notify()

        threading.Thread(
            target=waiter, daemon=True, name="exec-proc-waiter"
        ).start()
        while True:
            with cv:
                while not frames and not done.is_set():
                    cv.wait(timeout=0.5)
                batch, frames[:] = list(frames), []
                finished = done.is_set() and not batch
            for f in batch:
                yield f
            if finished:
                break
        yield {"exit": self.proc.returncode}

    def kill(self):
        try:
            self.proc.kill()
        except OSError:
            pass
        if self._master is not None:
            try:
                os.close(self._master)
            except OSError:
                pass
            self._master = None


def bridge_exec(proc: ExecProcess, stream) -> None:
    """Pump a duplex RPC stream against an ExecProcess until exit: output
    frames flow out on a writer thread while this thread consumes input
    frames. A peer disconnect kills the process (the reference cancels the
    exec when the stream drops)."""
    from ..rpc.mux import StreamClosed, StreamError

    def writer():
        try:
            for frame in proc.output_frames():
                stream.send(frame)
        except (StreamClosed, StreamError, TimeoutError):
            proc.kill()

    wt = threading.Thread(target=writer, daemon=True, name="exec-out")
    wt.start()
    try:
        while True:
            try:
                frame = stream.recv(timeout=3600.0)
            except StreamClosed:
                # peer half-closed: no more input is coming — that is
                # stdin EOF for the process (an interactive `cat` must
                # exit now, not hang on an open pipe)
                proc.close_stdin()
                break
            except StreamError:
                # peer ABORTED (websocket dropped mid-session): the exec
                # is cancelled, not ended — kill rather than EOF
                proc.kill()
                break
            except TimeoutError:
                proc.kill()
                break
            if not isinstance(frame, dict):
                continue
            if frame.get("stdin"):
                data = frame["stdin"]
                if isinstance(data, str):
                    data = data.encode()
                try:
                    proc.write_stdin(data)
                except (OSError, ValueError):
                    break
            if frame.get("eof"):
                proc.close_stdin()
            if frame.get("resize"):
                rows, cols = frame["resize"]
                proc.resize(int(rows), int(cols))
    finally:
        # peer gone or input done; writer finishes on process exit. If the
        # peer vanished early, kill so the writer unblocks.
        wt.join(timeout=0.1)
        if wt.is_alive() and stream.session.dead:
            proc.kill()
        wt.join(timeout=3600.0)
