"""A closed-loop stream of paired reads through two named pipes.

The load runs in a child process of its own, so that its writers never
take the interpreter's lock from the program under test: one writer
thread a mate writes the pool's gzip members (one batch of fragments
each) in order, cycling, as fast as the program reads them. `stop_at(t)`
ends the stream at time t: each writer finishes the member it is on and
both stop after the same number of members, so that both mates end on
the same fragment; then the pipes close and the program's reader sees
the end of its input.

The child is this file run as a script (`python3 stream.py <spec.json>`):
it reads the members from the spec's file, stops when a line comes on
its standard input or the input closes, and prints the members each
mate wrote as one JSON line on its standard output.
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import threading
import time

F_SETPIPE_SZ = 1031
CHILD_GRACE_S = 60.0


class PairStream:
    def __init__(self, members1: list, members2: list, workdir: str,
                 pipe_bytes: int = 1 << 20):
        if len(members1) != len(members2):
            raise ValueError("both mates need the same number of members")
        self.paths = (os.path.join(workdir, "reads_1.fq.gz"),
                      os.path.join(workdir, "reads_2.fq.gz"))
        for p in self.paths:
            os.mkfifo(p)
        self._spec = os.path.join(workdir, "stream.json")
        blob = os.path.join(workdir, "stream.bin")
        with open(blob, "wb") as fh:
            for m in (members1, members2):
                for b in m:
                    fh.write(b)
        with open(self._spec, "w") as fh:
            json.dump({"paths": self.paths, "blob": blob,
                       "lengths": [[len(b) for b in members1],
                                   [len(b) for b in members2]],
                       "pipe_bytes": pipe_bytes}, fh)
        self.written = [0, 0]
        self.errors = []
        self._child = None
        self._stop_time = None
        self._wake = threading.Event()
        self._timer = threading.Thread(target=self._watch, daemon=True)

    def start(self) -> None:
        self._child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self._spec],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self._timer.start()

    def stop_now(self) -> None:
        child = self._child
        if child is None or child.stdin is None or child.stdin.closed:
            return
        try:
            child.stdin.write(b"stop\n")
            child.stdin.close()
        except (BrokenPipeError, OSError, ValueError):
            pass

    def stop_at(self, t: float) -> None:
        """End the stream at time.perf_counter() == t."""
        self._stop_time = t
        self._wake.set()

    def _watch(self) -> None:
        self._wake.wait()
        while self._stop_time is not None:
            left = self._stop_time - time.perf_counter()
            if left <= 0:
                break
            time.sleep(left)
        self.stop_now()

    def members_written(self) -> int:
        return min(self.written)

    def close(self, timeout: float = 60.0) -> None:
        """Stop, release a writer that waits for its reader, end the
        child and read what it wrote."""
        self._stop_time = time.perf_counter()
        self._wake.set()
        self.stop_now()
        child = self._child
        if child is not None:
            deadline = time.monotonic() + timeout
            fds = []
            while child.poll() is None and time.monotonic() < deadline:
                # a writer blocked in open() or write() waits for a
                # reader: open one and drain it
                for p in self.paths:
                    if len(fds) < 2:
                        try:
                            fds.append(os.open(p, os.O_RDONLY
                                               | os.O_NONBLOCK))
                        except OSError:
                            pass
                got = False
                for fd in fds:
                    try:
                        got |= bool(os.read(fd, 1 << 20))
                    except BlockingIOError:
                        pass
                if not got:
                    time.sleep(0.01)
            for fd in fds:
                os.close(fd)
            if child.poll() is None:
                child.kill()
                self.errors.append("the stream's writer did not end")
            out = child.stdout.read()
            child.stdout.close()
            child.wait()
            try:
                rec = json.loads(out.decode().strip().splitlines()[-1])
                self.written = rec["written"]
                self.errors.extend(rec["errors"])
            except (ValueError, IndexError, KeyError):
                self.errors.append(f"the stream's writer said {out!r}")
        self._timer.join(1.0)
        for p in self.paths:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass


def _child_main(spec_path: str) -> int:
    with open(spec_path) as fh:
        spec = json.load(fh)
    with open(spec["blob"], "rb") as fh:
        blob = fh.read()
    members, at = [], 0
    for lens in spec["lengths"]:
        mate = []
        for n in lens:
            mate.append(blob[at:at + n])
            at += n
        members.append(mate)
    del blob
    written = [0, 0]
    errors = []
    lock = threading.Lock()
    stop = {"members": None}

    def write(mate: int) -> None:
        try:
            with open(spec["paths"][mate], "wb", buffering=1 << 20) as fh:
                try:
                    fcntl.fcntl(fh.fileno(), F_SETPIPE_SZ,
                                int(spec["pipe_bytes"]))
                except OSError:
                    pass
                i = 0
                while True:
                    with lock:
                        if stop["members"] is not None \
                                and i >= stop["members"]:
                            break
                    fh.write(members[mate][i % len(members[mate])])
                    fh.flush()
                    i += 1
                    with lock:
                        written[mate] = i
        except (BrokenPipeError, OSError) as e:
            errors.append(f"mate {mate + 1}: {e!r}")

    threads = [threading.Thread(target=write, args=(m,), daemon=True)
               for m in (0, 1)]
    for t in threads:
        t.start()
    sys.stdin.buffer.readline()       # a stop line, or the parent gone
    with lock:
        stop["members"] = max(written) + 1
    deadline = time.monotonic() + CHILD_GRACE_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        errors.append("a writer was still blocked at the end")
    sys.stdout.write(json.dumps({"written": written, "errors": errors})
                     + "\n")
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1]))
