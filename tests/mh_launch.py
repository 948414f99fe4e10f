"""Start the rank processes of one multi-process CPU run and wait for them.

Each run's coordinator port is reserved for as long as the run lasts: the
launcher holds a socket bound to it (``SO_REUSEADDR``, not listening), so
neither another process's ``bind(0)`` nor an outgoing connection's
ephemeral port can take it, while rank 0's store, which binds with
``SO_REUSEADDR`` too, listens on it beside that socket.  A port picked free
and closed before the ranks start stays open to others for the seconds the
ranks take to import under load; when one took it, rank 0 failed to bind
and the other ranks kept retrying their connection until the test's
timeout.

Each rank writes to a file of its own (no pipe fills while nobody reads it).
:meth:`Ranks.wait` returns the outputs once every rank has exited 0, and
ends the run at its first failure or at its deadline: the other ranks are
killed and the error shows every rank's last lines.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

TAIL = 3000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_env(threads):
    """The ranks' environment: this one without any process group's
    variables or ``XLA_FLAGS``, the repository on ``PYTHONPATH``, ``threads``
    OpenMP threads."""
    env = dict(os.environ)
    for k in ("SHGAN_DIST_COORDINATOR", "SHGAN_DIST_NPROCS", "SHGAN_DIST_PID",
              "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "XLA_FLAGS"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(threads)
    return env


def reserve_port():
    """``(socket, port)``: a port on 127.0.0.1 kept from others while the
    socket stays open."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s, s.getsockname()[1]


class Ranks:
    """``world`` processes of ``script``, rank ``r`` run as ``python script
    r world port *args``, its output in ``<out_dir>/rank<r>.log``."""

    def __init__(self, script, world, args, out_dir, env, timeout=240):
        os.makedirs(out_dir, exist_ok=True)
        self.sock, port = reserve_port()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.logs = [os.path.join(out_dir, f"rank{r}.log")
                     for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, script, str(r), str(world), str(port),
                     *map(str, args)], env=env, stdout=out,
                    stderr=subprocess.STDOUT))

    def _outputs(self):
        outs = []
        for path in self.logs:
            with open(path, errors="replace") as f:
                outs.append(f.read())
        return outs

    def stop(self):
        """Kill the ranks still running (none once :meth:`wait` returned)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        self.sock.close()

    def wait(self):
        """Every rank's output, once all exited 0; else AssertionError."""
        why = None
        try:
            while why is None:
                codes = [p.poll() for p in self.procs]
                if any(c not in (None, 0) for c in codes):
                    why = f"a rank failed (exit codes {codes})"
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > self.deadline:
                    why = f"ranks still running after {self.timeout} s"
                else:
                    time.sleep(0.05)
        finally:
            self.stop()
        outs = self._outputs()
        assert why is None, why + "\n" + "\n".join(
            f"--- rank {r}\n{o[-TAIL:]}" for r, o in enumerate(outs))
        return outs
