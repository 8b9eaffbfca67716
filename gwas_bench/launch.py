"""A cell whose ``chips`` is more than 1 runs as one process per card.

``run.py`` hands such a cell to :func:`launch`.  It starts ``chips`` rank
processes on this host, each running the same command with torchrun's
variables set (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` = 127.0.0.1 and a free
``MASTER_PORT``) and with this process's start time under :data:`STARTED`,
which marks a process as a rank.  Then it waits on them.  If any rank exits
non-zero or dies, the others are killed at once and the launcher exits
non-zero, so no rank sits in a collective until its timeout.  Rank 0's
standard output is captured: its last line, the result, becomes the
launcher's last line.  Rank 0's standard error goes to the launcher's as it
is, every other rank's output each line prefixed with its rank, a whole
line at a time.

This module imports only the standard library: the launcher holds no card
and loads nothing of the program.
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

#: the environment variable that carries the launcher's start time (on the
#: time.time() clock) to its ranks
STARTED = "GWAS_BENCH_LAUNCHER_STARTED"
#: top-level module names that no process of a run may load: JAX's and the
#: JAX package's (compared whole, so the port's longer name is not one)
FORBIDDEN = ("jax", "jaxlib", "flax", "pygemma_tpu")
_PR_SET_PDEATHSIG = 1
_POLL_S = 0.05  # how often the launcher looks at its ranks


def process_start() -> float:
    """This process's start on the time.time() clock (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    now = time.time()
    return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def launched_at() -> Optional[float]:
    """The launcher's start time in a rank process; None in any other."""
    value = os.environ.get(STARTED)
    return None if value is None else float(value)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In a child before exec: SIGKILL it when the launcher dies."""
    ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG,
                                            signal.SIGKILL)


def _pump(stream, sink) -> None:
    for line in stream:
        sink(line)
    stream.close()


def _write_err(text: str) -> None:
    sys.stderr.write(text)
    sys.stderr.flush()


def launch(cmd: List[str], world: int, started: float) -> int:
    """Run ``cmd`` as ``world`` ranks; print rank 0's result line and
    return 0 when every rank exits 0, else return non-zero and print no
    result."""
    port = free_port()
    procs, pumps, out = [], [], []
    streams = []  # (pipe, where its lines go)

    def on_term(signum, frame):
        raise SystemExit(128 + signum)

    old_term = signal.signal(signal.SIGTERM, on_term)
    try:
        for r in range(world):
            env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            env[STARTED] = repr(started)
            procs.append(subprocess.Popen(
                cmd, env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE if r == 0 else subprocess.STDOUT,
                text=True, bufsize=1, preexec_fn=_die_with_parent))
            p = procs[-1]
            if r == 0:
                streams += [(p.stdout, out.append), (p.stderr, _write_err)]
            else:
                streams.append((p.stdout, lambda line, r=r:
                                _write_err(f"rank {r}: {line}")))
        for stream, sink in streams:
            pumps.append(threading.Thread(target=_pump, args=(stream, sink),
                                          daemon=True))
            pumps[-1].start()
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if failed:
                r, c = failed[0]
                _write_err(f"launch: rank {r} exited with {c}; ending the "
                           f"other ranks\n")
                return c if c > 0 else 128 - c
            if all(c == 0 for c in codes):
                break
            time.sleep(_POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in pumps:
            t.join()
        signal.signal(signal.SIGTERM, old_term)
    found = forbidden_modules()
    if found:
        _write_err(f"launch: the launcher loaded {found}\n")
        return 4
    lines = [line for line in out if line.strip()]
    try:
        result = json.loads(lines[-1])
    except (IndexError, ValueError):
        _write_err("launch: rank 0 printed no result line\n")
        return 5
    for name, c in result.get("checks", {}).items():
        _write_err(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    _write_err(f"correct {result['correct']}\n")
    print(json.dumps(result), flush=True)
    return 0
