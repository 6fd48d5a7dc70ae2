"""Start N ranks of one command on this host.

    python -m kmc_tpu_torch.parallel.launch -n 4 -- -m kmc_tpu_torch.cli \\
        --replicas 2048 --steps 20 --out runs/ens

runs ``python <arguments>`` N times with ``KMC_COORDINATOR`` (a free
localhost port), ``KMC_NUM_PROCESSES`` and ``KMC_PROCESS_ID`` set, waits
for all of them and fails if any rank fails or the time limit passes (then
every rank is killed, so a rank left waiting on a message cannot hang the
caller).  Rank i takes card i % cards (``parallel/distributed.py``).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

GRACE_S = 10.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(n: int, argv, timeout: float = 600.0, cwd=None,
          env=None) -> list[str]:
    """Run ``python argv`` as ranks 0..n-1; returns each rank's output
    (stdout and stderr together).  ``argv`` is a list, or a function of
    (rank, port) that gives each rank's list.  Raises RuntimeError if a
    rank exits nonzero or the ranks outlast ``timeout`` seconds."""
    port = free_port()
    rank_argv = argv if callable(argv) else (lambda i, port: argv)
    base = dict(os.environ if env is None else env)
    # each rank writes to a file of its own: a pipe that nobody reads
    # while the caller waits on another rank could fill and block it
    outs = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
    procs = []
    for i in range(n):
        rank_env = dict(base, KMC_COORDINATOR=f"127.0.0.1:{port}",
                        KMC_NUM_PROCESSES=str(n), KMC_PROCESS_ID=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, *rank_argv(i, port)], cwd=cwd, env=rank_env,
            stdout=outs[i], stderr=subprocess.STDOUT, text=True))
    # a rank that fails leaves the others waiting on its messages: they
    # get GRACE_S seconds to end on their own, then every rank is killed
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if any(p.returncode for p in procs):
                deadline = min(deadline, now + GRACE_S)
            if now > deadline:
                break
            time.sleep(0.05)
    finally:
        late = [i for i, p in enumerate(procs) if p.poll() is None]
        for i in late:
            procs[i].kill()
            procs[i].wait()
        logs = []
        for f in outs:
            f.seek(0)
            logs.append(f.read())
            f.close()
    what = rank_argv(0, port)
    if late and not any(p.returncode for i, p in enumerate(procs)
                        if i not in late):
        raise RuntimeError(f"{n} ranks of {what} outlasted {timeout} s; "
                           f"rank 0 said:\n{logs[0][-3000:]}")
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} of {what} failed:\n" + "\n".join(
            f"--- rank {i} (exit {procs[i].returncode}):\n{logs[i][-3000:]}"
            for i in bad))
    return logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kmc_tpu_torch.parallel.launch",
                                 description=__doc__)
    ap.add_argument("-n", "--nproc", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=86400.0)
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        ap.error("give the python arguments after --")
    cut = argv.index("--")
    args = ap.parse_args(argv[:cut])
    cmd = argv[cut + 1:]
    try:
        logs = spawn(args.nproc, cmd, timeout=args.timeout)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    for i, log in enumerate(logs):
        print(f"--- rank {i}\n{log}", end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
