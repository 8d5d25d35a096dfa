"""Start the processes of a job of several ranks on this host and wait for
them all: the dry run's ranks (awm_tpu_torch.entry) and the drill's
(awm_tpu_torch.tools.multihost_drill).  They meet through a rendezvous of
their own; this module only starts, watches and stops them."""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spawn_ranks(argvs: dict[str, list[str]], log_dir: str, timeout: float, env: dict | None = None) -> None:
    """Start `sys.executable argv` for each name -> argv of argvs, from the
    repo's root with the repo first on PYTHONPATH and `env` over this
    process's environment, each writing its output to <log_dir>/<name>.log,
    and wait for all of them until `timeout` seconds pass.  At the first
    that exits non-zero, or when the time runs out, kill every one still
    running (a lost rank would hold the others in a collective) and raise
    RuntimeError with the tail of each log."""
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    logs = {name: os.path.join(log_dir, f"{name}.log") for name in argvs}
    procs = {}
    try:
        for name, argv in argvs.items():
            with open(logs[name], "w") as f:
                procs[name] = subprocess.Popen([sys.executable, *argv], env=env, cwd=REPO, stdout=f,
                                               stderr=subprocess.STDOUT)
        deadline = time.time() + timeout
        while True:
            codes = {name: p.poll() for name, p in procs.items()}
            fails = [(name, c) for name, c in codes.items() if c not in (None, 0)]
            if fails or None not in codes.values():
                break
            if time.time() > deadline:
                fails = [(next(n for n, c in codes.items() if c is None), f"nothing after {timeout:.0f} s")]
                break
            time.sleep(0.2)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if fails:
        tails = []
        for name, log in logs.items():
            with open(log) as f:
                tails.append(f"-- {name}:\n{f.read()[-3000:]}")
        raise RuntimeError(f"{fails[0][0]} exited {fails[0][1]}\n" + "\n".join(tails))
