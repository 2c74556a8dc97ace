"""Run a command as N local ranks, the way torchrun would, with a deadline.

Each rank is a process of its own that gets torchrun's environment
(RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR 127.0.0.1,
MASTER_PORT), so `parallel.mesh.init_distributed()` joins it to the
group from the environment. As torchrun's agent does, the calling
process hosts the group's TCPStore for the group's whole life, on a port
the system picks when it is bound (TORCHELASTIC_USE_AGENT_STORE tells
the ranks to connect to it): no port is released before the ranks take
it, so no other group can take it in between, and no rank outlives the
store. The ranks share one deadline: a rank that fails, or a group that
outlives the deadline, ends every rank, so a hung collective fails its
caller instead of waiting forever.

    outs = run_ranks([sys.executable, "driver.py"], n=2, timeout=120)
    # each rank's standard output; every rank exited 0
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["run_ranks", "RanksFailed"]

_ROOT = Path(__file__).resolve().parents[2]  # the checkout holding the package


class RanksFailed(RuntimeError):
    """A rank exited non-zero, or the group outlived its deadline."""


def _tail(path: str, n: int = 4000) -> str:
    with open(path, "rb") as f:
        return f.read()[-n:].decode(errors="replace")


def run_ranks(cmd: Sequence[str], n: int, timeout: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run `cmd` as ranks 0..n-1 and return each rank's standard output,
    in rank order: a return means every rank exited 0.

    The package's checkout is put first on PYTHONPATH. Raises RanksFailed
    with the failing rank's error output (the others are killed) if a
    rank exits non-zero or the group has not finished after `timeout`
    seconds.
    """
    from torch.distributed import TCPStore

    base = dict(os.environ if env is None else env)
    parts = [p for p in base.get("PYTHONPATH", "").split(os.pathsep) if p]
    base["PYTHONPATH"] = os.pathsep.join([str(_ROOT)] + parts)
    store = TCPStore("127.0.0.1", 0, n, is_master=True, wait_for_workers=False)
    try:
        base.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(store.port), TORCHELASTIC_USE_AGENT_STORE="True",
                    TORCHELASTIC_RESTART_COUNT="0")
        return _run(cmd, n, timeout, base, cwd)
    finally:
        del store  # every rank has ended: _run kills the ones still running


def _run(cmd, n, timeout, base, cwd) -> List[str]:
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for r in range(n):
            out, err = os.path.join(tmp, f"{r}.out"), os.path.join(tmp, f"{r}.err")
            logs.append((out, err))
            with open(out, "wb") as fo, open(err, "wb") as fe:
                procs.append(subprocess.Popen(
                    list(cmd), env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    cwd=cwd, stdout=fo, stderr=fe, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
                if bad:
                    failed = (bad[0], f"exit code {procs[bad[0]].returncode}")
                    break
                if time.monotonic() > deadline:
                    failed = (next(r for r, p in enumerate(procs) if p.poll() is None),
                              f"still running after {timeout:g} s")
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = (bad[0], f"exit code {procs[bad[0]].returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if failed is not None:
            r, why = failed
            raise RanksFailed(f"rank {r} of {n}: {why}\n{_tail(logs[r][1])}")
        return [open(out, encoding="utf-8", errors="replace").read() for out, _ in logs]
