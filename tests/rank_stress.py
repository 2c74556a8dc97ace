"""Stress of the port's rank groups (ROADMAP C8): run the mesh-serving
driver of tests/test_torch_mesh_serving.py through a tree's
`parallel/spawn.run_ranks` many times, several groups at once, while busy
processes load the CPU, and count the groups that fail.

Each group is two gloo ranks on the CPU. Options:

* `--tree DIR`: the checkout whose package and driver run (default: this
  one);
* `--load N`: N processes that spin on the CPU meanwhile (default 6);
* `--groups C`: C groups at once (default 3);
* `--port-pressure K RATE`: one more process holds K sockets listening on
  ports the system picks (bind to port 0, as gloo's listeners and other
  servers do), replacing them at RATE a second: a busy host's turnover of
  ports, raised;
* `--add-teardown`: the driver ends with a barrier and
  `destroy_process_group` (a tree whose driver lacks its teardown);
* `--host-store`: this process hosts each group's TCPStore on a port it
  binds once, the ranks told by TORCHELASTIC_USE_AGENT_STORE (a tree
  whose run_ranks hands out a free port).

Only this program's own processes and sockets are involved. Run from
the root of a checkout (no card needed):

    python tests/rank_stress.py -n 60 --port-pressure 3000 1500 --tree OLD --host-store

Prints a line a group and a JSON summary (failures by rank, exit code
and cause), and writes every failing rank's error output to `--out`.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ARENA = dict(r_min=10.0, r_max=60.0, r_res=2.0, theta_min=-12.0, theta_max=12.0,
             theta_res=4.0, phi_min=-6.0, phi_max=6.0, phi_res=2.0)
TEARDOWN = "\nimport torch.distributed as dist\ndist.barrier()\ndist.destroy_process_group()\n"
PRESSURE = r'''
import collections, socket, sys, time
K, RATE = int(sys.argv[1]), float(sys.argv[2])
held, n, t0 = collections.deque(), 0, time.time()
while True:
    s = socket.socket(); s.bind(("127.0.0.1", 0)); s.listen(1); held.append(s)
    if len(held) > K:
        held.popleft().close()
    n += 1
    lag = n / RATE - (time.time() - t0)
    if lag > 0:
        time.sleep(lag)
'''


def cause(msg: str) -> str:
    for key, text in (("EADDRINUSE", "EADDRINUSE"),
                      ("abort", "terminate called without an active exception"),
                      ("deadline", "still running after")):
        if text in msg:
            return key
    return "other"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", type=int, default=60, help="groups to run")
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--load", type=int, default=6)
    p.add_argument("--groups", type=int, default=3)
    p.add_argument("--port-pressure", type=float, nargs=2, metavar=("K", "RATE"))
    p.add_argument("--add-teardown", action="store_true")
    p.add_argument("--host-store", action="store_true")
    p.add_argument("--timeout", type=float, default=150)
    p.add_argument("--out", default=os.path.join("chiprun_out", "rank_stress_failures.txt"))
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from radarml_tpu_torch.parallel import spawn

    src = open(os.path.join(tree, "tests", "test_torch_mesh_serving.py")).read()
    driver = re.search(r"_DRIVER = r'''(.*?)'''", src, re.S).group(1)
    driver += TEARDOWN if args.add_teardown else ""
    env = dict(os.environ)
    if args.host_store and not hasattr(spawn, "free_port"):
        raise SystemExit(f"{tree}'s run_ranks hosts its group's store itself")

    if args.host_store:  # the tree's run_ranks sets MASTER_PORT from free_port()
        hosted = threading.local()
        spawn.free_port = lambda: hosted.store.port

    def run(cmd):
        if not args.host_store:
            return spawn.run_ranks(cmd, 2, args.timeout, env=env)
        from torch.distributed import TCPStore

        hosted.store = TCPStore("127.0.0.1", 0, 2, is_master=True, wait_for_workers=False)
        e = dict(env, TORCHELASTIC_USE_AGENT_STORE="True", TORCHELASTIC_RESTART_COUNT="0")
        try:
            return spawn.run_ranks(cmd, 2, args.timeout, env=e)
        finally:
            del hosted.store

    extra = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
             for _ in range(args.load)]
    if args.port_pressure:
        k, rate = args.port_pressure
        extra.append(subprocess.Popen([sys.executable, "-c", PRESSURE, str(int(k)), str(rate)]))
        time.sleep(5)  # the held ports fill up
    lock, todo = threading.Lock(), iter(range(args.n))
    fails, n_ok = [], [0]

    def worker():
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "driver.py")
            with open(path, "w") as f:
                f.write(driver)
            while True:
                with lock:
                    i = next(todo, None)
                if i is None:
                    return
                out = os.path.join(d, str(i))
                os.makedirs(out)
                t0 = time.time()
                try:
                    run([sys.executable, path, out, json.dumps(ARENA)])
                    err = None
                except spawn.RanksFailed as e:
                    err = str(e)
                with lock:
                    if err is None:
                        n_ok[0] += 1
                    else:
                        fails.append((i, err))
                    print(f"group {i}: {'ok' if err is None else 'FAILED'} "
                          f"({time.time() - t0:.1f} s)", flush=True)

    t0 = time.time()
    try:
        threads = [threading.Thread(target=worker) for _ in range(args.groups)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for q in extra:
            q.kill()
            q.wait()
    kinds = collections.Counter(
        " ".join([re.search(r"rank \d of 2: [^\n]*", m).group(0), cause(m)]) for _, m in fails)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.writelines(f"--- group {i}\n{m}\n" for i, m in fails)
    print(json.dumps({"tree": tree, "groups": args.n, "at_once": args.groups,
                      "load": args.load, "port_pressure": args.port_pressure,
                      "add_teardown": args.add_teardown, "host_store": args.host_store,
                      "ok": n_ok[0], "failed": len(fails), "by_kind": dict(kinds),
                      "s": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
