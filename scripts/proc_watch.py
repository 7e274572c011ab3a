"""Run ``chip_smoke.py`` in a checkout and list the processes it leaves.

    python3 scripts/proc_watch.py TREE OUT

TREE is a checkout (``git archive`` of the tree, unpacked), OUT a
directory for the logs.  The watcher makes itself the subreaper of what
it starts, runs ``python3 chip_smoke.py`` in TREE with its output in
``OUT/smoke.log``, and writes to ``OUT/procs.log`` every new process it
sees (``/proc`` read every 0.5 s: time since the start, pid, parent,
standard output, command line), the script's exit time and code, and
every process still there 0, 1, 4, 10 and 30 s after the exit.  Exits
with the script's code.
"""

import ctypes
import os
import subprocess
import sys
import time


def snapshot() -> dict[int, tuple[int, str, str, str]]:
    """Every process -> (parent, state, command line, standard output)."""
    rows = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            try:
                fd1 = os.readlink(f"/proc/{pid}/fd/1")
            except OSError:
                fd1 = "?"
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        rows[int(pid)] = (int(fields[1]), fields[0], cmd[:400], fd1)
    return rows


def main() -> int:
    tree, out = sys.argv[1], os.path.abspath(sys.argv[2])
    os.makedirs(out, exist_ok=True)
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # subreaper
    me = os.getpid()
    before = set(snapshot())
    log = open(f"{out}/procs.log", "w")
    t0 = time.time()
    with open(f"{out}/smoke.log", "w") as smoke:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree,
                                stdout=smoke, stderr=subprocess.STDOUT)
        seen = set()
        while proc.poll() is None:
            for pid, (ppid, _, cmd, fd1) in snapshot().items():
                if pid not in before and pid not in seen and pid != me:
                    seen.add(pid)
                    log.write(f"{time.time() - t0:8.1f} new pid={pid} "
                              f"ppid={ppid} fd1={fd1} {cmd}\n")
                    log.flush()
            time.sleep(0.5)
    log.write(f"{time.time() - t0:8.1f} chip_smoke exited "
              f"rc={proc.returncode}\n")
    for delay in (0, 1, 4, 10, 30):
        time.sleep(delay)
        left = {pid: row for pid, row in snapshot().items()
                if pid not in before and pid != me}
        log.write(f"--- {time.time() - t0:8.1f} s: {len(left)} left\n")
        for pid, (ppid, state, cmd, fd1) in left.items():
            log.write(f"  pid={pid} ppid={ppid} state={state} fd1={fd1} "
                      f"{cmd}\n")
        log.flush()
        while True:                     # reap what was left to this watcher
            try:
                reaped = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if reaped == (0, 0):
                break
            log.write(f"  reaped {reaped}\n")
    log.close()
    with open(f"{out}/procs.log") as f:
        print(f.read()[-20000:])
    return proc.returncode


if __name__ == "__main__":
    raise SystemExit(main())
