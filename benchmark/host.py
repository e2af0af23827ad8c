"""The host's facts, read per run from this process's own state and from
read-only files, so that a run's speed can be set beside where and how
its threads ran.

`snapshot()` reads, for each of the process's threads
(/proc/self/task/<tid>/), the CPU it last ran on, its CPU time, its time
on and waiting for a CPU (schedstat, ns) and its involuntary switches;
the whole process's user and system time; and for the machine the load
average, CPU pressure and the median `cpu MHz`. `between(a, b)` is what
changed from one snapshot to the next. `CardQuery` asks nvidia-smi for
the card's PCI bus id, SM clock and power in a child process of its own,
so that the question overlaps other set-up; it is never asked inside the
timed window. `node_cpus` gives the CPUs of the card's NUMA node from
/sys. Every reader returns what it finds and leaves out what is missing:
a run on a machine without nvidia-smi, /proc/pressure or a NUMA node
still gets the rest.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import time

CLK_TCK = os.sysconf("SC_CLK_TCK")
CARD_FIELDS = ("pci.bus_id", "clocks.sm", "power.draw", "power.limit")


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def parse_cpulist(text: str | None) -> set:
    """'0-3,8-11' -> {0, 1, 2, 3, 8, 9, 10, 11}; empty or None -> set()."""
    cpus: set = set()
    for part in (text or "").strip().split(","):
        part = part.strip()
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def cpulist_text(cpus) -> str:
    """{0, 1, 2, 3, 8} -> '0-3,8', the kernel's own cpulist form."""
    out, run = [], []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
        run = [c]
    if run:
        out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
    return ",".join(out)


def node_cpus(node: int | None, sys_root: str = "/sys") -> set:
    """The CPUs of NUMA node `node`; empty when the node is unknown (None
    or negative, as a card outside any node reads) or its cpulist is
    missing or empty."""
    if node is None or node < 0:
        return set()
    return parse_cpulist(_read(os.path.join(
        sys_root, "devices", "system", "node", f"node{node}", "cpulist")))


def card_node(bus_id: str | None, sys_root: str = "/sys") -> int | None:
    """NUMA node of the PCI device `bus_id` as nvidia-smi prints it
    ('00000000:18:00.0'), from /sys/bus/pci/devices/<id>/numa_node (whose
    names have a 4-digit domain)."""
    if not bus_id:
        return None
    dom, _, rest = bus_id.strip().lower().rpartition(":")
    dom, _, bus = dom.rpartition(":") if dom.count(":") else ("", "", dom)
    name = f"{int(dom or '0', 16):04x}:{bus}:{rest}"
    text = _read(os.path.join(sys_root, "bus", "pci", "devices", name,
                              "numa_node"))
    return int(text) if text and text.strip().lstrip("-").isdigit() else None


def _thread(tid: str) -> dict | None:
    base = f"/proc/self/task/{tid}/"
    stat = _read(base + "stat")
    if stat is None:            # the thread ended while we read
        return None
    f = stat[stat.rindex(")") + 2:].split()   # f[0] is field 3 (state)
    t = {"comm": stat[stat.index("(") + 1:stat.rindex(")")],
         "cpu": int(f[39 - 3]),
         "cpu_s": (int(f[14 - 3]) + int(f[15 - 3])) / CLK_TCK}
    sched = _read(base + "schedstat")
    if sched:
        run_ns, wait_ns = sched.split()[:2]
        t["run_ns"], t["wait_ns"] = int(run_ns), int(wait_ns)
    for line in (_read(base + "status") or "").splitlines():
        if line.startswith("nonvoluntary_ctxt_switches"):
            t["nvcsw"] = int(line.split()[1])
    return t


def _psi_total_us() -> int | None:
    for line in (_read("/proc/pressure/cpu") or "").splitlines():
        if line.startswith("some"):
            return int(line.rsplit("total=", 1)[1])
    return None


def _mhz() -> float | None:
    vals = [float(line.split(":")[1]) for line in
            (_read("/proc/cpuinfo") or "").splitlines()
            if line.startswith("cpu MHz")]
    return statistics.median(vals) if vals else None


def snapshot() -> dict:
    """This process's threads and the machine's load, now."""
    t0 = time.perf_counter()
    threads = {}
    for tid in os.listdir("/proc/self/task"):
        t = _thread(tid)
        if t is not None:
            threads[int(tid)] = t
    load = (_read("/proc/loadavg") or "").split()
    # the whole process, threads that have ended included (fields 14, 15)
    stat = _read("/proc/self/stat").rsplit(")", 1)[1].split()
    snap = {"wall": time.time(), "pid": os.getpid(), "threads": threads,
            "user_s": int(stat[14 - 3]) / CLK_TCK,
            "sys_s": int(stat[15 - 3]) / CLK_TCK,
            "affinity": sorted(os.sched_getaffinity(0)),
            "cpu_count": os.cpu_count(),
            "loadavg": [float(x) for x in load[:3]] if load else None,
            "psi_some_us": _psi_total_us(), "mhz": _mhz()}
    snap["read_ms"] = (time.perf_counter() - t0) * 1e3
    return snap


def between(a: dict, b: dict) -> dict:
    """What changed from snapshot a to snapshot b: the process's user and
    system time; the main thread's time on a CPU (stat) and on and off
    the run queue (schedstat), its involuntary switches and the CPUs it
    was seen on; the same summed over the other threads alive at b, with
    the busiest of them; and the machine's CPU pressure and load."""
    main = b["pid"]

    def d(key, tid):
        return b["threads"][tid].get(key, 0) - \
            a["threads"].get(tid, {}).get(key, 0)
    out = {"wall_s": b["wall"] - a["wall"],
           "user_s": b["user_s"] - a["user_s"],
           "sys_s": b["sys_s"] - a["sys_s"]}
    if main in b["threads"]:
        m = b["threads"][main]
        out["main"] = {"cpu_s": d("cpu_s", main),
                       "run_s": d("run_ns", main) * 1e-9,
                       "wait_s": d("wait_ns", main) * 1e-9,
                       "nvcsw": d("nvcsw", main),
                       "cpus": sorted({a["threads"].get(main, m)["cpu"],
                                       m["cpu"]})}
    others = [t for t in b["threads"] if t != main]
    cpu = {t: d("cpu_s", t) for t in others}
    out["others"] = {"n": len(others), "cpu_s": sum(cpu.values()),
                     "run_s": sum(d("run_ns", t) for t in others) * 1e-9,
                     "wait_s": sum(d("wait_ns", t) for t in others) * 1e-9,
                     "nvcsw": sum(d("nvcsw", t) for t in others)}
    if cpu:
        top = max(cpu, key=cpu.get)
        out["others"]["busiest"] = [b["threads"][top]["comm"], cpu[top]]
    if a["psi_some_us"] is not None and b["psi_some_us"] is not None:
        out["psi_some_s"] = (b["psi_some_us"] - a["psi_some_us"]) * 1e-6
    out["load1"] = b["loadavg"][0] if b["loadavg"] else None
    out["mhz"] = b["mhz"]
    out["read_ms"] = b["read_ms"]
    return out


class CardQuery:
    """nvidia-smi's reading of the card, asked in a child process at
    construction and collected by `result()`; None where there is no
    nvidia-smi or it fails. `close()` ends and reaps the child if nobody
    collected it."""

    def __init__(self, fields=CARD_FIELDS):
        self.fields = fields
        exe = shutil.which("nvidia-smi")
        self.proc = None if exe is None else subprocess.Popen(
            [exe, "--query-gpu=" + ",".join(fields),
             "--format=csv,noheader,nounits", "--id=0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def result(self, timeout: float = 30.0) -> dict | None:
        if self.proc is None:
            return None
        proc, self.proc = self.proc, None
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return None
        if proc.returncode != 0 or not out.strip():
            return None
        vals = [v.strip() for v in out.strip().splitlines()[0].split(",")]
        res = {}
        for k, v in zip(self.fields, vals):
            try:
                res[k] = v if k == "pci.bus_id" else float(v)
            except ValueError:
                res[k] = v
        return res

    def close(self):
        if self.proc is not None:
            self.proc.kill()
            self.proc.communicate()
            self.proc = None


def line(tag: str, rec: dict) -> str:
    """One stderr line: 'benchmark: host <tag> <json>'."""
    return f"benchmark: host {tag} " + json.dumps(rec, sort_keys=True)
