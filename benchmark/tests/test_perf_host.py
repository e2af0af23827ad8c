"""The host reader (benchmark/host.py) on this machine, without a card:
it parses /proc/self and gives its documented keys, leaves out what the
machine lacks (nvidia-smi, /proc/pressure), and reads a NUMA node's CPUs
from a cpulist tree."""
import os
import threading
import time

import pytest

from benchmark import host as H

SNAP_KEYS = {"wall", "pid", "threads", "user_s", "sys_s", "affinity",
             "cpu_count", "loadavg", "psi_some_us", "mhz", "read_ms"}


def _spin(stop):
    while not stop.is_set():
        sum(range(1000))


def test_snapshot_reads_this_process():
    snap = H.snapshot()
    assert set(snap) == SNAP_KEYS
    assert snap["pid"] == os.getpid() and snap["pid"] in snap["threads"]
    assert snap["affinity"] == sorted(os.sched_getaffinity(0))
    assert snap["cpu_count"] == os.cpu_count()
    main = snap["threads"][snap["pid"]]
    assert {"comm", "cpu", "cpu_s", "run_ns", "wait_ns", "nvcsw"} <= set(main)
    assert main["cpu"] in range(os.cpu_count())
    assert main["run_ns"] > 0 and snap["user_s"] + snap["sys_s"] > 0
    assert snap["read_ms"] < 100


def test_between_counts_the_main_thread_and_the_others():
    stop = threading.Event()
    worker = threading.Thread(target=_spin, args=(stop,))
    a = H.snapshot()
    worker.start()
    try:
        t = time.time()
        while time.time() - t < 0.4:
            sum(range(1000))
        b = H.snapshot()
    finally:
        stop.set()
        worker.join(timeout=10)
    assert not worker.is_alive()
    rec = H.between(a, b)
    assert rec["wall_s"] > 0
    assert 0 < rec["main"]["run_s"] <= rec["wall_s"] + 0.05
    assert rec["main"]["cpu_s"] <= rec["wall_s"] + 0.05
    assert rec["main"]["wait_s"] >= 0 and rec["main"]["nvcsw"] >= 0
    assert set(rec["main"]["cpus"]) <= set(range(os.cpu_count()))
    assert rec["others"]["n"] >= 1 and rec["others"]["run_s"] > 0
    assert rec["others"]["busiest"][1] > 0.05
    assert rec["user_s"] + rec["sys_s"] >= rec["main"]["cpu_s"] > 0


def test_missing_files_are_left_out(monkeypatch):
    real = H._read

    def no_pressure(path):
        return None if path.startswith("/proc/pressure") else real(path)
    monkeypatch.setattr(H, "_read", no_pressure)
    monkeypatch.setenv("PATH", "")
    a = H.snapshot()
    b = H.snapshot()
    assert a["psi_some_us"] is None
    assert "psi_some_s" not in H.between(a, b)
    q = H.CardQuery()
    assert q.proc is None and q.result() is None


@pytest.mark.parametrize("text,cpus", [
    ("0-3,8-11\n", {0, 1, 2, 3, 8, 9, 10, 11}),
    ("5", {5}),
    ("", set()),
    (None, set()),
])
def test_parse_cpulist(text, cpus):
    assert H.parse_cpulist(text) == cpus
    if cpus:
        assert H.parse_cpulist(H.cpulist_text(cpus)) == cpus


def _tree(tmp_path, node_text, bus="0000:18:00.0", numa="1\n"):
    node = tmp_path / "devices" / "system" / "node" / "node1"
    node.mkdir(parents=True)
    if node_text is not None:
        (node / "cpulist").write_text(node_text)
    dev = tmp_path / "bus" / "pci" / "devices" / bus
    dev.mkdir(parents=True)
    (dev / "numa_node").write_text(numa)
    return str(tmp_path)


def test_card_node_cpus_from_a_tree(tmp_path):
    root = _tree(tmp_path, "0-3,8-11\n")
    node = H.card_node("00000000:18:00.0", root)
    assert node == 1
    assert H.card_node("18:00.0", root) == 1
    assert len(H.node_cpus(node, root)) == 8
    assert H.cpulist_text(H.node_cpus(node, root)) == "0-3,8-11"


@pytest.mark.parametrize("node_text", ["", None])
def test_empty_or_missing_cpulist_gives_no_cpus(tmp_path, node_text):
    root = _tree(tmp_path, node_text)
    assert H.node_cpus(H.card_node("00000000:18:00.0", root), root) == set()


def test_card_outside_any_node(tmp_path):
    root = _tree(tmp_path, "0-3", numa="-1\n")
    assert H.card_node("00000000:18:00.0", root) == -1
    assert H.node_cpus(-1, root) == set()
    assert H.card_node("00000000:19:00.0", root) is None
    assert H.card_node(None, root) is None
