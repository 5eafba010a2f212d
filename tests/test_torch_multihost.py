"""Multi-process clusters of daft_tpu_torch over torch.distributed on the CPU
(``gloo``): the cases of tests/test_multihost.py through the port.

Each case spawns worker processes (tests/torch_multihost_worker.py), each
with its own CPU slots of one global mesh, and reads their marker lines.
The exchange between processes is the real collective on ``gloo``
(``device_shuffles``), where the reference, whose jaxlib CPU backend has no
cross-process collective, takes its peer transport (``transport_shuffles``),
and the raw collective probe passes where the reference's is a strict xfail
naming that gap (pinned differences, ROADMAP Queue 3).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(scenario: str, nproc: int, timeout: int = 120):
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, scenario, str(i), str(nproc), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {scenario} worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    return outs


def _line(out: str, marker: str) -> str:
    return next(ln for ln in out.splitlines() if ln.startswith(marker))


def test_two_process_cluster_exchange_q5_and_scan_locality():
    import daft_tpu
    from benchmarks import tpch

    outs = _spawn("main", 2)
    opened_total = 0
    rows = []
    for i, out in enumerate(outs):
        assert f"MULTIHOST_OK {i}" in out, out
        assert f"MULTIHOST_Q5_OK {i}" in out, out
        # the exchange crossed processes as the collective itself
        assert int(_line(out, f"MULTIHOST_Q5_OK {i}").split("shuffles=")[1]) >= 1
        rows.append(json.loads(_line(out, "MULTIHOST_Q5_ROWS ").split(" ", 1)[1]))
        opened = int(_line(out, f"MULTIHOST_SCANLOC_OK {i}").split("opened=")[1])
        assert opened <= 6, out
        opened_total += opened
        assert int(_line(out, f"MULTIHOST_MAPCHAIN_OK {i}").split("opened=")[1]) <= 6, out
        assert f"MULTIHOST_EMPTYLOCAL_OK {i}" in out, out
        assert f"MULTIHOST_STRINGPAYLOAD_OK {i}" in out, out
    assert opened_total >= 8, opened_total
    # every process holds the same Q5, and it is the reference's answer
    assert rows[0] == rows[1]
    t = tpch.generate_tables(scale=0.02, seed=42)
    cust = daft_tpu.from_arrow(t["customer"]).repartition(4, "c_custkey")
    orders = daft_tpu.from_arrow(t["orders"]).repartition(4, "o_custkey")
    line = (daft_tpu.from_arrow(t["lineitem"])
            .select(daft_tpu.col("l_orderkey"), daft_tpu.col("l_extendedprice"),
                    daft_tpu.col("l_discount")).repartition(4, "l_orderkey"))
    want = tpch.q5(cust, orders, line, daft_tpu.from_arrow(t["nation"])).to_pydict()
    assert rows[0]["n_name"] == want["n_name"]
    for a, b in zip(rows[0]["revenue"], want["revenue"]):
        assert a == pytest.approx(b, rel=1e-5)


def test_four_process_cluster_string_shuffle():
    for i, out in enumerate(_spawn("four", 4)):
        assert f"MULTIHOST4_OK {i}" in out, out
        assert int(_line(out, f"MULTIHOST4_OK {i}").split("shuffles=")[1]) >= 1


def test_two_process_register_allmerge():
    """The register merge across processes: all_gather of each process's
    max, then a max (the mesh's routing declines the multi-process case, as
    the reference's does, so the collective is driven directly)."""
    for i, out in enumerate(_spawn("sketch", 2)):
        assert f"SKETCH_MERGE_OK {i}" in out, out


def test_raw_cpu_collective_probe():
    """Pinned difference: the raw cross-process collectives run on gloo, where
    the reference's probe is a strict xfail on its jaxlib's CPU gap."""
    for i, out in enumerate(_spawn("probe", 2)):
        assert f"PROBE_OK {i}" in out, out


def test_two_process_transport_shuffle_after_a_collective_failure():
    """The mesh's host transport (dist/peer.py) between two gloo processes:
    with collective.exchange armed on both, a repartition takes the transport
    (transport_shuffles 1, no collective and no host shuffle), every process
    holds the same 8 partitions, and each holds the rows of the reference's
    partition of the same index over the same rows."""
    import numpy as np

    import daft_tpu

    outs = _spawn("transport", 2)
    parts = []
    for i, out in enumerate(outs):
        assert f"TRANSPORT_OK {i} transport_shuffles=1" in out, out
        parts.append(json.loads(_line(out, "TRANSPORT_ROWS ").split(" ", 1)[1]))
    assert parts[0] == parts[1]
    rng = np.random.RandomState(5)
    k = rng.randint(0, 50, 6000).astype(np.int64)
    v = rng.randint(0, 1000, 6000).astype(np.int64)
    want = [p.to_pydict() for p in daft_tpu.from_pydict({"k": k, "v": v}).repartition(
        8, "k").collect().iter_partitions()]
    assert parts[0] == want
