"""The port's network server and client (tests/test_network.py's case):
an in-process server on a loopback socket, and the front ends' device
flag: `python -m quickstep_tpu_torch --device ...` and the server's
`--device`."""

import os
import subprocess
import sys
import threading

from quickstep_tpu_torch import Database
from quickstep_tpu_torch.cli.network import QueryClient, QueryServer
from quickstep_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_network_roundtrip():
    db = Database(device="cpu")
    db.execute("CREATE TABLE n (a INT NOT NULL)")
    db.execute("INSERT INTO n VALUES (1), (2), (3)")
    server = QueryServer(db, port=0)   # ephemeral port
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        client = QueryClient("127.0.0.1", server.port)
        resp = client.query("SELECT sum(a) AS s FROM n")
        assert resp["rows"] == [[6]]
        assert resp["columns"] == ["s"]
        assert "6" in resp["stdout"]
        # error path
        resp = client.query("SELECT nope FROM n")
        assert "unknown column" in resp["stderr"]
        # second query on same connection
        resp = client.query("SELECT count(*) FROM n WHERE a > 1")
        assert resp["rows"] == [[2]]
        client.close()
    finally:
        server.shutdown()


def test_network_clients_get_a_streamed_answer():
    """Two clients of a server whose database has a device memory budget
    get the same streamed answer."""
    import numpy as np
    from quickstep_tpu_torch.storage.column import Column
    from quickstep_tpu_torch.storage.table import TableData
    from quickstep_tpu_torch.types import INT
    db = Database(config=Config(hbm_budget_bytes=64 * 1024), device="cpu")
    db.execute("CREATE TABLE big (k INT NOT NULL, v INT NOT NULL)")
    k = np.arange(50_000, dtype=np.int32)
    rel = db.catalog.default_database.get_relation("big")
    rel.set_data(TableData({"k": Column(INT, k, None, None),
                            "v": Column(INT, k % 7, None, None)}))
    rel.analyze()
    server = QueryServer(db, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        answers = []
        for _ in range(2):
            c = QueryClient("127.0.0.1", server.port)
            answers.append(c.query("SELECT SUM(v) FROM big WHERE k >= 100"))
            c.close()
        assert [a["rows"] for a in answers] == \
            [[[int((k[100:] % 7).sum())]]] * 2
        assert db.executor.last_stream_info["segments_run"] > 1
    finally:
        server.shutdown()


def _run(*args):
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)


def test_the_front_ends_need_the_device():
    """python -m quickstep_tpu_torch runs on the card unless --device cpu
    asks for the CPU: without a card the default refuses (never a quiet
    CPU run); with --device cpu, -c runs the statements (the REPL's path,
    reading display_timing from the config); the server's default refuses
    alike."""
    proc = _run("-m", "quickstep_tpu_torch", "-c", "SELECT 1;")
    assert proc.returncode != 0 and "finds no CUDA device" in proc.stderr
    proc = _run("-m", "quickstep_tpu_torch", "--device", "cpu",
                "--display_timing", "false", "-c",
                "CREATE TABLE t (a INT NOT NULL); "
                "INSERT INTO t VALUES (4), (5); SELECT SUM(a) FROM t;")
    assert proc.returncode == 0, proc.stderr
    assert "9" in proc.stdout and "(1 rows)" in proc.stdout
    assert "Time:" not in proc.stdout
    proc = _run("-m", "quickstep_tpu_torch.cli.network", "--port", "0")
    assert proc.returncode != 0 and "finds no CUDA device" in proc.stderr
