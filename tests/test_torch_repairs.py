"""Faults of the port that are repaired: COPY FROM parses text as the
reference does (through the native scanner, storage/native_io.py, built
from native/csv_scanner.cpp into build/native/), and the settings the port
cannot honour raise instead of being ignored: a device memory budget,
`distributed` without the mesh's shard count, and a mesh over distinct
devices."""

import pytest
import torch

from quickstep_tpu import Database as JaxDatabase
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.errors import ExecutionError
from quickstep_tpu_torch.parallel import mesh as TM
from quickstep_tpu_torch.storage import csv_io, native_io


@pytest.fixture
def native_calls(monkeypatch):
    """Results of the port's native parse attempts (None: not taken)."""
    got = []
    real = csv_io._try_native

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        got.append(out)
        return out
    monkeypatch.setattr(csv_io, "_try_native", counted)
    return got


def _copy_rows(db, tmp_path, ddl, text):
    path = tmp_path / "in.tbl"
    path.write_text(text)
    db.execute(ddl)
    db.execute(f"COPY t FROM '{path}' WITH (DELIMITER '|')")
    return db.execute("SELECT * FROM t").rows


# The native scanner knows no quotes and no escapes, and reads as many
# fields as the schema has (native/csv_scanner.cpp:186-239): these are the
# reference's rows, and now the port's.
@pytest.mark.parametrize("ddl,text,rows", [
    ("CREATE TABLE t (a INT NOT NULL, b VARCHAR(10) NOT NULL, "
     "c VARCHAR(10) NOT NULL)", '1|"ab|c"|x\n', [(1, '"ab', 'c"')]),
    ("CREATE TABLE t (a INT NOT NULL, b VARCHAR(10) NOT NULL)", "1|a\\|b\n",
     [(1, "a\\")]),
], ids=("quoted_delimiter", "escaped_delimiter"))
def test_copy_from_parses_like_the_reference(tmp_path, native_calls, ddl,
                                             text, rows):
    assert native_io.native_available()
    port = Database(device="cpu")
    try:
        got = _copy_rows(port, tmp_path, ddl, text)
    finally:
        port.close()
    assert native_calls and all(r is not None for r in native_calls)
    want = _copy_rows(JaxDatabase(), tmp_path, ddl, text)
    assert got == want == rows


def test_copy_to_round_trip_gives_the_reference_rows(tmp_path, native_calls):
    """COPY TO escapes the delimiter inside 'a|b'; COPY FROM reads the
    file back as the reference does."""
    out = []
    for db in (Database(device="cpu"), JaxDatabase()):
        path = tmp_path / f"{type(db).__module__}.tbl"
        db.execute("CREATE TABLE u (a INT NOT NULL, b VARCHAR(10) NOT NULL)")
        db.execute("INSERT INTO u VALUES (1, 'a|b')")
        db.execute(f"COPY u TO '{path}' WITH (DELIMITER '|')")
        db.execute("CREATE TABLE t (a INT NOT NULL, b VARCHAR(10) NOT NULL)")
        db.execute(f"COPY t FROM '{path}' WITH (DELIMITER '|')")
        out.append((path.read_text(), db.execute("SELECT * FROM t").rows))
    assert out[0] == out[1]
    assert out[0] == ("1|a\\|b\n", [(1, "a\\")])
    assert native_calls and native_calls[0] is not None


def test_native_library_is_built_here_not_loaded_from_native():
    native_io._load_library()
    assert native_io._LIB is not None
    path = native_io._LIB._name
    assert path.endswith("build/native/libqstpu_io.so"), path


def test_hbm_budget_raises():
    """A device memory budget is honoured (exec/streaming.py), so a
    database takes one; what raises is a plan the budget cannot hold: a
    table over half the budget with no streamable shape (here scanned
    twice) under strict_hbm_budget, which never quietly runs resident."""
    cfg = Config()
    cfg.hbm_budget_bytes = 1 << 30
    Database(config=cfg, device="cpu").close()
    db = Database(device="cpu")
    try:
        db.execute("CREATE TABLE t (a INT NOT NULL)")
        db.execute("INSERT INTO t VALUES " + ", ".join(
            f"({i})" for i in range(100)))
        q = "SELECT COUNT(*) FROM t t1, t t2 WHERE t1.a = t2.a"
        db.config.hbm_budget_bytes = 256
        db.config.strict_hbm_budget = True
        with pytest.raises(ExecutionError, match="streamable"):
            db.execute(q)
        db.config.strict_hbm_budget = False
        assert db.execute(q).rows == [(100,)]
        assert db.executor.last_stream_info is None
    finally:
        db.close()


def test_distributed_needs_the_shard_count():
    cfg = Config()
    cfg.distributed = True
    with pytest.raises(ExecutionError, match="mesh_shards"):
        Database(config=cfg, device="cpu")
    db = Database(device="cpu")
    try:
        db.config.distributed = True
        with pytest.raises(ExecutionError, match="mesh_shards"):
            db.execute("SELECT 1")
    finally:
        db.close()


def test_mesh_over_distinct_devices_raises():
    """A mesh over several devices in one process has one member a device
    (Database(..., mesh_devices=[...])): the local shards of one mesh share
    one device."""
    with pytest.raises(ValueError, match="one member a device"):
        TM.Mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    mesh = TM.make_mesh(8, "cpu")
    assert mesh.n == 8 and mesh.axis == "x"
