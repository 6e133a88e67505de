"""The port's 4-shard mesh on the CPU against the port on one device over
bench/differential.py's edge-case databases: the battery of the other
differential files (differential.rotation: one query of each family on
every seed; chip_smoke.py's phase 2d runs every query on the card's
mesh), with replicate_threshold_rows low enough that every table of more
than 8 rows shards. The rows are held bit for bit (NaN to NaN,
-0.0 apart from 0.0), as the same sequence where the query orders; float
SUM and AVG columns alone are held within their worst case over the
column (differential.sum_bound, float64 accumulation), since the mesh
folds each shard's partial sum in shard order (parallel/mesh.py
fold_partials)."""

import pytest

from differential_engines import cases, mesh_database
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench import differential as D


@pytest.fixture(scope="module")
def pair():
    one, mesh = Database(device="cpu"), mesh_database("cpu")
    state = {"seed": None}

    def load(seed):
        if state["seed"] != seed:
            state["tables"] = D.make_database(seed)
            for db in (one, mesh):
                D.load_tables(db, state["tables"])
            state["seed"] = seed
        return state["tables"]
    yield one, mesh, load
    one.close()
    mesh.close()


@pytest.mark.parametrize("seed,family", cases(D.FAMILIES))
def test_mesh_matches_one_device(pair, seed, family):
    one, mesh, load = pair
    tables = load(seed)
    battery = [q for q in D.rotation(seed, D.queries(seed))
               if q.family == family]
    assert battery
    for query in battery:
        why = D.mesh_difference(D.run_query(mesh, query),
                                D.run_query(one, query), query, tables)
        assert why is None, f"seed {seed} {query.sql}: {why}"
