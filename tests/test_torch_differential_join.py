"""The port against quickstep_tpu over bench/differential.py's edge-case
databases on the CPU: the unique and expansion joins (K3, K4, K7, K10).
Each case runs its family's share of one seed's battery
(differential.rotation) through both engines, as
differential_engines.Engines.check runs it: rows compare as
differential.same_rows says, and a query on the shape of one of
ROADMAP's known reference faults is held against sqlite instead."""

import pytest

from differential_engines import Engines, cases

FAMILIES = ("unique_join", "expansion_join")


@pytest.fixture(scope="module")
def engines():
    e = Engines()
    yield e
    e.close()


@pytest.mark.parametrize("seed,family", cases(FAMILIES))
def test_port_matches_reference(engines, seed, family):
    engines.check(seed, family)
