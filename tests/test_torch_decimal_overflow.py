"""The cases of tests/test_decimal_overflow.py run against quickstep_tpu_torch
(Database(device="cpu") and the port's copies).

SF100-scale decimal-sum overflow guard: when stats prove the int64 unit
accumulation could exceed 2^63, SUM/AVG over DECIMAL fall back to f64
accumulation (reference parity: the reference's TPC-H decimals are DOUBLEs)
instead of silently wrapping."""

from quickstep_tpu_torch import Database


def test_wide_decimal_sum_widens_instead_of_wrapping():
    db = Database(device="cpu")
    db.execute("CREATE TABLE w (v DECIMAL(18,6) NOT NULL)")
    # 300 rows x 9e17 units: bound 2.7e20 >= 2^63 -> guard must widen
    val = "900000000000.123456"
    db.execute("INSERT INTO w VALUES " + ", ".join(f"({val})" for _ in range(300)))
    db.execute("\\analyze")
    r = db.execute("SELECT SUM(v), AVG(v) FROM w")
    s, a = r.rows[0]
    expected = 300 * 900000000000.123456
    assert abs(float(s) - expected) <= 1e-6 * expected, s
    assert abs(float(a) - 900000000000.123456) <= 1.0, a


def test_small_decimal_sum_stays_exact():
    db = Database(device="cpu")
    db.execute("CREATE TABLE e (v DECIMAL(12,2) NOT NULL)")
    db.execute("INSERT INTO e VALUES (1.25), (2.50), (3.25)")
    db.execute("\\analyze")
    r = db.execute("SELECT SUM(v) FROM e")
    # exact integer-unit accumulation: printed value is exact
    assert float(r.rows[0][0]) == 7.00
