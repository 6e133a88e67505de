"""The cases of tests/test_dictionary.py run against quickstep_tpu_torch
(Database(device="cpu") and the port's copies).

Unit tests: ordered dictionary (reference compression/tests analog)."""

import numpy as np

from quickstep_tpu_torch.storage.dictionary import Dictionary


def test_build_and_order():
    d, codes = Dictionary.build(["banana", "apple", "cherry", "apple"])
    assert d.values == ["apple", "banana", "cherry"]
    assert list(codes) == [1, 0, 2, 0]
    # order preserving: code comparisons == string comparisons
    assert d.code_of("apple") < d.code_of("banana") < d.code_of("cherry")


def test_range_bounds():
    d, _ = Dictionary.build(["b", "d", "f"])
    assert d.lower_bound("a") == 0
    assert d.lower_bound("b") == 0
    assert d.lower_bound("c") == 1
    assert d.upper_bound("b") == 1
    assert d.upper_bound("z") == 3
    assert d.code_of("zz") == -1


def test_like():
    d, _ = Dictionary.build(["MEDIUM POLISHED TIN", "SMALL BRASS", "PROMO BRASS"])
    bm = d.match_like("%BRASS")
    assert list(bm) == [False, True, True]
    bm = d.match_like("MEDIUM%")
    assert bm[d.code_of("MEDIUM POLISHED TIN")]
    bm = d.match_like("%special%requests%")
    assert not bm.any()


def test_like_underscore_and_escape():
    d, _ = Dictionary.build(["abc", "aXc", "a_c"])
    assert list(d.match_like("a_c")) == [True, True, True]
    bm = d.match_like("a\\_c", escape="\\")
    # escaped underscore is literal: only "a_c" matches (bitmap is over the
    # sorted dictionary, so index via code_of)
    assert bm[d.code_of("a_c")]
    assert bm.sum() == 1


def test_merge():
    a, _ = Dictionary.build(["b", "d"])
    b, _ = Dictionary.build(["a", "d"])
    m, ra, rb = Dictionary.merge(a, b)
    assert m.values == ["a", "b", "d"]
    assert list(ra) == [1, 2]
    assert list(rb) == [0, 2]


def test_map_values():
    d, _ = Dictionary.build(["13-555", "31-444", "13-999"])
    nd, remap = d.map_values(lambda s: s[:2])
    assert nd.values == ["13", "31"]
    # '13-555' and '13-999' map to same new code
    assert remap[d.code_of("13-555")] == remap[d.code_of("13-999")]


def test_like_fast_path_matches_regex_oracle():
    """The %-only str.find chain must agree with the regex lowering on
    adversarial values (values containing % and _ themselves, overlapping
    prefix/suffix, empty pattern)."""
    import random
    from quickstep_tpu_torch.storage.dictionary import _like_to_regex
    random.seed(7)
    vals = sorted(set("".join(random.choices("ab_c%", k=random.randint(0, 8)))
                      for _ in range(2000)))
    d = Dictionary(vals)
    for p in ["", "%", "a%", "%a", "a%b", "ab", "%ab%", "a%b%c", "%%",
              "a%%b", "abc%a", "%a%a", "aa%aa", "ab%ba", "c%", "%c%c%c%"]:
        rx = _like_to_regex(p, None)
        want = [rx.fullmatch(v) is not None for v in vals]
        got = list(d.match_like(p))
        assert want == got, p


def test_like_bitmap_memoized():
    d, _ = Dictionary.build(["x", "xy", "zy"])
    assert d.match_like("%y") is d.match_like("%y")
    assert d.match_regex("x.*") is d.match_regex("x.*")
