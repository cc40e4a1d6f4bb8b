"""Host score classes, torch port vs the JAX package: the twin of
`tests/test_scores.py`. Every case runs the same operations on both
packages' `SimpleScore`, `HardSoftScore` and `HardMediumSoftScore` and
requires equal results (values, order, JSON). Tolerance: none."""

from greyjack_tpu.score_calculation import scores as jscores
from greyjack_tpu_torch.score_calculation import scores as tscores

PKGS = (jscores, tscores)


def _both(fn):
    want, got = [fn(p) for p in PKGS]
    assert got == want
    return want


def test_simple_score_impl():
    out = _both(lambda s: [s.SimpleScore(-1.0).get_sum_abs(),
                           s.SimpleScore(9.0).get_priority_score(),
                           s.SimpleScore(9.0).get_fitness_value()])
    assert out == [1.0, 9.0, 0.9]


def test_simple_score_comparison():
    def fn(s):
        small, null, large = (s.SimpleScore(-10.0), s.SimpleScore(0.0),
                              s.SimpleScore(10.0))
        scores = [s.SimpleScore(float(i)) for i in range(10)]
        return [small < large, small <= large, small != large,
                null == s.SimpleScore(0.0), large > null, large >= large,
                [x.values for x in sorted(reversed(scores))]]
    out = _both(fn)
    assert out[:6] == [True] * 6


def test_simple_score_add():
    def fn(s):
        s1 = s.SimpleScore(-1.0)
        a = (s1 + s.SimpleScore(1.0)).values
        s1 += s.SimpleScore(1.0)
        return [a, s1.values]
    assert _both(fn) == [[0.0], [0.0]]


def test_hard_soft_impl():
    out = _both(lambda s: [s.HardSoftScore(-1.0, -1.0).get_sum_abs(),
                           s.HardSoftScore(0.0, 9.0).get_priority_score(),
                           s.HardSoftScore(0.0, 9.0).get_fitness_value()])
    assert out == [2.0, 9.0, 0.45]


def test_hard_soft_lexicographic():
    def fn(s):
        small = s.HardSoftScore(-1.0, -1.0)
        null = s.HardSoftScore(0.0, 0.0)
        large = s.HardSoftScore(0.0, 0.1)
        scores = [s.HardSoftScore(float(i), float(2 * i)) for i in range(10)]
        return [small < large, null < large,
                s.HardSoftScore(1.0, 0.0) > s.HardSoftScore(0.0, 1e9),
                [x.values for x in sorted(reversed(scores))]]
    assert _both(fn)[:3] == [True] * 3


def test_hard_medium_soft_lexicographic():
    def fn(s):
        a = s.HardMediumSoftScore(0.0, 0.0, 5.0)
        b = s.HardMediumSoftScore(0.0, 1.0, 0.0)
        c = s.HardMediumSoftScore(1.0, 0.0, 0.0)
        return [a < b < c] + [s.HardMediumSoftScore(*v).get_priority_score()
                              for v in ((0.0, 0.0, 0.0), (2.0, 1.0, 0.5),
                                        (0.0, 1.0, 0.5), (-1.0, 3.0, 0.5))]
    assert _both(fn) == [True, 0.0, 2.0, 1.0, 3.0]


def test_round_precision():
    def fn(s):
        x = s.HardSoftScore(1.23456, 7.89123)
        x.round([3, 3])
        y = s.HardMediumSoftScore(50778.123456, -2.5, 1.9999)
        y.round([0, 1, 3])
        return [x.values, y.values]
    out = _both(fn)
    assert out[0] == [1.234, 7.891]


def test_stub_and_null():
    def fn(s):
        stub = s.HardSoftScore.get_stub_score()
        return [s.HardSoftScore(1e300, 1e300) < stub, stub.values,
                s.HardSoftScore.get_null_score().values]
    assert _both(fn)[0] is True


def test_mul_and_json_roundtrip():
    def fn(s):
        x = s.HardMediumSoftScore(1.0, 2.0, 3.0).mul(2.0)
        j = x.to_json()
        return [x.values, j, s.HardMediumSoftScore.from_json(j) == x,
                s.SimpleScore(4.0).to_json(),
                s.SimpleScore.from_row([4.0]).values]
    out = _both(fn)
    assert out[0] == [2.0, 4.0, 6.0] and out[2] is True
