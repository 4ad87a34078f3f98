"""The traffic generator: the same seed gives the same tracks, another seed
other tracks of the same length and rate; a mix with a pool gives every
seed the pool's tracks, in another order."""
import numpy as np

from port_bench.traffic import Tracks, load_mix


def mix(name="longform", **kw):
    m = load_mix(name)
    m.update(seconds=3.0, prepared_tracks=2, **kw)
    return m


def test_same_seed_same_tracks():
    for name in ("longform", "patch"):
        a, b = Tracks(mix(name), 2**33 + 5), Tracks(mix(name), 2**33 + 5)
        for x, y in zip([a.setup(), a.next(), a.next(), a.next()], [b.setup(), b.next(), b.next(), b.next()]):
            assert x.seed == y.seed and x.check == y.check and x.sr == y.sr
            np.testing.assert_array_equal(x.audio, y.audio)


def test_other_seed_other_tracks_same_sizes():
    a, b = Tracks(mix(), 11), Tracks(mix(), 12)
    x, y = a.next(), b.next()
    assert x.seed != y.seed
    assert not np.array_equal(x.audio, y.audio)
    assert x.audio.shape == y.audio.shape == (int(3.0 * mix()["sample_rate"]),)
    assert x.frames == y.frames == 72 and len(x.check) == len(y.check) == mix()["frames_checked"]
    assert x.audio.dtype == np.float32 and np.isfinite(x.audio).all()


def test_tracks_in_a_window_differ_and_past_the_prepared_ones_are_drawn():
    t = Tracks(mix(), 3)
    seen = [t.next() for _ in range(4)]
    assert len({s.seed for s in seen}) == 4 and [s.index for s in seen] == [0, 1, 2, 3]


def test_a_pool_gives_every_seed_its_tracks_in_another_order():
    orders = [[t.seed for t in (lambda tr: [tr.next() for _ in range(5)])(Tracks(mix("patch"), s))]
              for s in (1, 2, 3, 4)]
    assert all(len(set(o[:4])) == 4 and set(o[:4]) == set(orders[0][:4]) and o[4] == o[0] for o in orders)
    assert len({tuple(o[:4]) for o in orders}) > 1
    a, b = Tracks(mix("patch"), 1), Tracks(mix("patch"), 2)
    assert a.setup().seed not in orders[0] and a.next().check != b.next().check
