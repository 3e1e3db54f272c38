"""The traffic generators: deterministic per seed, the same sizes for
every seed, LJSpeech's bucket shares, texts the program reads as
written."""

import numpy as np

from benchmark import traffic as tr


def test_same_seed_same_traffic():
    assert tr.texts(5, 50) == tr.texts(5, 50)
    assert np.array_equal(tr.arrivals(5, 300.0, 30.0),
                          tr.arrivals(5, 300.0, 30.0))
    a, b = tr.corpus_lengths(9, 500, 5.6, 0.15, 1024)
    c, d = tr.corpus_lengths(9, 500, 5.6, 0.15, 1024)
    assert np.array_equal(a, c) and np.array_equal(b, d)


def test_seeds_reorder_the_same_sizes():
    x, y = tr.texts(1, 400), tr.texts(2, 400)
    assert x != y
    assert sorted(map(len, x)) == sorted(map(len, y))
    ga = np.diff(tr.arrivals(1, 200.0, 10.0))
    gb = np.diff(tr.arrivals(2, 200.0, 10.0))
    assert not np.array_equal(ga, gb)
    full = np.round(tr.exponential_gaps(2000, 10.0), 9)
    assert np.isin(np.round(ga, 9), full).all()
    assert np.isin(np.round(gb, 9), full).all()
    p1 = sorted(zip(*tr.corpus_lengths(1, 300, 5.6, 0.15, 1024)))
    p2 = sorted(zip(*tr.corpus_lengths(2, 300, 5.6, 0.15, 1024)))
    assert p1 == p2


def test_lengths_follow_the_shares():
    n = 20000
    lengths = tr.length_quantiles(n)
    share = {64: np.mean(lengths <= 64),
             128: np.mean((lengths > 64) & (lengths <= 128)),
             192: np.mean(lengths > 128)}
    total = sum(tr.SHARES.values())
    for b, p in tr.SHARES.items():
        assert abs(share[b] - p / total) < 1e-3
    assert lengths.min() >= 8 and lengths.max() <= 192
    # uniform within a bucket: the middle bucket's halves hold alike
    mid = lengths[(lengths > 64) & (lengths <= 128)]
    assert abs(np.mean(mid <= 96) - 0.5) < 0.02


def test_rate_and_span():
    due = tr.arrivals(3, 250.0, 12.0)
    assert len(due) == 3000
    assert due[0] == 0.0 and due[-1] < 12.0
    assert np.all(np.diff(due) > 0)


def test_texts_read_as_written():
    from tacotron2_tpu_torch.text import text_to_sequence
    for text in tr.texts(11, 300):
        ids = text_to_sequence(text, ["english_cleaners"])
        assert list(tr.text_ids(text)) == ids
    rng = np.random.RandomState(0)
    for n in (8, 9, 17, 64, 65, 128, 192):
        assert len(tr.make_text(rng, n)) == n


def test_frames_per_character():
    lengths, frames = tr.corpus_lengths(4, 2048, 5.6, 0.15, 1024)
    assert frames.max() <= 1024
    ratio = frames / lengths
    assert ratio.min() >= 5.6 * 0.85 - 0.1
    uncapped = frames < 1024
    assert abs(np.mean(ratio[uncapped]) - 5.6) < 0.1
