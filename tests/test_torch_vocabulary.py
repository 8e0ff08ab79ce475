"""The port's BoW vocabulary against the JAX package's, on the CPU:
training (bit-exact), descent, dense and sparse BoW, L1 scores, the
candidate group rule and the DBoW2 text format, plus
``tests/test_vocabulary.py``'s cases on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.models import vocabulary as jv
from active_orb_slam2_tpu_torch.models import vocabulary as tv

torch.set_num_threads(1)


def descs(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def tdesc(d):
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32))


def as_np(voc):
    return (voc.centers.numpy().view(np.uint32), voc.children.numpy(),
            voc.word_id.numpy(), voc.idf.numpy())


@pytest.fixture(scope="module")
def pair():
    """A seeded corpus with repeated descriptors and both vocabularies
    trained on it (k=4, depth=3: 64 words)."""
    rng = np.random.default_rng(3)
    base = descs(rng, 300)
    corpus = np.concatenate([base, base[:100]])
    return (corpus, jv.train_vocabulary(corpus, k=4, depth=3, iters=4),
            tv.train_vocabulary(corpus, k=4, depth=3, iters=4))


def test_train_vocabulary_bit_exact(pair):
    _, jvoc, tvoc = pair
    c, ch, w, idf = as_np(tvoc)
    np.testing.assert_array_equal(c, np.asarray(jvoc.centers))
    np.testing.assert_array_equal(ch, np.asarray(jvoc.children))
    np.testing.assert_array_equal(w, np.asarray(jvoc.word_id))
    np.testing.assert_allclose(idf, np.asarray(jvoc.idf), atol=1e-6)
    assert (tvoc.k, tvoc.depth, tvoc.n_words) == (4, 3, 64)


@pytest.mark.parametrize("n_valid", [200, 137])
def test_transform_matches_jax(pair, n_valid):
    corpus, jvoc, tvoc = pair
    rng = np.random.default_rng(n_valid)
    q = np.concatenate([corpus[rng.integers(0, len(corpus), 150)],
                        descs(rng, 50)])
    valid = np.arange(200) < n_valid
    jw = np.asarray(jv._descend(jvoc, jnp.asarray(q)))
    np.testing.assert_array_equal(tv._descend(tvoc, tdesc(q)).numpy(), jw)
    jwords, jbow = jv.transform(jvoc, jnp.asarray(q), jnp.asarray(valid))
    twords, tbow = tv.transform(tvoc, tdesc(q), torch.from_numpy(valid))
    np.testing.assert_array_equal(twords.numpy(), np.asarray(jwords))
    np.testing.assert_allclose(tbow.numpy(), np.asarray(jbow), atol=1e-6)
    js = jv.transform_sparse(jvoc, jnp.asarray(q), jnp.asarray(valid))
    ts = tv.transform_sparse(tvoc, tdesc(q), torch.from_numpy(valid))
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
    np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
    np.testing.assert_allclose(ts[2].numpy(), np.asarray(js[2]), atol=1e-6)
    # a leading batch axis gives each row's own result
    tb = tv.transform(tvoc, tdesc(q).view(2, 100, 8),
                      torch.from_numpy(valid).view(2, 100))[1]
    for r in range(2):
        _, jb = jv.transform(jvoc, jnp.asarray(q[100 * r:100 * r + 100]),
                             jnp.asarray(valid[100 * r:100 * r + 100]))
        np.testing.assert_allclose(tb[r].numpy(), np.asarray(jb), atol=1e-6)


def test_scores_and_candidates_match_jax(pair):
    corpus, jvoc, tvoc = pair
    rng = np.random.default_rng(9)
    K, F = 12, 64
    kd = np.stack([corpus[rng.integers(0, len(corpus), F)] for _ in range(K)])
    kd[5] = kd[2]                                 # a perfect match
    ones = np.ones(F, bool)
    jrows = [jv.transform(jvoc, jnp.asarray(d), jnp.asarray(ones))[1]
             for d in kd]
    trows = tv.transform(tvoc, tdesc(kd), torch.ones(K, F, dtype=torch.bool))[1]
    sj = np.asarray(jv.l1_score(jrows[2], jnp.stack(jrows)))
    st = tv.l1_score(trows[2], trows).numpy()
    np.testing.assert_allclose(st, sj, atol=1e-6)
    jsp = [jv.transform_sparse(jvoc, jnp.asarray(d), jnp.asarray(ones))
           for d in kd]
    tsp = tv.transform_sparse(tvoc, tdesc(kd), torch.ones(K, F,
                                                          dtype=torch.bool))
    sj2 = np.asarray(jv.l1_score_sparse(
        jvoc.n_words, jsp[2][1], jsp[2][2], jnp.stack([r[1] for r in jsp]),
        jnp.stack([r[2] for r in jsp])))
    st2 = tv.l1_score_sparse(tvoc.n_words, tsp[1][2], tsp[2][2], tsp[1],
                             tsp[2]).numpy()
    np.testing.assert_allclose(st2, sj2, atol=1e-6)
    np.testing.assert_allclose(st2, st, atol=1e-5)
    # the group rule with integer covisibility weights full of ties
    W = rng.integers(0, 4, (K, K)).astype(np.int32)
    W = np.triu(W, 1) + np.triu(W, 1).T
    valid = np.ones(K, bool)
    valid[7] = False
    covis = W[2] >= 2
    covis[2] = True
    for min_score in (0.0, float(np.sort(sj)[K // 2])):
        _, ja = jv.detect_candidates_from_scores(
            jnp.asarray(sj), jnp.asarray(valid), jnp.asarray(covis),
            min_score, covis_weights=jnp.asarray(W))
        _, ta = tv.detect_candidates_from_scores(
            torch.from_numpy(sj), torch.from_numpy(valid),
            torch.from_numpy(covis), min_score,
            covis_weights=torch.from_numpy(W))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert ta.any()
    _, ja = jv.detect_candidates(jrows[2], jnp.stack(jrows), jnp.asarray(valid),
                                 jnp.asarray(covis), 0.1)
    _, ta = tv.detect_candidates(trows[2], trows, torch.from_numpy(valid),
                                 torch.from_numpy(covis), 0.1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_text_round_trip_both_ways(pair, tmp_path):
    corpus, jvoc, tvoc = pair
    pj, pt = tmp_path / "jax.txt", tmp_path / "port.txt"
    jv.save_text_vocabulary(jvoc, str(pj))
    tv.save_text_vocabulary(tvoc, str(pt))
    assert pj.read_text() == pt.read_text()
    from_jax = tv.load_text_vocabulary(str(pj))
    for a, b in zip(as_np(from_jax), as_np(tvoc)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    from_port = jv.load_text_vocabulary(str(pt))
    np.testing.assert_array_equal(np.asarray(from_port.centers),
                                  as_np(tvoc)[0])
    q = corpus[:50]
    np.testing.assert_array_equal(
        tv._descend(from_jax, tdesc(q)).numpy(),
        np.asarray(jv._descend(from_port, jnp.asarray(q))))


# ---------------------------------------- tests/test_vocabulary.py on the port

def test_train_shapes(rng):
    voc = tv.train_vocabulary(descs(rng, 400), k=4, depth=3, iters=3)
    assert voc.n_words == 64
    assert voc.centers.shape == (4 + 16 + 64, 8)
    assert voc.idf.shape == (64,)


def test_transform_assigns_nearest_leaf(rng):
    d = descs(rng, 300)
    voc = tv.train_vocabulary(d, k=4, depth=2, iters=4)
    words, bow = tv.transform(voc, tdesc(d), torch.ones(300, dtype=torch.bool))
    assert words.shape == (300,)
    assert (words >= 0).all() and (words < 16).all()
    assert abs(float(bow.abs().sum()) - 1.0) < 1e-5


def test_same_descriptors_same_words(rng):
    d = descs(rng, 100)
    voc = tv.train_vocabulary(d, k=4, depth=2, iters=4)
    w1, _ = tv.transform(voc, tdesc(d), torch.ones(100, dtype=torch.bool))
    w2, _ = tv.transform(voc, tdesc(d[:50]), torch.ones(50, dtype=torch.bool))
    assert torch.equal(w1[:50], w2)


def test_l1_score_properties(rng):
    d = descs(rng, 200)
    voc = tv.train_vocabulary(d, k=4, depth=2, iters=4)
    ones = torch.ones(100, dtype=torch.bool)
    _, a = tv.transform(voc, tdesc(d[:100]), ones)
    _, b = tv.transform(voc, tdesc(d[100:]), ones)
    _, mix = tv.transform(voc, tdesc(np.concatenate([d[:80], d[100:120]])),
                          ones)
    s_aa = float(tv.l1_score(a, a[None])[0])
    s_ab = float(tv.l1_score(a, b[None])[0])
    s_am = float(tv.l1_score(a, mix[None])[0])
    assert abs(s_aa - 1.0) < 1e-5
    assert s_ab < s_am < s_aa + 1e-6


def test_detect_candidates_excludes_covis(rng):
    d = descs(rng, 100)
    voc = tv.train_vocabulary(d, k=4, depth=2, iters=4)
    _, bow = tv.transform(voc, tdesc(d), torch.ones(100, dtype=torch.bool))
    covis = torch.zeros(8, dtype=torch.bool)
    covis[1:3] = True
    _, acc = tv.detect_candidates(bow, bow[None].expand(8, -1),
                                  torch.ones(8, dtype=torch.bool), covis,
                                  min_score=0.5)
    assert not acc[1] and not acc[2] and acc[3]


def test_nonfull_tree_descent(tmp_path):
    """An early leaf (above the tree's depth) loops on itself."""
    def line(parent, leaf, b, w):
        return " ".join([str(parent), "1" if leaf else "0"]
                        + [str(x) for x in b] + [str(w)])
    p = tmp_path / "voc.txt"
    p.write_text("\n".join([
        "2 2 0 0", line(0, True, [0xFF] * 32, 0.5),
        line(0, False, [0x00] * 32, 0.0), line(2, True, [0xF0] + [0] * 31, 0.7),
        line(2, True, [0x0F] + [0] * 31, 0.9)]) + "\n")
    voc = tv.load_text_vocabulary(str(p))
    assert voc.n_words == 3
    q = np.zeros((3, 8), np.uint32)
    q[0] = 0xFFFFFFFF
    q[1, 0] = 0xF0
    q[2, 0] = 0x0F
    words, _ = tv.transform(voc, tdesc(q), torch.ones(3, dtype=torch.bool))
    assert words.tolist() == [0, 1, 2]


def test_large_map_retrieval_10k_words(rng):
    """The 10,000-word vocabulary (the loop closer's second stage)
    retrieves a bit-noised keyframe top-1 through the sparse path."""
    K, F = 256, 64
    kf_desc = rng.integers(0, 2**32, size=(K, F, 8), dtype=np.uint32)
    corpus = kf_desc.reshape(-1, 8)
    voc = tv.train_vocabulary(corpus[rng.permutation(len(corpus))[:8000]],
                              k=10, depth=4, iters=3)
    assert voc.n_words == 10_000
    _, dbw, dbwt = tv.transform_sparse(voc, tdesc(kf_desc),
                                       torch.ones(K, F, dtype=torch.bool))
    hits = 0
    for k in (3, 57, 120, 200, 255):
        noisy = kf_desc[k].copy()
        for f in range(16):
            for _ in range(8):
                noisy[f, rng.integers(0, 8)] ^= np.uint32(1) << np.uint32(
                    rng.integers(0, 32))
        _, qw, qwt = tv.transform_sparse(voc, tdesc(noisy),
                                         torch.ones(F, dtype=torch.bool))
        s = tv.l1_score_sparse(voc.n_words, qw, qwt, dbw, dbwt)
        hits += int(int(torch.argmax(s)) == k)
    assert hits >= 4, hits


def test_loop_closer_loads_text_vocabulary(pair, tmp_path):
    """``LoopCloser(vocab_path=...)`` (``System(vocab_path=...)``) takes a
    DBoW2 text vocabulary and never trains one."""
    from active_orb_slam2_tpu_torch.models import loop_closing as tlc
    from tests.test_torch_tracking import configs
    corpus, _, tvoc = pair
    path = tmp_path / "voc.txt"
    tv.save_text_vocabulary(tvoc, str(path))
    lc = tlc.LoopCloser(configs()[1], vocab_path=str(path))
    assert lc.ensure_vocabulary(None, n_kf=1000) is lc.vocab
    np.testing.assert_array_equal(lc.vocab.centers.numpy(),
                                  tvoc.centers.numpy())


def test_vocabulary_cache_keys_the_whole_corpus(rng):
    """Two corpora of one size that share their first 16 descriptors (two
    maps of a process whose first keyframe is the same) train two
    vocabularies; the same corpus again takes the cached one."""
    from active_orb_slam2_tpu_torch.models.loop_closing import (
        train_vocab_cached)
    a = descs(rng, 2048)
    b = a.copy()
    b[16:] = descs(rng, 2048 - 16)
    va, vb = train_vocab_cached(a, 8, 3), train_vocab_cached(b, 8, 3)
    assert not torch.equal(va.centers, vb.centers)
    assert torch.equal(vb.centers, tv.train_vocabulary(b, k=8, depth=3).centers)
    assert train_vocab_cached(a.copy(), 8, 3) is va
