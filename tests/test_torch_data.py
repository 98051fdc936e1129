"""Parity of the PyTorch port's host data layer with the JAX package.

The same synthetic dumps go through both packages' ``preprocess`` (the
``synthetic`` preset's preprocessing) and ``Dataset.reorder``; features,
adjacency, labels, splits, class medians, the reorder permutation and the
geo metrics must agree. The port's TF-IDF is its own numpy implementation
of scikit-learn's ``TfidfVectorizer`` semantics, which the JAX package uses.
"""

import numpy as np
import pytest

from graphconvgeo_torch.data import features as t_features
from graphconvgeo_torch.data import pipeline as t_pipeline
from graphconvgeo_torch.train.evaluate import geo_eval as t_geo_eval
from graphconvgeo_tpu.data import pipeline as j_pipeline
from graphconvgeo_tpu.data.synthetic import make_synthetic_dumps
from graphconvgeo_tpu.train.evaluate import geo_eval as j_geo_eval

# the synthetic preset's preprocessing (bucket 30, min_df 2, celebrity 10)
PREPROCESS = dict(bucket_size=30, min_df=2, celebrity_threshold=10, encoding="latin1")
DATASETS = {
    "600x6": dict(n_users=600, n_clusters=6),  # bell input layer
    "1100x32": dict(n_users=1100, n_clusters=32),  # slab input layer
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def both(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(f"dumps_{request.param}"))
    make_synthetic_dumps(d, seed=0, **DATASETS[request.param])
    j = j_pipeline.preprocess(d, j_pipeline.PreprocessConfig(**PREPROCESS), use_cache=False)
    t = t_pipeline.preprocess(d, t_pipeline.PreprocessConfig(**PREPROCESS), use_cache=False)
    (jr, jro), (tr, tro) = j.reorder(), t.reorder()
    return {"j": j, "t": t, "jr": jr, "tr": tr, "jro": jro, "tro": tro}


def _assert_csr_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_features_match(both):
    j, t = both["j"].x, both["t"].x
    assert t.dtype == np.float32
    assert j.shape == t.shape
    j.sort_indices()
    t.sort_indices()
    np.testing.assert_array_equal(j.indptr, t.indptr)
    np.testing.assert_array_equal(j.indices, t.indices)
    np.testing.assert_allclose(t.data, j.data, rtol=1e-6, atol=0)


def test_graph_labels_splits_match(both):
    j, t = both["j"], both["t"]
    _assert_csr_equal(j.adj, t.adj)
    for name in ("y", "train_idx", "dev_idx", "test_idx", "lat", "lon",
                 "class_lat_median", "class_lon_median",
                 "groups_offsets", "groups_members", "direct_src", "direct_dst"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name), err_msg=name)


def test_reorder_matches(both):
    np.testing.assert_array_equal(both["jro"].perm, both["tro"].perm)
    np.testing.assert_array_equal(both["jro"].inv, both["tro"].inv)
    assert both["tr"].reorder_method == both["tro"].method
    _assert_csr_equal(both["jr"].adj, both["tr"].adj)
    np.testing.assert_array_equal(both["jr"].y, both["tr"].y)
    np.testing.assert_array_equal(both["jr"].dev_idx, both["tr"].dev_idx)


def test_geo_eval_matches(both):
    t = both["t"]
    pred = np.random.default_rng(3).integers(0, t.n_classes, len(t.dev_idx))
    args = (pred, t.lat[t.dev_idx], t.lon[t.dev_idx], t.class_lat_median, t.class_lon_median)
    want, got = j_geo_eval(*args), t_geo_eval(*args)
    for k in ("acc_at_161", "mean_km", "median_km"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["distances"], want["distances"])


def test_stop_words_are_sklearns():
    text = pytest.importorskip("sklearn.feature_extraction.text")
    assert t_features.ENGLISH_STOP_WORDS == frozenset(text.ENGLISH_STOP_WORDS)


def test_tfidf_matches_sklearn_on_edge_cases():
    """Hashtags, mentions, case, stop words, unseen dev terms, empty rows."""
    text = pytest.importorskip("sklearn.feature_extraction.text")
    train = [
        "The cat sat on #mat with @bob and Cat", "dog DOG dog barks at the cat",
        "@alice the BIRD sings", "a b c", "bird dog cat fish", "fish fish fish swims",
    ]
    dev = ["cat unseenword dog", "", "#cat @dog"]
    cfg = t_features.TfidfConfig(min_df=1, max_df=0.6)
    vec = text.TfidfVectorizer(
        token_pattern=t_features.TOKEN_PATTERN, min_df=1, max_df=0.6,
        sublinear_tf=True, stop_words="english",
    )
    want_train, want_dev = vec.fit_transform(train), vec.transform(dev)
    ours = t_features.TfidfVectorizer(cfg)
    got_train, got_dev = ours.fit_transform(train), ours.transform(dev)
    assert ours.vocabulary_ == {k: int(v) for k, v in vec.vocabulary_.items()}
    np.testing.assert_allclose(ours.idf_, vec.idf_, rtol=1e-12)
    np.testing.assert_allclose(got_train.toarray(), want_train.toarray(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got_dev.toarray(), want_dev.toarray(), rtol=1e-12, atol=0)


# TfidfConfig's options one at a time (the rest at the reference's values)
TFIDF_OPTIONS = {
    "reference": {},
    "raw_tf": dict(sublinear_tf=False),
    "no_idf": dict(use_idf=False),
    "binary": dict(binary=True),
    "l1": dict(norm="l1"),
    "no_norm": dict(norm=None),
    "no_stop_words": dict(stop_words=None),
    "own_stop_words": dict(stop_words=["cat", "fish"]),
    "hashtags": dict(keep_hashtags=True),
}


@pytest.mark.parametrize("name", list(TFIDF_OPTIONS))
def test_tfidf_options_match_jax(name):
    """Each of TfidfConfig's options in the port's numpy TF-IDF against the
    JAX package's build_features (scikit-learn) in this process: the same
    vocabulary and the same float32 matrix to rtol 1e-6 (both weigh in
    float64, in other orders, and cast last)."""
    pytest.importorskip("sklearn.feature_extraction.text")
    from graphconvgeo_tpu.data import features as j_features

    train = [
        "The cat sat on #mat with @bob and Cat cat", "dog DOG dog barks at the cat #mat",
        "@alice the BIRD sings", "a b c", "bird dog cat fish", "fish fish fish swims #mat",
        "the #beach day again beach sunny", "going to the beach with @friend",
    ]
    dev = ["cat unseenword dog", "", "#cat @dog #mat", "beach beach"]
    kw = dict(min_df=1, max_df=0.6, **TFIDF_OPTIONS[name])
    want, j_vec = j_features.build_features(train, dev, dev, j_features.TfidfConfig(**kw))
    got, t_vec = t_features.build_features(train, dev, dev, t_features.TfidfConfig(**kw))
    assert t_vec.vocabulary_ == {k: int(v) for k, v in j_vec.vocabulary_.items()}
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-6, atol=0)
    if name == "hashtags":
        assert "#mat" in t_vec.vocabulary_
