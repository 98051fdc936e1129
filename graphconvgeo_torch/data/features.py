"""BoW / TF-IDF text features (reference: ``data.py :: DataLoader.tfidf``).

A TF-IDF vectorizer fit on *train* text only, then applied to dev and test,
written in numpy and scipy. It reproduces the semantics of scikit-learn's
``TfidfVectorizer`` as the reference configures it, so the port needs no
scikit-learn:

- lowercase, then tokens from ``TOKEN_PATTERN`` (word tokens of length ≥ 2
  not preceded by ``@`` or ``#``), or with ``keep_hashtags`` from
  ``TOKEN_PATTERN_HASHTAGS`` (``#tag`` kept as a token of its own);
- stop words removed: ``"english"`` is scikit-learn's ``ENGLISH_STOP_WORDS``,
  None removes none, a collection of words removes those;
- terms kept when their train document frequency is ≥ ``min_df`` (an
  integer count) and ≤ ``max_df`` × the number of train documents;
- vocabulary sorted alphabetically;
- term counts set to 1 under ``binary``; sublinear tf ``1 + ln(tf)`` under
  ``sublinear_tf``; smooth idf ``ln((1 + n) / (1 + df)) + 1`` under
  ``use_idf``; the row-wise ``norm`` ("l2", "l1" or None), all in float64;
  the result is cast to float32 last.

``TfidfConfig``'s defaults are the reference's (the JAX package's).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import scipy.sparse as sp

# Matches word tokens of length ≥2 not preceded by '@' or '#': the reference
# excludes BOTH mention handles (graph signal, not text signal) and hashtags
# from the vocabulary (SURVEY.md C5 — ``data.py :: DataLoader.tfidf`` token
# pattern).
TOKEN_PATTERN = r"(?u)(?<![@#])\b\w\w+\b"
# Deviation knob: keep '#hashtag' as a vocabulary token (non-reference).
TOKEN_PATTERN_HASHTAGS = r"(?u)(?<![@])#?\b\w\w+\b"

# scikit-learn's ``ENGLISH_STOP_WORDS`` (the reference's ``stop_words="english"``)
ENGLISH_STOP_WORDS = frozenset(
    """
    a about above across after afterwards again against all almost alone
    along already also although always am among amongst amoungst amount
    an and another any anyhow anyone anything anyway anywhere are around
    as at back be became because become becomes becoming been before
    beforehand behind being below beside besides between beyond bill
    both bottom but by call can cannot cant co con could couldnt cry de
    describe detail do done down due during each eg eight either eleven
    else elsewhere empty enough etc even ever every everyone everything
    everywhere except few fifteen fifty fill find fire first five for
    former formerly forty found four from front full further get give go
    had has hasnt have he hence her here hereafter hereby herein
    hereupon hers herself him himself his how however hundred i ie if in
    inc indeed interest into is it its itself keep last latter latterly
    least less ltd made many may me meanwhile might mill mine more
    moreover most mostly move much must my myself name namely neither
    never nevertheless next nine no nobody none noone nor not nothing
    now nowhere of off often on once one only onto or other others
    otherwise our ours ourselves out over own part per perhaps please
    put rather re same see seem seemed seeming seems serious several she
    should show side since sincere six sixty so some somehow someone
    something sometime sometimes somewhere still such system take ten
    than that the their them themselves then thence there thereafter
    thereby therefore therein thereupon these they thick thin third this
    those though three through throughout thru thus to together too top
    toward towards twelve twenty two un under until up upon us very via
    was we well were what whatever when whence whenever where whereafter
    whereas whereby wherein whereupon wherever whether which while
    whither who whoever whole whom whose why will with within without
    would yet you your yours yourself yourselves
    """.split()
)


@dataclasses.dataclass
class TfidfConfig:
    min_df: int = 10
    max_df: float = 0.2
    sublinear_tf: bool = True
    use_idf: bool = True
    binary: bool = False
    norm: str | None = "l2"
    stop_words: str | frozenset | None = "english"
    keep_hashtags: bool = False  # reference behavior: hashtags excluded


_NORMS = ("l2", "l1", None)


class TfidfVectorizer:
    """Fit-on-train TF-IDF with the semantics listed in the module docstring.

    ``vocabulary_`` maps term -> column (alphabetical order) and ``idf_`` holds
    the float64 idf weights after :meth:`fit_transform`."""

    def __init__(self, cfg: TfidfConfig = TfidfConfig()):
        if cfg.norm not in _NORMS:
            raise ValueError(f"norm must be one of {_NORMS}, got {cfg.norm!r}")
        self.cfg = cfg
        self._token = re.compile(TOKEN_PATTERN_HASHTAGS if cfg.keep_hashtags else TOKEN_PATTERN)
        if cfg.stop_words == "english":
            self._stop = ENGLISH_STOP_WORDS
        elif isinstance(cfg.stop_words, str):
            raise ValueError(f"stop_words must be 'english', a collection or None, "
                             f"got {cfg.stop_words!r}")
        else:
            self._stop = frozenset(cfg.stop_words or ())
        self.vocabulary_: dict = {}
        self.idf_: np.ndarray | None = None

    def _analyze(self, doc: str) -> list:
        return [t for t in self._token.findall(doc.lower()) if t not in self._stop]

    def _counts(self, docs, vocab: dict) -> sp.csr_matrix:
        """Term counts over a fixed vocabulary (unknown terms dropped)."""
        indptr, cols, vals = [0], [], []
        for doc in docs:
            counter: dict = {}
            for tok in self._analyze(doc):
                j = vocab.get(tok)
                if j is not None:
                    counter[j] = counter.get(j, 0) + 1
            cols.extend(counter.keys())
            vals.extend(counter.values())
            indptr.append(len(cols))
        x = sp.csr_matrix(
            (np.asarray(vals, np.float64), np.asarray(cols, np.int64), np.asarray(indptr, np.int64)),
            shape=(len(indptr) - 1, len(vocab)),
        )
        x.sort_indices()
        return x

    def _weight(self, x: sp.csr_matrix) -> sp.csr_matrix:
        """tf (binary, then sublinear) times idf, then the row-wise norm."""
        cfg = self.cfg
        x = x.copy()
        if cfg.binary:
            x.data[:] = 1.0
        if cfg.sublinear_tf:
            np.log(x.data, x.data)
            x.data += 1.0
        if cfg.use_idf:
            x.data *= self.idf_[x.indices]
        if cfg.norm is not None:
            rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
            w = x.data**2 if cfg.norm == "l2" else np.abs(x.data)
            norms = np.bincount(rows, weights=w, minlength=x.shape[0])
            if cfg.norm == "l2":
                norms = np.sqrt(norms)
            scale = np.where(norms == 0.0, 1.0, norms)
            x.data /= scale[rows]
        return x

    def fit_transform(self, docs) -> sp.csr_matrix:
        docs = list(docs)
        n_doc = len(docs)
        df: dict = {}
        for doc in docs:
            for tok in set(self._analyze(doc)):
                df[tok] = df.get(tok, 0) + 1
        max_count = self.cfg.max_df * n_doc
        if max_count < self.cfg.min_df:
            raise ValueError("max_df corresponds to < documents than min_df")
        terms = sorted(t for t, c in df.items() if self.cfg.min_df <= c <= max_count)
        if not terms:
            raise ValueError(
                "After pruning, no terms remain. Try a lower min_df or a higher max_df."
            )
        self.vocabulary_ = {t: j for j, t in enumerate(terms)}
        df_kept = np.asarray([df[t] for t in terms], dtype=np.float64)
        self.idf_ = np.log((n_doc + 1.0) / (df_kept + 1.0)) + 1.0
        return self._weight(self._counts(docs, self.vocabulary_))

    def transform(self, docs) -> sp.csr_matrix:
        if self.idf_ is None:
            raise RuntimeError("transform before fit_transform")
        return self._weight(self._counts(docs, self.vocabulary_))


def build_features(
    train_text, dev_text, test_text, cfg: TfidfConfig = TfidfConfig()
) -> tuple:
    """Returns (X csr [n_total, vocab] float32, vectorizer)."""
    vec = TfidfVectorizer(cfg)
    x_train = vec.fit_transform(train_text)
    x_dev = vec.transform(dev_text)
    x_test = vec.transform(test_text)
    x = sp.vstack([x_train, x_dev, x_test]).tocsr().astype(np.float32)
    return x, vec
