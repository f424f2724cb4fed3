"""Real-data ingestion on AUTHENTIC raw file formats (VERDICT r2 item 1).

The reference's experiments consume specific on-disk layouts:

* UCI abalone.data — string Sex column (M/F/I), one-hot encoded in code
  (reference experiments/abalone/abalone.py:23-26).
* UCI/StatLib housing.data — 14 whitespace-separated numeric columns
  (reference experiments/boston_housing/boston_housing.py:50-60).
* OpenML kin8nm CSV — header row + 9 comma columns.
* NOAA co2_mm_mlo.txt — '#' comment preamble, year/month/decimal-date/
  average/deseasonalized columns, -99.99 missing codes
  (reference experiments/co2/CO2_1d_regression.py:45-58).

Fixture files in these exact formats live in tests/fixtures/real_formats/
(values from the repo's surrogate generators; only the FORMAT is real).
These tests prove the `source == "real"` branch ingests them end-to-end:
a user who drops the genuine files into experiments/data/ runs the
experiments with zero code changes.
"""

import os

import numpy as np
import pytest

from scfgp.data import datasets

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "real_formats")


@pytest.fixture()
def real_data_dir(monkeypatch):
    """Point the loader's search directory at the authentic-format fixtures."""
    monkeypatch.setattr(datasets, "DATA_DIR", FIXTURES)


def test_abalone_uci_raw_one_hot(real_data_dir):
    Xt, yt, Xv, yv, meta = datasets.load_abalone(seed=0)
    assert meta["source"] == "real"
    X = np.vstack([Xt, Xv])
    y = np.concatenate([yt, yv])
    assert X.shape == (80, 10)  # 3 one-hot sex + 7 morphometrics
    # one-hot block: exactly one of the first three columns is 1
    assert np.array_equal(np.unique(X[:, :3]), [0.0, 1.0])
    assert np.all(X[:, :3].sum(axis=1) == 1.0)
    # all three classes present; order is sorted-unique (F, I, M) like the
    # reference's label_binarize(X_cate, np.unique(X_cate))
    assert np.all(X[:, :3].sum(axis=0) > 0)
    # first fixture row is F,0.5211,...,15 -> locate it and check encoding
    row = X[np.isclose(X[:, 3], 0.5211)][0]
    assert list(row[:3]) == [1.0, 0.0, 0.0]
    assert np.all(y == np.round(y))  # Rings are integers
    assert y.min() >= 1


def test_abalone_numeric_coded_sex(tmp_path, monkeypatch):
    # A pre-numericized 9-column file (sex coded 0/1/2) also one-hots.
    rng = np.random.RandomState(0)
    sex = rng.choice(3, 40)
    num = rng.rand(40, 8)
    num[:, 7] = rng.randint(1, 20, 40)
    path = tmp_path / "abalone.csv"
    with open(path, "w") as fh:
        for i in range(40):
            fh.write(",".join([str(sex[i])] +
                              [f"{v:.4f}" for v in num[i, :7]] +
                              [str(int(num[i, 7]))]) + "\n")
    monkeypatch.setattr(datasets, "DATA_DIR", str(tmp_path))
    Xt, yt, Xv, yv, meta = datasets.load_abalone(seed=0)
    assert meta["source"] == "real"
    X = np.vstack([Xt, Xv])
    assert X.shape == (40, 10)
    assert np.all(X[:, :3].sum(axis=1) == 1.0)


def test_boston_statlib_whitespace(real_data_dir):
    Xt, yt, Xv, yv, meta = datasets.load_boston(seed=0)
    assert meta["source"] == "real"
    X = np.vstack([Xt, Xv])
    y = np.concatenate([yt, yv])
    assert X.shape == (80, 13)
    # MEDV is the target, in the clipped [5, 50] band
    assert 5.0 <= y.min() and y.max() <= 50.0
    # CHAS (col 3) is the 0/1 dummy
    assert set(np.unique(X[:, 3])) <= {0.0, 1.0}


def test_kin8nm_openml_header_csv(real_data_dir):
    Xt, yt, Xv, yv, meta = datasets.load_kin8nm(seed=0)
    assert meta["source"] == "real"
    X = np.vstack([Xt, Xv])
    assert X.shape == (80, 8)
    # header row must have been dropped, not parsed as data
    assert np.isfinite(X).all()
    assert np.abs(X).max() < np.pi  # joint angles in (-pi/2, pi/2)


def test_co2_noaa_monthly(real_data_dir):
    Xt, yt, Xv, yv, meta = datasets.load_co2(seed=0)
    assert meta["source"] == "real"
    X = np.vstack([Xt, Xv])
    y = np.concatenate([yt, yv])
    # fixture has 80 rows; the -99.99 row falls back to the deseasonalized
    # column, so nothing is dropped
    assert X.shape == (80, 1)
    assert y.shape == (80,)
    assert np.all(y > -90)  # no missing code leaked through
    # X is the decimal-date coordinate
    assert 1958.0 <= X.min() and X.max() < 1966.0


def test_co2_missing_rows_dropped_without_fallback(tmp_path, monkeypatch):
    # A 4-column NOAA file (no deseasonalized column): missing rows drop.
    path = tmp_path / "co2_mm_mlo.txt"
    with open(path, "w") as fh:
        fh.write("# year month decimal_date average\n")
        for i in range(12):
            avg = -99.99 if i == 5 else 315.0 + i * 0.1
            fh.write(f"1958 {i+1} {1958 + (i+0.5)/12.0:.4f} {avg:.2f}\n")
    monkeypatch.setattr(datasets, "DATA_DIR", str(tmp_path))
    Xt, yt, Xv, yv, meta = datasets.load_co2(seed=0)
    assert meta["source"] == "real"
    assert len(np.concatenate([yt, yv])) == 11


def test_co2_two_column_table(tmp_path, monkeypatch):
    path = tmp_path / "co2.csv"
    with open(path, "w") as fh:
        fh.write("time,ppm\n")
        for i in range(24):
            fh.write(f"{1958 + i/12.0:.4f},{315.0 + 0.3*i:.2f}\n")
    monkeypatch.setattr(datasets, "DATA_DIR", str(tmp_path))
    Xt, yt, Xv, yv, meta = datasets.load_co2(seed=0)
    assert meta["source"] == "real"
    assert np.vstack([Xt, Xv]).shape == (24, 1)


def test_malformed_files_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(datasets, "DATA_DIR", str(tmp_path))
    # wrong column count for boston
    with open(tmp_path / "housing.data", "w") as fh:
        fh.write("1.0 2.0 3.0\n4.0 5.0 6.0\n")
    with pytest.raises(ValueError, match="14 columns"):
        datasets.load_boston(seed=0)
    os.remove(tmp_path / "housing.data")
    # ragged rows
    with open(tmp_path / "kin8nm.csv", "w") as fh:
        fh.write(",".join(["0.1"] * 9) + "\n" + ",".join(["0.2"] * 7) + "\n")
    with pytest.raises(ValueError, match="columns"):
        datasets.load_kin8nm(seed=0)


def test_real_branch_end_to_end_fit(real_data_dir):
    """load_* -> Scaler -> fit on the real branch: the full user path."""
    from scfgp import SCFGP
    Xt, yt, Xv, yv, meta = datasets.load_abalone(seed=0)
    assert meta["source"] == "real"
    model = SCFGP(sparsity=4, nfeats=8)
    model.fit_fast(Xt, yt, Xv, yv, max_iter=30)
    mu, std = model.predict(Xv)
    mu, std = np.asarray(mu).ravel(), np.asarray(std).ravel()
    assert mu.shape == (len(yv),)
    assert np.isfinite(mu).all() and np.isfinite(std).all()
    assert std.min() > 0
    # better than predicting the mean (sanity, tiny data so loose)
    nmse = np.mean((mu - np.asarray(yv).ravel()) ** 2) / np.var(yv)
    assert nmse < 1.5


def test_native_parser_matches_python_path(tmp_path):
    """The C++/OpenMP numeric-table fast path (native/table_parser.cpp) must
    agree exactly with the Python sniffing parser on clean numeric files —
    headers, comments, comma and whitespace delimiters — and decline
    (None) on categorical files so loaders fall back."""
    import numpy as np

    from scfgp.data.datasets import _numeric_block, _parse_table
    from scfgp.data.native import get_lib, parse_numeric_table_native

    if get_lib() is None:
        import pytest
        pytest.skip("native library unavailable (no g++?)")

    rng = np.random.RandomState(0)
    arr = rng.randn(50, 6)
    cases = {
        "plain.csv": "\n".join(",".join(f"{v:.10g}" for v in r)
                               for r in arr),
        "header.csv": "a,b,c,d,e,f\n" + "\n".join(
            ",".join(f"{v:.10g}" for v in r) for r in arr),
        "spaces.txt": "# comment\n" + "\n".join(
            "  ".join(f"{v:.10g}" for v in r) for r in arr),
    }
    for fname, text in cases.items():
        p = tmp_path / fname
        p.write_text(text + "\n")
        fast = parse_numeric_table_native(str(p))
        slow = _numeric_block(_parse_table(str(p)), str(p))
        assert fast is not None, fname
        np.testing.assert_array_equal(fast, slow, err_msg=fname)

    cat = tmp_path / "cat.csv"
    cat.write_text("M,0.45,7\nF,0.53,9\n")
    assert parse_numeric_table_native(str(cat)) is None
