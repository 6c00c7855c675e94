"""The likelihood file of the port (``sbayes_tpu_torch/results/hdf5.py``,
HDF5 written with numpy and the standard library) against h5py and the JAX
package's logger, on the CPU: h5py reads the port's file with the JAX
file's dataset names, dtypes (``na_values`` as numpy ``bool``) and shapes,
bit for bit, at 0, 1 and many rows and after appends to a reopened file;
the port's reader reads back what the writer was given and reads h5py's
contiguous files; the JAX logger's file (chunked, gzip) is refused by the
plain reader and read through h5py by the port's ``elpd``, or raises an
ImportError naming the file without h5py; a resumed logger appends to its
own file and overwrites h5py's after a warning. Everything here is exact."""
import logging
import sys
from types import SimpleNamespace

import h5py
import numpy as np
import pytest

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)

N_OBJECTS, N_FEATURES = 5, 3


def _na(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((N_OBJECTS, N_FEATURES)) < 0.3


def _rows(n: int, seed: int = 1) -> np.ndarray:
    """Float32 rows with the values a likelihood file can hold, and worse:
    1.0 at NA cells, tiny, subnormal, zero, inf and NaN."""
    rows = np.random.default_rng(seed).random((n, N_OBJECTS * N_FEATURES), dtype=np.float32)
    specials = np.array([1.0, 1e-30, 1e-42, 0.0, np.inf, np.nan], dtype=np.float32)
    rows[:, :len(specials)] = specials
    return rows


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype="<f4").view("<u4")


def _write(path, na, rows):
    from sbayes_tpu_torch.results.hdf5 import LikelihoodFile

    lf = LikelihoodFile.create(path, na)
    for row in rows:
        lf.append(row)
    lf.close()


def _assert_h5py_reads(path, na, rows):
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["likelihood", "na_values"]
        lh, na_values = f["likelihood"], f["na_values"]
        assert lh.dtype == np.dtype("<f4") and lh.shape == rows.shape
        assert na_values.dtype == np.dtype(bool) and na_values.shape == (na.size,)
        np.testing.assert_array_equal(_bits(lh[()]), _bits(rows))
        np.testing.assert_array_equal(na_values[()], na.ravel())
        # ~is_na selects the valid columns, as both elpd tools index them
        assert (~na_values[()]).sum() == (~na).sum()


@pytest.mark.parametrize("n_rows", [0, 1, 64])
def test_h5py_reads_the_plain_file(tmp_path, n_rows):
    na, rows = _na(), _rows(n_rows)
    path = tmp_path / "likelihood_K1_0.h5"
    _write(path, na, rows)
    _assert_h5py_reads(path, na, rows)
    with h5py.File(path, "r") as f:
        assert f["likelihood"].chunks is None and f["likelihood"].compression is None


@pytest.mark.parametrize("first", [0, 1, 10])
def test_appends_to_a_reopened_file_keep_the_earlier_bytes(tmp_path, first):
    """A resumed run's appends: the file's first rows stay byte for byte
    and h5py reads every row."""
    from sbayes_tpu_torch.results.hdf5 import LikelihoodFile

    na, rows = _na(), _rows(first + 7)
    path = tmp_path / "lh.h5"
    _write(path, na, rows[:first])
    before = path.read_bytes()
    for start, stop in ((first, first + 3), (first + 3, first + 7)):
        lf = LikelihoodFile.append_to(path, N_OBJECTS * N_FEATURES)
        assert lf.rows == start
        for row in rows[start:stop]:
            lf.append(row)
        lf.close()
    _assert_h5py_reads(path, na, rows)
    after = path.read_bytes()
    row_bytes = rows.itemsize * rows.shape[1]
    assert len(after) == len(before) + 7 * row_bytes
    earlier_rows = slice(len(before) - first * row_bytes, len(before))
    assert after[earlier_rows] == before[earlier_rows]


@pytest.mark.parametrize("n_rows", [0, 1, 64])
def test_plain_reader_reads_back_what_was_written(tmp_path, n_rows):
    from sbayes_tpu_torch.results.hdf5 import read_datasets

    na, rows = _na(2), _rows(n_rows, seed=3)
    path = tmp_path / "lh.h5"
    _write(path, na, rows)
    got = read_datasets(path)
    assert sorted(got) == ["likelihood", "na_values"]
    assert got["likelihood"].dtype == np.dtype("<f4") and got["na_values"].dtype == bool
    np.testing.assert_array_equal(_bits(got["likelihood"]), _bits(rows))
    np.testing.assert_array_equal(got["na_values"], na.ravel())


@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", "|i1", "<u2", "bool"])
def test_plain_reader_reads_h5py_contiguous_files(tmp_path, dtype):
    """h5py's own files of the same layout (its default, contiguous) read
    the same arrays."""
    from sbayes_tpu_torch.results.hdf5 import read_datasets

    rng = np.random.default_rng(4)
    data = {"a": (rng.random((6, 4)) * 100).astype(dtype), "b": rng.random(5) < 0.5,
            "c": np.zeros((0, 3), dtype=dtype)}
    path = tmp_path / "h5py.h5"
    with h5py.File(path, "w") as f:
        for name, value in data.items():
            f.create_dataset(name, data=value)
    got = read_datasets(path)
    assert sorted(got) == sorted(data)
    for name, value in data.items():
        assert got[name].dtype == value.dtype and got[name].shape == value.shape, name
        np.testing.assert_array_equal(got[name], value)


def _jax_logger_file(path, na, rows, resume: bool = False):
    """The file the JAX package's ``LikelihoodLogger`` writes (h5py,
    chunked, gzip and fletcher32)."""
    from sbayes_tpu.results.loggers import LikelihoodLogger, SampleRecord

    consts = SimpleNamespace(N=N_OBJECTS, F=N_FEATURES, na=na)
    logger = LikelihoodLogger(path, consts, None, resume=resume)
    for i, row in enumerate(rows):
        logger.write_sample(SampleRecord(i_step=i, clusters=None, weights=None, source=None,
                                         log_lh=0.0, log_prior=0.0,
                                         observation_lh=row.reshape(N_OBJECTS, N_FEATURES)))
    logger.close()


def test_the_jax_file_is_refused_by_the_plain_reader_and_read_through_h5py(tmp_path):
    from sbayes_tpu_torch.results.hdf5 import LikelihoodFile, UnsupportedLayout, read_datasets
    from sbayes_tpu_torch.tools.elpd import read_log_likelihood

    na, rows = _na(), _rows(20)
    jax_file, port_file = tmp_path / "jax.h5", tmp_path / "port.h5"
    _jax_logger_file(jax_file, na, rows)
    _write(port_file, na, rows)
    with pytest.raises(UnsupportedLayout):
        read_datasets(jax_file)
    with pytest.raises(UnsupportedLayout):
        LikelihoodFile.append_to(jax_file, N_OBJECTS * N_FEATURES)
    # both files give the same dataset names, types and values under h5py
    with h5py.File(jax_file, "r") as fj, h5py.File(port_file, "r") as fp:
        assert fj["likelihood"].chunks is not None and fj["likelihood"].compression == "gzip"
        for name in ("likelihood", "na_values"):
            assert fj[name].dtype == fp[name].dtype and fj[name].shape == fp[name].shape
            np.testing.assert_array_equal(fj[name][()], fp[name][()])
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_array_equal(read_log_likelihood(jax_file, 0.1),
                                      read_log_likelihood(port_file, 0.1))


def test_the_jax_file_without_h5py_raises_an_import_error_naming_it(tmp_path, monkeypatch):
    from sbayes_tpu_torch.tools.elpd import read_log_likelihood

    jax_file, port_file = tmp_path / "jax.h5", tmp_path / "port.h5"
    _jax_logger_file(jax_file, _na(), _rows(3))
    _write(port_file, _na(), _rows(3))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with np.errstate(divide="ignore", invalid="ignore"):
        assert read_log_likelihood(port_file, 0.0).shape == (3, (~_na()).sum())
        with pytest.raises(ImportError, match="jax.h5"):
            read_log_likelihood(jax_file, 0.0)


def _port_logger(path, na, resume: bool):
    from sbayes_tpu_torch.results.loggers import LikelihoodLogger

    consts = SimpleNamespace(N=N_OBJECTS, F=N_FEATURES, na=na)
    return LikelihoodLogger(path, consts, None, resume=resume)


def _log(logger, rows):
    from sbayes_tpu_torch.results.loggers import SampleRecord

    for i, row in enumerate(rows):
        logger.write_sample(SampleRecord(i_step=i, clusters=None, weights=None, source=None,
                                         log_lh=0.0, log_prior=0.0,
                                         observation_lh=row.reshape(N_OBJECTS, N_FEATURES)))
    logger.close()


def test_resumed_logger_appends_to_its_own_file(tmp_path):
    na, rows = _na(), _rows(9)
    path = tmp_path / "likelihood_K1_0.h5"
    _log(_port_logger(path, na, resume=False), rows[:5])
    _log(_port_logger(path, na, resume=True), rows[5:])
    _assert_h5py_reads(path, na, rows)


def test_resumed_logger_overwrites_the_h5py_file_after_a_warning(tmp_path, caplog):
    """Today's rule for a file the writer cannot append to (the JAX
    logger's, chunked): a warning, then a new file."""
    na, rows = _na(), _rows(6)
    path = tmp_path / "likelihood_K1_0.h5"
    _jax_logger_file(path, na, rows[:4])
    with caplog.at_level(logging.WARNING):
        _log(_port_logger(path, na, resume=True), rows[4:])
    assert "Could not append to existing likelihood file" in caplog.text
    _assert_h5py_reads(path, na, rows[4:])


def test_refuses_a_row_of_another_width_and_a_truncated_file(tmp_path):
    from sbayes_tpu_torch.results.hdf5 import LikelihoodFile, read_datasets

    path = tmp_path / "lh.h5"
    _write(path, _na(), _rows(2))
    lf = LikelihoodFile.append_to(path, N_OBJECTS * N_FEATURES)
    with pytest.raises(ValueError, match="a row of 4 values"):
        lf.append(np.zeros(4))
    lf.close()
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError, match="end of the file"):
        read_datasets(path)
