"""The fixed-point input tier of mpx_torch (``io/apfixed.py``, the ``ap*``
dtypes) against mpx's: the codec bit for bit, MPXQ files both ways, and
the profiles of the quantized series (2e-3 for ap16/ap24, computed in
float32; 1e-8 for ap32/ap64, in float64; the tie rule of
tests/helpers.py)."""

import os

import numpy as np
import pytest

import mpx
from mpx.io import apfixed as mpx_ap
from mpx.io.tsb import read_series as mpx_read_series
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.io import apfixed
from mpx_torch.io.tsb import read_series
from tests.conftest import DATA_DIR
from tests.helpers import assert_profile_close

FORMATS = ["ap16", "ap24", "ap32", "ap64"]


def _values(fmt_name: str, n: int = 4000, seed: int = 0) -> np.ndarray:
    """Values across the format's safe range, its bounds, zero, values
    just inside the bounds and tiny ones of both signs."""
    fmt = apfixed.get_format(fmt_name)
    rng = np.random.default_rng(seed)
    x = rng.uniform(fmt.min_value, fmt.max_value, n)
    edge = [fmt.min_value, fmt.max_value, 0.0, -0.0, fmt.max_value - 1e-9,
            fmt.min_value + 1e-9, 1e-12, -1e-12, 2.0 ** -fmt.fraction, -3 * 2.0 ** -60]
    return np.concatenate([x, edge])


@pytest.mark.parametrize("name", FORMATS)
def test_codec_is_bit_equal_to_mpx(name):
    x = _values(name)
    fmt, ref_fmt = apfixed.get_format(name), mpx_ap.get_format(name)
    assert (fmt.width, fmt.integer, fmt.fraction, fmt.scale, fmt.min_value,
            fmt.max_value, fmt.storage_dtype) == (
        ref_fmt.width, ref_fmt.integer, ref_fmt.fraction, ref_fmt.scale,
        ref_fmt.min_value, ref_fmt.max_value, ref_fmt.storage_dtype)
    q = apfixed.quantize(x, name)
    np.testing.assert_array_equal(q.view(np.int64), mpx_ap.quantize(x, name).view(np.int64))
    raw = apfixed.to_raw(x, name)
    ref_raw = mpx_ap.to_raw(x, name)
    assert raw.dtype == ref_raw.dtype
    np.testing.assert_array_equal(raw, ref_raw)
    np.testing.assert_array_equal(apfixed.from_raw(raw, name), mpx_ap.from_raw(raw, name))
    np.testing.assert_array_equal(apfixed.from_raw(raw, fmt), q)
    assert apfixed.quantization_error_bound(name) == mpx_ap.quantization_error_bound(name)
    assert np.abs(x - q).max() < apfixed.quantization_error_bound(name)
    apfixed.check_range(x, fmt)


@pytest.mark.parametrize("name", FORMATS)
def test_out_of_range_raises_like_mpx(name):
    fmt = apfixed.get_format(name)
    for bad in (fmt.max_value + 0.5, fmt.min_value - 1e-9, np.nan, np.inf):
        x = np.array([0.0, 1.0, bad, 2.0])
        with pytest.raises(ValueError) as ours:
            apfixed.quantize(x, name)
        with pytest.raises(ValueError) as ref:
            mpx_ap.quantize(x, name)
        assert str(ours.value) == str(ref.value)
        assert "index 2" in str(ours.value)
    # Unchecked, the out-of-range value is truncated all the same.
    x = np.array([fmt.max_value + 0.5])
    np.testing.assert_array_equal(apfixed.to_raw(x, name, check=False),
                                  mpx_ap.to_raw(x, name, check=False))
    with pytest.raises(ValueError, match="Unknown ap_fixed format"):
        apfixed.get_format("ap8")


@pytest.mark.parametrize("name", FORMATS)
def test_mpxq_files_both_ways(tmp_path, name):
    x = _values(name, n=500, seed=1)
    by_mpx, by_port = str(tmp_path / "mpx.q"), str(tmp_path / "port.q")
    mpx_ap.write_quantized(by_mpx, x, name)
    apfixed.write_quantized(by_port, x, name)
    assert open(by_mpx, "rb").read() == open(by_port, "rb").read()
    for path in (by_mpx, by_port):
        assert apfixed.is_quantized_file(path)
        got = apfixed.read_quantized(path, n=x.shape[0])
        np.testing.assert_array_equal(got, mpx_ap.read_quantized(path))
        np.testing.assert_array_equal(read_series(path), mpx_read_series(path))
    with pytest.raises(ValueError, match="unexpected number of elements"):
        apfixed.read_quantized(by_port, n=x.shape[0] + 1)
    open(by_port, "ab").write(b"\0")
    with pytest.raises(ValueError, match="payload"):
        apfixed.read_quantized(by_port)
    assert not apfixed.is_quantized_file(os.path.join(DATA_DIR, "binary", "1024.tsb"))
    assert not apfixed.is_quantized_file(str(tmp_path / "missing"))


@pytest.mark.parametrize("name,eps", [("ap16", 2e-3), ("ap24", 2e-3), ("ap32", 1e-8),
                                      ("ap64", 1e-8)])
def test_profile_of_quantized_series_matches_mpx(name, eps):
    T = read_series(os.path.join(DATA_DIR, "test", "1024.txt"))
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype=name, band=256, chunk=512, device="cpu")
    assert cfg.input_quant == name
    assert cfg.dtype == ("float32" if name in ("ap16", "ap24") else "float64")
    MP, MPI = (o.numpy() for o in compute_matrix_profile(T, config=cfg))
    assert MP.dtype == np.dtype(cfg.dtype)
    ref = mpx.compute_matrix_profile(
        T, config=mpx.MatrixProfileConfig(m=m, dtype=name, band=256, chunk=512))
    Tq = mpx_ap.quantize(T, name)
    assert_profile_close(Tq, m, MP, MPI, np.asarray(ref[0]), np.asarray(ref[1]), eps=eps)


def test_input_quant_conflicts_and_unknown_raise():
    with pytest.raises(ValueError, match="conflicts"):
        MatrixProfileConfig(m=16, dtype="ap16", input_quant="ap32", device="cpu")
    with pytest.raises(ValueError, match="Unknown ap_fixed format"):
        MatrixProfileConfig(m=16, input_quant="ap12", device="cpu")
    cfg = MatrixProfileConfig(m=16, input_quant="ap24", dtype="float64", device="cpu")
    assert (cfg.input_quant, cfg.dtype) == ("ap24", "float64")
    T = np.full(64, 20.0)  # outside ap16's safe range [-16, 15]
    with pytest.raises(ValueError, match="safe-range"):
        compute_matrix_profile(T, config=MatrixProfileConfig(m=16, dtype="ap16",
                                                             device="cpu"))
