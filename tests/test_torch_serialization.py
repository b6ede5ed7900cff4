"""The port's serialization codecs against the JAX package's on the same
NumPy inputs (``repro_torch.core.serialization`` vs
``repro.core.serialization``): the same blobs byte for byte, each package
decoding the other's, the same pickle fallback, the same spill and the
same Table 1 harness.

    PYTHONPATH=src python -m pytest -q tests/test_torch_serialization.py
"""
import gc
import inspect
import os

import numpy as np
import pytest

from repro.core import serialization as ref
from repro_torch.core import serialization as port

DTYPES = list(ref._DTYPES)        # the codes of every dtype the codecs take
ARRAY_CODECS = ["npy", "raw"]


def _block(code, shape=(7, 13), seed=0):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(ref._DTYPES[code])
    if dtype.kind == "f":
        return (rng.standard_normal(shape) * 10).astype(dtype)
    if dtype.kind == "b":
        return rng.random(shape) < 0.5
    return rng.integers(0 if dtype.kind == "u" else -100, 100, size=shape).astype(dtype)


def test_the_registries_and_signatures_match():
    assert list(port.CODECS) == list(ref.CODECS) == ["pickle", "npy", "raw"]
    assert port.DEFAULT_CODEC == ref.DEFAULT_CODEC
    for name, codec in ref.CODECS.items():
        assert port.CODECS[name].array_only == codec.array_only
    assert (port.MmapCodec.name, port.MmapCodec.array_only) == ("mmap", True)
    for fn in ("serialize", "deserialize", "benchmark_codecs"):
        assert inspect.signature(getattr(port, fn)) == inspect.signature(getattr(ref, fn))
    for meth in ("ser_to_file", "de_from_file", "spill"):
        assert inspect.signature(getattr(port.MmapCodec, meth)) == \
            inspect.signature(getattr(ref.MmapCodec, meth))


@pytest.mark.parametrize("code", DTYPES)
@pytest.mark.parametrize("codec", ARRAY_CODECS)
def test_array_blobs_are_byte_for_byte_the_reference(codec, code):
    arr = _block(code)
    blob = port.serialize(arr, codec)
    assert blob == ref.serialize(arr, codec)
    out = port.deserialize(blob, codec)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    assert out.tobytes() == arr.tobytes()


@pytest.mark.parametrize("code", DTYPES)
@pytest.mark.parametrize("codec", ["pickle"] + ARRAY_CODECS)
def test_each_package_decodes_the_others_blobs(codec, code):
    arr = _block(code, shape=(3, 4, 5), seed=1)
    for enc, dec in ((port, ref), (ref, port)):
        out = np.asarray(dec.deserialize(enc.serialize(arr, codec), codec))
        assert out.dtype == arr.dtype and out.shape == arr.shape
        assert out.tobytes() == arr.tobytes()


@pytest.mark.parametrize("codec", ["pickle"] + ARRAY_CODECS)
def test_non_arrays_fall_back_to_pickle(codec):
    obj = {"a": [1, 2, 3], "b": "hello", "c": (4.5, None)}
    blob = port.serialize(obj, codec)
    assert blob == ref.serialize(obj, codec) == port.serialize(obj, "pickle")
    assert port.deserialize(blob, codec) == obj
    assert ref.deserialize(blob, codec) == obj


def test_npy_blobs_keep_zero_d_and_fortran_arrays():
    for arr in (np.array(3.5), np.asfortranarray(np.arange(12.0).reshape(3, 4))):
        blob = port.serialize(arr, "npy")
        assert blob == ref.serialize(arr, "npy")
        out = port.deserialize(blob, "npy")
        np.testing.assert_array_equal(out, arr)
        assert out.shape == arr.shape


def test_mmap_files_cross_between_the_packages(tmp_path):
    arr = _block("f8", shape=(33, 17), seed=2)
    for i, (enc, dec) in enumerate(((port, ref), (ref, port))):
        path = str(tmp_path / f"x{i}.rjx")
        assert enc.MmapCodec().ser_to_file(arr, path) == ref.MmapCodec().ser_to_file(arr, path)
        view = dec.MmapCodec().de_from_file(path)
        assert isinstance(view, np.memmap)
        np.testing.assert_array_equal(np.asarray(view), arr)
        del view


def test_mmap_spill_leaves_no_file_after_collection(tmp_path):
    mc = port.MmapCodec()
    spill_dir = str(tmp_path)
    for i in range(5):
        arr = np.full((64, 64), float(i))
        view = mc.spill(arr, dir=spill_dir)
        assert isinstance(view, np.memmap)
        names = os.listdir(spill_dir)
        assert len(names) == 1 and names[0].startswith("rjax_spill_") \
            and names[0].endswith(".rjx")
        np.testing.assert_array_equal(np.asarray(view), arr)
        del view
        gc.collect()
        assert os.listdir(spill_dir) == []


def test_mmap_spill_leaves_no_file_when_the_write_fails(tmp_path):
    with pytest.raises(TypeError):
        port.MmapCodec().spill(np.array(["a", "b"]), dir=str(tmp_path))
    assert os.listdir(str(tmp_path)) == []


def test_benchmark_codecs_has_the_reference_table():
    got = port.benchmark_codecs(sizes=(64, 128), repeats=1)
    want = ref.benchmark_codecs(sizes=(64, 128), repeats=1)
    assert list(got) == list(want) == ["pickle", "npy", "raw", "mmap"]
    for codec, per_size in got.items():
        assert list(per_size) == list(want[codec]) == [64, 128]
        for s, d in per_size.values():
            assert np.isfinite(s) and np.isfinite(d) and s >= 0 and d >= 0
