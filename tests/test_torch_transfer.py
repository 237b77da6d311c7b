"""The port's chunked host-to-device upload on the CPU
(`tpu_ir_torch/utils/transfer.py::stream_to_device`): every input comes
back bit for bit across the chunk boundaries (dtypes int32, uint16,
float32 and bf16 carried as int16; 0-d, empty, one element, exactly one
chunk, one chunk plus one, a memory-mapped file, chunks that split an
element), a CRC mismatch raises faults.IntegrityError naming the label
as the JAX package's upload does, and the `load.h2d_bytes` counter and
the `load.h2d` span count what crossed. The card's own run, with its
pinned staging and side stream, is in test_torch_cuda.py."""

import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_ir import faults as jax_faults
from tpu_ir.utils.transfer import stream_to_device as jax_stream_to_device

from tpu_ir_torch import faults, obs
from tpu_ir_torch.obs import get_registry
from tpu_ir_torch.search.layout import upload_index
from tpu_ir_torch.utils.transfer import stream_to_device

CHUNK = 64
DTYPES = {"int32": np.int32, "uint16": np.uint16, "float32": np.float32,
          "bf16": ml_dtypes.bfloat16}
SIZES = ("scalar", "empty", "one", "chunk", "chunk_plus_one", "mmap")


@pytest.fixture(autouse=True)
def _clean_registry():
    obs.reset_all()
    yield
    obs.reset_all()


def _case(size: str, dtype, tmp_path) -> np.ndarray:
    rng = np.random.default_rng(5)
    item = np.dtype(dtype).itemsize
    n = {"scalar": 1, "empty": 0, "one": 1, "chunk": CHUNK // item,
         "chunk_plus_one": CHUNK // item + 1,
         "mmap": 7 * CHUNK // item + 3}[size]
    a = (rng.standard_normal(n) * 1e3).astype(dtype)
    if size == "scalar":
        return a.reshape(())
    if size == "mmap":
        path = str(tmp_path / "a.bin")
        a.tofile(path)
        return np.memmap(path, dtype=dtype, mode="r", shape=(n,))
    return a


def _port_input(a: np.ndarray) -> np.ndarray:
    """bf16 crosses as its int16 bits (numpy has no bf16 for torch)."""
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_to_device_is_bitwise(tmp_path, dtype, size):
    a = _case(size, DTYPES[dtype], tmp_path)
    before = get_registry().get("load.h2d_bytes")
    t = stream_to_device(_port_input(a), device="cpu", chunk_bytes=CHUNK,
                         label="case")
    assert t.device.type == "cpu" and tuple(t.shape) == a.shape
    want = np.ascontiguousarray(a).tobytes()
    assert t.numpy().tobytes() == want
    # the JAX package's upload of the same array holds the same bytes
    assert np.asarray(jax_stream_to_device(
        np.array(a), chunk_bytes=CHUNK)).tobytes() == want
    if dtype == "bf16":
        assert t.view(torch.bfloat16).float().numpy().tobytes() == \
            np.asarray(a, np.float32).tobytes()
    if dtype == "uint16":
        assert t.dtype == torch.int16
    assert get_registry().get("load.h2d_bytes") - before == a.nbytes


@pytest.mark.parametrize("chunk_bytes", [1, 3, 6, 7, 1 << 20])
def test_chunks_that_split_elements(chunk_bytes):
    """A chunk size that is no multiple of the element size cuts values
    in two; the bytes still land in place."""
    a = np.arange(1, 101, dtype=np.int32) * 65_537
    t = stream_to_device(a, device="cpu", chunk_bytes=chunk_bytes)
    assert np.array_equal(t.numpy(), a)


def test_non_contiguous_input():
    a = np.arange(60, dtype=np.float32).reshape(6, 10)[:, ::3]
    t = stream_to_device(a, device="cpu", chunk_bytes=8)
    assert np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("chunk_bytes", [8, 1 << 20])
def test_crc_mismatch_raises_integrity_error(chunk_bytes):
    """A recorded CRC that the streamed bytes do not fold to raises
    IntegrityError naming the label, where the JAX package's upload
    raises its own; the right CRC passes."""
    import zlib

    a = np.arange(40, dtype=np.int32)
    good = f"crc32:{zlib.crc32(a.tobytes()):08x}"
    t = stream_to_device(a, device="cpu", chunk_bytes=chunk_bytes,
                         expected_crc=good, label="tier_docs_0")
    assert np.array_equal(t.numpy(), a)
    bad = "crc32:00000000"
    with pytest.raises(faults.IntegrityError, match="tier_docs_0") as err:
        stream_to_device(a, device="cpu", chunk_bytes=chunk_bytes,
                         expected_crc=bad, label="tier_docs_0")
    assert err.value.path == "tier_docs_0"
    assert "checksum mismatch during device upload" in err.value.detail
    with pytest.raises(jax_faults.IntegrityError, match="tier_docs_0"):
        jax_stream_to_device(a, chunk_bytes=chunk_bytes, expected_crc=bad,
                             label="tier_docs_0")


def test_chunk_size_from_the_environment(monkeypatch):
    """TPU_IR_H2D_CHUNK_BYTES sets the chunk (64 MiB by default, at least
    1), and each call is one load.h2d span."""
    from tpu_ir_torch import envvars

    assert envvars.get_int("TPU_IR_H2D_CHUNK_BYTES") == 64 << 20
    monkeypatch.setenv("TPU_IR_H2D_CHUNK_BYTES", "0")
    assert envvars.get_int("TPU_IR_H2D_CHUNK_BYTES") == 1
    before = get_registry().hist_state()
    a = np.arange(33, dtype=np.int32)
    assert np.array_equal(stream_to_device(a, device="cpu").numpy(), a)
    spans = get_registry().delta_summary(before)
    assert spans["load.h2d"]["count"] == 1


def test_upload_index_widens_slim_columns():
    """upload_index: a uint16 column crosses as int16 bits and is widened
    to its 0..65535 values; an int64 column is cast to int32."""
    u = np.array([0, 1, 40_000, 65_535], np.uint16)
    assert upload_index(u, torch.device("cpu")).tolist() == [0, 1, 40_000,
                                                            65_535]
    i = np.array([3, -1, 2**20], np.int64)
    t = upload_index(i, torch.device("cpu"), label="x")
    assert t.dtype == torch.int32 and t.tolist() == [3, -1, 2**20]
    assert get_registry().get("load.h2d_bytes") == u.nbytes + 12
