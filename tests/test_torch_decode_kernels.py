"""The host side and the kernels' plain versions of the port's parquet
decode against the JAX package's, on the same bytes and tables:

  - `_parse_hybrid` (exact and inexact streams, the truncated-stream and
    empty-run errors), `_bucket` and `_parse_page_header`
    (every page header of pyarrow-written files, v1 and v2 pages);
  - the plain `hybrid_expand` against the reference's XLA body
    `_hybrid_expand_body` and its Pallas kernel
    `PK.hybrid_expand(..., interpret=True)`, at bit widths 0 to 24 with
    RLE, bit-packed and mixed runs, over the whole padded output (the
    tail past the last value included);
  - `dict_gather`'s plain route against `PK.dict_gather(...,
    interpret=True)`.

Tolerance: none, every run table, header field and value is
bit-identical. The reference runs only inside the `reference` fixture
(tests/torch_parity.py); nothing here calls its read route. One test
runs every check (see tests/torch_parity.py on why)."""

import numpy as np
import pytest

from tests.torch_parity import reference, torch_one_thread  # noqa: F401


def _streams(rng):
    """(bytes, bit width, value count) hybrid streams: RLE runs, bit-packed
    runs and both, at widths 0..24, and streams shorter than the count."""
    out = []
    for bw in (0, 1, 2, 3, 5, 8, 9, 12, 16, 17, 20, 24):
        vbw = (bw + 7) // 8
        buf = bytearray()
        n = 0
        for k in range(6):
            if k % 2 == 0:  # RLE run of 1..300 values
                run = int(rng.integers(1, 300))
                buf += bytes([run << 1 & 0x7F | 0x80, run >> 6]) \
                    if run >= 64 else bytes([run << 1])
                buf += int(rng.integers(0, 1 << bw)).to_bytes(vbw, "little") \
                    if bw else b""
                n += run
            else:  # bit-packed run of 1..3 groups of 8
                groups = int(rng.integers(1, 4))
                buf += bytes([groups << 1 | 1])
                buf += rng.integers(0, 256, groups * bw,
                                    dtype=np.uint8).tobytes()
                n += groups * 8
        out.append((bytes(buf), bw, n))
    return out


def _check_parse_hybrid_matches(rng):
    from bodo_tpu.io import device_decode as ref
    from bodo_tpu_torch.io import device_decode as port
    streams = _streams(rng)
    for buf, bw, n in streams:
        for count, exact in ((n, True), (n - 3, True), (n + 50, False)):
            a = port._parse_hybrid(buf, 0, len(buf), bw, count, exact)
            b = ref._parse_hybrid(buf, 0, len(buf), bw, count, exact)
            for f in ("starts", "is_rle", "vals", "bits"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.bits.dtype == np.int64  # exact past 256 MiB pages
        # a stream that runs out before `count` values: only exact raises
        for mod in (port, ref):
            with pytest.raises(mod.Unsupported, match="truncated"):
                mod._parse_hybrid(buf, 0, len(buf), bw, n + 50, True)
    for bad, why in ((bytes([0]), "empty RLE run"),
                     (bytes([1]), "empty bit-packed run"),
                     (bytes([(40 << 1) | 1, 0]), "overruns")):
        for mod in (port, ref):
            with pytest.raises(mod.Unsupported, match=why):
                mod._parse_hybrid(bad, 0, len(bad), 8, 16)
    for n in (0, 1, 16, 17, 128, 129, 20_000):
        for lo in (8, 16, 128, 4096):
            assert port._bucket(n, lo) == ref._bucket(n, lo)


def _chunk_range(md, leaf):
    """[start, start + size) of the first row group's chunk of `leaf`."""
    col = md.row_group(0).column(leaf)
    start = col.data_page_offset
    if col.dictionary_page_offset is not None and \
            0 < col.dictionary_page_offset < start:
        start = col.dictionary_page_offset
    return start, col.total_compressed_size


def _check_page_headers_match(tmp_path, rng):
    import pandas as pd
    import pyarrow.parquet as pq
    from bodo_tpu.io import device_decode as ref
    from bodo_tpu_torch.io import device_decode as port
    n = 3000
    df = pd.DataFrame({
        "i": rng.integers(-10**9, 10**9, n),
        "f": np.where(rng.random(n) < 0.2, np.nan, rng.standard_normal(n)),
        "b": rng.integers(0, 2, n).astype(bool),
        "s": rng.choice(["ab", "cd", "ef"], n),
    })
    pages = 0
    for i, kw in enumerate((dict(data_page_size=1024),
                            dict(data_page_version="2.0",
                                 compression="zstd"),
                            dict(use_dictionary=False))):
        path = tmp_path / f"h{i}.parquet"
        df.to_parquet(path, index=False, **kw)
        md = pq.ParquetFile(path).metadata
        raw = path.read_bytes()
        for leaf in range(md.num_columns):
            start, size = _chunk_range(md, leaf)
            off = start
            while off < start + size:
                a = port._parse_page_header(raw, off)
                b = ref._parse_page_header(raw, off)
                assert vars(a) == vars(b)
                off += a.header_len + a.compressed_size
                pages += 1
    assert pages > 20


def _runs(rng, n, n_runs, sentinel):
    """Random run tables over [0, n): sorted starts (some repeated), RLE
    and bit-packed runs, padded with sentinel starts."""
    starts = np.sort(rng.integers(0, n, n_runs - 4)).astype(np.int32)
    starts[0] = 0
    starts = np.concatenate([starts, np.full(4, sentinel, np.int32)])
    is_rle = rng.random(n_runs) < 0.5
    vals = rng.integers(0, 1 << 20, n_runs).astype(np.int32)
    return starts, is_rle, vals


def _check_hybrid_expand_plain_matches(rng):
    import jax.numpy as jnp
    import torch
    from bodo_tpu.io.device_decode import _hybrid_expand_body
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu_torch.ops import cuda_kernels as CK
    for bw in range(25):
        for n_bucket, n_runs in ((128, 8), (1024, 40)):
            nb = 4096
            data = rng.integers(0, 256, nb, dtype=np.uint8)
            starts, is_rle, vals = _runs(rng, n_bucket - 100, n_runs,
                                         n_bucket + 1)
            bits = rng.integers(0, (nb - 8) * 8, n_runs).astype(np.int32)
            got = CK.hybrid_expand(*(torch.from_numpy(a) for a in (
                data, starts, is_rle, vals, bits.astype(np.int64))),
                bw, n_bucket)
            assert got.dtype == torch.int32 and got.shape == (n_bucket,)
            body = _hybrid_expand_body(jnp, *(jnp.asarray(a) for a in (
                data, starts, is_rle, vals, bits)), bw, n_bucket)
            np.testing.assert_array_equal(got.numpy(), np.asarray(body),
                                          err_msg=f"bw={bw}")
            if bw in (0, 1, 2, 8, 13, 17, 24) and n_runs == 40:
                pk = PK.hybrid_expand(*(jnp.asarray(a) for a in (
                    data, starts, is_rle, vals, bits)), bw, n_bucket,
                    interpret=True)
                np.testing.assert_array_equal(got.numpy(), np.asarray(pk),
                                              err_msg=f"bw={bw}")
    # a bit offset reaching past the page's last byte clips to it
    data = np.arange(1, 17, dtype=np.uint8)
    args = (data, np.array([0], np.int32), np.array([False]),
            np.array([0], np.int32))
    got = CK.hybrid_expand(*(torch.from_numpy(a) for a in args),
                           torch.tensor([120], dtype=torch.int64), 24, 128)
    body = _hybrid_expand_body(jnp, *(jnp.asarray(a) for a in args),
                               jnp.asarray(np.array([120], np.int32)), 24,
                               128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(body))


def _check_dict_gather_plain_matches(rng):
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu_torch.ops import cuda_kernels as CK
    for k, n in ((1, 5), (4, 1000), (179, 3000), (4096, 2048)):
        lut = rng.permutation(k).astype(np.int32)
        codes = rng.integers(0, k, n).astype(np.int32)
        before = dict(CK.launches)
        got = CK.dict_gather(torch.from_numpy(codes), torch.from_numpy(lut))
        assert CK.launches == before  # the plain route launches nothing
        want = PK.dict_gather(jnp.asarray(codes), jnp.asarray(lut),
                              interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_kernels_match_reference(reference, tmp_path):
    rng = np.random.default_rng(0)
    _check_parse_hybrid_matches(rng)
    _check_page_headers_match(tmp_path, rng)
    _check_hybrid_expand_plain_matches(rng)
    _check_dict_gather_plain_matches(rng)
