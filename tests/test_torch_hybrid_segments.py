"""The plain version of the port's chunk-wide `hybrid_expand`
(`cuda_kernels.hybrid_expand_segments_plain`, reached through
`hybrid_expand_segments` on CPU tensors) against the JAX package's page
decode, on chunks of hybrid streams staged the way the port's chunk
decode stages them: each segment of a chunk against the reference's XLA
body `_hybrid_expand_body` and its Pallas kernel
`PK.hybrid_expand(..., interpret=True)` run on that segment's page.

The chunks mix bit widths 0, 1, 2, 8, 15 to 18 and 24; hold segments of
0 and 1 values and a segment without runs (a PLAIN page's place in the
chunk: zeros); RLE-only, bit-packed-only and mixed streams; streams whose
last bit-packed group runs past the page's data into its padding and
past its window; pages staged at offsets that are not multiples of 8,
between bytes of other pages that a value must never read. The tables
come from `cuda_kernels.hybrid_segments`, whose refusals are checked too.

Tolerance: none, every value is bit-identical. The reference runs only
inside the `reference` fixture (tests/torch_parity.py). One test runs
every check (see tests/torch_parity.py on why)."""

import numpy as np
import pytest

from tests.torch_parity import reference, torch_one_thread  # noqa: F401

WIDTHS = (0, 1, 2, 8, 15, 16, 17, 18, 24)


def _stream(rng, n: int, bw: int, kind: str):
    """A hybrid stream holding at least `n` values of width `bw`: 'rle'
    runs, 'packed' runs (whole groups of 8) or both, alternating."""
    vbw = (bw + 7) // 8
    out = bytearray()

    def uvarint(v):
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return

    values, k = [], 0
    while sum(len(v) for v in values) < n:
        left = n - sum(len(v) for v in values)
        run = int(rng.integers(1, min(left, 300) + 1))
        packed = kind == "packed" or (kind == "mixed" and k % 2)
        if packed:
            groups = -(-run // 8)
            vals = rng.integers(0, 1 << bw, groups * 8) if bw else \
                np.zeros(groups * 8, np.int64)
            uvarint(groups << 1 | 1)
            planes = (vals[:, None] >> np.arange(bw)) & 1
            out += np.packbits(planes.reshape(-1).astype(np.uint8),
                               bitorder="little").tobytes()
        else:
            v = int(rng.integers(0, 1 << bw)) if bw else 0
            uvarint(run << 1)
            out += v.to_bytes(vbw, "little")
            vals = np.full(run, v, np.int64)
        values.append(vals)
        k += 1
    return bytes(out), np.concatenate(values)[:n]


def _chunk(rng, specs):
    """Stage one page for each (n, bw, kind, cut, pad) spec in one buffer
    of random bytes, each page at an offset that is not a multiple of 8:
    a random prefix (the page's header bytes), the stream less its last
    `cut` bytes, `pad` zero bytes. Returns (buffer, the hybrid_segments
    streams, each segment's true values, or None where the cut lost
    some)."""
    from bodo_tpu_torch.io import device_decode as port
    buf = bytearray(rng.integers(1, 256, 5, dtype=np.uint8).tobytes())
    streams, truths = [], []
    for n, bw, kind, cut, pad in specs:
        gap = int(rng.integers(1, 8))
        buf += rng.integers(1, 256, gap, dtype=np.uint8).tobytes()
        if len(buf) % 8 == 0:
            buf.append(0xFF)
        lo = len(buf)
        prefix = rng.integers(0, 256, int(rng.integers(0, 6)),
                              dtype=np.uint8).tobytes()
        if n:
            stream, truth = _stream(rng, n, bw, kind)
            page = prefix + stream
            rt = port._parse_hybrid(page, len(prefix), len(page), bw, n,
                                    exact=False)
            runs = (rt.starts, rt.is_rle, rt.vals, rt.bits)
        else:
            page, truth = prefix + b"\x00", np.zeros(0, np.int64)
            runs = (np.zeros(0, np.int32), np.zeros(0, bool),
                    np.zeros(0, np.int32), np.zeros(0, np.int64))
        if kind == "none":  # a page without hybrid values: no runs
            runs = tuple(a[:0] for a in runs)
            truth = np.zeros(n, np.int64)
        page = page[:len(page) - cut] + bytes(pad)
        buf += page
        streams.append((n, lo, lo + len(page), bw, *runs))
        truths.append(None if cut else truth)
    buf += rng.integers(1, 256, 11, dtype=np.uint8).tobytes()
    return np.frombuffer(bytearray(buf), np.uint8), streams, truths


def _check_chunk(rng, specs, interpret_every: int):
    import jax
    import jax.numpy as jnp
    import torch
    from bodo_tpu.io.device_decode import _hybrid_expand_body
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu_torch.ops import cuda_kernels as CK
    buf, streams, truths = _chunk(rng, specs)
    segs, starts, is_rle, vals, bits = CK.hybrid_segments(streams)
    n_total = int(segs[:, CK.SEG_N].sum())
    assert segs[0, CK.SEG_BASE] == 0 and np.array_equal(
        segs[1:, CK.SEG_BASE], np.cumsum(segs[:-1, CK.SEG_N]))
    before = dict(CK.launches)
    got = CK.hybrid_expand_segments(
        *(torch.from_numpy(a) for a in (buf, segs, starts, is_rle, vals,
                                        bits)), n_total)
    assert CK.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == (n_total,)
    got = got.numpy()
    for s, ((n, lo, hi, bw, st, rle, vv, bb), truth) in enumerate(
            zip(streams, truths)):
        base = int(segs[s, CK.SEG_BASE])
        mine = got[base:base + n]
        if truth is not None:
            np.testing.assert_array_equal(mine, truth, err_msg=f"seg {s}")
        if n == 0 or len(st) == 0:
            continue
        page = buf[lo:hi]
        args = (page, st, rle, vv, bb.astype(np.int32))
        body = jax.jit(_hybrid_expand_body, static_argnums=(0, 6, 7))(
            jnp, *(jnp.asarray(a) for a in args), bw, n)
        np.testing.assert_array_equal(mine, np.asarray(body),
                                      err_msg=f"seg {s} bw={bw}")
        if s % interpret_every == 0:
            pk = PK.hybrid_expand(*(jnp.asarray(a) for a in args), bw, n,
                                  interpret=True)
            np.testing.assert_array_equal(mine, np.asarray(pk),
                                          err_msg=f"seg {s} bw={bw}")
    return n_total


def _check_refusals():
    from bodo_tpu_torch.ops import cuda_kernels as CK
    st, rle = np.array([0, 4], np.int32), np.array([True, False])
    vv, bb = np.array([3, 0], np.int32), np.array([0, 8], np.int64)
    for bad in ((8, 0, 16, 25, st, rle, vv, bb),          # width
                (8, 0, 16, 8, st[::-1].copy(), rle, vv, bb),  # order
                (8, 4, 4, 8, st, rle, vv, bb),            # no page bytes
                (8, 0, 16, 8, st, rle[:1], vv, bb)):      # lengths
        with pytest.raises(ValueError, match="hybrid segment"):
            CK.hybrid_segments([bad])


def test_hybrid_segments_match_reference(reference, torch_one_thread):
    rng = np.random.default_rng(0)
    kinds = ("rle", "packed", "mixed")
    # every width in one chunk, each stream kind, 0- and 1-value segments
    # and a segment without runs
    specs = [(int(rng.integers(40, 700)), bw, kinds[k % 3], 0,
              int(rng.integers(0, 9)))
             for k, bw in enumerate(WIDTHS)]
    specs[2:2] = [(0, 8, "mixed", 0, 0), (1, 17, "packed", 0, 0),
                  (1, 0, "rle", 0, 3), (300, 8, "none", 0, 0)]
    assert _check_chunk(rng, specs, 2) > 2000
    # last bit-packed groups cut short: into the padding, and past the
    # window (clipped to its last byte)
    specs = [(int(rng.integers(20, 200)), bw, "packed", cut, pad)
             for bw in (1, 8, 17, 24) for cut, pad in ((2, 8), (3, 0))]
    _check_chunk(rng, specs, 3)
    # every segment of a chunk of one value each, and an empty chunk
    _check_chunk(rng, [(1, bw, "mixed", 0, 1) for bw in WIDTHS], 4)
    assert _check_chunk(rng, [(0, 8, "rle", 0, 0)], 1) == 0
    _check_refusals()
