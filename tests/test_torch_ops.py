"""The port's column kernels against the JAX package's on the same inputs:
hashes and key encodings bit-identical (uint64 bits held in int64),
datetime fields (pre-1970 included), compaction, segment aggregations,
the multi-key sort and the hash-table claim.

One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import numpy as np

from tests.torch_parity import reference, torch_one_thread  # noqa: F401

N = 1000


def _t(a):
    import torch
    return torch.from_numpy(np.array(a))


def _columns():
    """Key columns of every physical dtype, with nulls, NaN and -0.0."""
    r = np.random.default_rng(11)
    null = r.random(N) < 0.15
    f64 = r.normal(size=N)
    f64[:4] = [-0.0, 0.0, np.nan, -np.inf]
    f32 = f64.astype(np.float32)
    return {
        "int64": (r.integers(-2**63, 2**63 - 1, N, dtype=np.int64,
                             endpoint=True), None),
        "int32": (r.integers(-50, 50, N).astype(np.int32), ~null),
        "int8": (r.integers(-128, 127, N).astype(np.int8), None),
        "uint8": (r.integers(0, 255, N).astype(np.uint8), None),
        "uint32": (r.integers(0, 2**32 - 1, N).astype(np.uint32), ~null),
        "uint64": (r.integers(0, 2**64 - 1, N, dtype=np.uint64,
                              endpoint=True), None),
        "float64": (f64, None),
        "float32": (f32, ~null),
        "bool": (r.random(N) < 0.5, ~null),
    }


_COLS = _columns()


def _check_encode_value(kind, ascending):
    import jax.numpy as jnp
    from bodo_tpu.ops import sort_encoding as RSE
    from bodo_tpu_torch.ops import sort_encoding as SE
    data, _ = _COLS[kind]
    want = np.asarray(RSE.encode_value(jnp.asarray(data), ascending))
    got = SE.encode_value(_t(data), ascending).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want,
                                  err_msg=f"encode_value {kind} {ascending}")


def _check_hash_column(kind):
    import jax.numpy as jnp
    from bodo_tpu.ops import hashing as RH
    from bodo_tpu_torch.ops import hashing as H
    data, valid = _COLS[kind]
    rv = None if valid is None else jnp.asarray(valid)
    pv = None if valid is None else _t(valid)
    want = np.asarray(RH.hash_column(jnp.asarray(data), rv))
    got = H.hash_column(_t(data), pv).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want,
                                  err_msg=f"hash_column {kind}")


def _check_hash_columns_and_dest_shard(shards):
    import jax.numpy as jnp
    from bodo_tpu.ops import hashing as RH
    from bodo_tpu_torch.ops import hashing as H
    names = ("int64", "float32", "uint64", "bool")
    ref_cols = [(jnp.asarray(_COLS[k][0]),
                 None if _COLS[k][1] is None else jnp.asarray(_COLS[k][1]))
                for k in names]
    port_cols = [(_t(_COLS[k][0]),
                  None if _COLS[k][1] is None else _t(_COLS[k][1]))
                 for k in names]
    want = RH.hash_columns(ref_cols, seed=5)
    got = H.hash_columns(port_cols, seed=5)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))
    np.testing.assert_array_equal(H.dest_shard(got, shards).numpy(),
                                  np.asarray(RH.dest_shard(want, shards)))


def _check_hashtable_helpers():
    import jax.numpy as jnp
    from bodo_tpu.ops import hashtable as RHT
    from bodo_tpu_torch.ops import hashtable as HT
    names = ("int32", "float64", "uint32")
    ref_keys = [(jnp.asarray(_COLS[k][0]),
                 None if _COLS[k][1] is None else jnp.asarray(_COLS[k][1]))
                for k in names]
    port_keys = [(_t(_COLS[k][0]),
                  None if _COLS[k][1] is None else _t(_COLS[k][1]))
                 for k in names]
    for null_equal in (True, False):
        rcodes, rok = RHT.encode_columns(ref_keys, null_equal)
        pcodes, pok = HT.encode_columns(port_keys, null_equal)
        assert len(rcodes) == len(pcodes)
        for rc, pc in zip(rcodes, pcodes):
            np.testing.assert_array_equal(pc.numpy().view(np.uint64),
                                          np.asarray(rc))
        assert (rok is None) == (pok is None)
        if rok is not None:
            np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
        np.testing.assert_array_equal(
            HT.combine_hash(pcodes).numpy().view(np.uint64),
            np.asarray(RHT.combine_hash(rcodes)))
        np.testing.assert_array_equal(
            HT._fmix64(pcodes[-1]).numpy().view(np.uint64),
            np.asarray(RHT._fmix64(rcodes[-1])))


def _check_claim_slots_and_densify():
    import jax.numpy as jnp
    from bodo_tpu.ops import hashtable as RHT
    from bodo_tpu_torch.ops import hashtable as HT
    r = np.random.default_rng(2)
    keys = r.integers(0, 300, N)  # many duplicates: shared slots
    ok = r.random(N) < 0.9
    T = HT.table_size(N)
    assert T == RHT.table_size(N)
    rcodes, _ = RHT.encode_columns([(jnp.asarray(keys), None)])
    pcodes, _ = HT.encode_columns([(_t(keys), None)])
    rslot, rowner, rr, runres = RHT.claim_slots(rcodes, jnp.asarray(ok), T)
    pslot, powner, pr, punres = HT.claim_slots(pcodes, _t(ok), T)
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(powner.numpy(), np.asarray(rowner))
    assert (pr, punres) == (int(rr), bool(runres))
    rseg, rrow, rng_ = RHT.densify(rslot, rowner, T)
    pseg, prow, png = HT.densify(pslot, powner, T)
    np.testing.assert_array_equal(pseg.numpy(), np.asarray(rseg))
    np.testing.assert_array_equal(prow.numpy(), np.asarray(rrow))
    assert png == int(rng_)


def _check_datetime_fields_pre_and_post_epoch():
    import jax.numpy as jnp
    from bodo_tpu.ops import datetime as RDT
    from bodo_tpu_torch.ops import datetime as DT
    r = np.random.default_rng(4)
    ns = r.integers(-4 * 10**18, 4 * 10**18, N)
    ns[:6] = [-1, 0, 1, -86_400_000_000_000, -86_400_000_000_001,
              951_782_400 * 10**9]  # 2000-02-29
    for field in ("date", "month", "hour", "dayofweek", "year", "day"):
        want = np.asarray(RDT.FIELDS[field](jnp.asarray(ns)))
        got = DT.FIELDS[field](_t(ns)).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    # against numpy's own calendar
    days = ns // 86_400_000_000_000
    np.testing.assert_array_equal(DT.date(_t(ns)).numpy(), days)
    months = ns.astype("datetime64[ns]").astype("datetime64[M]")
    np.testing.assert_array_equal(DT.month(_t(ns)).numpy(),
                                  months.astype(np.int64) % 12 + 1)


def _check_compact_is_stable():
    import jax.numpy as jnp
    from bodo_tpu.ops import kernels as RK
    from bodo_tpu_torch.ops import kernels as K
    r = np.random.default_rng(5)
    mask = r.random(N) < 0.3
    a = r.normal(size=N)
    b = np.arange(N, dtype=np.int32)
    v = r.random(N) < 0.5
    (ra, rb, rv), rn = RK.compact(jnp.asarray(mask),
                                  (jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(v)))
    (pa, pb, pv), pn = K.compact(_t(mask), (_t(a), _t(b), _t(v)))
    assert pn == int(rn) == mask.sum()
    for got, want in ((pa, ra), (pb, rb), (pv, rv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pb.numpy()[:pn], np.flatnonzero(mask))
    # a cut below the live rows: the count is the live rows' (6), the
    # first 3 of them are kept
    mask = np.zeros(10, bool)
    mask[[1, 2, 4, 6, 7, 9]] = True
    b = np.arange(10, dtype=np.int32) * 3
    (rb,), rn = RK.compact(jnp.asarray(mask), (jnp.asarray(b),),
                           capacity_out=3)
    (pb,), pn = K.compact(_t(mask), (_t(b),), capacity_out=3)
    assert pn == int(rn) == 6
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    assert pb.tolist() == [3, 6, 12]


def _check_segment_agg(op):
    import jax.numpy as jnp
    from bodo_tpu.ops.groupby import _segment_agg as ref_agg
    from bodo_tpu_torch.ops.groupby import _segment_agg
    r = np.random.default_rng(6)
    seg = r.integers(0, 40, N).astype(np.int32)
    vals = r.normal(size=N)
    vals[r.random(N) < 0.1] = np.nan
    valid = r.random(N) < 0.8
    pad = np.arange(N) < N - 17
    for data, vmask in ((vals, None), (vals, valid),
                        (r.integers(-9, 9, N), valid)):
        rd, rv = ref_agg(op, jnp.asarray(data),
                         None if vmask is None else jnp.asarray(vmask),
                         jnp.asarray(seg), jnp.asarray(pad), 40)
        pd_, pv = _segment_agg(op, _t(data),
                               None if vmask is None else _t(vmask),
                               _t(seg), _t(pad), 40)
        assert pv is None and rv is None
        assert pd_.numpy().dtype == np.asarray(rd).dtype
        np.testing.assert_allclose(pd_.numpy(), np.asarray(rd), rtol=1e-12,
                                   err_msg=op)


def _check_sort_local_permutation():
    import jax.numpy as jnp
    from bodo_tpu.ops.sort import sort_local as ref_sort
    from bodo_tpu_torch.ops.sort import sort_local
    r = np.random.default_rng(8)
    k1 = r.integers(0, 5, N).astype(np.int32)
    k1v = r.random(N) < 0.9
    # + 0.0 turns -0.0 into 0.0: the reference's jitted sort orders -0.0
    # before 0.0 (XLA folds its `x + 0.0` canonicalization away), the
    # port ties them as pandas does — see _check_sort_ties_signed_zeros
    k2 = r.normal(size=N).round(1) + 0.0
    k2[r.random(N) < 0.1] = np.nan
    payload = np.arange(N)
    count = N - 30
    for asc in ((True, True), (False, True), (True, False)):
        for na_last in (True, False):
            rarr = ((jnp.asarray(k1), jnp.asarray(k1v)),
                    (jnp.asarray(k2), None), (jnp.asarray(payload), None))
            parr = ((_t(k1), _t(k1v)), (_t(k2), None), (_t(payload), None))
            rout, rperm = ref_sort(rarr, jnp.asarray(count), 2, asc,
                                   na_last)
            pout, pperm = sort_local(parr, count, 2, asc, na_last)
            np.testing.assert_array_equal(pperm.numpy(), np.asarray(rperm),
                                          err_msg=f"{asc} {na_last}")


def _check_sort_ties_signed_zeros():
    from bodo_tpu_torch.ops.sort import sort_local
    k = np.array([0.0, -0.0, 1.0, -0.0, 0.0])
    payload = np.arange(5)
    out, perm = sort_local(((_t(k), None), (_t(payload), None)), 5, 1,
                           (True,))
    assert perm.tolist() == [0, 1, 3, 4, 2]  # equal keys keep row order


def test_ops_match_reference(reference):
    for kind in sorted(_COLS):
        for ascending in (True, False):
            _check_encode_value(kind, ascending)
        _check_hash_column(kind)
    for shards in (1, 3, 8):
        _check_hash_columns_and_dest_shard(shards)
    _check_hashtable_helpers()
    _check_claim_slots_and_densify()
    _check_datetime_fields_pre_and_post_epoch()
    _check_compact_is_stable()
    for op in ("count", "size", "sum", "mean"):
        _check_segment_agg(op)
    _check_sort_local_permutation()
    _check_sort_ties_signed_zeros()
