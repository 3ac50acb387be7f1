"""The port stands alone: importing every module of bodo_tpu_torch pulls in
neither JAX nor the JAX package (nor pandas/pyarrow, which only its
readers and converters import when called); its entry points default to
CUDA and raise without it instead of running on the CPU (the 1D ones too:
make_mesh, Table.shard on the default mesh, the sharded pipelines;
read_parquet; the f32 groupby pipelines); the
CUDA kernel wrappers never fall back to their plain versions for a
tensor that is not on the CPU. One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_parity import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import bodo_tpu_torch
mods = ["bodo_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    bodo_tpu_torch.__path__, "bodo_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bodo_tpu", "pandas",
                                    "pyarrow"))
print("MODULES", len(mods))
print("FORBIDDEN", bad)
import torch
if not torch.cuda.is_available():
    from bodo_tpu_torch.workloads.taxi import pipeline
    from bodo_tpu_torch.workloads import f32_groupby, star_join
    from bodo_tpu_torch.parallel.mesh import make_mesh
    from bodo_tpu_torch.table import Table
    from bodo_tpu_torch.io import read_parquet
    import numpy as np
    cpu_table = Table.from_numpy({"a": np.arange(3)}, device="cpu")
    for call in (lambda: pipeline(sys.argv[1], sys.argv[2]),
                 lambda: pipeline(sys.argv[1], sys.argv[2], shard=True),
                 lambda: star_join.pipeline(*star_join.gen_star_arrays(10)),
                 lambda: star_join.pipeline(*star_join.gen_star_arrays(10),
                                            shard=True),
                 lambda: f32_groupby.pipeline_dense(
                     f32_groupby.gen_f32_arrays(10)[0]),
                 lambda: f32_groupby.pipeline_sparse(
                     f32_groupby.gen_f32_arrays(10)[1]),
                 lambda: Table.from_numpy({"a": np.arange(3)}),
                 lambda: read_parquet(sys.argv[1]),
                 lambda: make_mesh(4),
                 lambda: cpu_table.shard()):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("ran without CUDA")
    print("NO_CUDA_RAISES")
"""


def _check_imports_no_jax_and_needs_cuda(tmp_path):
    pq, csv = tmp_path / "t.parquet", tmp_path / "w.csv"
    pq.write_bytes(b"")
    csv.write_text("DATE,PRCP\n2024-01-01,0.1\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _PROBE, str(pq), str(csv)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "FORBIDDEN []" in lines, res.stdout
    assert int(lines[0].split()[1]) >= 20  # every module was walked
    import torch
    if not torch.cuda.is_available():
        assert "NO_CUDA_RAISES" in lines, res.stdout


def _check_resolve_device_defaults_to_cuda():
    import torch
    from bodo_tpu_torch.config import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)


def _check_lut_gather_never_falls_back_off_the_cpu():
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    before = dict(CK.launches)
    codes = torch.zeros(8, dtype=torch.int32, device="meta")
    lut = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        CK.lut_gather(codes, lut)
    with pytest.raises(ValueError, match="CUDA"):
        CK.lut_gather(torch.zeros(8, dtype=torch.int32), lut)
    assert CK.launches == before


def _check_hash_probe_never_falls_back_off_the_cpu():
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    before = dict(CK.launches)
    i64 = torch.zeros(8, dtype=torch.int64)
    args = (torch.zeros(2, 4, dtype=torch.int64),
            torch.full((16,), -1, dtype=torch.int32),
            torch.zeros(2, 8, dtype=torch.int64),
            torch.ones(8, dtype=torch.bool), i64, i64)
    for i in range(len(args)):
        mixed = list(args)
        mixed[i] = mixed[i].to("meta")
        with pytest.raises(ValueError, match="CUDA"):
            CK.hash_probe(*mixed, 16, 64)
    idx, unresolved = CK.hash_probe(*args, 16, 64)  # all on the CPU
    assert (idx == -1).all() and not bool(unresolved)
    assert CK.launches == before


def _check_partition_kernels_never_fall_back_off_the_cpu():
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    before = dict(CK.launches)
    dest = torch.zeros(8, dtype=torch.int32)
    ok = torch.ones(8, dtype=torch.bool)
    for args in ((dest.to("meta"), ok), (dest, ok.to("meta"))):
        with pytest.raises(ValueError, match="CUDA"):
            CK.partition_rank(*args, 4)
    pk = torch.zeros(8, dtype=torch.int64)
    spl = torch.zeros(3, dtype=torch.int64)
    rows = torch.zeros(2, 3, dtype=torch.int64)
    for args in ((pk.to("meta"), spl), (pk, spl.to("meta")),
                 ((pk, pk.to("meta")), rows), ((pk, pk), rows.to("meta"))):
        with pytest.raises(ValueError, match="CUDA"):
            CK.range_partition(*args)
    rank, counts = CK.partition_rank(dest, ok, 4)  # all on the CPU
    assert rank.tolist() == list(range(8)) and counts.tolist() == [8, 0, 0, 0]
    assert CK.range_partition(pk, spl).tolist() == [3] * 8
    assert CK.range_partition((pk, pk), rows).tolist() == [3] * 16
    assert CK.launches == before


def _check_decode_kernels_never_fall_back_off_the_cpu():
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    before = dict(CK.launches)
    args = (torch.zeros(64, dtype=torch.uint8),
            torch.tensor([0, 9], dtype=torch.int32),
            torch.tensor([True, False]),
            torch.tensor([5, 0], dtype=torch.int32),
            torch.tensor([0, 0], dtype=torch.int64))
    for i in range(len(args)):
        mixed = list(args)
        mixed[i] = mixed[i].to("meta")
        with pytest.raises(ValueError, match="CUDA"):
            CK.hybrid_expand(*mixed, 8, 16)
    segs = torch.tensor([[0, 16, 0, 64, 8, 0, 2]], dtype=torch.int64)
    chunk = (args[0], segs, *args[1:])
    for i in range(len(chunk)):
        mixed = list(chunk)
        mixed[i] = mixed[i].to("meta")
        with pytest.raises(ValueError, match="CUDA"):
            CK.hybrid_expand_segments(*mixed, 16)
    assert CK.hybrid_expand_segments(*chunk, 16).tolist() == \
        [5] * 9 + [0] * 7  # all on the CPU: one segment, as one page
    codes = torch.zeros(8, dtype=torch.int32)
    lut = torch.arange(4, dtype=torch.int32)
    for pair in ((codes.to("meta"), lut), (codes, lut.to("meta"))):
        with pytest.raises(ValueError, match="CUDA"):
            CK.dict_gather(*pair)
    out = CK.hybrid_expand(*args, 8, 16)  # all on the CPU
    assert out.tolist() == [5] * 9 + [0] * 7
    assert CK.dict_gather(codes + 3, lut).tolist() == [3] * 8
    assert CK.launches == before


def _check_groupby_sum_never_falls_back_off_the_cpu():
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    before = dict(CK.launches)
    codes = torch.tensor([0, 1, 1, 7], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0])
    ok = torch.ones(4, dtype=torch.bool)
    for args in ((codes.to("meta"), [vals], [ok]),
                 (codes, [vals.to("meta")], [ok]),
                 (codes, [None], [ok.to("meta")])):
        with pytest.raises(ValueError, match="CUDA"):
            CK.groupby_sum(*args, 2)
        with pytest.raises(ValueError, match="CUDA"):
            CK.dense_accumulate(*args, 2)
    out = CK.groupby_sum(codes, [vals, None], [ok, ok], 2)  # on the CPU
    assert out.tolist() == [[1.0, 1.0], [5.0, 2.0]]
    assert CK.launches == before


def _check_kernel_build_is_lazy():
    """No kernel is built or loaded while the modules import: the build
    directory is keyed by source and flags, and nothing loaded it."""
    from bodo_tpu_torch.ops import cuda_kernels as CK
    assert CK._entry_fns == {} or all(
        CK.library_path(n).exists() for n in CK._entry_fns)
    assert sorted(CK.SOURCES) == ["groupby_sum", "hash_probe",
                                  "hybrid_expand", "lut_gather",
                                  "partition_rank", "range_partition"]
    for name in CK.SOURCES:
        path = CK.library_path(name)
        assert path.parent == REPO / "build"
        assert path.name.startswith(f"lib{name}.") and path.suffix == ".so"


def test_port_stands_alone(torch_one_thread, tmp_path):
    _check_imports_no_jax_and_needs_cuda(tmp_path)
    _check_resolve_device_defaults_to_cuda()
    _check_lut_gather_never_falls_back_off_the_cpu()
    _check_hash_probe_never_falls_back_off_the_cpu()
    _check_partition_kernels_never_fall_back_off_the_cpu()
    _check_decode_kernels_never_fall_back_off_the_cpu()
    _check_groupby_sum_never_falls_back_off_the_cpu()
    _check_kernel_build_is_lazy()
