"""The plain 3xTF32 split product (gumbi_tpu_torch/ops/tf32x3.py) on the CPU:
the rounding against hand-computed bit patterns, the product against f64,
and the blocked Cholesky's accuracy rule with the split product in its
trailing update: the CPU rehearsal of what the CUDA kernels are held to."""

import numpy as np
import pytest
import torch

from gumbi_tpu_torch.ops import _build
from gumbi_tpu_torch.ops.hopper_chol import cholesky_plain
from gumbi_tpu_torch.ops.tf32x3 import matmul_3xtf32_plain, tf32_round, tf32_split


def _bits(values):
    return torch.tensor(values, dtype=torch.int64).to(torch.int32).view(torch.float32)


def _as_bits(x):
    return [v & 0xFFFFFFFF for v in x.view(torch.int32).tolist()]


@pytest.mark.parametrize("bits_in, bits_out", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 number
    (0x3F800FFF, 0x3F800000),  # just under half a place: down
    (0x3F801000, 0x3F802000),  # a tie rounds away from zero ...
    (0xBF801000, 0xBF802000),  # ... on either side
    (0x3F801001, 0x3F802000),  # just over half a place: up
    (0x3F803000, 0x3F804000),  # a tie on an odd last place rounds away too (not to even)
    (0x3FFFF000, 0x40000000),  # the carry runs into the exponent
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x00001000, 0x00002000),  # subnormals round like any magnitude
    (0x00000FFF, 0x00000000),
    (0x7F7FF000, 0x7F800000),  # within half a place of the largest TF32 number: inf
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
])
def test_tf32_round_bit_patterns(bits_in, bits_out):
    signed = bits_in - (1 << 32) if bits_in >= 1 << 31 else bits_in
    assert _as_bits(tf32_round(_bits([signed]))) == [bits_out]


def test_tf32_round_passes_nan_through_and_refuses_other_types():
    x = _bits([0x7FC00000, 0x7FFFFFFF, 0x7F800001])
    out = tf32_round(x)
    assert bool(torch.isnan(out).all())
    assert _as_bits(out) == _as_bits(x)
    with pytest.raises(TypeError, match="float32"):
        tf32_round(torch.zeros(3, dtype=torch.float64))


def test_tf32_split_is_exact_to_22_bits():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert all(b & 0x1FFF == 0 for b in _as_bits(part))  # both are TF32 numbers
    assert float((hi.double() + lo.double() - x.double()).abs().max() / x.abs().max()) <= 2.0**-22
    assert float((lo.abs() / x.abs().clamp_min(1e-30)).max()) <= 2.0**-11


@pytest.mark.parametrize("m, n, k", [(64, 64, 64), (128, 72, 1024)])
def test_matmul_3xtf32_plain_is_f32_class(m, n, k):
    """Within 2e-6·(|a|·|b|) of the f64 product, and far better than one
    TF32 pass on the same operands."""
    rng = np.random.default_rng(m + n + k)
    a = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32))
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err = lambda c: float(((c.double() - ref).abs() / scale).max())  # noqa: E731
    e3, e1 = err(matmul_3xtf32_plain(a, b)), err(tf32_round(a) @ tf32_round(b))
    assert e3 <= 2e-6
    assert e3 < e1 / 16


@pytest.mark.parametrize("D, n", [(1, 256), (2, 512), (1, 768)])
def test_blocked_cholesky_holds_its_rule_with_the_split_product(D, n):
    """The rule the CUDA kernel is held to on the card (error against the
    f64 factor at most twice the f32 library's), rehearsed here with the
    trailing product of the plain version done as three TF32 passes, on the
    same SPD inputs X·Xᵀ/64 + 2I from a numpy seed."""
    X = torch.as_tensor(np.random.default_rng(0).normal(size=(D, n, 64)).astype(np.float32))
    A = X @ X.transpose(1, 2) / 64 + 2.0 * torch.eye(n)
    L64 = torch.linalg.cholesky(A.double())
    err = lambda L: float((L.double() - L64).abs().max())  # noqa: E731
    e_split = err(cholesky_plain(A, matmul=matmul_3xtf32_plain))
    e_lib = err(torch.linalg.cholesky(A))
    assert e_split <= 2.0 * e_lib
    assert e_split <= 5e-5 * max(float(L64.abs().max()), 1.0)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A source's library name changes when only a header it includes
    changes, directly or through another header; an unrelated file and a
    system include do not enter."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// unrelated\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    files = _build.source_files(tmp_path / "k.cu")
    assert [f.name for f in files] == ["k.cu", "a.cuh", "b.cuh"]
    before = _build._lib_path("k")
    (tmp_path / "other.cuh").write_text("// changed\n")
    assert _build._lib_path("k") == before
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert _build._lib_path("k") != before


def test_package_sources_name_the_shared_header():
    """Both redesigned kernels include the shared tile product, so both
    rebuild when it changes; rbf_gram does not."""
    names = lambda src: [f.name for f in _build.source_files(_build.CSRC / src)]  # noqa: E731
    assert names("blocked_chol.cu") == ["blocked_chol.cu", "tf32x3.cuh"]
    assert names("fused_matvec.cu") == ["fused_matvec.cu", "tf32x3.cuh"]
    assert names("rbf_gram.cu") == ["rbf_gram.cu"]
