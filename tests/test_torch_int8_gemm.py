"""The int8 GEMM's wrapper on the CPU: the shape -> variant plan, the layout
check, the plain version and ``int_mm``'s counts.

The kernel itself (csrc/int8_gemm.cu) runs only on the card:
``tests/test_torch_cuda_kernels.py`` holds it against ``torch._int_mm`` bit
for bit.  Here the plan is held to what the kernel assumes (a tile holds a
narrow N whole, no split is empty, one wave at most where K is split), and
the layout check to the operands every caller builds.
"""

import pytest
import torch

from quantumsimulations_tpu_torch.kernels import launches
from quantumsimulations_tpu_torch.ops import extprec as tx
from quantumsimulations_tpu_torch.ops import int8_gemm as ig
from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing

H100_SMS = 132


@pytest.mark.parametrize(
    "shape,want",
    [
        # the ext chain's panel products: one wave of 64 x 2 tiles, K whole
        ((8192, 512, 122880), ("wide", 256, 1)),
        ((8192, 512, 8192), ("wide", 256, 1)),
        # the doubling passes' state products
        ((8192, 1, 16384), ("narrow", 8, 4)),
        ((8192, 8, 16384), ("narrow", 8, 4)),
        ((8192, 13, 16384), ("narrow", 16, 4)),
        ((8192, 32, 16384), ("narrow", 32, 4)),
        ((8192, 64, 16384), ("narrow", 64, 4)),
        ((8192, 65, 16384), ("wide", 128, 2)),
        ((8192, 128, 16384), ("wide", 128, 2)),
        ((8192, 256, 16384), ("wide", 256, 2)),
        # the Ozaki chain's squaring: 2,048 tiles, K whole
        ((8192, 8192, 90112), ("wide", 256, 1)),
        # small shapes: the split never exceeds K's 128-byte slices
        ((5, 3, 37), ("narrow", 8, 1)),
        ((17, 9, 1000), ("narrow", 16, 8)),
        ((128, 8, 122880), ("narrow", 8, 264)),
    ],
)
def test_plan_picks_the_variant_from_the_shape(shape, want):
    M, N, K = shape
    assert ig.int8_gemm_plan(M, N, K, H100_SMS) == want


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_plan_keeps_the_kernel_s_assumptions(sms):
    for M in (1, 17, 128, 300, 8192):
        for K in (1, 16, 129, 8192, 122880):
            for N in (1, 7, 64, 65, 128, 129, 512, 8192):
                variant, bn, splits = ig.int8_gemm_plan(M, N, K, sms)
                assert variant == ("narrow" if N <= ig.NARROW_N else "wide")
                assert bn in (8, 16, 32, 64, 128, 256)
                if variant == "narrow":  # one tile holds N, the smallest that does
                    assert bn >= N and (bn == 8 or bn // 2 < N)
                k_tiles = -(-K // ig.TILE_K)
                assert 1 <= splits <= k_tiles  # no split is empty
                tiles = -(-M // ig.TILE_M) * -(-N // bn)
                if splits > 1:  # K is split only to fill one wave
                    assert tiles * splits <= ig.BLOCKS_PER_SM[variant] * sms


def _ext_operands(M, N, kl, L, j0, j1, device="cpu"):
    """ext_cmatmul's operands: a K slice of an (M, L kl) stack, and the
    transpose of the same slice of a K-contiguous (N, L kl) copy."""
    a = torch.zeros((M, L * kl), dtype=torch.int8, device=device)
    b = torch.zeros((N, L * kl), dtype=torch.int8, device=device)
    return a[:, j0 * kl:j1 * kl], b[:, j0 * kl:j1 * kl].t()


@pytest.mark.parametrize("M,N,kl,L,j0,j1", [(64, 32, 64, 15, 3, 9), (64, 1, 16, 15, 0, 15),
                                             (1, 5, 48, 11, 0, 11), (40, 24, 48, 15, 14, 15)])
def test_layout_takes_the_callers_operands(M, N, kl, L, j0, j1):
    a, b = _ext_operands(M, N, kl, L, j0, j1)
    lda, ldb = ig.int8_gemm_layout(a, b)
    assert lda == (L * kl if M > 1 else (j1 - j0) * kl)
    assert ldb == (L * kl if N > 1 else (j1 - j0) * kl)


def test_layout_takes_the_limb_stacks_the_routes_build(monkeypatch):
    """Every GEMM that ``diagonal_mm`` issues on the routes' operands passes
    the kernel's layout check."""
    checked = []
    monkeypatch.setattr(tx, "int_mm", lambda a, b, out=None: checked.append(
        ig.int8_gemm_layout(a, b)))
    gen = torch.Generator().manual_seed(3)
    for K in (16, 40, 33):  # ragged K: each limb in whole 16-byte rows
        A = torch.randint(-16, 17, (15, 24, K), generator=gen, dtype=torch.int8)
        B = torch.randint(-16, 17, (15, K, 20), generator=gen, dtype=torch.int8)
        left, right = tx._cat_k(A), tx._right_rev(B)
        kw = -(-K // 16) * 16
        assert left.shape == (24, 15 * kw) and right.shape == (20, 15 * kw)
        for s in range(15 + tx.EXT_GUARD):
            tx.diagonal_mm(left, right, 15, s)
    assert len(checked) == 3 * (15 + tx.EXT_GUARD)


def test_layout_refuses_an_n_contiguous_b():
    a = torch.zeros((32, 64), dtype=torch.int8)
    b = torch.zeros((64, 32), dtype=torch.int8)  # (K, N) row-major: N-contiguous
    with pytest.raises(ValueError, match="K-contiguous"):
        ig.int8_gemm_layout(a, b)


def test_layout_refuses_a_with_strided_k():
    a = torch.zeros((64, 32), dtype=torch.int8).t()
    b = torch.zeros((32, 64), dtype=torch.int8).t()
    with pytest.raises(ValueError, match="unit stride along K"):
        ig.int8_gemm_layout(a, b)


@pytest.mark.parametrize("which", ["a", "b"])
def test_layout_refuses_a_misaligned_stride(which):
    # rows 40 bytes apart on one side, 48 on the other
    a = torch.zeros((32, 40 if which == "a" else 48), dtype=torch.int8)[:, :40]
    b = torch.zeros((8, 40 if which == "b" else 48), dtype=torch.int8)[:, :40].t()
    with pytest.raises(ValueError, match=f"takes {which.upper()} with a 16-byte"):
        ig.int8_gemm_layout(a, b)


def test_layout_refuses_a_misaligned_start():
    buf = torch.zeros((32, 64), dtype=torch.int8)
    b = torch.zeros((8, 64), dtype=torch.int8)[:, :48].t()
    with pytest.raises(ValueError, match="16-byte aligned start"):
        ig.int8_gemm_layout(buf[:, 8:56], b)


@pytest.mark.parametrize("bad", ["dtype", "shape", "empty", "tensor"])
def test_layout_refuses_other_operands(bad):
    a = torch.zeros((32, 64), dtype=torch.int8)
    b = torch.zeros((8, 64), dtype=torch.int8).t()
    if bad == "dtype":
        with pytest.raises(TypeError, match="int8"):
            ig.int8_gemm_layout(a.to(torch.int16), b)
    elif bad == "shape":
        with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
            ig.int8_gemm_layout(a, b[:32])
    elif bad == "empty":
        with pytest.raises(ValueError, match="out of range"):
            ig.int8_gemm_layout(a[:0], b)
    else:
        with pytest.raises(TypeError, match="torch tensors"):
            ig.int8_gemm_layout(a.numpy(), b)


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 37, 3), (17, 16, 8), (40, 129, 70)])
def test_plain_version_is_exact(shape):
    M, K, N = shape
    gen = torch.Generator().manual_seed(M * K + N)
    a = torch.randint(-66, 67, (M, K), generator=gen, dtype=torch.int8)
    b = torch.randint(-66, 67, (K, N), generator=gen, dtype=torch.int8)
    want = (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)
    torch.testing.assert_close(ig.int8_gemm(a, b), want, rtol=0, atol=0)
    torch.testing.assert_close(ig.int8_gemm_plain(a, b), want, rtol=0, atol=0)


def test_int_mm_on_the_cpu_launches_nothing_and_counts_no_variant():
    a = torch.ones((20, 16), dtype=torch.int8)
    b = torch.ones((16, 8), dtype=torch.int8)
    timer = StageTimer()
    with tracing(timer), timer.stage("horner"):
        out = tx.int_mm(a, b)
    assert not launches(timer)
    assert torch.equal(out, torch.full((20, 8), 16, dtype=torch.int32))
    assert timer.counters == {"horner": {"int8_gemm.calls": 1, "int8_gemm.ops": 2 * 20 * 16 * 8}}


def test_int8_gemm_refuses_other_devices():
    a = torch.zeros((4, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ig.int8_gemm(a, a)


@pytest.mark.parametrize("shape", [(5, 37, 3), (40, 129, 70)])
def test_out_takes_a_view_of_a_workspace(shape):
    """``out=`` writes the product into a contiguous (M, N) view of a larger
    int32 workspace, returns that view and leaves the rest as it was."""
    M, K, N = shape
    gen = torch.Generator().manual_seed(M + K + N)
    a = torch.randint(-66, 67, (M, K), generator=gen, dtype=torch.int8)
    b = torch.randint(-66, 67, (K, N), generator=gen, dtype=torch.int8)
    ws = torch.full((3, M, N), 7, dtype=torch.int32)
    got = tx.int_mm(a, b, out=ws[1])
    assert got.data_ptr() == ws[1].data_ptr()
    assert torch.equal(ws[1], ig.int8_gemm_plain(a, b))
    assert (ws[0] == 7).all() and (ws[2] == 7).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided"])
def test_out_refuses_what_the_kernel_cannot_write(bad):
    a = torch.ones((8, 16), dtype=torch.int8)
    b = torch.ones((16, 4), dtype=torch.int8)
    out = {"dtype": torch.empty((8, 4), dtype=torch.int64),
           "shape": torch.empty((8, 5), dtype=torch.int32),
           "strided": torch.empty((8, 8), dtype=torch.int32)[:, :4]}[bad]
    with pytest.raises(ValueError, match="contiguous"):
        ig.int8_gemm(a, b, out=out)
