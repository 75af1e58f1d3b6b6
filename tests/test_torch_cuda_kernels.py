"""The port's CUDA kernels on the card (skip where there is no CUDA device).

Every test here carries the ``requires_cuda`` marker.  This file imports
neither JAX nor the JAX package, so it also runs on a GPU machine without
JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Bounds: cmatmul_f32 against its plain PyTorch version, 1e-5 of the output's
largest magnitude (the kernel's 3xTF32 tensor-core products are ~2^-21
relative per term, summed in another order than the plain IEEE float32
products); the eig32
propagator against the float64 one, 2e-4 (the JAX package's bar);
limb_matmul_canon against its plain version, equal bit for bit (int32 sums
are exact in any order and under any split of K; two calls are also equal
to each other); the extp Chebyshev stepper against the f64 one,
1e-11 (the JAX package's bar, tests/test_limb_kernels.py:161);
ext_obs_diagonals_int8 against its plain version and the ext limb product
(int8 GEMMs through the hand-written kernel) against the CPU, equal bit
for bit; int8_gemm against torch._int_mm, equal bit for bit (int32 sums are
exact in any order and under any split of K; two calls equal); the ext
route's rows on the card against the CPU, 1e-13 (equal limbs, the float64
observable combine summed in another order); z_expectations_f32 against its
plain version, 1e-5 of the output's largest magnitude (both sum the same
float32 products in float64, in another order; two calls equal bit for bit);
the matrix-free krylov and chebyshev routes on the card
against the CPU, 1e-12 (the same float64 operations, reduced in another
order); the Ozaki limb products on the card against the CPU, equal bit for
bit (exact int8 GEMMs, the same float64 operations in the same order); the
dense and Ozaki expm routes on the card against the CPU, 1e-12; dopri and
the lab frame on the card against the CPU at atol 1e-12, rtol 1e-11, 1e-9
(the step sequences may differ by a step where an error norm sits within
rounding of a decision);
the limb tier against the f64 tier on the card, 1e-11, and against the CPU,
1e-12; the 2D grid (``run_grid2d``) on the card against the CPU, 1e-10 on
every saved trace (the eig route's bar above) and 1e-8 relative on the
metrics; at world size 1 over NCCL (a one-rank process group on the card),
the dp-sharded eig and eig32 rows and the DR-sharded limb apply against the
unsharded card runs, equal bit for bit.
"""

import numpy as np
import pytest
import torch

from quantumsimulations_tpu_torch.dynamics import cheb_step as tcs
from quantumsimulations_tpu_torch.dynamics import chebyshev as tcheb
from quantumsimulations_tpu_torch.dynamics import eig_propagator as teig
from quantumsimulations_tpu_torch.dynamics import expm_propagator as tep
from quantumsimulations_tpu_torch.dynamics import krylov as tkry
from quantumsimulations_tpu_torch.kernels import launch_counts
from quantumsimulations_tpu_torch.models.dipolar import build_model
from quantumsimulations_tpu_torch.models.params import DipolarRareParams
from quantumsimulations_tpu_torch.ops import cmatmul as cm
from quantumsimulations_tpu_torch.ops import ext_obs as eo
from quantumsimulations_tpu_torch.ops import extprec as ep
from quantumsimulations_tpu_torch.ops import int8_gemm as ig
from quantumsimulations_tpu_torch.ops import limb_kernels as lk
from quantumsimulations_tpu_torch.ops import zexp

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape",
    [(1, 128, 128, 128), (2, 64, 200, 96), (1, 300, 513, 130), (39, 128, 128, 1680),
     (1, 5, 1, 3), (2, 9, 7, 12), (1, 15, 9, 6), (1, 2048, 2048, 1024)],
)
def test_kernel_matches_plain(cuda_device, shape):
    B, M, K, N = shape
    gen = torch.Generator(device=cuda_device).manual_seed(B * M + N)
    ar, ai = (torch.randn(B, M, K, generator=gen, device=cuda_device) for _ in range(2))
    br, bi = (torch.randn(B, K, N, generator=gen, device=cuda_device) for _ in range(2))
    before = launch_counts["cmatmul_f32"]
    cr, ci = cm.cmatmul_f32(ar, ai, br, bi)
    torch.cuda.synchronize()
    assert launch_counts["cmatmul_f32"] == before + 1
    pr, pi = cm.cmatmul_f32_plain(ar, ai, br, bi)
    scale = torch.maximum(pr.abs().max(), pi.abs().max())
    err = torch.maximum((cr - pr).abs().max(), (ci - pi).abs().max())
    assert float(err / scale) <= 1e-5


def test_kernel_unbatched_ragged_and_empty(cuda_device):
    ar, ai = (torch.randn(33, 17, device=cuda_device) for _ in range(2))
    br, bi = (torch.randn(17, 65, device=cuda_device) for _ in range(2))
    cr, ci = cm.cmatmul_f32(ar, ai, br, bi)
    pr, pi = cm.cmatmul_f32_plain(ar, ai, br, bi)
    assert cr.shape == (33, 65)
    scale = float(torch.maximum(pr.abs().max(), pi.abs().max()))
    assert float((cr - pr).abs().max()) <= 1e-5 * scale
    assert float((ci - pi).abs().max()) <= 1e-5 * scale
    before = launch_counts["cmatmul_f32"]
    er, ei = cm.cmatmul_f32(ar[:0], ai[:0], br, bi)
    assert er.shape == ei.shape == (0, 65)
    assert launch_counts["cmatmul_f32"] == before  # nothing to launch


def test_cuda_tensors_never_take_the_plain_version(cuda_device, monkeypatch):
    def refuse(*args):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(cm, "cmatmul_f32_plain", refuse)
    x = torch.randn(8, 8, device=cuda_device)
    cr, _ = cm.cmatmul_f32(x, x, x, x)
    assert cr.is_cuda


def test_eig32_on_card_within_bound_of_f64(cuda_device):
    kw = dict(
        n_sea=4, gamma_sea=8.1812e7, gamma_rare=6.976e7, B0_sea=3.0, B0_rare=3.0,
        B1_sea=2 * np.pi * 5e4 / 8.1812e7, B1_rare=2 * np.pi * 70710.678 / 6.976e7,
        omega_rf_sea=8.1812e7 * 3.0 - 2 * np.pi * 5e4, omega_rf_rare=6.976e7 * 3.0,
        phi_sea=np.pi / 2, phi_rare=np.pi / 2, dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9, drive_sea=True, drive_rare=True, is_spin_three_half=False,
    )
    m = build_model(DipolarRareParams(**kw))
    w, V = np.linalg.eigh(m.hamiltonian.to_dense())
    times = np.linspace(0.0, 0.5, 3001)
    args = (w[None], V[None], m.psi0[None], times, m.dims, np.asarray([m.n_sea_effective]),
            m.idx_rare)
    rows64 = teig.eig_traces_assembled_batched(*args, device=cuda_device)
    cpu64 = teig.eig_traces_assembled_batched(*args, device="cpu")
    before = launch_counts["cmatmul_f32"]
    rows32 = teig.eig_traces_assembled_batched32(*args, device=cuda_device)
    assert launch_counts["cmatmul_f32"] > before
    assert np.abs(rows64[:, :7] - cpu64[:, :7]).max() <= 1e-10
    assert np.abs(rows32[:, :7] - rows64[:, :7]).max() <= 2e-4
    assert np.abs(rows64[:, 6] - 1.0).max() < 1e-12


def _limbs(shape, gen, device):
    x = torch.randint(-32, 33, shape, generator=gen, device=device, dtype=torch.int32)
    x[0] = torch.randint(-64, 65, shape[1:], generator=gen, device=device, dtype=torch.int32)
    return x.to(torch.int8).contiguous()


@pytest.mark.parametrize(
    "M,K,N,tm",
    [
        (256, 128, 256, None),  # H_L of the n13 extp apply
        (1792, 128, 128, 128),  # cross stage 1, transpose_out
        (128, 1792, 128, None),  # cross stage 2
        (256, 128, 256, None),  # H_R
        (33, 50, 70, None),  # ragged M, N, K
        (96, 37, 24, 32),  # ragged K, transpose_out
        (640, 301, 700, None),  # unsplit, ragged K
        (7, 45, 5, None),  # M, N < 16, K not a multiple of 32
        (12, 100, 9, None),  # M, N < 16, K split in four slices
        (128, 4096, 64, None),  # split K: 32 slices of 128
        (2048, 2048, 2048, None),  # large square, unsplit
    ],
)
def test_limb_kernel_matches_plain(cuda_device, M, K, N, tm):
    gen = torch.Generator(device=cuda_device).manual_seed(M + 7 * K + 13 * N)
    a, b = _limbs((10, M, K), gen, cuda_device), _limbs((10, K, N), gen, cuda_device)
    kw = dict(tm=tm, transpose_out=True) if tm else {}
    before = launch_counts["limb_matmul_canon"]
    out = lk.limb_matmul_canon(a, b, bits=6, **kw)
    torch.cuda.synchronize()
    assert launch_counts["limb_matmul_canon"] == before + 1
    assert torch.equal(out, lk.limb_matmul_canon_plain(a, b, 6, **kw))


def test_limb_kernel_split_k_is_deterministic(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    a, b = _limbs((10, 128, 1792), gen, cuda_device), _limbs((10, 1792, 128), gen, cuda_device)
    assert lk.limb_launch_plan(128, 1792, 128).ksplit > 1
    first = lk.limb_matmul_canon(a, b, bits=6)
    second = lk.limb_matmul_canon(a, b, bits=6)
    assert torch.equal(first, second)
    assert torch.equal(first, lk.limb_matmul_canon_plain(a, b, 6))


def test_limb_kernel_extreme_limbs_long_k(cuda_device):
    """Full-range limbs with -128 rows and columns at the cross stage's
    K = 1792: the largest digits the headroom allows, through split K."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    a = torch.randint(-128, 128, (10, 128, 1792), generator=gen, device=cuda_device).to(torch.int8)
    b = torch.randint(-128, 128, (10, 1792, 128), generator=gen, device=cuda_device).to(torch.int8)
    a[:, 0, :] = -128
    b[:, :, 0] = -128
    assert torch.equal(lk.limb_matmul_canon(a, b, bits=6), lk.limb_matmul_canon_plain(a, b, 6))


def test_limb_kernel_extreme_limbs(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randint(-128, 128, (10, 40, 24), generator=gen, device=cuda_device).to(torch.int8)
    b = torch.randint(-128, 128, (10, 24, 50), generator=gen, device=cuda_device).to(torch.int8)
    a[:, 0, :] = -128
    assert torch.equal(lk.limb_matmul_canon(a, b, bits=6), lk.limb_matmul_canon_plain(a, b, 6))


@pytest.mark.parametrize("bad", ["cpu_operand", "dtype", "noncontiguous", "overflow_k", "limbs"])
def test_limb_kernel_wrapper_raises(cuda_device, bad):
    a = torch.zeros((10, 32, 16), dtype=torch.int8, device=cuda_device)
    b = torch.zeros((10, 16, 8), dtype=torch.int8, device=cuda_device)
    err = ValueError
    if bad == "cpu_operand":
        b = b.cpu()
    elif bad == "dtype":
        a, err = a.to(torch.int32), TypeError
    elif bad == "noncontiguous":
        b = torch.zeros((10, 8, 16), dtype=torch.int8, device=cuda_device).transpose(1, 2)
    elif bad == "overflow_k":
        K = 2**31 // (2**12 * 10) + 1
        a = torch.zeros((10, 1, K), dtype=torch.int8, device=cuda_device)
        b = torch.zeros((10, K, 1), dtype=torch.int8, device=cuda_device)
        err = AssertionError
    else:
        a, b = a[:8].contiguous(), b[:8].contiguous()
    with pytest.raises(err):
        lk.limb_matmul_canon(a, b, bits=6)


def test_limb_cuda_tensors_never_take_the_plain_version(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(lk, "limb_matmul_canon_plain", refuse)
    monkeypatch.setattr(lk, "product_digits", refuse)
    x = torch.zeros((10, 16, 16), dtype=torch.int8, device=cuda_device)
    assert lk.limb_matmul_canon(x, x, bits=6).is_cuda


def test_extp_steps_on_card_within_bound_of_f64(cuda_device):
    kw = dict(
        n_sea=9, gamma_sea=8.1812e7, gamma_rare=6.976e7, B0_sea=3.0, B0_rare=3.0,
        B1_sea=2 * np.pi * 5e4 / 8.1812e7, B1_rare=2 * np.pi * 70710.678 / 6.976e7,
        omega_rf_sea=8.1812e7 * 3.0, omega_rf_rare=6.976e7 * 3.0,
        phi_sea=np.pi / 2, phi_rare=np.pi / 2, dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9, drive_sea=True, drive_rare=True, is_spin_three_half=False,
    )
    m = build_model(DipolarRareParams(**kw))
    times = np.arange(2) * (30.0 / 19_999)
    args = (m.hamiltonian, m.psi0, times, m.dims, m.n_sea_effective, m.idx_rare)
    f64 = tcs.chebyshev_step_traces(*args, arithmetic="f64", device=cuda_device)
    before = launch_counts["limb_matmul_canon"]
    extp = tcs.chebyshev_step_traces(*args, arithmetic="extp", device=cuda_device)
    assert launch_counts["limb_matmul_canon"] > before
    assert np.abs(extp[:7] - f64[:7]).max() <= 1e-11
    assert np.abs(extp[6] - 1.0).max() < 1e-12


JJ, II, _ = tep._EXT_PAIRS


def _ext_limbs(shape, gen, device):
    """Canonical-range limbs, limb 0 over its full range [-33, 33]."""
    x = torch.randint(-16, 17, shape, generator=gen, device=device, dtype=torch.int32)
    x[0] = torch.randint(-33, 34, shape[1:], generator=gen, device=device, dtype=torch.int32)
    x[0, 0, 0], x[0, -1, -1] = 33, -33
    return x.to(torch.int8).contiguous()


def _ext_pairs(nd):
    return tuple(zip(*[(j, s - j) for s in range(nd) for j in range(s + 1)]))


# (L, dim, T, n_diag, every limb at +-33): n_sites 1-14 at a narrow T (33:
# staged a byte at a time; 32: staged by the TMA), T 1, 33, 130 and 2049,
# n_diag < 11 with L = n_diag, and limbs at the headroom's worst case; at
# n_sites 14 (a column in two blocks) ragged T of 1, 9 and 130 too
_EXT_CASES = (
    [(15, 1 << n, 33, 11, False) for n in range(1, 15)]
    + [(15, 1 << n, 32, 11, False) for n in range(1, 15)]
    + [(15, 1 << 14, T, 11, False) for T in (1, 9, 130)]
    + [(11, 1 << 14, 48, 11, False), (7, 1 << 14, 40, 7, False), (15, 1 << 14, 64, 11, True)]
    + [(15, 2048, T, 11, False) for T in (1, 33, 130, 2049)]
    + [(15, 64, 200, 11, False), (15, 256, 384, 11, False), (11, 32, 1, 11, False)]
    + [(nd, 1 << n, 48, nd, False) for nd, n in ((1, 5), (4, 9), (7, 12), (10, 13))]
    + [(15, 1 << n, T, 11, True) for n, T in ((2, 33), (8, 64), (13, 130), (13, 32))]
)


@pytest.mark.parametrize("L,dim,T,nd,extreme", _EXT_CASES)
def test_ext_obs_kernel_matches_plain(cuda_device, L, dim, T, nd, extreme):
    gen = torch.Generator(device=cuda_device).manual_seed(dim + T + nd)
    if extreme:
        S_re, S_im = ((torch.randint(0, 2, (L, dim, T), generator=gen, device=cuda_device) * 66 - 33)
                      .to(torch.int8).contiguous() for _ in range(2))
    else:
        S_re, S_im = (_ext_limbs((L, dim, T), gen, cuda_device) for _ in range(2))
    jj, ii = _ext_pairs(nd)
    before = launch_counts["ext_obs_diagonals_int8"]
    got = eo.ext_obs_diagonals_int8(S_re, S_im, jj, ii, nd)
    torch.cuda.synchronize()
    assert launch_counts["ext_obs_diagonals_int8"] == before + 1
    want = eo.ext_obs_diagonals_plain(S_re, S_im, jj, ii, nd)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(15, 8, 33), (15, 1024, 64), (15, 8192, 160)])
def test_ext_obs_kernel_two_calls_equal_bits(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1])
    S_re, S_im = _ext_limbs(shape, gen, cuda_device), _ext_limbs(shape, gen, cuda_device)
    first = eo.ext_obs_diagonals_int8(S_re, S_im, JJ, II, 11)
    second = eo.ext_obs_diagonals_int8(S_re, S_im, JJ, II, 11)
    assert torch.equal(first, second)


def test_ext_obs_kernel_counts_one_launch_per_call(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    shapes = [(15, 16, 33), (15, 4096, 48), (15, 16, 33)]
    stacks = [(_ext_limbs(s, gen, cuda_device), _ext_limbs(s, gen, cuda_device)) for s in shapes]
    before = launch_counts["ext_obs_diagonals_int8"]
    for k, (S_re, S_im) in enumerate(stacks, start=1):
        eo.ext_obs_diagonals_int8(S_re, S_im, JJ, II, 11)
        assert launch_counts["ext_obs_diagonals_int8"] == before + k
    torch.cuda.synchronize()


def test_ext_obs_kernel_rejects_dims_above_8192(cuda_device):
    # dim 16384 runs (two blocks a column); 32768 is past the kernel
    S = torch.zeros((11, 1 << 15, 2), dtype=torch.int8, device=cuda_device)
    before = launch_counts["ext_obs_diagonals_int8"]
    with pytest.raises(ValueError, match="dim <= 16384"):
        eo.ext_obs_diagonals_int8(S, S, JJ, II, 11)
    assert launch_counts["ext_obs_diagonals_int8"] == before


def test_ext_obs_kernel_takes_only_the_full_pair_triangle(cuda_device):
    S = torch.zeros((15, 16, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="triangle"):
        eo.ext_obs_diagonals_int8(S, S, JJ[:-1], II[:-1], 11)
    with pytest.raises(ValueError, match="triangle"):
        eo.ext_obs_diagonals_int8(S[:8], S[:8], JJ, II, 11)  # L < n_diag
    with pytest.raises(ValueError, match="contiguous"):
        eo.ext_obs_diagonals_int8(S[:, :, ::2], S[:, :, ::2], JJ, II, 11)


def test_ext_obs_cuda_tensors_never_take_the_plain_version(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(eo, "ext_obs_diagonals_plain", refuse)
    S = torch.zeros((15, 16, 8), dtype=torch.int8, device=cuda_device)
    assert eo.ext_obs_diagonals_int8(S, S, JJ, II, 11).is_cuda


@pytest.mark.parametrize("M,K,N,panel", [(64, 64, 64, 64), (96, 40, 24, 16), (20, 16, 3, 512)])
def test_ext_cmatmul_on_card_equals_cpu(cuda_device, M, K, N, panel):
    gen = torch.Generator().manual_seed(M + K + N)
    ops = [_ext_limbs(s, gen, "cpu") for s in ((15, M, K), (15, M, K), (15, K, N), (15, K, N))]
    want = ep.ext_cmatmul(*ops, panel=panel)
    got = ep.ext_cmatmul(*[x.to(cuda_device) for x in ops], panel=panel)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# The int8 GEMM (csrc/int8_gemm.cu) against torch._int_mm, bit for bit.
# ---------------------------------------------------------------------------


def _i8(shape, gen, device, lo=-66, hi=66):
    return torch.randint(lo, hi + 1, shape, generator=gen, device=device,
                         dtype=torch.int32).to(torch.int8)


def _ext_gemm_operands(M, N, kl, L, j0, j1, gen, device):
    """The ext chain's GEMM operands: A the K slice [j0 kl, j1 kl) of an
    (M, L kl) limb stack, B the transpose of the same slice of a
    K-contiguous (N, L kl) copy."""
    a = _i8((M, L * kl), gen, device, -33, 33)[:, j0 * kl:j1 * kl]
    b = _i8((N, L * kl), gen, device, -33, 33)[:, j0 * kl:j1 * kl].t()
    return a, b


def _int_mm_ref(a, b, device):
    """torch._int_mm on contiguous copies on ``device``, zero-padded to its
    shapes (cuBLASLt refuses some small padded shapes; the CPU takes all)."""
    return ig.int8_gemm_plain(a.to(device).contiguous(), b.to(device).contiguous())


def _assert_gemm_equal(a, b, ref_device="cuda"):
    before = launch_counts["int8_gemm"]
    got = ig.int8_gemm(a, b)
    assert launch_counts["int8_gemm"] == before + 1
    assert torch.equal(got.to(ref_device), _int_mm_ref(a, b, ref_device))
    return got


@pytest.mark.parametrize("j0,j1", [(0, 1), (0, 15), (3, 9), (13, 15)])
def test_int8_gemm_main_path_views_equal_int_mm(cuda_device, j0, j1):
    gen = torch.Generator(device=cuda_device).manual_seed(100 + j0 * 16 + j1)
    _assert_gemm_equal(*_ext_gemm_operands(8192, 512, 8192, 15, j0, j1, gen, cuda_device))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 32, 64, 128, 256])
def test_int8_gemm_doubling_shapes_equal_int_mm(cuda_device, n):
    gen = torch.Generator(device=cuda_device).manual_seed(200 + n)
    _assert_gemm_equal(*_ext_gemm_operands(8192, n, 8192, 15, 0, 3, gen, cuda_device))


@pytest.mark.parametrize("n", [8192, 128])
def test_int8_gemm_ozaki_shapes_equal_int_mm(cuda_device, n):
    gen = torch.Generator(device=cuda_device).manual_seed(300 + n)
    _assert_gemm_equal(*_ext_gemm_operands(8192, n, 8192, 11, 0, 11, gen, cuda_device))


@pytest.mark.parametrize("m,k,n", [(1, 16, 1), (5, 37, 3), (16, 200, 13), (17, 1000, 9),
                                   (300, 129, 70), (129, 4097, 257), (8, 15, 130)])
def test_int8_gemm_ragged_shapes_equal_int_mm(cuda_device, m, k, n):
    """Ragged M < 17, N % 8 != 0, K % 16 != 0: views of 16-byte aligned
    buffers, against torch._int_mm on the CPU."""
    gen = torch.Generator(device=cuda_device).manual_seed(m * k + n)
    width = -(-k // 16) * 16 + 32
    a = _i8((m, width), gen, cuda_device)[:, :k]
    b = _i8((n, width), gen, cuda_device)[:, :k].t()
    _assert_gemm_equal(a, b, ref_device="cpu")


@pytest.mark.parametrize("m,n", [(256, 512), (8192, 8)])
def test_int8_gemm_extreme_limbs_at_the_headroom(cuda_device, m, n):
    """Every limb at +-66 (the Karatsuba sums' range) over the longest K the
    ext chain's headroom allows (15 limb pairs of 8192)."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + n)
    k = 15 * 8192
    a = (torch.randint(0, 2, (m, k), generator=gen, device=cuda_device) * 132 - 66).to(torch.int8)
    b = (torch.randint(0, 2, (n, k), generator=gen, device=cuda_device) * 132 - 66).to(torch.int8)
    assert k * 66 * 66 < 2**31
    _assert_gemm_equal(a, b.t())


def test_int8_gemm_two_calls_equal_one_launch_each(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for n in (8, 256, 512):  # narrow and wide split K across blocks, wide at N 512 does not
        a, b = _ext_gemm_operands(8192, n, 8192, 15, 2, 7, gen, cuda_device)
        before = launch_counts["int8_gemm"]
        first, second = ig.int8_gemm(a, b), ig.int8_gemm(a, b)
        assert launch_counts["int8_gemm"] == before + 2
        assert torch.equal(first, second)


def test_int8_gemm_cuda_tensors_never_reach_torch_int_mm(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch._int_mm called with CUDA tensors")

    gen = torch.Generator().manual_seed(11)
    ops = [_ext_limbs(s, gen, "cpu") for s in ((15, 64, 64), (15, 64, 64), (15, 64, 24), (15, 64, 24))]
    want = ep.ext_cmatmul(*ops)
    monkeypatch.setattr(torch, "_int_mm", refuse)
    got = ep.ext_cmatmul(*[x.to(cuda_device) for x in ops])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_int8_gemm_wrapper_raises_on_other_layouts(cuda_device):
    a = torch.zeros((64, 64), dtype=torch.int8, device=cuda_device)
    before = launch_counts["int8_gemm"]
    with pytest.raises(ValueError, match="K-contiguous"):
        ig.int8_gemm(a, torch.zeros((64, 32), dtype=torch.int8, device=cuda_device))
    with pytest.raises(ValueError, match="16-byte"):
        ig.int8_gemm(torch.zeros((64, 40), dtype=torch.int8, device=cuda_device),
                     torch.zeros((32, 48), dtype=torch.int8, device=cuda_device)[:, :40].t())
    with pytest.raises(ValueError, match="one device"):
        ig.int8_gemm(a, torch.zeros((32, 64), dtype=torch.int8).t())
    assert launch_counts["int8_gemm"] == before


def test_int8_gemm_variant_counters_sum_to_calls(cuda_device):
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing

    gen = torch.Generator().manual_seed(12)
    a = [_ext_limbs((15, 128, 128), gen, "cpu").to(cuda_device) for _ in range(2)]
    s = [_ext_limbs((15, 128, n), gen, "cpu").to(cuda_device) for n in (4, 4, 96, 96)]
    timer = StageTimer()
    before = launch_counts["int8_gemm"]
    with tracing(timer), timer.stage("doubling"):
        ep.ext_cmatmul(a[0], a[1], s[0], s[1])  # narrow
        ep.ext_cmatmul(a[0], a[1], s[2], s[3])  # wide
    c = timer.counters["doubling"]
    assert c["int8_gemm.narrow"] == c["int8_gemm.wide"] == 51
    assert c["int8_gemm.narrow"] + c["int8_gemm.wide"] == c["int8_gemm.calls"]
    assert launch_counts["int8_gemm"] - before == c["int8_gemm.calls"]


def test_stage_memory_high_water_on_card(cuda_device):
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer(device=torch.device(cuda_device), memory=True)
    with timer.stage("outer"):
        with timer.stage("big"):
            x = torch.empty(64 << 20, dtype=torch.int8, device=cuda_device)
            del x
        with timer.stage("small"):
            y = torch.empty(1 << 20, dtype=torch.int8, device=cuda_device)
            del y
    big = timer.counters["big"]["memory.peak_bytes"]
    assert big >= 64 << 20
    assert timer.counters["small"]["memory.peak_bytes"] < big
    assert timer.counters["outer"]["memory.peak_bytes"] >= big  # the inner reset is folded in
    plain = StageTimer(device=torch.device(cuda_device))
    with plain.stage("big"):
        pass
    assert "big" not in plain.counters  # off unless asked for


def test_ext_route_on_card_equals_cpu(cuda_device):
    kw = dict(
        n_sea=4, gamma_sea=8.1812e7, gamma_rare=6.976e7, B0_sea=3.0, B0_rare=3.0,
        B1_sea=2 * np.pi * 5e4 / 8.1812e7, B1_rare=2 * np.pi * 70710.678 / 6.976e7,
        omega_rf_sea=8.1812e7 * 3.0 - 2 * np.pi * 900.0, omega_rf_rare=6.976e7 * 3.0,
        phi_sea=np.pi / 2, phi_rare=np.pi / 2, dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9, drive_sea=True, drive_rare=True, is_spin_three_half=False,
    )
    m = build_model(DipolarRareParams(**kw))
    t = np.linspace(0.0, 0.0199, 200)
    args = (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)
    before = launch_counts["ext_obs_diagonals_int8"]
    card = tep.expm_traces_assembled_ext(*args, block=128, device=cuda_device)
    assert launch_counts["ext_obs_diagonals_int8"] > before
    cpu = tep.expm_traces_assembled_ext(*args, block=128, device="cpu")
    assert np.abs(card - cpu).max() <= 1e-13
    assert np.abs(card[6] - 1.0).max() < 1e-12


def _zexp_inputs(device, n, dim, T, dtype, sign_dtype=torch.float64, seed=None):
    gen = torch.Generator(device=device).manual_seed(n * dim + T if seed is None else seed)
    re, im = (torch.randn(dim, T, generator=gen, device=device, dtype=dtype) for _ in range(2))
    dims = (2,) * (n - 1) + (dim >> (n - 1),)
    signs = torch.as_tensor(zexp.z_sign_table(dims), device=device).to(sign_dtype)
    return re, im, signs


@pytest.mark.parametrize("sign_dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "n,dim,T,dtype",
    [(4, 16, 37, torch.float64), (7, 128, 2000, torch.float32), (14, 16384, 21, torch.float64),
     (16, 65536, 64, torch.float32), (14, 16384, 1, torch.float64),
     (14, 16384, 33, torch.float64), (14, 16384, 2049, torch.float64),
     (1, 16, 21, torch.float64), (1, 16, 2049, torch.float32)],
)
def test_zexp_kernel_matches_plain(cuda_device, n, dim, T, dtype, sign_dtype):
    re, im, signs = _zexp_inputs(cuda_device, n, dim, T, dtype, sign_dtype)
    before = launch_counts["z_expectations_f32"]
    got = zexp.z_expectations_f32(re, im, signs)
    torch.cuda.synchronize()
    assert launch_counts["z_expectations_f32"] == before + 1
    want = zexp.z_expectations_f32_plain(re, im, signs)
    assert got.dtype == torch.float32 and got.shape == (n, T)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("n,dim,T,dtype", [(14, 16384, 21, torch.float64),
                                           (14, 16384, 2048, torch.float64),
                                           (16, 65536, 64, torch.float32)])
def test_zexp_kernel_two_calls_equal_bits(cuda_device, n, dim, T, dtype):
    args = _zexp_inputs(cuda_device, n, dim, T, dtype)
    assert torch.equal(zexp.z_expectations_f32(*args), zexp.z_expectations_f32(*args))


def test_zexp_kernel_alternating_shapes_on_one_stream(cuda_device):
    # each call's last block resets the merge counters it used: calls of
    # other plans on the same stream (and so the same counters) stay right
    cases = [_zexp_inputs(cuda_device, 14, 16384, 21, torch.float64, seed=1),
             _zexp_inputs(cuda_device, 16, 65536, 64, torch.float32, seed=2),
             _zexp_inputs(cuda_device, 14, 16384, 2048, torch.float64, seed=3)]
    wants = [zexp.z_expectations_f32_plain(*c) for c in cases]
    for k in range(9):
        got = zexp.z_expectations_f32(*cases[k % 3])
        want = wants[k % 3]
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_zexp_kernel_counts_one_launch_per_call(cuda_device):
    args = _zexp_inputs(cuda_device, 14, 16384, 21, torch.float64)
    before = launch_counts["z_expectations_f32"]
    for _ in range(5):
        zexp.z_expectations_f32(*args)
    torch.cuda.synchronize()
    assert launch_counts["z_expectations_f32"] == before + 5
    empty = zexp.z_expectations_f32(args[0][:, :0], args[1][:, :0], args[2])
    assert empty.shape == (14, 0)
    assert launch_counts["z_expectations_f32"] == before + 5  # nothing to launch


def test_zexp_cuda_tensors_never_take_the_plain_version(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(zexp, "z_expectations_f32_plain", refuse)
    x = torch.ones((8, 3), dtype=torch.float64, device=cuda_device)
    signs = torch.as_tensor(zexp.z_sign_table((2, 2, 2)), device=cuda_device)
    assert zexp.z_expectations_f32(x, x, signs).is_cuda
    with pytest.raises(ValueError, match="contiguous"):
        zexp.z_expectations_f32(x.T.contiguous().T, x, signs)
    with pytest.raises(ValueError, match="sites"):
        big = torch.ones((17, 8), dtype=torch.float64, device=cuda_device)
        zexp.z_expectations_f32(x, x, big)


@pytest.mark.parametrize("route", ["krylov", "chebyshev"])
def test_matrix_free_routes_on_card_equal_cpu(cuda_device, route):
    kw = dict(
        n_sea=4, gamma_sea=8.1812e7, gamma_rare=6.976e7, B0_sea=3.0, B0_rare=3.0,
        B1_sea=2 * np.pi * 5e4 / 8.1812e7, B1_rare=2 * np.pi * 70710.678 / 6.976e7,
        omega_rf_sea=8.1812e7 * 3.0 - 2 * np.pi * 900.0, omega_rf_rare=6.976e7 * 3.0,
        phi_sea=np.pi / 2, phi_rare=np.pi / 2, dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9, drive_sea=True, drive_rare=True, is_spin_three_half=False,
    )
    m = build_model(DipolarRareParams(**kw))
    t = np.linspace(0.0, 4e-4, 41)
    args = (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)
    fn = tkry.krylov_traces_assembled if route == "krylov" else tcheb.chebyshev_traces_assembled
    card = fn(*args, device=cuda_device)
    cpu = fn(*args, device="cpu")
    assert np.abs(card[:7] - cpu[:7]).max() <= 1e-12
    assert abs(card[7, 0] - cpu[7, 0]) <= 1e-12 * abs(cpu[7, 0])
    assert np.abs(card[6] - 1.0).max() < 1e-12


# ---------------------------------------------------------------------------
# The solvers without a hand-written kernel (the expm routes, dopri, the lab
# frame, the limb tier) on the card against the CPU.
# ---------------------------------------------------------------------------

_SMALL = dict(
    n_sea=3, gamma_sea=8.1812e7, gamma_rare=6.976e7, B0_sea=3.0, B0_rare=3.0,
    B1_sea=2 * np.pi * 5e4 / 8.1812e7, B1_rare=2 * np.pi * 70710.678 / 6.976e7,
    omega_rf_sea=8.1812e7 * 3.0 - 2 * np.pi * 900.0, omega_rf_rare=6.976e7 * 3.0,
    phi_sea=np.pi / 2, phi_rare=np.pi / 2, dipolar_scale=1e-7 * 1.054571817e-34,
    shell_scale=0.282393e-9, drive_sea=True, drive_rare=True, is_spin_three_half=False,
)


def test_ozaki_products_on_card_equal_cpu(cuda_device):
    rng = np.random.default_rng(5)
    planes = [rng.standard_normal((300, 257)) * 1e3, rng.standard_normal((300, 257)),
              rng.standard_normal((257, 130)) * 1e-4, rng.standard_normal((257, 130))]
    card = ep.cmatmul_f64(*(torch.as_tensor(p, device=cuda_device) for p in planes))
    cpu = ep.cmatmul_f64(*(torch.as_tensor(p) for p in planes))
    for g, w in zip(card, cpu):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("route", ["dense", "ozaki"])
def test_expm_routes_on_card_equal_cpu(cuda_device, route):
    m = build_model(DipolarRareParams(**_SMALL))
    t = np.linspace(0.0, 4e-4, 37)
    if route == "dense":
        card = tep.expm_propagate_traces(m.hamiltonian, m.psi0, t, m.dims, block=8, device=cuda_device)
        cpu = tep.expm_propagate_traces(m.hamiltonian, m.psi0, t, m.dims, block=8, device="cpu")
        assert np.abs(card["site_xyz"] - cpu["site_xyz"]).max() <= 1e-12
        assert np.abs(card["norm"] - 1.0).max() <= 1e-11
        return
    args = (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)
    card = tep.expm_traces_assembled_ozaki(*args, block=8, device=cuda_device)
    cpu = tep.expm_traces_assembled_ozaki(*args, block=8, device="cpu")
    assert np.abs(card[:7] - cpu[:7]).max() <= 1e-12


def test_dopri_and_lab_frame_on_card_equal_cpu(cuda_device):
    from quantumsimulations_tpu_torch.dynamics import dopri as tdop
    from quantumsimulations_tpu_torch.models import labframe as tlab

    m = build_model(DipolarRareParams(**_SMALL))
    t = np.linspace(0.0, 1e-4, 11)
    tight = dict(atol=1e-12, rtol=1e-11)
    card = tdop.dopri_propagate_traces(m.hamiltonian, m.psi0, t, m.dims, device=cuda_device, **tight)
    cpu = tdop.dopri_propagate_traces(m.hamiltonian, m.psi0, t, m.dims, device="cpu", **tight)
    assert abs(card["n_accepted"] - cpu["n_accepted"]) <= 1
    assert np.abs(card["site_xyz"] - cpu["site_xyz"]).max() <= 1e-9
    lab_kw = dict(_SMALL, n_sea=2, gamma_sea=1e5, gamma_rare=8e4, B0_sea=1.0, B0_rare=1.0,
                  B1_sea=2 * np.pi * 1e3 / 1e5, B1_rare=2 * np.pi * 1e3 / 8e4,
                  t_final=2e-4, steps=9)
    tight = dict(atol=1e-12, rtol=1e-11)  # the lab-frame tests' tolerances
    _, lab_card = tlab.simulate_lab_frame(DipolarRareParams(**lab_kw), device=cuda_device, **tight)
    _, lab_cpu = tlab.simulate_lab_frame(DipolarRareParams(**lab_kw), device="cpu", **tight)
    for key in lab_cpu:
        assert np.abs(lab_card[key] - lab_cpu[key]).max() <= 1e-9, key


def test_limb_tier_on_card_within_bound_of_f64(cuda_device):
    m = build_model(DipolarRareParams(**dict(_SMALL, n_sea=4)))
    t = np.linspace(0.0, 1e-4, 3)
    args = (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)
    limb = tcs.chebyshev_step_traces(*args, arithmetic="limb", device=cuda_device)
    f64 = tcs.chebyshev_step_traces(*args, arithmetic="f64", device=cuda_device)
    cpu = tcs.chebyshev_step_traces(*args, arithmetic="limb", device="cpu")
    assert np.abs(limb[:7] - f64[:7]).max() <= 1e-11
    assert np.abs(limb[:7] - cpu[:7]).max() <= 1e-12


def test_grid2d_on_card_equals_cpu(cuda_device, tmp_path, monkeypatch):
    """2 rows x 2 detunings through ``run_grid2d`` on the card and on the
    CPU: every saved trace within 1e-10, every metric within 1e-8 relative.
    The runner's clock advances one second per reading, so that the rows
    never share a directory (they are named to the second)."""
    import contextlib
    import datetime as real_dt
    import io
    import itertools
    import json
    import os
    import types

    from quantumsimulations_tpu_torch.sweep import runner
    from quantumsimulations_tpu_torch.sweep.grid2d import run_grid2d

    ticks = itertools.count()

    class _Clock(real_dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return real_dt.datetime(2026, 1, 2, 3, 4, 5) + real_dt.timedelta(seconds=next(ticks))

    monkeypatch.setattr(runner, "_dt", types.SimpleNamespace(datetime=_Clock))
    gamma_sea, gamma_rare = 8.1812e7, 6.976e7
    grid = dict(f_Az=gamma_sea * 3.0 / (2 * np.pi), f1A_values_Hz=[30e3, 50e3],
                gamma_sea=gamma_sea, gamma_rare=gamma_rare, n_detunings=2, n_sea=3,
                t_final=2.0, steps=200, coarse_window=10, make_plots=False)
    with contextlib.redirect_stdout(io.StringIO()):
        card = run_grid2d(**grid, out_root=str(tmp_path / "cuda"), device=cuda_device)
        cpu = run_grid2d(**grid, out_root=str(tmp_path / "cpu"), device="cpu")
    assert len(set(card)) == len(card) == 2
    for dc, dh in zip(card, cpu):
        with open(os.path.join(dc, "summary.json")) as f:
            sc = json.load(f)
        with open(os.path.join(dh, "summary.json")) as f:
            sh = json.load(f)
        assert sc["global_params"] == sh["global_params"]
        for rc, rh in zip(sc["sweep_results"], sh["sweep_results"], strict=True):
            assert list(rc) == list(rh)
            for key in rh:
                assert np.isclose(rc[key], rh[key], rtol=1e-8, atol=0.0, equal_nan=True), key
        labels = sorted(d for d in os.listdir(dh) if d.startswith("delta_"))
        assert labels == sorted(d for d in os.listdir(dc) if d.startswith("delta_"))
        assert len(labels) == 2
        for label in labels:
            for tag in ("center_off", "center_on", "shell_off"):
                name = f"time_and_obs_{tag}.npz"
                with np.load(os.path.join(dc, label, name)) as zc, \
                        np.load(os.path.join(dh, label, name)) as zh:
                    assert set(zc.files) == set(zh.files)
                    for key in zh.files:
                        assert np.abs(zc[key] - zh[key]).max() <= 1e-10, (label, tag, key)


@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A one-rank NCCL process group on this card (the port's
    ``initialize_multihost``, a file rendezvous) and its (1, 1) mesh; the
    group is destroyed after the test."""
    import torch.distributed as dist

    from quantumsimulations_tpu_torch.parallel.distributed import initialize_multihost
    from quantumsimulations_tpu_torch.parallel.mesh import make_mesh

    assert initialize_multihost(f"file://{tmp_path / 'rdv'}", 1, 0, device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        yield make_mesh(1, sp=1, device="cuda")
    finally:
        dist.destroy_process_group()


def _sweep_batch(n: int):
    """n models of the eig32 test's physics, 500 Hz apart in sea detuning."""
    kw = dict(
        n_sea=4, gamma_sea=8.1812e7, gamma_rare=6.976e7, B0_sea=3.0, B0_rare=3.0,
        B1_sea=2 * np.pi * 5e4 / 8.1812e7, B1_rare=2 * np.pi * 70710.678 / 6.976e7,
        omega_rf_rare=6.976e7 * 3.0, phi_sea=np.pi / 2, phi_rare=np.pi / 2,
        dipolar_scale=1e-7 * 1.054571817e-34, shell_scale=0.282393e-9, drive_sea=True,
        drive_rare=True, is_spin_three_half=False,
    )
    models = [build_model(DipolarRareParams(
        **kw, omega_rf_sea=8.1812e7 * 3.0 - 2 * np.pi * 500.0 * (i + 1))) for i in range(n)]
    w, V = zip(*[np.linalg.eigh(m.hamiltonian.to_dense()) for m in models])
    return (np.stack(w), np.stack(V), np.stack([m.psi0 for m in models]),
            np.linspace(0.0, 0.05, 2001), models[0].dims,
            np.asarray([m.n_sea_effective for m in models]), models[0].idx_rare)


def test_dp_sharded_sweep_on_card_equals_unsharded(nccl_mesh):
    """World size 1 over NCCL: the dp-sharded eig and eig32 rows equal the
    unsharded card rows bit for bit (dp = 1 gives the same batch and time
    chunks), and the eig32 run launches the f32 kernel."""
    from quantumsimulations_tpu_torch.parallel.sweep_shard import (
        eig_traces_assembled_sharded,
        eig_traces_assembled_sharded32,
    )

    args = _sweep_batch(5)
    np.testing.assert_array_equal(eig_traces_assembled_sharded(*args, nccl_mesh),
                                  teig.eig_traces_assembled_batched(*args, device="cuda"))
    before = launch_counts["cmatmul_f32"]
    got32 = eig_traces_assembled_sharded32(*args, nccl_mesh)
    assert launch_counts["cmatmul_f32"] > before
    np.testing.assert_array_equal(got32,
                                  teig.eig_traces_assembled_batched32(*args, device="cuda"))


def test_ext_apply_sharded_on_card_equals_single_card(nccl_mesh):
    """World size 1 over NCCL: the DR-sharded limb apply (its int32 digit
    all_reduce included) equals the single-card ext apply bit for bit."""
    from quantumsimulations_tpu_torch.ops import split_apply_ext as spx

    m = build_model(DipolarRareParams(**{**_SMALL, "n_sea": 5}))
    H = m.hamiltonian
    single, so, ops = spx.make_ext_apply(H, scale=1e-6, device="cuda")
    sharded, _, _ = spx.make_ext_apply_sharded(H, nccl_mesh.get_group("sp"), 1, scale=1e-6,
                                               device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(7)
    psi = torch.randn(2, so.DL, so.DR, generator=gen, dtype=torch.float64)
    T = ops.split((psi / psi.norm()).to("cuda"))
    torch.testing.assert_close(sharded.stacked(T), single.stacked(T), rtol=0, atol=0)
