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
(int8 GEMMs through cuBLASLt) against the CPU, equal bit for bit; the ext
route's rows on the card against the CPU, 1e-13 (equal limbs, the float64
observable combine summed in another order); z_expectations_f32 against its
plain version, 1e-5 of the output's largest magnitude (the kernel's float32
sums against the plain version's float64 sum of the same float32 products); the matrix-free krylov and chebyshev routes on the card
against the CPU, 1e-12 (the same float64 operations, reduced in another
order).
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


@pytest.mark.parametrize("shape", [(15, 64, 200), (15, 256, 384), (11, 32, 1), (15, 2048, 130)])
def test_ext_obs_kernel_matches_plain(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1] + shape[2])
    S_re, S_im = _ext_limbs(shape, gen, cuda_device), _ext_limbs(shape, gen, cuda_device)
    before = launch_counts["ext_obs_diagonals_int8"]
    got = eo.ext_obs_diagonals_int8(S_re, S_im, JJ, II, 11)
    torch.cuda.synchronize()
    assert launch_counts["ext_obs_diagonals_int8"] == before + 1
    want = eo.ext_obs_diagonals_plain(S_re, S_im, JJ, II, 11)
    assert torch.equal(got, want)


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


@pytest.mark.parametrize(
    "n,dim,T,dtype",
    [(4, 16, 37, torch.float64), (7, 128, 2000, torch.float32), (14, 16384, 21, torch.float64),
     (16, 65536, 64, torch.float32)],
)
def test_zexp_kernel_matches_plain(cuda_device, n, dim, T, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n * dim + T)
    re, im = (torch.randn(dim, T, generator=gen, device=cuda_device, dtype=dtype)
              for _ in range(2))
    dims = (2,) * (n - 1) + (dim >> (n - 1),)
    signs = torch.as_tensor(zexp.z_sign_table(dims), device=cuda_device)
    before = launch_counts["z_expectations_f32"]
    got = zexp.z_expectations_f32(re, im, signs)
    torch.cuda.synchronize()
    assert launch_counts["z_expectations_f32"] == before + 1
    want = zexp.z_expectations_f32_plain(re, im, signs)
    assert got.dtype == torch.float32 and got.shape == (n, T)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


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
