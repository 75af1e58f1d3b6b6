"""The port's CUDA kernels on the card (skip where there is no CUDA device).

Every test here carries the ``requires_cuda`` marker.  This file imports
neither JAX nor the JAX package, so it also runs on a GPU machine without
JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Bounds: the kernel against its plain PyTorch version, 1e-5 of the output's
largest magnitude (both IEEE float32, summed in another order); the eig32
propagator against the float64 one, 2e-4 (the JAX package's bar).
"""

import numpy as np
import pytest
import torch

from quantumsimulations_tpu_torch.dynamics import eig_propagator as teig
from quantumsimulations_tpu_torch.kernels import launch_counts
from quantumsimulations_tpu_torch.models.dipolar import build_model
from quantumsimulations_tpu_torch.models.params import DipolarRareParams
from quantumsimulations_tpu_torch.ops import cmatmul as cm

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape", [(1, 128, 128, 128), (2, 64, 200, 96), (1, 300, 513, 130), (39, 128, 128, 1680)]
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
