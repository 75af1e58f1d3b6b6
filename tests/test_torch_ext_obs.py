"""Port vs reference: the int8 limb-pair observable sums (CPU).

The port's plain version ``ext_obs_diagonals_plain`` (what its wrapper runs
on a CPU tensor, and what the CUDA kernel is held against on the card) must
equal the JAX package's Pallas kernel ``ext_obs_diagonals_int8`` in
interpret mode bit for bit: int32 sums are exact in any order.  The float64
observables built on them (``_ext_site_obs_fused``) and the general-dims
reduction (``_ext_site_obs``, spin-3/2 rare spins) agree with the JAX
package's within 1e-13 (tests/test_extprec.py:312-339).
"""

from dataclasses import dataclass
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.dynamics import expm_propagator as jep
from quantumsimulations_tpu.ops import extprec as jx
from quantumsimulations_tpu.ops.pallas_kernels import ext_obs_diagonals_int8 as jkernel
from quantumsimulations_tpu_torch.dynamics import expm_propagator as tep
from quantumsimulations_tpu_torch.kernels import launches
from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing
from quantumsimulations_tpu_torch.ops import ext_obs as tobs

JJ, II, _ = jep._EXT_PAIRS


def _limbs(rng, shape):
    """Random canonical-range limbs, negative digits included, limb 0 at
    its full range [-33, 33] with both extremes present."""
    x = rng.integers(-16, 17, (15,) + shape).astype(np.int8)
    x[0] = rng.integers(-33, 34, shape)
    x[0].flat[0], x[0].flat[-1] = 33, -33
    return x


@pytest.mark.parametrize("shape,t_tile", [((16, 128), 128), ((32, 256), 128), ((16, 200), 8)])
def test_plain_equals_pallas_interpret(shape, t_tile):
    rng = np.random.default_rng(shape[0] + shape[1])
    S_re, S_im = _limbs(rng, shape), _limbs(rng, shape)
    want = np.asarray(jkernel(jnp.asarray(S_re), jnp.asarray(S_im), jnp.asarray(JJ),
                              jnp.asarray(II), n_diag=11, t_tile=t_tile, interpret=True))
    got = tobs.ext_obs_diagonals_plain(torch.from_numpy(S_re), torch.from_numpy(S_im), JJ, II, 11)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(3)
    S_re, S_im = (torch.from_numpy(_limbs(rng, (8, 40))) for _ in range(2))
    timer = StageTimer()
    with tracing(timer):
        got = tobs.ext_obs_diagonals_int8(S_re, S_im, JJ, II, n_diag=11, t_tile=128,
                                          interpret=True)
    assert not launches(timer)  # no kernel launch on the CPU
    torch.testing.assert_close(got, tobs.ext_obs_diagonals_plain(S_re, S_im, JJ, II, 11),
                               rtol=0, atol=0)
    assert got.shape == (11, 16, 40)  # R = 3*3 + 1 rounded up to 8


def test_asserts_kept():
    z = torch.zeros((15, 24, 8), dtype=torch.int8)
    with pytest.raises(AssertionError, match="power-of-two"):
        tobs.ext_obs_diagonals_int8(z, z, JJ, II, 11)
    big = torch.zeros((1, 1 << 18, 1), dtype=torch.int8)
    with pytest.raises(AssertionError, match="overflow"):
        tobs.ext_obs_diagonals_int8(big, big, JJ, II, 11)
    with pytest.raises(TypeError):
        tobs.ext_obs_diagonals_int8(z.to(torch.int32), z, JJ, II, 11)


def test_pair_table_check_of_the_cuda_path():
    assert tobs._is_triangle(JJ, II, 11)
    assert tobs._is_triangle(JJ[::-1], II[::-1], 11)  # any order: int32 sums commute
    assert not tobs._is_triangle(JJ[:-1], II[:-1], 11)
    assert not tobs._is_triangle(JJ, II, 10)


def _states(rng, dim, T):
    psis = rng.standard_normal((dim, T)) + 1j * rng.standard_normal((dim, T))
    psis /= np.linalg.norm(psis, axis=0, keepdims=True)
    return (np.array(jx.ext_split(jnp.asarray(psis.real))),
            np.array(jx.ext_split(jnp.asarray(psis.imag))))


@pytest.mark.parametrize("dims", [(2, 2, 2, 2), (2, 2, 2, 2, 2)])
def test_fused_site_obs_matches_reference(dims):
    rng = np.random.default_rng(7)
    S_re, S_im = _states(rng, int(np.prod(dims)), 128)
    xyz_j, nr_j = jep._ext_site_obs_fused(jnp.asarray(S_re), jnp.asarray(S_im), dims)
    xyz_t, nr_t = tep._ext_site_obs_fused(torch.from_numpy(S_re), torch.from_numpy(S_im), dims)
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), rtol=0, atol=1e-13)
    np.testing.assert_allclose(nr_t.numpy(), np.asarray(nr_j), rtol=0, atol=1e-13)
    np.testing.assert_allclose(nr_t.numpy(), 1.0, rtol=0, atol=1e-12)  # normalised states


@pytest.mark.parametrize("dims", [(2, 2, 2, 2), (2, 2, 2, 4), (4, 2, 2)])
def test_site_obs_matches_reference(dims):
    """The general-dims reduction, spin-3/2 sites included, and (all-spin-1/2)
    the fused path on the same limbs."""
    rng = np.random.default_rng(11)
    S_re, S_im = _states(rng, int(np.prod(dims)), 24)
    xyz_j, nr_j = jep._ext_site_obs(jnp.asarray(S_re), jnp.asarray(S_im), dims)
    xyz_t, nr_t = tep._ext_site_obs(torch.from_numpy(S_re), torch.from_numpy(S_im), dims)
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), rtol=0, atol=1e-13)
    np.testing.assert_allclose(nr_t.numpy(), np.asarray(nr_j), rtol=0, atol=1e-13)
    if all(d == 2 for d in dims):
        xyz_f, nr_f = tep._ext_site_obs_fused(torch.from_numpy(S_re), torch.from_numpy(S_im), dims)
        np.testing.assert_allclose(xyz_f.numpy(), xyz_t.numpy(), rtol=0, atol=1e-13)
        np.testing.assert_allclose(nr_f.numpy(), nr_t.numpy(), rtol=0, atol=1e-13)


# The CUDA kernel's plan and arithmetic, on the CPU.  The kernel itself runs
# only on the card (tests/test_torch_cuda_kernels.py); these check the work
# plan it follows (ext_obs_plan below restates the index formulas of
# csrc/ext_obs_diagonals.cu::ext_obs_kernel) and its Gram decomposition,
# emulated in numpy at the level of its mma operands and fragment decoding,
# against the plain version bit for bit.

#: warps of one CUDA block (THREADS / 32 in the kernel), which share a column
KERNEL_WARPS = 16


#: the most sites whose column one CUDA block holds (BLOCK_SITES in the
#: kernel); above it a column's rows are split over two blocks of a cluster
KERNEL_BLOCK_SITES = 13


@dataclass(frozen=True)
class ObsUnit:
    """One unit of the CUDA kernel's work on a column: 32 level pairs of
    ``site``, rows given as rows of the whole column.  For a stride dr >=
    16, level-0 rows in two 16-row chunks at ``a_lo`` and ``a_hi`` and
    their partners at ``b_lo``, ``b_hi`` (= + dr); for dr < 16 (``b_lo`` is
    None), the two 32-row blocks at ``a_lo`` and ``a_hi`` (= a_lo + 32),
    whose level-0 bytes and partners' the kernel compacts into A and B."""

    site: int
    dr: int
    a_lo: int
    a_hi: int
    b_lo: int | None
    b_hi: int | None


def ext_obs_plan(n_sites: int) -> dict:
    """The CUDA kernel's work plan for one column.  Up to KERNEL_BLOCK_SITES
    sites one block holds the column (``rows`` = dim); above, two blocks of
    a cluster hold a half each (``rows`` = dim / 2, block h rows h * rows ..).
    Each block runs max(1, rows / 64) units (:class:`ObsUnit`) per site, in
    site order, each warp a contiguous share of them, and each warp a share
    of the norm's 32-row blocks of the block's rows (q < max(1, rows / 32)).
    In a split column sites >= 1 pair rows inside each half, and site 0
    pairs row a of half 0 with row a of half 1: block h takes its level
    pairs 32 (u + h uk) .., reading both halves.  Positions at and above dim
    read the kernel's zero padding (a plane holds max(rows, 64) + 16
    bytes)."""
    dim = 1 << n_sites
    split = n_sites > KERNEL_BLOCK_SITES
    n_blocks = 2 if split else 1
    rows = dim // n_blocks
    per_site = max(1, rows // 64)
    blocks = []
    for h in range(n_blocks):
        r0, units = h * rows, []
        for k in range(n_sites):
            sh = n_sites - 1 - k
            dr = 1 << sh
            for u in range(per_site):
                if split and k == 0:
                    p0 = 32 * (u + h * per_site)
                    units.append(ObsUnit(k, dr, p0, p0 + 16, p0 + dr, p0 + 16 + dr))
                elif dr >= 16:
                    p0, p1 = 32 * u, 32 * u + 16
                    a0 = r0 + (((p0 >> sh) << (sh + 1)) | (p0 & (dr - 1)))
                    a1 = r0 + (((p1 >> sh) << (sh + 1)) | (p1 & (dr - 1)))
                    units.append(ObsUnit(k, dr, a0, a1, a0 + dr, a1 + dr))
                else:
                    units.append(ObsUnit(k, dr, r0 + 64 * u, r0 + 64 * u + 32, None, None))
        n_units, nb, w = len(units), max(1, rows // 32), KERNEL_WARPS
        blocks.append({
            "row0": r0,
            "units": units,
            "warp_units": [(i * n_units // w, (i + 1) * n_units // w) for i in range(w)],
            "norm_blocks": [(i * nb // w, (i + 1) * nb // w) for i in range(w)],
        })
    return {
        "dim": dim,
        "rows": rows,
        "plane_bytes": max(rows, 64) + 16,
        # rows of the whole column every read lies in (padding included)
        "column_bytes": dim if split else max(dim, 64) + 16,
        "blocks": blocks,
        "units": [u for blk in blocks for u in blk["units"]],
    }


def _block_of(plan, r):
    """(block, row in its planes) of column row ``r``."""
    h = min(r // plan["rows"], len(plan["blocks"]) - 1)
    return h, r - h * plan["rows"]


@pytest.mark.parametrize("n_sites", list(range(1, tobs.KERNEL_MAX_SITES + 1)))
def test_kernel_plan_visits_every_level_pair_and_norm_row_once(n_sites):
    plan = ext_obs_plan(n_sites)
    dim, top = plan["dim"], plan["plane_bytes"]
    assert len(plan["blocks"]) == (2 if n_sites > KERNEL_BLOCK_SITES else 1)
    for k in range(n_sites):
        dr = 1 << (n_sites - 1 - k)
        seen = np.zeros(dim, dtype=np.int64)
        for h, blk_plan in enumerate(plan["blocks"]):
            for u in (u for u in blk_plan["units"] if u.site == k):
                assert u.dr == dr
                if u.b_lo is not None:  # chunk pairs: level-0 chunks and their partners
                    assert dr >= 16 and u.b_lo == u.a_lo + dr and u.b_hi == u.a_hi + dr
                    a = np.r_[u.a_lo:u.a_lo + 16, u.a_hi:u.a_hi + 16]
                    reads = np.r_[a, a + dr]
                else:  # two 32-row blocks, pairs inside each 16-byte row
                    assert dr < 16 and u.a_hi == u.a_lo + 32 and u.a_lo % 64 == 0
                    reads = np.arange(u.a_lo, u.a_lo + 64)
                    a = reads[(reads & dr) == 0]
                # every read lies in one block's padded plane; a block reads
                # another's only for site 0 of a split column
                where = [_block_of(plan, int(r)) for r in reads]
                assert all(0 <= lr < top for _, lr in where)
                if not (len(plan["blocks"]) == 2 and k == 0):
                    assert {b for b, _ in where} == {h}
                real = a[a < dim]
                assert np.all((real & dr) == 0)  # level-0 rows only; partner = a + dr
                assert np.all(a[a >= dim] + dr >= dim)  # padding pairs with padding
                np.add.at(seen, real, 1)
        level0 = (np.arange(dim) & dr) == 0
        np.testing.assert_array_equal(seen, level0.astype(np.int64))
    rows = np.zeros(dim, dtype=np.int64)
    for blk_plan in plan["blocks"]:
        for lo, hi in blk_plan["norm_blocks"]:
            for q in range(lo, hi):
                r = blk_plan["row0"] + np.arange(32 * q, 32 * q + 32)
                np.add.at(rows, r[r < dim], 1)
    np.testing.assert_array_equal(rows, 1)


@pytest.mark.parametrize("n_sites", [1, 5, 9, 13, 14])
def test_kernel_plan_splits_units_evenly_over_warps(n_sites):
    for blk_plan in ext_obs_plan(n_sites)["blocks"]:
        ranges, n_units = blk_plan["warp_units"], len(blk_plan["units"])
        assert len(ranges) == KERNEL_WARPS and ranges[0][0] == 0 and ranges[-1][1] == n_units
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1
        sites = [{u.site for u in blk_plan["units"][lo:hi]} for lo, hi in ranges]
        assert max(len(s) for s in sites) <= 3  # a warp reduces into at most three sites


def test_kernel_plan_mirror_restates_the_kernel_source():
    # ext_obs_plan's constants and split formulas, as they stand in the .cu
    src = (Path(tobs.__file__).parent.parent / "csrc" / "ext_obs_diagonals.cu").read_text()
    for line in (f"constexpr int THREADS = {32 * KERNEL_WARPS};",
                 "constexpr int WARPS = THREADS / 32;",
                 f"constexpr int MAX_SITES = {tobs.KERNEL_MAX_SITES};",
                 f"constexpr int BLOCK_SITES = {KERNEL_BLOCK_SITES};",
                 "const bool split = n_sites > BLOCK_SITES;",
                 "const int rows = SPLIT ? dim / 2 : dim;",
                 "const int half = rank / COLS, c = rank - half * COLS;",
                 "int site_units(int dim) { return max(1, dim / 64); }",
                 "const int uk = site_units(rows), total = n_sites * uk;",
                 "const int u_begin = warp * total / WARPS, u_end = (warp + 1) * total / WARPS;",
                 "const int nb = max(1, rows / 32);",
                 "for (int u = warp * nb / WARPS; u < (warp + 1) * nb / WARPS; ++u) {",
                 "const int p0 = 32 * u, p1 = p0 + 16;",
                 "const int a0 = ((p0 >> sh) << (sh + 1)) | (p0 & (dr - 1));",
                 "load_blk(b, base, ln, a0 + dr, a1 + dr);",
                 "const int p0 = 32 * (u + half * uk), p1 = p0 + 16;",
                 "const uint32_t a_base = map_rank(base, c), b_base = map_rank(base, COLS + c);",
                 "load_blk(x, base, ln, 64 * u, 64 * u + 16);",
                 "load_blk(y, base, ln, 64 * u + 32, 64 * u + 48);",
                 "return (rows > 64 ? rows : 64) + ROW_PAD; }",
                 "constexpr int ROW_PAD = 16;"):
        assert line in src, line


_F_ROWS = [("R", j) for j in range(8)] + [("I", j) for j in range(8)]
_H_ROWS = [("R", 8), ("R", 9), ("R", 10), ("I", 8), ("I", 9), ("I", 10), ("R", 3), ("R", 7)]
_G_ROWS = [("R", j) for j in range(4)] + [("I", j) for j in range(4)]


def _emulate_kernel_column(R, I, n_sites, nd):
    """One column's (nd, 3 n + 1) sums as the CUDA kernel forms them, the
    blocks of a split column added together: R, I are (11, column_bytes)
    int64 planes of the whole column (zero at limbs >= nd and rows >= dim)."""
    plan = ext_obs_plan(n_sites)

    def blk(lo, hi):
        k = np.r_[lo:lo + 16, hi:hi + 16]
        return [np.stack([(R if p == "R" else I)[j, k] for p, j in spec])
                for spec in (_F_ROWS, _H_ROWS, _G_ROWS)]

    g = np.arange(8)[:, None]

    def self_gram(a, x):  # A rows 8-10: R8..10 against R; rows 11-13: I8..10 against I
        a_r = np.vstack([a[0][:8], np.where(g < 3, a[1], 0)])
        a_i = np.vstack([a[0][8:], np.where((g >= 3) & (g < 6), a[1], 0)])
        return a_r @ x[0][:8].T + a_i @ x[0][8:].T

    def add_sym(c, diag):
        for m in range(14):
            j = m if m < 11 else m - 3
            for col in range(8):
                if j + col < nd:
                    diag[j + col] += (2 if j >= 8 else 1) * c[m, col]

    xs, ys = np.zeros((n_sites, nd), np.int64), np.zeros((n_sites, nd), np.int64)
    gaa, norm = np.zeros((n_sites, nd), np.int64), np.zeros(nd, np.int64)
    for u in plan["units"]:
        if u.b_lo is not None:
            a = x = blk(u.a_lo, u.a_hi)
            b = blk(u.b_lo, u.b_hi)
        else:  # the kernel compacts the level-0 bytes of two blocks into one
            # K of 32; the same pairs, masked block by block here
            kk = np.arange(32)
            xs_ = [blk(lo, lo + 16) for lo in (u.a_lo, u.a_hi)]
            a = [np.hstack([m * ((kk & u.dr) == 0) for m in ms]) for ms in zip(*xs_)]
            b = [np.hstack([m[:, kk ^ u.dr] for m in ms]) for ms in zip(*xs_)]
            x = a
        c1, c2 = a[0] @ b[0][:8].T, a[0] @ b[0][8:].T
        z8 = np.zeros_like(a[1])
        c3 = np.vstack([a[1], z8]) @ b[2].T + np.vstack([z8, b[1]]) @ a[2].T
        for m in range(16):
            for col in range(8):
                s = m % 8 + col
                if s < nd:
                    if m < 8:
                        xs[u.site, s] += c1[m, col]
                        ys[u.site, s] += c2[m, col]
                    else:
                        ys[u.site, s] -= c1[m, col]
                        xs[u.site, s] += c2[m, col]
                mm = m % 8
                s = 8 + mm % 3 + col % 4
                if mm < 6 and s < nd:
                    h_im, g_im = mm >= 3, col >= 4
                    a_im, b_im = (h_im, g_im) if m < 8 else (g_im, h_im)
                    if a_im == b_im:
                        xs[u.site, s] += c3[m, col]
                    else:
                        ys[u.site, s] += c3[m, col] if b_im else -c3[m, col]
        add_sym(self_gram(a, x), gaa[u.site])
    for blk_plan in plan["blocks"]:
        for lo, hi in blk_plan["norm_blocks"]:
            for q in range(lo, hi):
                r = blk_plan["row0"] + 32 * q
                x = blk(r, r + 16)
                add_sym(self_gram(x, x), norm)
    rows = np.zeros((nd, 3 * n_sites + 1), np.int64)
    rows[:, 0:3 * n_sites:3], rows[:, 1:3 * n_sites:3] = xs.T, ys.T
    rows[:, 2:3 * n_sites:3] = (2 * gaa - norm[None, :]).T
    rows[:, 3 * n_sites] = norm
    return rows


@pytest.mark.parametrize("L,dim,T,nd", [(15, 2, 3, 11), (15, 16, 5, 11), (11, 64, 3, 11),
                                        (7, 128, 2, 7), (15, 256, 2, 11), (15, 32, 4, 4),
                                        (15, 16384, 1, 11)])
def test_kernel_gram_decomposition_equals_plain(L, dim, T, nd):
    rng = np.random.default_rng(dim + T + nd)
    x = rng.integers(-16, 17, (2, L, dim, T))
    x[:, 0] = rng.integers(-33, 34, (2, dim, T))
    x[0, :, 0, 0], x[1, :, -1, -1] = 33, -33  # every limb at its extremes somewhere
    S_re, S_im = (torch.from_numpy(v.astype(np.int8)) for v in x)
    jj, ii = zip(*[(j, s - j) for s in range(nd) for j in range(s + 1)])
    want = tobs.ext_obs_diagonals_plain(S_re, S_im, jj, ii, nd).numpy()
    n = dim.bit_length() - 1
    top = ext_obs_plan(n)["column_bytes"]
    for t in range(T):
        R, I = (np.zeros((11, top), np.int64) for _ in range(2))
        R[:nd, :dim], I[:nd, :dim] = x[0, :nd, :, t], x[1, :nd, :, t]
        got = _emulate_kernel_column(R, I, n, nd)
        np.testing.assert_array_equal(got, want[:, :3 * n + 1, t])
        assert not want[:, 3 * n + 1:, t].any()
