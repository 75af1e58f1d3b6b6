"""The frozen counts give PERF.md's bounds (one H100 SXM, dense int8
1,979 TOP/s, HBM 3.35 TB/s)."""

import math

import counts


def _h100():
    return counts.card_peaks("NVIDIA H100 80GB HBM3")


def test_ext_product_bound_is_0245_s():
    t = counts.ext_product_ops(8192, 8192, 8192) / _h100()["int8_ops_per_s"]
    assert counts.ext_pairs() == 147
    assert math.isclose(t, 0.245, rel_tol=1e-3)


def test_ozaki_real_product_bound_is_00367_s():
    t = counts.ozaki_real_product_ops(8192, 8192, 8192) / _h100()["int8_ops_per_s"]
    assert counts.ozaki_pairs() == 66
    assert math.isclose(t, 0.0367, rel_tol=1e-3)


def test_ext_obs_bound_is_11125_ms_at_the_n12_call():
    cols = counts.ext_obs_columns(20000)
    assert cols == 20480
    nbytes = counts.ext_obs_bytes(8192, cols)
    assert math.isclose(nbytes, 3.73e9, rel_tol=1e-3)
    assert math.isclose(nbytes / _h100()["hbm_bytes_per_s"] * 1e3, 1.1125, rel_tol=1e-4)


def test_chain_ops_counts_the_stage_calls():
    # one ext evolution at n12: 9 Horner steps, 17 squarings, 9 doubling passes
    ops = counts.chain_ops("ext", 8192, {"horner": 9, "squarings": 17, "doubling": 9}, 1)
    square = counts.ext_product_ops(8192, 8192, 8192)
    seeds = sum(counts.ext_product_ops(8192, 8192, 1 << k) for k in range(9))
    assert ops == 35 * square + seeds
    two = counts.chain_ops("ext", 8192, {"horner": 18, "squarings": 34, "doubling": 18}, 2)
    assert two == 2 * ops
    # Ozaki: a Horner step and a squaring are four real products each
    oz = counts.chain_ops("ozaki", 8192, {"horner": 15, "squarings": 13, "doubling": 7}, 1)
    real = counts.ozaki_real_product_ops(8192, 8192, 8192)
    assert oz == 4 * (15 + 13 + 7) * real + 4 * sum(
        counts.ozaki_real_product_ops(8192, 8192, 1 << k) for k in range(7))


def test_chain_ops_reads_nothing_without_the_chain():
    assert counts.chain_ops("ext", 8192, {"lambda": 1, "stepping": 3}, 1) is None
    assert counts.chain_ops("krylov", 8192, {"horner": 1, "squarings": 1, "doubling": 1}, 1) is None


def test_peaks_by_card_name():
    assert _h100()["part"] == "H100 SXM"
    assert counts.card_peaks("NVIDIA H100 PCIe")["part"] == "H100 PCIe"
    assert counts.card_peaks("NVIDIA H100 NVL")["part"] == "H100 NVL"
    assert counts.card_peaks("NVIDIA A100-SXM4-80GB") is None
