"""The frozen least-bytes count, by hand."""
from life_bench import yardstick


def test_dsc_bytes_by_hand():
    # 1,000 coefficients: 4 (atom) + 4 (fiber) + 4 (value) each; 50 voxel
    # pointers; D 16 x 8 floats; w 20 floats; Y 50 x 8 floats
    assert yardstick.dsc_bytes(1000, 50, 20, 16, 8) == (
        12_000 + 200 + 512 + 80 + 1_600)


def test_wc_bytes_by_hand():
    assert yardstick.wc_bytes(1000, 50, 20, 16, 8) == (
        12_000 + 80 + 512 + 1_600 + 80)


def test_cohort_sums_subjects_and_counts_the_dictionary_once():
    one = yardstick.dsc_bytes(1000, 50, 20, 16, 8)
    three = yardstick.dsc_bytes(3000, 50, 20, 16, 8, subjects=3)
    assert three == 3 * one - 2 * 512


def test_bf16_storage_halves_values_and_dictionary_only():
    assert (yardstick.wc_bytes(1000, 50, 20, 16, 8)
            - yardstick.wc_bytes(1000, 50, 20, 16, 8, storage="bf16")
            == 1000 * 2 + 16 * 8 * 2)


def test_ifod1_call_is_about_0p28_gb():
    # 15.4M coefficients, Nv 250,047, Nf 500,000, Na 1,024, Ntheta 96
    b = yardstick.dsc_bytes(15_400_000, 250_047, 500_000, 1024, 96)
    assert 0.28e9 < b < 0.29e9
    assert abs(yardstick.hbm_seconds(3.35e12) - 1.0) < 1e-12
