import numpy as np
import pytest

from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.panel import assign_positions_to_grid, compress_panel, trans_rates
from quilt_tpu.utils import pack_bits_32
from quilt_tpu.kernels import FBInputs, fb_full_batched
from quilt_tpu.oracle import haploid_dosage_versus_refs, make_gl_from_reads


def setup(rng, K=90, nSNPs=333, nMaxDH=8):
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    rhb_t = pack_bits_32(haps)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(rhb_t, nSNPs, ref_error=0.001, nMaxDH=nMaxDH)
    sigma = rng.uniform(0.95, 0.999, nGrids - 1)
    trans = trans_rates(sigma)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, sim = simulate_sample_reads(
        rng, truth, pos, grid, coverage=2.0, read_length_bp=1500, phred=25
    )
    return haps, pos, grid, panel, trans, truth, reads, sim


def test_fb_kernel_matches_oracle(rng):
    haps, pos, grid, panel, trans, truth, reads, sim = setup(rng)
    assert len(panel.esc_k) > 0
    nSNPs = len(pos)
    gls = []
    oracle_res = []
    thinned = np.array([1, 4, 8])
    for h in (0, 1):
        which = np.flatnonzero(sim.labels == h)
        gl = make_gl_from_reads(reads, which, nSNPs)
        gls.append(gl)
        oracle_res.append(
            haploid_dosage_versus_refs(
                gl, panel, trans, thinned_grids=thinned, K_top_matches=5
            )
        )
    inputs = FBInputs.build(panel, trans, thinned_grids=thinned)
    gl_b = np.stack(gls).astype(np.float32)
    dosage, log_like, tv, ti = fb_full_batched(gl_b, inputs, K_top=8)
    for h in (0, 1):
        np.testing.assert_allclose(
            dosage[h], oracle_res[h].dosage, atol=2e-3
        ), f"hap {h} dosage mismatch"
        assert abs(log_like[h] - oracle_res[h].log_like) < np.abs(
            oracle_res[h].log_like
        ) * 1e-3 + 0.5
        # top matches: kernel's top-8 should contain oracle's top-5 values
        for i, g in enumerate(thinned):
            otm = oracle_res[h].top_matches[i][:5]
            otv = oracle_res[h].top_values[i][:5]
            kv = tv[g, h]
            kidx = ti[g, h]
            # best match should agree (up to ties in gamma)
            assert abs(kv[0] - otv[0]) < 1e-3
            assert set(otm[:3]).issubset(set(kidx.tolist()) | set(otm[:3][otv[:3] < kv[-1] + 1e-6]))


def test_fb_kernel_no_escapes(rng):
    haps, pos, grid, panel, trans, truth, reads, sim = setup(
        rng, K=50, nSNPs=222, nMaxDH=64
    )
    if len(panel.esc_k) > 0:
        # force no escapes by high nMaxDH
        panel = compress_panel(pack_bits_32(haps), len(pos), nMaxDH=255)
    assert len(panel.esc_k) == 0
    which = np.flatnonzero(sim.labels == 0)
    gl = make_gl_from_reads(reads, which, len(pos))
    res = haploid_dosage_versus_refs(gl, panel, trans)
    inputs = FBInputs.build(panel, trans)
    dosage, log_like, tv, ti = fb_full_batched(
        gl[None].astype(np.float32), inputs
    )
    np.testing.assert_allclose(dosage[0], res.dosage, atol=2e-3)


@pytest.mark.parametrize("K", [130, 300])
def test_fb_kernel_several_lane_pads_matches_oracle(K):
    """K spanning two and three 128-hap pads: pad haps carry no mass and
    real haps match the float64 oracle."""
    rng = np.random.default_rng(K)
    haps, pos, grid, panel, trans, truth, reads, sim = setup(
        rng, K=K, nSNPs=200, nMaxDH=16
    )
    assert len(panel.esc_k) > 0
    nSNPs = len(pos)
    gls = np.stack([
        make_gl_from_reads(reads, np.flatnonzero(sim.labels == h), nSNPs)
        for h in (0, 1)
    ]).astype(np.float32)
    inputs = FBInputs.build(panel, trans)
    assert inputs.K_pad == 128 * (-(-K // 128))
    dosage, log_like, _, _ = fb_full_batched(gls, inputs, K_top=8)
    for h in (0, 1):
        ref = haploid_dosage_versus_refs(gls[h].astype(np.float64), panel,
                                         trans)
        np.testing.assert_allclose(dosage[h], ref.dosage, atol=2e-3)
        assert abs(log_like[h] - ref.log_like) < abs(ref.log_like) * 1e-3 + 0.5


def test_fb_row_chunk_from_memory_limit():
    """Rows per FB call follow the memory limit and the row ceiling: all
    rows when they fit, fewer as the limit shrinks, never below one, and
    an even split over the fewest calls."""
    from quilt_tpu.kernels.fb_full import (
        FB_MAX_ROWS, FB_MEMORY_SHARE, FB_ROW_ARRAYS, fb_row_chunk,
    )

    G, K_pad = 512, 98304
    per_row = FB_ROW_ARRAYS * G * K_pad * 4
    limit = 60 << 30
    cap = min(int(limit * FB_MEMORY_SHARE) // per_row, FB_MAX_ROWS)
    chunk = fb_row_chunk(112, G, K_pad, limit)
    n_calls = -(-112 // chunk)
    assert chunk <= cap and n_calls == -(-112 // cap)
    assert n_calls * chunk - 112 < n_calls        # an even split
    assert fb_row_chunk(112, G, K_pad, 1) == 1
    assert fb_row_chunk(FB_MAX_ROWS, 512, 5120, 60 << 30) == FB_MAX_ROWS
    assert fb_row_chunk(7, 512, 5120, 60 << 30) == 7
    # 448 rows at K=5,120 on a 60 GiB limit: the row ceiling decides
    chunk = fb_row_chunk(448, 512, 5120, 60 << 30)
    assert chunk <= FB_MAX_ROWS and -(-448 // chunk) == -(-448 // FB_MAX_ROWS)


def test_fb_chunked_rows_equal_unchunked(rng, monkeypatch):
    """Splitting the rows into memory-sized chunks (with neutral pad rows
    in the last chunk) gives the unchunked results row for row."""
    import quilt_tpu.kernels.fb_full as fbm

    haps, pos, grid, panel, trans, truth, reads, sim = setup(rng)
    nSNPs = len(pos)
    gls = np.stack([
        make_gl_from_reads(reads, np.flatnonzero(sim.labels == h), nSNPs)
        for h in (0, 1, 0, 1, 1)
    ]).astype(np.float32)
    gls[2:] = gls[2:] ** 0.5              # rows must differ
    inputs = FBInputs.build(panel, trans, thinned_grids=np.array([1, 4, 8]))
    whole = fb_full_batched(gls, inputs, K_top=8)
    per_row = fbm.FB_ROW_ARRAYS * inputs.nGrids * inputs.K_pad * 4
    # room for exactly two rows per call: chunks of 2, 2, 1 (+1 pad row)
    monkeypatch.setattr(
        fbm, "device_bytes_limit",
        lambda: int(2 * per_row / fbm.FB_MEMORY_SHARE) + 1,
    )
    assert fbm.fb_row_chunk(5, inputs.nGrids, inputs.K_pad,
                            fbm.device_bytes_limit()) == 2
    chunked = fb_full_batched(gls, inputs, K_top=8)
    for a, b, name in zip(whole, chunked, ("dosage", "ll", "tv", "ti")):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)


def test_fb_grid_far_from_every_hap_matches_oracle(rng):
    """GLs that contradict every panel haplotype over one grid put all of
    that grid's emissions below float32's range; the log-space scaling
    keeps the FB finite and equal to the float64 oracle."""
    haps, pos, grid, panel, trans, truth, reads, sim = setup(rng)
    nSNPs = len(pos)
    gl = make_gl_from_reads(reads, np.flatnonzero(sim.labels == 0), nSNPs)
    g = 3
    snps = np.arange(32 * g, 32 * (g + 1))
    observed = rng.integers(0, 2, 32)                 # random alleles
    gl[:, snps] = 1e-10
    gl[observed, snps] = 1.0
    inputs = FBInputs.build(panel, trans)
    dosage, log_like, _, _ = fb_full_batched(
        gl[None].astype(np.float32), inputs
    )
    ref = haploid_dosage_versus_refs(gl.astype(np.float64), panel, trans)
    assert ref.log_like < -100                        # beyond exp's f32 range
    assert np.isfinite(dosage).all() and np.isfinite(log_like).all()
    np.testing.assert_allclose(dosage[0], ref.dosage, atol=2e-3)
    assert abs(log_like[0] - ref.log_like) < abs(ref.log_like) * 1e-3 + 0.5
