"""On-the-fly block-Gibbs boundary detection + composed suffix moves.

Covers the round-4 rework mirroring the reference's production behavior
(Rcpp_define_blocked_snps_using_gamma_on_the_fly,
QUILT/src/gibbs-nipt-block.cpp:311-527, invoked per block iteration at
gibbs-nipt.cpp:3009):

- device _boundaries_from_rate == NumPy oracle boundaries_from_rate
- composed suffix moves (one apply pass, original-state statistics) give
  the SAME draws and state as the sequential per-boundary loops
- nipt_block_within accepts per-row [NB, B] boundaries and reproduces the
  shared [NB] behavior when rows agree
- the live jump rate matches the oracle formula
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quilt_tpu.kernels.gibbs import (
    _block_moves_nipt,
    _block_moves_nipt_otf,
    _block_moves_pair,
    _block_moves_pair_otf,
    _boundaries_from_rate,
    _live_jump_rate,
    nipt_block_within,
)
from quilt_tpu.kernels import nipt as nipt_tables
from quilt_tpu.oracle.block_gibbs import (
    boundaries_from_rate,
    live_jump_rate,
)
from quilt_tpu.panel.prepare import smoothing_band


def test_boundaries_from_rate_oracle_vs_device(rng):
    Gm, B, NB = 97, 5, 8
    L = np.sort(rng.choice(np.arange(100, 1_000_000, 37), Gm + 1,
                           replace=False))
    W = smoothing_band(L, 5000)
    rate2 = (rng.random((Gm, B)) ** 3).astype(np.float32)
    dev = np.asarray(_boundaries_from_rate(
        jnp.asarray(rate2), tuple(jnp.asarray(x) for x in W), NB, 0.95
    ))
    assert dev.shape == (NB, B)
    for b in range(B):
        want = boundaries_from_rate(
            rate2[:, b].astype(np.float64),
            (W[0].astype(np.float64), W[1]),
            max_boundaries=NB, quantile_prob=0.95,
        )
        got = dev[:, b][dev[:, b] > 0]
        np.testing.assert_array_equal(np.sort(got), np.sort(want))


def test_boundaries_flat_rate_gives_none(rng):
    # constant smoothed rate: nothing exceeds the quantile threshold, so
    # no boundaries (the reference's "cheap out", gibbs-nipt-block.cpp:418)
    Gm, B = 63, 3
    L = np.arange(Gm + 1) * 1000
    W = smoothing_band(L, 5000)
    rate2 = np.full((Gm, B), 0.25, dtype=np.float32)
    dev = np.asarray(_boundaries_from_rate(
        jnp.asarray(rate2), tuple(jnp.asarray(x) for x in W), 8, 0.95
    ))
    assert (dev == 0).all()


def _random_state(rng, G, R, B, K, nl):
    """Random sweep state in the sampler's layouts: planes [G, B, nl, K],
    read labels/classes and grid-sorted read grids [R, B], mask [B, R]."""
    lemg = jnp.asarray(
        np.log(rng.random((G, B, nl, K)).astype(np.float32) + 0.1)
    )
    beta = jnp.asarray(rng.random((G, B, nl, K)).astype(np.float32) + 0.05)
    alphas = jnp.asarray(rng.random((G, B, nl, K)).astype(np.float32) + 0.05)
    H = jnp.asarray(rng.integers(0, nl, (R, B)).astype(np.int32))
    Hc = jnp.asarray(rng.integers(0, 8, (R, B)).astype(np.int32))
    wif0_r = jnp.asarray(
        np.sort(rng.integers(0, G, (B, R)), axis=1).T.astype(np.int32)
    )
    read_mask = jnp.asarray(rng.random((B, R)) < 0.7)
    return lemg, beta, alphas, H, Hc, wif0_r, read_mask


def test_pair_composed_equals_sequential(rng):
    G, R, B, K, nl = 24, 40, 4, 16, 2
    lemg, beta, alphas, H, _, wif0_r, _ = _random_state(
        rng, G, R, B, K, nl
    )
    NB = 5
    bnd = np.array([0, 3, 7, 15, 21], dtype=np.int32)
    u = jnp.asarray(rng.random((NB, B)).astype(np.float32))
    seq = _block_moves_pair(
        lemg, beta, alphas, H, jnp.asarray(bnd), u, wif0_r
    )
    bnd_rb = jnp.broadcast_to(jnp.asarray(bnd)[:, None], (NB, B))
    comp = _block_moves_pair_otf(lemg, beta, alphas, H, bnd_rb, u, wif0_r)
    for s, c, name in zip(seq, comp, ("lemg", "beta", "alphas", "H")):
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(c), rtol=1e-5, atol=1e-6,
            err_msg=name,
        )


def test_nipt_composed_equals_sequential(rng):
    G, R, B, K, nl = 24, 40, 4, 16, 3
    lemg, beta, alphas, H, Hc, wif0_r, read_mask = _random_state(
        rng, G, R, B, K, nl
    )
    NB = 5
    bnd = np.array([0, 3, 7, 15, 21], dtype=np.int32)
    u = jnp.asarray(rng.random((NB, B)).astype(np.float32))
    K_real = 13
    ff = 0.2
    clp = jnp.asarray(nipt_tables.class_log_p(ff).astype(np.float32))
    perm_mask = jnp.ones(6, jnp.float32)
    seq = _block_moves_nipt(
        lemg, beta, alphas, H, Hc, jnp.asarray(bnd), u, wif0_r, read_mask,
        K_real, clp, perm_mask,
    )
    bnd_rb = jnp.broadcast_to(jnp.asarray(bnd)[:, None], (NB, B))
    comp = _block_moves_nipt_otf(
        lemg, beta, alphas, H, Hc, bnd_rb, u, wif0_r, read_mask, K_real,
        clp, perm_mask,
    )
    for s, c, name in zip(
        seq, comp, ("lemg", "beta", "alphas", "H", "Hc")
    ):
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(c), rtol=1e-5, atol=1e-6,
            err_msg=name,
        )


def test_within_per_row_matches_shared(rng):
    G, B, K, R = 16, 3, 12, 20
    lemg = jnp.asarray(
        np.log(rng.random((G, B, 3, K)).astype(np.float32) + 0.1)
    )
    beta = jnp.asarray(rng.random((G, B, 3, K)).astype(np.float32) + 0.05)
    H = jnp.asarray(rng.integers(0, 3, (R, B)).astype(np.int32))
    Hc = jnp.asarray(rng.integers(0, 8, (R, B)).astype(np.int32))
    wif0 = jnp.asarray(
        np.sort(rng.integers(0, G, (B, R)), axis=1).astype(np.int32)
    )
    read_mask = jnp.asarray(rng.random((B, R)) < 0.8)
    log_em = jnp.asarray(
        np.log(rng.random((B, K, R)).astype(np.float32) + 0.05)
    )
    trans = jnp.asarray(
        np.stack([np.full(G, 0.97), np.full(G, 0.03)], axis=1)
        .astype(np.float32)
    )
    NB = 4
    bnd = np.array([0, 4, 9, 13], dtype=np.int32)
    block_u = jnp.asarray(rng.random((NB, 3, B)).astype(np.float32))
    ff = 0.15
    clp = jnp.asarray(nipt_tables.class_log_p(ff).astype(np.float32))
    rlc = jnp.asarray(nipt_tables.make_rlc(ff).astype(np.float32))
    perm_mask = jnp.ones(6, jnp.float32)
    out1 = nipt_block_within(
        lemg, beta, H, Hc, wif0, read_mask, log_em, trans,
        jnp.asarray(bnd), block_u, clp, perm_mask, rlc, 10,
    )
    bnd_rb = jnp.broadcast_to(jnp.asarray(bnd)[:, None], (NB, B))
    out2 = nipt_block_within(
        lemg, beta, H, Hc, wif0, read_mask, log_em, trans,
        bnd_rb, block_u, clp, perm_mask, rlc, 10,
    )
    for a, b, name in zip(
        out1, out2, ("lemg", "beta", "alphas", "H", "Hc")
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7,
            err_msg=name,
        )


def test_live_jump_rate_padded_vs_oracle(rng):
    G, B, K, nl = 12, 2, 8, 2
    lemg = np.log(rng.random((G, B, nl, K)).astype(np.float32) + 0.1)
    beta = rng.random((G, B, nl, K)).astype(np.float32) + 0.05
    alphas = rng.random((G, B, nl, K)).astype(np.float32) + 0.05
    trans_t = np.stack(
        [np.full(G, 0.96), np.full(G, 0.04)]
    ).astype(np.float32)
    trans_t[:, 0] = (1.0, 0.0)
    prior = jnp.asarray([0.5, 0.5], jnp.float32)
    dev = np.asarray(_live_jump_rate(
        jnp.asarray(alphas), jnp.asarray(beta), jnp.asarray(lemg),
        jnp.asarray(trans_t.T), prior, K,
    ))                                                  # [G-1, B]
    for b in range(B):
        # oracle layout [nl, K, G]; relative emissions match the kernel's
        # per-(grid,row) max-shift up to scale, which the rate is
        # invariant to
        a_o = np.stack([alphas[:, b, h, :].T for h in range(nl)])
        b_o = np.stack([beta[:, b, h, :].T for h in range(nl)])
        e_o = np.stack([np.exp(lemg[:, b, h, :]).T for h in range(nl)])
        want = live_jump_rate(
            a_o, b_o, e_o, trans_t[:, 1:], include3=True
        )
        np.testing.assert_allclose(dev[:, b], want, rtol=2e-4, atol=2e-5)


def test_engine_otf_block_gibbs_smoke(rng):
    """End-to-end: default gamma detection through the batched engine."""
    from quilt_tpu.config import ImputeConfig
    from quilt_tpu.engine import quilt_impute
    from quilt_tpu.io import simulate_panel, simulate_sample_reads
    from quilt_tpu.io.simulate import simulate_truth_mosaic
    from quilt_tpu.panel.prepare import (
        PreparedReference, assign_positions_to_grid, compress_panel,
        trans_rates,
    )
    from quilt_tpu.utils import unpack_bits_32

    K, nSNPs = 60, 512
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=240_000)
    from quilt_tpu.utils.bits import pack_bits_32
    rhb_t = pack_bits_32(haps)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(rhb_t, nSNPs, nMaxDH=63)
    sigma = np.full(nGrids - 1, 0.98)
    prep = PreparedReference(
        chrom="chr20", pos=pos,
        ref_allele=np.array(["A"] * nSNPs),
        alt_allele=np.array(["G"] * nSNPs),
        rhb_t=rhb_t, af=haps.mean(axis=0), grid=grid,
        L_grid=np.asarray(L_grid),
        cM_grid=np.asarray(L_grid, dtype=np.float64) * 1e-6,
        sigma=sigma, panel=panel,
        regionStart=None, regionEnd=None, buffer=0, nGen=100,
        ref_error=0.001,
    )
    truths, samples = [], []
    for _ in range(2):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        reads, _ = simulate_sample_reads(
            rng, truth, pos, grid, coverage=1.5, read_length_bp=300,
            phred=25,
        )
        truths.append(truth)
        samples.append(reads)
    cfg = ImputeConfig(
        nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
        small_ref_panel_gibbs_iterations=8, seed=3, sample_batch=2,
        override_default_params_for_small_ref_panel=False,
    )
    assert cfg.block_gibbs_boundary_detection == "gamma"
    out = quilt_impute(prep, samples, ["S0", "S1"], cfg)
    for i in range(2):
        ds = out.results[i].dosage
        tg = truths[i].sum(axis=0)
        r2 = np.corrcoef(ds, tg)[0, 1] ** 2
        assert r2 > 0.8, r2


def test_edge_peak_run_cascade(rng):
    """A run whose maximum sits at the run edge: the reference greedy
    (gibbs-nipt-block.cpp:440-470) clears only the peak's ±1
    neighborhood, so lower peaks of the same run are also kept — both
    the NumPy greedy oracle and the multi-pass device detector emit the
    cascade (VERDICT r4 item 7)."""
    from quilt_tpu.oracle.block_gibbs import greedy_peak_boundaries

    Gm = 63
    smoothed = np.full(Gm, 0.001)
    # monotone decreasing run of 6 gaps starting at index 20: max at the
    # run's left edge -> stride-2 cascade 20, 22, 24
    smoothed[20:26] = [0.9, 0.8, 0.7, 0.6, 0.5, 0.4]
    # interior-peaked run at 40..44: exactly one boundary at its max
    smoothed[40:45] = [0.3, 0.5, 0.95, 0.5, 0.3]
    thresh = 0.1
    got = greedy_peak_boundaries(smoothed.copy(), thresh)
    assert got.tolist() == [21, 23, 25, 43], got
    # device multi-pass detector on the same field (identity smoothing)
    band = np.ones((Gm, 1), np.float32)
    idx0 = np.arange(Gm, dtype=np.int64)
    rate2 = np.tile(smoothed[:, None], (1, 2)).astype(np.float32)
    # quantile such that thresh ~ 0.1: choose prob so sorted[v] ~ 0.1;
    # with 9 hot gaps of 63, prob=0.85 -> v=53 -> value 0.001... build
    # the field so the quantile lands between 0.001 and 0.3
    dev = np.asarray(_boundaries_from_rate(
        jnp.asarray(rate2), (jnp.asarray(band), jnp.asarray(idx0)),
        NB=8, quantile_prob=0.85,
    ))
    for b in range(2):
        got_dev = sorted(x for x in dev[:, b].tolist() if x > 0)
        assert got_dev == [21, 23, 25, 43], got_dev


def test_pse_parity_hot_map(rng, tmp_path):
    """Phasing accuracy on a hot recombination map: the pass-limited
    device cascade detector vs the uncapped greedy oracle boundaries
    (static injection of the greedy result) reach comparable PSE
    (VERDICT r4 item 7 'PSE parity shown')."""
    from quilt_tpu.config import ImputeConfig
    from quilt_tpu.engine import quilt_impute
    from quilt_tpu.io import simulate_panel, simulate_sample_reads
    from quilt_tpu.io.simulate import simulate_truth_mosaic
    from quilt_tpu.panel import prepare_panel
    from quilt_tpu.out.metrics import calculate_pse

    K, nSNPs = 120, 2048
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    # hot map: several recombination hotspots (10x background rate)
    rate = np.full(nSNPs, 1.0)
    for h0 in (300, 700, 1100, 1500, 1900):
        rate[h0:h0 + 60] = 15.0
    cm = np.cumsum(rate) * 2e-5
    prep = prepare_panel(
        chrom="chr20", pos=pos,
        ref_allele=np.array(["A"] * nSNPs),
        alt_allele=np.array(["G"] * nSNPs),
        haps=haps, nMaxDH=64, gmap_pos=pos, gmap_cm=cm, nGen=1000,
    )
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(
        rng, truth, pos, prep.grid, coverage=4.0, read_length_bp=600,
        phred=28,
    )
    pses = {}
    for mode in ("gamma", "map"):
        cfg = ImputeConfig(
            nGibbsSamples=3, n_seek_its=2, Ksubset=80, Knew=80,
            small_ref_panel_gibbs_iterations=12, seed=7,
            block_gibbs_boundary_detection=mode,
            override_default_params_for_small_ref_panel=False,
        )
        out = quilt_impute(prep, [reads], ["S0"], cfg)
        res = out.results[0]
        pse = calculate_pse(res.phased_haps[:2].T, truth.T)
        pses[mode] = pse["pse"]
    # both detectors must phase the hot map well and agree closely
    # (0.08: chain trajectories are seeded but XLA:CPU reduction order
    # varies run to run, so PSE jitters by a few switch events)
    assert pses["gamma"] < 0.1, pses
    assert abs(pses["gamma"] - pses["map"]) < 0.08, pses
