"""Full benchmark table on one GPU: FB, Gibbs sweep, and end-to-end
samples/s. Prints the table as JSON (with the device it ran on); `bench.py`
times the FB alone.

Workload: QUILT quick-start-like scale — K=5120 panel haplotypes,
nSNPs=16384 (512 grids), Ksubset=600, 7 chains x 3 seek its, N=8 samples
at ~1x coverage. End-to-end timing excludes compilation (first batch
warms the kernels; the timed run reuses them), as in production where one
region's compiles amortize over thousands of samples.
"""
import json
import os
import time

import numpy as np

from quilt_tpu.io.simulate import fast_packed_panel


def _timed(fn, reps):
    """(seconds of the first call, mean seconds of `reps` later calls),
    each call ended by jax.block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return first, (time.perf_counter() - t0) / reps


def reference_cells_per_s():
    return _baseline("reference_cells_per_s")


def _baseline(key):
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BASELINE_MEASURED.json")) as fh:
            return float(json.load(fh)[key])
    except (OSError, KeyError, ValueError):
        return None


def main():
    import jax
    from quilt_tpu.config import ImputeConfig
    from quilt_tpu.engine import quilt_impute
    from quilt_tpu.engine.sample import RegionContext
    from quilt_tpu.io import simulate_sample_reads
    from quilt_tpu.io.simulate import simulate_truth_mosaic
    from quilt_tpu.panel.prepare import (
        PreparedReference, compress_panel, trans_rates,
        assign_positions_to_grid,
    )
    from quilt_tpu.utils import unpack_bits_32

    from quilt_tpu.utils.device import describe_device

    rng = np.random.default_rng(0)
    results = {"device": describe_device()}

    # ---------------- FB kernel (same as bench.py) ----------------
    from quilt_tpu.kernels import FBInputs, fb_full_batched
    import jax.numpy as jnp

    K, nSNPs_fb, B = 5120, 65536, 28
    rhb_t = fast_packed_panel(rng, K, nSNPs_fb // 32)
    nGrids_fb = nSNPs_fb // 32
    panel_fb = compress_panel(rhb_t, nSNPs_fb, nMaxDH=255)
    trans_fb = trans_rates(np.full(nGrids_fb - 1, 0.99))
    inputs = FBInputs.build(panel_fb, trans_fb,
                            thinned_grids=np.arange(0, nGrids_fb, 10))
    gl = jnp.asarray(
        rng.uniform(0.05, 1.0, (B, 2, nSNPs_fb)).astype(np.float32)
    )
    _, dt = _timed(
        lambda: fb_full_batched(gl, inputs, K_top=8, return_arrays=False), 6
    )
    results["fb_kernel"] = {
        "cells_per_s": 2.0 * B * K * nGrids_fb / dt,
        "K": K, "nGrids": nGrids_fb, "B": B, "seconds": dt,
        "vs_measured_ref_core": 2.0 * B * K * nGrids_fb / dt
        / reference_cells_per_s(),
    }

    # ---------------- sharded-FB bodies -------------------------------
    # single-chip throughput of the two shard_map bodies: the segment-
    # fused body (one psum per SEG_LEN grids; dist/mesh.py default) vs
    # the per-grid-psum body. Sharded equality is covered by
    # tests/test_dist_sharded.py on the CPU mesh.
    from quilt_tpu.kernels.fb_full import (
        SEG_LEN, _fb_core_impl, _fb_core_segmented,
    )
    import functools as _ft
    dev_fb = inputs.device()
    fb_args = (gl, dev_fb["dh"], dev_fb["ie"], dev_fb["dh_bits"],
               dev_fb["esc_grid"], dev_fb["esc_k"], dev_fb["esc_bits"],
               dev_fb["trans"], dev_fb["thin_flag"], dev_fb["capture_flag"])
    fb_kw = dict(K=inputs.K, K_pad=inputs.K_pad, nMaxDH=inputs.nMaxDH,
                 nnz=inputs.nnz, K_top=8, ref_error=0.001)
    cells_body = 2.0 * B * K * nGrids_fb
    results["sharded_fb_body"] = {"seg_len": SEG_LEN,
                                  "collectives_per_grid_pergrid": 4.0,
                                  "collectives_per_grid_segmented":
                                  round(3.0 / SEG_LEN + 1.0 / nGrids_fb, 3)}
    for name, body in (("pergrid", _fb_core_impl),
                       ("segmented", _fb_core_segmented)):
        f = _ft.partial(
            jax.jit(body, static_argnames=tuple(fb_kw)), **fb_kw
        )
        _, dtb = _timed(lambda: f(*fb_args), 3)
        results["sharded_fb_body"][name] = {
            "cells_per_s": cells_body / dtb, "seconds": dtb,
        }

    # ---------------- FB at the biobank panel (K=98,304) ----------------
    # one call at B=16 rows; fb_full_batched splits rows into chunks sized
    # from the device's memory limit
    results["fb_kernel_K98304"] = {}
    K_big, G_big = 98304, 512
    panel_big = compress_panel(
        fast_packed_panel(rng, K_big, G_big), G_big * 32, nMaxDH=255
    )
    in_big = FBInputs.build(
        panel_big, trans_rates(np.full(G_big - 1, 0.99)),
        thinned_grids=np.arange(0, G_big, 10),
    )
    gl_big = jnp.asarray(
        rng.uniform(0.05, 1.0, (16, 2, in_big.S)).astype(np.float32)
    )
    _, dtb = _timed(
        lambda: fb_full_batched(gl_big, in_big, K_top=8, return_arrays=False),
        3,
    )
    cells_b = 2.0 * 16 * K_big * G_big
    results["fb_kernel_K98304"] = {
        "cells_per_s": cells_b / dtb, "K": K_big, "nGrids": G_big,
        "B": 16, "seconds": dtb,
        "vs_measured_ref_core": cells_b / dtb / reference_cells_per_s(),
    }
    in_big = panel_big = gl_big = None

    # ---------------- end-to-end engine (batched) ------------------------
    nSNPs = 16384
    K_panel = 5120
    rhb_small = rhb_t[:K_panel, : nSNPs // 32]
    haps = unpack_bits_32(rhb_small, nSNPs)
    pos = np.arange(1, nSNPs + 1, dtype=np.int64) * 60   # ~1 Mb
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(rhb_small, nSNPs, nMaxDH=255)
    cm = np.asarray(L_grid, dtype=np.float64) * 1e-6   # 1 cM/Mb
    sigma = np.full(nGrids - 1, 0.99)
    prep = PreparedReference(
        chrom="chr20", pos=pos,
        ref_allele=np.array(["A"] * nSNPs),
        alt_allele=np.array(["G"] * nSNPs),
        rhb_t=rhb_small, af=haps.mean(axis=0), grid=grid,
        L_grid=np.asarray(L_grid), cM_grid=cm, sigma=sigma, panel=panel,
        regionStart=None, regionEnd=None, buffer=0, nGen=100,
        ref_error=0.001,
    )
    N = int(os.environ.get("QUILT_BENCH_N", "32"))   # batch-scaling knob
    samples = []
    n_reads_total = 0
    for i in range(N):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        reads, _ = simulate_sample_reads(
            rng, truth, pos, grid, coverage=1.0, read_length_bp=600,
            phred=25,
        )
        samples.append(reads)
        n_reads_total += reads.nReads
    cfg = ImputeConfig(
        nGibbsSamples=7, n_seek_its=3, Ksubset=600, Knew=600,
        small_ref_panel_gibbs_iterations=20, seed=1, sample_batch=N,
        override_default_params_for_small_ref_panel=False,
        make_plots=False,
    )
    names = [f"S{i}" for i in range(N)]
    quilt_impute(prep, samples, names, cfg)            # warm-up (compiles)
    t0 = time.time()
    out2 = quilt_impute(prep, samples, names, cfg)
    dt = time.time() - t0
    ref_sps = _baseline("samples_per_s_core")
    results["end_to_end"] = {
        "samples_per_s": N / dt,
        "reads_per_s": n_reads_total / dt,
        "snps_per_s": N * nSNPs / dt,
        "seconds_for_N_samples": dt,
        "N": N,
        "n_reads_total": n_reads_total,
        "nSNPs": nSNPs, "K_panel": K_panel,
        "config": "7 chains x 3 seek its x 21 sweeps, Ksubset=600",
        "vs_measured_ref_core": (N / dt) / ref_sps if ref_sps else None,
    }
    # per-stage wall-time breakdown: rerun the same
    # workload with section timers + stage-boundary drains enabled
    from dataclasses import replace as dc_replace
    cfg_t = dc_replace(cfg, print_extra_timing_information=True)
    out_t = quilt_impute(prep, samples, names, cfg_t)
    results["end_to_end"]["stage_breakdown_s"] = {
        k: round(v["seconds"], 3)
        for k, v in (out_t.timing or {}).items()
    }

    # ---------------- end-to-end, QUILT2 path (mspbwt selection) --------
    from quilt_tpu.panel.mspbwt import build_mspbwt_indices
    prep.ms_indices = build_mspbwt_indices(panel.hapMatcher)
    cfg2 = dc_replace(cfg, use_mspbwt=True)
    quilt_impute(prep, samples, names, cfg2)           # warm-up
    t0 = time.time()
    quilt_impute(prep, samples, names, cfg2)
    dt2 = time.time() - t0
    results["end_to_end_quilt2"] = {
        "samples_per_s": N / dt2,
        "seconds_for_N_samples": dt2,
        "N": N,
        "config": "QUILT2 path: mspbwt selection, same shapes",
        "vs_measured_ref_core": (N / dt2) / ref_sps if ref_sps else None,
    }
    prep.ms_indices = None

    # ---------------- NIPT end-to-end (BASELINE config 3) ---------------
    # triploid cfDNA imputation, ff=0.2, measured against the triploid
    # reference core (bench_ref/gibbs_ref_bench e2e3)
    ref_sps_nipt = _baseline("samples_per_s_core_nipt")
    samples_nipt = []
    for i in range(N):
        truth3 = simulate_truth_mosaic(rng, haps, n_latent=3)
        r3, _ = simulate_sample_reads(
            rng, truth3, pos, grid, coverage=1.0, read_length_bp=600,
            phred=25, ff=0.2,
        )
        samples_nipt.append(r3)
    cfg_nipt = dc_replace(cfg, method="nipt")
    ff_arr = np.full(N, 0.2)
    quilt_impute(prep, samples_nipt, names, cfg_nipt, ff_values=ff_arr)
    t0 = time.time()
    quilt_impute(prep, samples_nipt, names, cfg_nipt, ff_values=ff_arr)
    dtn = time.time() - t0
    results["end_to_end_nipt"] = {
        "samples_per_s": N / dtn,
        "seconds_for_N_samples": dtn,
        "N": N, "ff": 0.2, "K_panel": K_panel,
        "config": "triploid mother+fetus, 7 chains x 3 seek its",
        "vs_measured_ref_core": (
            (N / dtn) / ref_sps_nipt if ref_sps_nipt else None
        ),
    }

    # ---------------- ONT end-to-end (BASELINE config 4) ----------------
    # long high-error reads (reference README.md:28); denominator is the
    # same-shape reference core (J~100 SNPs/read, 10% error)
    ref_sps_ont = _baseline("samples_per_s_core_ont")
    samples_ont = []
    for i in range(N):
        trutho = simulate_truth_mosaic(rng, haps, n_latent=2)
        ro, _ = simulate_sample_reads(
            rng, trutho, pos, grid, coverage=1.0, read_length_bp=6000,
            phred=10,
        )
        samples_ont.append(ro)
    quilt_impute(prep, samples_ont, names, cfg)
    t0 = time.time()
    quilt_impute(prep, samples_ont, names, cfg)
    dto = time.time() - t0
    results["end_to_end_ont"] = {
        "samples_per_s": N / dto,
        "seconds_for_N_samples": dto,
        "N": N, "K_panel": K_panel,
        "mean_snps_per_read": float(np.mean(
            [np.diff(r.offsets).mean() for r in samples_ont]
        )),
        "config": "ONT-shaped: ~6kb reads at 10% error, 1x coverage",
        "vs_measured_ref_core": (
            (N / dto) / ref_sps_ont if ref_sps_ont else None
        ),
    }

    # ---------------- HLA typing wall time (BASELINE config 5) ----------
    # synthetic IMGT-style world (the in-environment maximum: no IPD-IMGT
    # release or real BAMs without network); wall time covers the full
    # per-sample pipeline — gamma-capture QUILT run + kmer filtering +
    # per-allele read likelihoods + combination. No reference denominator
    # (the reference HLA path shells out to samtools and needs the real
    # database); recorded as absolute wall time.
    from quilt_tpu.hla import (
        HLAGene, prepare_hla_reference, simulate_hla_db, type_hla_sample,
    )
    from quilt_tpu.hla.db import BASES as _BASES, alleles_at_positions
    from quilt_tpu.hla.typing import GeneRead
    from quilt_tpu.engine.sample import (
        RegionContext as _RC, impute_one_sample as _i1s,
    )
    from quilt_tpu.panel import prepare_panel
    gene = HLAGene("HLA-A", "chr6", 10_001, 16_000)
    db = simulate_hla_db(rng, gene, n_alleles=40, n_variant_sites=400)
    var_sites = np.flatnonzero((db.seqs != db.seqs[0][None, :]).any(axis=0))
    pos_h = gene.start + var_sites.astype(np.int64)
    ref_h = np.array([_BASES[b] for b in db.seqs[0, var_sites]])
    alt_h = []
    for s in var_sites:
        col = db.seqs[:, s]
        others = col[col != db.seqs[0, s]]
        alt_h.append(_BASES[others[0]])
    alt_h = np.array(alt_h)
    K_h = 200
    hap_allele = rng.integers(0, db.n_alleles, K_h)
    states_h, _ = alleles_at_positions(db, pos_h, ref_h, alt_h)
    haps_h = np.zeros((K_h, len(pos_h)), dtype=np.uint8)
    for k in range(K_h):
        haps_h[k] = np.where(states_h[hap_allele[k]] == 1, 1, 0)
    prep_h = prepare_panel(
        chrom="chr6", pos=pos_h, ref_allele=ref_h, alt_allele=alt_h,
        haps=haps_h, nMaxDH=64,
    )
    hla_ref = prepare_hla_reference(db, prep_h, k=10)
    true_a = (1, 3)
    truth_h = np.stack([
        np.where(states_h[true_a[0]] == 1, 1, 0),
        np.where(states_h[true_a[1]] == 1, 1, 0),
    ]).astype(np.uint8)
    reads_imp, _ = simulate_sample_reads(
        rng, truth_h, prep_h.pos, prep_h.grid, coverage=2.0,
        read_length_bp=400, phred=28,
    )
    L = 150
    gene_reads = []
    for r in range(200):
        a = true_a[r % 2]
        start = int(rng.integers(0, gene.length - L))
        seq = db.seqs[a, start:start + L].copy()
        err = rng.random(L) < 0.01
        seq = np.where(err, (seq + 1) % 4, seq).astype(np.uint8)
        gene_reads.append(GeneRead(
            pos0=gene.start - 1 + start, seq=seq, qual=np.full(L, 30),
        ))
    cfg_h = ImputeConfig(
        nGibbsSamples=7, n_seek_its=2, Ksubset=K_h, Knew=K_h,
        small_ref_panel_gibbs_iterations=20, hla_run=True,
        gamma_physically_closest_to=(gene.start + gene.end) // 2,
        override_default_params_for_small_ref_panel=False, seed=5,
    )
    ctx_h = _RC.build(prep_h, cfg_h)
    res_imp = _i1s(ctx_h, reads_imp, cfg_h, seed=11)       # warm-up
    t0 = time.time()
    res_imp = _i1s(ctx_h, reads_imp, cfg_h, seed=11)
    res_t = type_hla_sample(
        hla_ref, gene_reads, gammas=res_imp.hla_gamma_total
    )
    dth = time.time() - t0
    expected_h = {db.allele_names[true_a[0]], db.allele_names[true_a[1]]}
    results["hla_typing"] = {
        "seconds_per_sample": dth,
        "n_gene_reads": len(gene_reads), "n_alleles": db.n_alleles,
        "K_panel": K_h,
        "call_correct": {res_t.bestallele1, res_t.bestallele2} == expected_h,
        "config": (
            "synthetic IMGT-style world; full pipeline: gamma-capture "
            "QUILT run + kmer filter + per-allele read likelihoods + "
            "combination"
        ),
    }

    # ---------------- end-to-end at UKB panel scale (K~100k) ------------
    # the reference's headline claim is "hundreds of thousands or millions
    # of haplotypes" (reference README.md:33); this measures the full
    # engine at K=98304 on one card, QUILT1 (full-panel FB selection) and
    # QUILT2 (planes-mspbwt selection), against the same-K measured
    # reference core (bench_ref/gibbs_ref_bench e2e ... 98304)
    K_big = 98304
    rhb_100k = fast_packed_panel(rng, K_big, nSNPs // 32)
    panel_100k = compress_panel(rhb_100k, nSNPs, nMaxDH=255)
    prep_100k = PreparedReference(
        chrom="chr20", pos=pos,
        ref_allele=np.array(["A"] * nSNPs),
        alt_allele=np.array(["G"] * nSNPs),
        rhb_t=rhb_100k, af=unpack_bits_32(rhb_100k[:2048], nSNPs).mean(0),
        grid=grid, L_grid=np.asarray(L_grid), cM_grid=cm, sigma=sigma,
        panel=panel_100k, regionStart=None, regionEnd=None, buffer=0,
        nGen=100, ref_error=0.001,
    )
    N_big = 8
    samples_big = samples[:N_big]
    cfg_big = dc_replace(cfg, sample_batch=N_big)
    names_big = names[:N_big]
    ref_sps_100k = _baseline("samples_per_s_core_K98304")
    quilt_impute(prep_100k, samples_big, names_big, cfg_big)   # warm-up
    t0 = time.time()
    quilt_impute(prep_100k, samples_big, names_big, cfg_big)
    dt = time.time() - t0
    results["end_to_end_K100k"] = {
        "samples_per_s": N_big / dt,
        "seconds_for_N_samples": dt,
        "N": N_big, "K_panel": K_big,
        "config": "QUILT1 path, full-panel FB selection, same shapes",
        "vs_measured_ref_core_same_K": (
            (N_big / dt) / ref_sps_100k if ref_sps_100k else None
        ),
    }
    from quilt_tpu.panel.mspbwt import build_mspbwt_indices as _bmi
    t0 = time.time()
    prep_100k.ms_indices = _bmi(panel_100k.hapMatcher)
    ms_build_s = time.time() - t0
    cfg_big2 = dc_replace(cfg_big, use_mspbwt=True)
    quilt_impute(prep_100k, samples_big, names_big, cfg_big2)  # warm-up
    t0 = time.time()
    quilt_impute(prep_100k, samples_big, names_big, cfg_big2)
    dt2 = time.time() - t0
    results["end_to_end_K100k_quilt2"] = {
        "samples_per_s": N_big / dt2,
        "seconds_for_N_samples": dt2,
        "N": N_big, "K_panel": K_big,
        "mspbwt_build_seconds": ms_build_s,
        "config": "QUILT2 path: planes-mspbwt selection, same shapes",
        "vs_measured_ref_core_same_K": (
            (N_big / dt2) / ref_sps_100k if ref_sps_100k else None
        ),
    }
    prep_100k = None
    rhb_100k = None
    panel_100k = None

    # ---------------- Gibbs sweep alone -------------------------------
    from quilt_tpu.engine.sample import RegionContext as RC
    from quilt_tpu.kernels import PaddedReads
    from quilt_tpu.kernels.gibbs import GibbsInputs, run_gibbs_chains
    from quilt_tpu.kernels.common import pad_to_multiple, unpack_bits_device

    reads0 = samples[0].sorted_by_grid()
    trans = trans_rates(prep.sigma)
    ginputs = GibbsInputs.build(reads0, trans, nGrids)
    preads = PaddedReads.build(reads0, ref_error=0.001)
    C = 7
    n_its = 21
    Ksub = 600
    Kp = pad_to_multiple(Ksub, 128)
    which = np.sort(rng.choice(K_panel, Ksub, replace=False))
    sub = rhb_small[which]
    sub = np.concatenate(
        [sub, np.repeat(sub[:1], Kp - Ksub, axis=0)], axis=0
    )
    import jax.numpy as jnp
    # device-resident PACKED inputs (as the engine holds them)
    bits1_dev = jnp.asarray(sub)
    bits = jax.device_put(
        jnp.broadcast_to(bits1_dev[None], (C, Kp, nGrids))
    ).block_until_ready()
    uniforms = jnp.asarray(
        rng.random((n_its, C, ginputs.R)).astype(np.float32)
    )
    H0 = jnp.asarray(rng.choice(2, size=(C, ginputs.R)).astype(np.int32))
    first = rng.integers(0, reads0.nReads, C).astype(np.int32)
    args = dict(
        bits=bits, preads=preads, inputs=ginputs, uniforms=uniforms,
        H0=H0, first_read=first, n_latent=2, ff=0.0, n_burn_in=n_its - 1,
        iterative_init=True, K_real=Ksub, return_arrays=False,
    )
    _, dt = _timed(lambda: run_gibbs_chains(**args), 3)
    ref_rps = _baseline("gibbs_resamples_per_s_core")
    rps = n_its * C * reads0.nReads / dt
    results["gibbs_sweep"] = {
        "seconds_per_21_sweep_call": dt,
        "read_resamples_per_s": rps,
        "nReads": reads0.nReads, "chains": C, "Ksubset": Ksub,
        "nGrids": nGrids,
        "max_reads_per_grid": int(ginputs.read_count.max()),
        "vs_measured_ref_core": rps / ref_rps if ref_rps else None,
    }

    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
