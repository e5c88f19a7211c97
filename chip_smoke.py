"""Smoke test of the imputation path on one NVIDIA GPU.

    python chip_smoke.py                # phases 1-4 on one card
    python chip_smoke.py --four-cards   # the 4-card mesh phase only

Phases (any failure stops the run with a non-zero exit and no result line):

1. device: JAX's first device must be a GPU; prints the card's name and
   power limit as nvidia-smi reports them.
2. kernels, compiled for the card, against the plain float64 references
   in quilt_tpu/oracle: the XLA FB at K=5,120, the Gibbs sweep at
   Ksubset=600 (diploid and NIPT), and the read-window scatter against
   np.add.at.
3. end to end through the CLI on synthetic files written by the package's
   own writers, at the quick-start shape (K=5,120 haplotypes, 16,384 SNPs,
   1x 600 bp reads at phred 25, 7 chains x 3 seek iterations, Ksubset=600):
   prepare/impute with N=32, prepare2/impute2 with N=32, and NIPT
   (ff=0.2) with N=8. DS against truth must reach r2 >= 0.9 (maternal
   NIPT: >= 0.85).
4. the biobank-sized panel: K=98,304, N=8, through quilt_impute.

With --four-cards only the mesh phase runs, on the K=98,304 world: the
FB on a (data=1, panel=4) and a (data=4, panel=1) mesh against the
one-card FB on the same GL rows (max abs dosage and relative
log-likelihood differences), then quilt_impute with its chains spread
over a (data=4, panel=1) mesh, checked against truth.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Synthetic inputs are written under chip_smoke_work/ and removed at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# quick-start shape (bench_full.py) and the biobank panel
K_QUICK, NSNPS, N_DIPLOID, N_NIPT, FF = 5120, 16384, 32, 8, 0.2
K_BIOBANK, N_BIOBANK = 98304, 8
SNP_SPACING = 60               # bp between SNPs: a ~1 Mb region
R2_DIPLOID, R2_NIPT = 0.9, 0.85


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


_SETUP_SECONDS = [0.0]      # tracing, lowering and compiling, summed


def _count_setup(event: str, duration: float, **_) -> None:
    if event.startswith("/jax/core/compile/"):
        _SETUP_SECONDS[0] += duration


def timed(fn, *args):
    """(result, wall seconds, of which JAX set-up seconds): set-up is the
    tracing, lowering and compiling JAX reports through jax.monitoring."""
    s0 = _SETUP_SECONDS[0]
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0, _SETUP_SECONDS[0] - s0


def r2(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, float), np.asarray(b, float))[0, 1]
                 ** 2)


# ---------------------------------------------------------------- phase 1
def device_phase(n_cards: int):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (first device: {devs[0].platform})")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    for i, line in enumerate(smi):
        log(f"nvidia-smi card {i}: {line}")
    log(f"jax: {len(devs)} x {devs[0].device_kind} ({devs[0].platform}), "
        f"jax {jax.__version__}")
    jax.monitoring.register_event_duration_secs_listener(_count_setup)
    return devs, smi[0]


# ---------------------------------------------------------------- phase 2
def fb_kernel_check(K=K_QUICK, B=4, G=64, seed=1):
    """XLA FB against oracle/fb_full.py (float64) on GLs from reads."""
    from quilt_tpu.io.simulate import (
        fast_packed_panel, simulate_sample_reads, simulate_truth_mosaic,
    )
    from quilt_tpu.kernels import FBInputs, fb_full_batched
    from quilt_tpu.oracle import haploid_dosage_versus_refs, make_gl_from_reads
    from quilt_tpu.panel import (
        assign_positions_to_grid, compress_panel, trans_rates,
    )
    from quilt_tpu.utils import unpack_bits_32

    rng = np.random.default_rng(seed)
    nSNPs = G * 32
    rhb_t = fast_packed_panel(rng, K, G)
    haps = unpack_bits_32(rhb_t, nSNPs)
    pos = np.arange(1, nSNPs + 1, dtype=np.int64) * SNP_SPACING
    grid, _, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(rhb_t, nSNPs, nMaxDH=255)
    trans = trans_rates(rng.uniform(0.95, 0.999, nGrids - 1))
    gls = []
    for _ in range(B // 2):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        reads, sim = simulate_sample_reads(
            rng, truth, pos, grid, coverage=2.0, read_length_bp=600,
            phred=25,
        )
        for h in (0, 1):
            gls.append(make_gl_from_reads(
                reads, np.flatnonzero(sim.labels == h), nSNPs
            ))
    gl = np.stack(gls).astype(np.float32)
    thinned = np.arange(0, nGrids, 8)
    inputs = FBInputs.build(panel, trans, thinned_grids=thinned)
    dosage, log_like, _, _ = fb_full_batched(gl, inputs, K_top=8)
    # the dosage sums bf16-rounded gammas (relative error <= 2^-9, and the
    # gammas of a row sum to 1) against alleles in [0, 1]; 5e-4 more for
    # the float32 recursion against float64
    tol = 2.0 ** -9 + 5e-4
    worst, worst_ll = 0.0, 0.0
    for b in range(B):
        ref = haploid_dosage_versus_refs(gl[b].astype(np.float64), panel,
                                         trans)
        worst = max(worst, float(np.abs(dosage[b] - ref.dosage).max()))
        worst_ll = max(worst_ll, abs(float(log_like[b]) - ref.log_like)
                       / abs(ref.log_like))
    log(f"fb (XLA) vs oracle/fb_full.py float64: K={K} B={B} G={nGrids}, "
        f"escapes={len(panel.esc_k)}: max|d dosage| {worst:.3e} (tol "
        f"{tol:.3e}), max rel d loglik {worst_ll:.3e} (tol 1e-3); "
        "precision: float32 recursion, emission table gathered exactly "
        "(no matmul), dosage one-hot matmul with a bf16 gamma operand and "
        "f32 accumulation, then the f32 allele contraction at HIGHEST")
    check(worst <= tol, f"FB dosage off the oracle by {worst}")
    check(worst_ll <= 1e-3, f"FB log-likelihood off the oracle by {worst_ll}")


def gibbs_kernel_check(nl: int, Ksub=600, nSNPs=2048, seed=2):
    """run_gibbs_chains (one chain) against oracle/gibbs.py on identical
    uniforms, at Ksubset=600 padded to 640 as the engine pads it."""
    from quilt_tpu.io import simulate_panel, simulate_sample_reads
    from quilt_tpu.io.simulate import simulate_truth_mosaic
    from quilt_tpu.kernels import PaddedReads
    from quilt_tpu.kernels.common import pad_to_multiple
    from quilt_tpu.kernels.gibbs import GibbsInputs, run_gibbs_chains
    from quilt_tpu.oracle import gibbs_sample_one_chain
    from quilt_tpu.panel import assign_positions_to_grid, trans_rates

    rng = np.random.default_rng(seed + nl)
    ff = FF if nl == 3 else 0.0
    haps, pos = simulate_panel(rng, K=Ksub, nSNPs=nSNPs,
                               region_span=nSNPs * SNP_SPACING)
    grid, _, nGrids = assign_positions_to_grid(pos)
    truth = simulate_truth_mosaic(rng, haps, n_latent=nl)
    reads, _ = simulate_sample_reads(
        rng, truth, pos, grid, coverage=2.0, read_length_bp=600, phred=25,
        ff=ff,
    )
    trans = trans_rates(np.full(nGrids - 1, 0.985))
    n_its = 9
    uniforms = rng.random((n_its, reads.nReads))
    p = [0.5, 0.5] if nl == 2 else [0.5, (1 - ff) / 2, ff / 2]
    H_init = rng.choice(nl, size=reads.nReads, p=p)
    oracle = gibbs_sample_one_chain(
        reads=reads, hap_alleles=haps, grid=grid, trans=trans, n_latent=nl,
        ff=ff, uniforms=uniforms, H_init=H_init, nGrids=nGrids,
        iterative_init=True, first_read_init=0, n_burn_in_its=n_its - 1,
        n_sample_its=1,
    )
    inputs = GibbsInputs.build(reads, trans, nGrids)
    R = inputs.R
    u_pad = np.zeros((n_its, 1, R), dtype=np.float32)
    u_pad[:, 0, : reads.nReads] = uniforms
    H0 = np.zeros((1, R), dtype=np.int32)
    H0[0, : reads.nReads] = H_init
    Kp = pad_to_multiple(Ksub, 128)
    bits = np.zeros((1, Kp, nGrids * 32), dtype=np.uint8)
    bits[0, :Ksub, :nSNPs] = haps
    bits[0, Ksub:, :nSNPs] = haps[0]          # pad rows repeat a real hap
    gp, gpF, _, H, _, uf, _ = run_gibbs_chains(
        bits=bits, preads=PaddedReads.build(reads, ref_error=0.001),
        inputs=inputs, uniforms=u_pad, H0=H0,
        first_read=np.zeros(1, dtype=np.int32), n_latent=nl, ff=ff,
        n_burn_in=n_its - 1, iterative_init=True, K_real=Ksub,
    )
    check(not uf[0], "Gibbs sweep underflowed")
    informative = oracle.eMatRead.min(axis=0) < 0.5
    agree = float((H[0, : reads.nReads] == oracle.H)[informative].mean())
    dos_r2 = r2(gp[0, 1, :nSNPs] + 2 * gp[0, 2, :nSNPs],
                oracle.genProbs[1] + 2 * oracle.genProbs[2])
    # float32 device sweep vs float64 oracle on the same uniforms: labels
    # may differ only where a draw lands within rounding of its threshold
    agree_tol, r2_tol = (0.99, 0.999) if nl == 2 else (0.95, 0.99)
    name = "diploid" if nl == 2 else f"NIPT ff={ff}"
    msg = (f"gibbs (XLA sweep) vs oracle/gibbs.py float64, {name}: "
           f"Ksubset={Ksub} reads={reads.nReads} grids={nGrids} "
           f"its={n_its}: informative label agreement {agree:.4f} "
           f"(tol >= {agree_tol}), dosage r2 {dos_r2:.5f} (tol >= {r2_tol})")
    if nl == 3:
        f_r2 = r2(gpF[0, 1, :nSNPs] + 2 * gpF[0, 2, :nSNPs],
                  oracle.genProbsF[1] + 2 * oracle.genProbsF[2])
        msg += f", fetal dosage r2 {f_r2:.5f} (tol >= 0.98)"
        check(f_r2 >= 0.98, f"NIPT fetal dosage r2 {f_r2}")
    log(msg + "; precision: float32, HIGHEST for f32 contractions")
    check(agree >= agree_tol, f"{name} label agreement {agree}")
    check(dos_r2 >= r2_tol, f"{name} dosage r2 {dos_r2}")


def window_scatter_check(seed=3):
    """ReadWindowCache rows against np.add.at where slots collide: pad
    bases clip onto window slot 0, and reads list a SNP twice."""
    from quilt_tpu.kernels.emissions import ReadWindowCache

    rng = np.random.default_rng(seed)
    Bu, R, J, G = 4, 300, 24, 64
    u = np.sort(rng.integers(0, G * 32, (Bu, R, J)), axis=-1).astype(np.int32)
    u[:, :, 1] = u[:, :, 0]                      # a SNP listed twice
    mask = rng.random((Bu, R, J)) < 0.8
    mask[:, :, :2] = True
    u = np.where(mask, u, 0)
    lpr = np.where(mask, -rng.random((Bu, R, J)), 0).astype(np.float32)
    lpa = np.where(mask, -rng.random((Bu, R, J)), 0).astype(np.float32)
    cache = ReadWindowCache(u, lpr, lpa, mask, G, Rc=128)
    got = np.asarray(cache.pr[0], np.float32) + np.asarray(cache.pr[1],
                                                          np.float32)
    want = np.zeros((Bu, cache.Rpad, cache.Swin), np.float64)
    s0 = np.repeat(np.asarray(cache.s0), cache.Rc)[:R]
    loc = np.clip(u - (s0 * 32)[None, :, None], 0, cache.Swin - 1)
    b_i, r_i, _ = np.indices(u.shape)
    np.add.at(want, (b_i, r_i, loc), np.where(mask, lpr, 0.0))
    err = float(np.abs(got - want).max())
    tol = 1e-4          # bf16 hi/lo split keeps ~16 mantissa bits
    log(f"read-window scatter vs np.add.at (colliding slots): max|d| "
        f"{err:.3e} (tol {tol})")
    check(err <= tol, f"read-window scatter off np.add.at by {err}")


# ---------------------------------------------------------------- phase 3
def write_panel(work, rng):
    """Panel VCF (K_QUICK haplotypes x NSNPS) and a flat 1 cM/Mb genetic
    map, written by the package's writers. Returns (vcf, gmap, haps, pos)."""
    from quilt_tpu.io.bam_writer import write_panel_vcf
    from quilt_tpu.io.simulate import fast_packed_panel
    from quilt_tpu.utils import unpack_bits_32

    os.makedirs(work, exist_ok=True)
    haps = unpack_bits_32(fast_packed_panel(rng, K_QUICK, NSNPS // 32), NSNPS)
    pos = np.arange(1, NSNPS + 1, dtype=np.int64) * SNP_SPACING
    vcf = os.path.join(work, "panel.vcf.gz")
    write_panel_vcf(vcf, "chr20", pos, np.array(["A"] * NSNPS),
                    np.array(["G"] * NSNPS), haps)
    gmap = os.path.join(work, "map.txt")
    with open(gmap, "w") as fh:
        fh.write("position COMBINED_rate.cM.Mb. Genetic_Map.cM.\n"
                 f"{pos[0]} 1.0 0.0\n{pos[-1]} 1.0 "
                 f"{(pos[-1] - pos[0]) / 1e6:.6f}\n")
    return vcf, gmap, haps, pos


def write_bams(work, rng, haps, pos, N, n_latent, ff=0.0, L=600, phred=25):
    """N BAMs of 1x coverage, L bp reads at `phred`, from truth mosaics of
    the panel (NIPT: 3 haplotypes with read priors 0.5, (1-ff)/2, ff/2).
    Returns (bamlist path, truths [N] of [n_latent, nSNPs])."""
    from quilt_tpu.io.bam_writer import BamWriter
    from quilt_tpu.io.simulate import simulate_truth_mosaic

    span = int(pos[-1] - pos[0])
    snp_at = np.full(span + L + 2, -1, dtype=np.int64)   # offset -> SNP
    snp_at[pos - pos[0]] = np.arange(len(pos))
    probs = [0.5, 0.5] if n_latent == 2 else [0.5, (1 - ff) / 2, ff / 2]
    tag = "nipt" if n_latent == 3 else "dip"
    truths, bams = [], []
    for i in range(N):
        truth = simulate_truth_mosaic(rng, haps, n_latent=n_latent)
        truths.append(truth)
        bam = os.path.join(work, f"{tag}{i}.bam")
        n_reads = span // L
        starts = np.sort(rng.integers(0, span, n_reads))
        labels = rng.choice(n_latent, size=n_reads, p=probs)
        with BamWriter(bam, "chr20", int(pos[-1]) + 2 * L,
                       sample_name=f"S{i}") as w:
            for r in range(n_reads):
                idx = snp_at[starts[r]:starts[r] + L]
                hit = idx >= 0
                allele = truth[labels[r], np.where(hit, idx, 0)]
                err = rng.random(L) < 10 ** (-phred / 10)
                allele = np.where(err, 1 - allele, allele)
                seq = np.where(hit, np.where(allele == 1, "G", "A"), "C")
                # 0-based start: base j sits at pos[0] + starts[r] + j
                w.write_read(f"r{r}", int(pos[0] + starts[r] - 1),
                             "".join(seq), [phred] * L)
        bams.append(bam)
    bamlist = os.path.join(work, f"{tag}_bamlist.txt")
    with open(bamlist, "w") as fh:
        fh.write("\n".join(bams) + "\n")
    return bamlist, truths


def read_vcf_ds(path, n_samples):
    """[nSNPs, n_samples] DS (MDS for NIPT) from the output VCF."""
    from quilt_tpu.out.bgzf import bgzf_open

    rows = []
    for line in bgzf_open(path):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        fmt = f[8].split(":")
        k = fmt.index("DS") if "DS" in fmt else fmt.index("MDS")
        rows.append([float(c.split(":")[k]) for c in f[9:9 + n_samples]])
    return np.asarray(rows)


def run_cli(args):
    """(wall seconds, JAX set-up seconds) of one CLI command."""
    from quilt_tpu.cli import main

    rc, wall, setup = timed(main, args)
    check(rc == 0, f"quilt-tpu {args[0]} returned {rc}")
    return wall, setup


def cli_phase(work, card):
    rng = np.random.default_rng(5)
    vcf, gmap, haps, pos = write_panel(work, rng)
    bl_dip, tr_dip = write_bams(work, rng, haps, pos, N_DIPLOID, 2)
    bl_nipt, tr_nipt = write_bams(work, rng, haps, pos, N_NIPT, 3, ff=FF)
    ff_file = os.path.join(work, "ff.txt")
    with open(ff_file, "w") as fh:
        fh.write("\n".join([str(FF)] * N_NIPT) + "\n")
    common = ["--chr=chr20", "--nGen=100", f"--genetic_map_file={gmap}",
              f"--reference_vcf_file={vcf}"]
    run_opts = ["--nGibbsSamples=7", "--n_seek_its=3", "--Ksubset=600",
                "--Knew=600", "--seed=1"]
    out1 = os.path.join(work, "out_quilt1")
    out2 = os.path.join(work, "out_quilt2")
    runs = [   # (prepare command or None, outdir, impute args, ...)
        ("prepare", out1, ["impute", f"--bamlist={bl_dip}"],
         "diploid QUILT1", tr_dip, R2_DIPLOID),
        ("prepare2", out2, ["impute2", f"--bamlist={bl_dip}"],
         "diploid QUILT2", tr_dip, R2_DIPLOID),
        (None, out1, ["impute", f"--bamlist={bl_nipt}", "--method=nipt",
                      f"--fflist={ff_file}"], f"NIPT ff={FF}", tr_nipt,
         R2_NIPT),
    ]
    for prep_cmd, out, imp, name, truths, r2_min in runs:
        N = len(truths)
        t_prep = 0.0
        if prep_cmd is not None:
            t_prep, _ = run_cli([prep_cmd, f"--outputdir={out}"] + common)
        imp = imp + [f"--outputdir={out}", f"--sample_batch={N}"] \
            + common + run_opts
        wall, setup = run_cli(imp)
        ds = read_vcf_ds(os.path.join(out, "quilt.chr20.vcf.gz"), N)
        check(ds.shape == (NSNPS, N) and np.isfinite(ds).all(),
              f"{name}: DS shape {ds.shape} or non-finite values")
        r2s = [r2(ds[:, i], truths[i][0] + truths[i][1]) for i in range(N)]
        log(f"e2e {name} (CLI {imp[0]}, smoke run, not a benchmark cell) "
            f"on {card}: N={N} K={K_QUICK} SNPs={NSNPS}: prepare "
            f"{t_prep:.1f} s; impute {wall:.1f} s, of which JAX compile "
            f"{setup:.1f} s, run {wall - setup:.1f} s; "
            f"{N / (wall - setup):.3f} samples/s; DS r2 vs truth mean "
            f"{np.mean(r2s):.4f} min {np.min(r2s):.4f} (tol mean >= "
            f"{r2_min})")
        check(np.mean(r2s) >= r2_min, f"{name}: mean r2 {np.mean(r2s)}")


# ---------------------------------------------------------------- phase 4
def biobank_world(seed=7, K=K_BIOBANK, N=N_BIOBANK, nSNPs=NSNPS):
    """The K=98,304 prepared reference and N simulated 1x samples, built
    in memory as bench_full.py builds them. Truth mosaics draw on 4,096
    haplotypes spread over the whole panel, so every shard of a
    panel-sharded FB carries posterior mass. Returns (prep, reads [N],
    true haplotype label of each read [N], truth genotypes [nSNPs, N])."""
    from quilt_tpu.io import simulate_sample_reads
    from quilt_tpu.io.simulate import fast_packed_panel, simulate_truth_mosaic
    from quilt_tpu.panel.prepare import (
        PreparedReference, assign_positions_to_grid, compress_panel,
    )
    from quilt_tpu.utils import unpack_bits_32

    rng = np.random.default_rng(seed)
    rhb = fast_packed_panel(rng, K, nSNPs // 32)
    pos = np.arange(1, nSNPs + 1, dtype=np.int64) * SNP_SPACING
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(rhb, nSNPs, nMaxDH=255)
    spread = np.sort(rng.choice(K, size=min(K, 4096), replace=False))
    some = unpack_bits_32(rhb[spread], nSNPs)      # truth mosaics + af
    prep = PreparedReference(
        chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
        alt_allele=np.array(["G"] * nSNPs), rhb_t=rhb, af=some.mean(0),
        grid=grid, L_grid=np.asarray(L_grid),
        cM_grid=np.asarray(L_grid, dtype=np.float64) * 1e-6,
        sigma=np.full(nGrids - 1, 0.99), panel=panel, regionStart=None,
        regionEnd=None, buffer=0, nGen=100, ref_error=0.001,
    )
    samples, labels, truth_g = [], [], []
    for _ in range(N):
        truth = simulate_truth_mosaic(rng, some, n_latent=2)
        reads, sim = simulate_sample_reads(
            rng, truth, pos, grid, coverage=1.0, read_length_bp=600,
            phred=25,
        )
        samples.append(reads)
        labels.append(sim.labels)
        truth_g.append(truth.sum(axis=0))
    return prep, samples, labels, np.stack(truth_g, axis=1)


def biobank_cfg(**kw):
    from quilt_tpu.config import ImputeConfig

    return ImputeConfig(
        nGibbsSamples=7, n_seek_its=3, Ksubset=600, Knew=600, seed=1,
        sample_batch=N_BIOBANK, make_plots=False, **kw,
    )


def impute_dosages(prep, samples, cfg, truth_g):
    from quilt_tpu.engine import quilt_impute

    names = [f"S{i}" for i in range(len(samples))]
    out, wall, setup = timed(quilt_impute, prep, samples, names, cfg)
    ds = np.stack([r.dosage for r in out.results], axis=1)
    check(ds.shape == truth_g.shape and np.isfinite(ds).all(),
          f"dosage shape {ds.shape} or non-finite values")
    return ds, wall, setup


def biobank_phase(card):
    import jax

    prep, samples, _, truth_g = biobank_world()
    ds, wall, setup = impute_dosages(prep, samples, biobank_cfg(), truth_g)
    r2s = [r2(ds[:, i], truth_g[:, i]) for i in range(ds.shape[1])]
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"e2e biobank panel (quilt_impute, smoke run, not a benchmark "
        f"cell) on {card}: N={N_BIOBANK} K={K_BIOBANK} SNPs={NSNPS}: "
        f"{wall:.1f} s, of which JAX compile {setup:.1f} s, run "
        f"{wall - setup:.1f} s; {N_BIOBANK / (wall - setup):.3f} "
        f"samples/s; DS r2 vs truth mean {np.mean(r2s):.4f} min "
        f"{np.min(r2s):.4f} (tol mean >= {R2_DIPLOID}); peak_bytes_in_use "
        f"{peak / 2**30:.2f} GiB")
    check(np.mean(r2s) >= R2_DIPLOID, f"biobank mean r2 {np.mean(r2s)}")


# ---------------------------------------------------------------- phase 5
MESH_FB_ROWS = 16      # haploid GL rows of the mesh FB comparison
# mesh FB vs one card on identical GL rows: each side sums bf16-rounded
# gammas (<= 2^-9 off the exact dosage); the rest is float32 rounding of
# the segment-fused recursion and of the psum order
MESH_DS_TOL = 2 * 2.0 ** -9 + 5e-4
MESH_LL_RTOL = 1e-4


def mesh_fb_rows(prep, samples, labels, n_rows=MESH_FB_ROWS):
    """FBInputs of the prepared panel and n_rows haploid GL rows: each
    sample's reads split by their true haplotype."""
    from quilt_tpu.kernels import FBInputs
    from quilt_tpu.oracle import make_gl_from_reads
    from quilt_tpu.panel import trans_rates

    nSNPs = len(prep.pos)
    gls = [make_gl_from_reads(r, np.flatnonzero(lab == h), nSNPs)
           for r, lab in zip(samples, labels) for h in (0, 1)][:n_rows]
    check(len(gls) == n_rows, f"{len(gls)} GL rows, want {n_rows}")
    inputs = FBInputs.build(prep.panel, trans_rates(prep.sigma),
                            thinned_grids=np.arange(0, prep.panel.nGrids, 8))
    return inputs, np.stack(gls).astype(np.float32)


def compare_sharded_fb(inputs, gl, meshes):
    """The FB on each (data, panel) mesh against the one-device FB on the
    same GL rows. The panel-sharded FB lifts every sum over K to a psum,
    so a shard whose mass went missing moves dosages and log-likelihoods
    far past MESH_DS_TOL / MESH_LL_RTOL. Each call runs twice; the second
    is timed. Returns one dict per mesh."""
    from quilt_tpu.dist.mesh import ShardedFB, make_mesh
    from quilt_tpu.kernels import fb_full_batched

    def twice(fn):
        fn()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    (ds_1, ll_1, _, _), t_1 = twice(
        lambda: fb_full_batched(gl, inputs, K_top=8))
    check(np.isfinite(ds_1).all() and np.isfinite(ll_1).all(),
          "one-device FB: non-finite output")
    rows = []
    for n_data, n_panel in meshes:
        fb = ShardedFB(inputs, make_mesh(n_data, n_panel), K_top=8)
        (ds_m, ll_m, _, _), t_m = twice(lambda: fb(gl))
        row = {
            "mesh": (n_data, n_panel),
            "max_abs_ds_diff": float(np.abs(ds_m - ds_1).max()),
            "max_rel_ll_diff": float(np.max(np.abs(ll_m - ll_1)
                                            / np.abs(ll_1))),
            "seconds": t_m, "seconds_one_device": t_1,
        }
        rows.append(row)
        check(row["max_abs_ds_diff"] <= MESH_DS_TOL
              and row["max_rel_ll_diff"] <= MESH_LL_RTOL,
              f"mesh {n_data}x{n_panel} FB off one device: {row}")
    return rows


def mesh_engine_check(prep, samples, truth_g, cfg, mesh, r2_min=R2_DIPLOID):
    """quilt_impute on a (data, panel) mesh: Gibbs chains sharded over its
    devices, finite dosages of the right shape, DS r2 vs truth >= r2_min.
    Returns (mean r2, wall seconds, of which JAX set-up seconds)."""
    from dataclasses import replace

    cfg_m = replace(cfg, mesh_data=mesh[0], mesh_panel=mesh[1])
    ds, wall, setup = impute_dosages(prep, samples, cfg_m, truth_g)
    r2_m = float(np.mean([r2(ds[:, i], truth_g[:, i])
                          for i in range(ds.shape[1])]))
    check(r2_m >= r2_min, f"mesh {mesh} engine: DS r2 vs truth {r2_m}")
    return r2_m, wall, setup


def four_card_phase(cards):
    prep, samples, labels, truth_g = biobank_world()
    inputs, gl = mesh_fb_rows(prep, samples, labels)
    for row in compare_sharded_fb(inputs, gl, [(1, 4), (4, 1)]):
        log(f"FB on mesh data={row['mesh'][0]} panel={row['mesh'][1]} vs "
            f"one card ({cards}): K={K_BIOBANK} rows={len(gl)} "
            f"G={inputs.nGrids}, same GL rows: max|d dosage| "
            f"{row['max_abs_ds_diff']:.3e} (tol {MESH_DS_TOL:.3e}), max rel "
            f"d loglik {row['max_rel_ll_diff']:.3e} (tol {MESH_LL_RTOL}); "
            f"{row['seconds']:.3f} s vs {row['seconds_one_device']:.3f} s "
            "per call (second call)")
    r2_m, wall, setup = mesh_engine_check(prep, samples, truth_g,
                                          biobank_cfg(), (4, 1))
    log(f"e2e quilt_impute on mesh data=4 panel=1 ({cards}): K={K_BIOBANK} "
        f"N={N_BIOBANK}: {wall:.1f} s, of which JAX compile {setup:.1f} s; "
        f"DS r2 vs truth mean {r2_m:.4f} (tol >= {R2_DIPLOID})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    devs, card = device_phase(n_cards)
    sys.path.insert(0, REPO)
    import quilt_tpu  # noqa: F401  (fails where the package is absent)

    if args.four_cards:
        four_card_phase(card)
    else:
        fb_kernel_check()
        gibbs_kernel_check(2)
        gibbs_kernel_check(3)
        window_scatter_check()
        work = os.path.join(REPO, "chip_smoke_work")
        try:
            cli_phase(work, card)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        biobank_phase(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
