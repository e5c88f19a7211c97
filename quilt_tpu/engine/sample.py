"""Per-sample imputation engine: chains x seek-iterations orchestration.

Functional equivalent of get_and_impute_one_sample (reference:
QUILT/R/functions.R:3-1499): the outer loop over nGibbsSamples Gibbs chains
plus a final phasing pass, each running n_seek_its seek iterations of
{small-panel Gibbs -> full-panel FB -> haplotype re-selection}, dosage/GP
accumulation past seek burn-in, cross-chain read-label consensus, and the
phasing recast.

Restructured for a device: the reference runs its chains sequentially in one
process; here all chains advance together as the batch axis of the device
kernels (Gibbs batch = chains, FB batch = chains x latent haps), with only
the cheap haplotype-selection heuristics and consensus on the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ImputeConfig
from ..io.reads import SampleReads, bq_to_probs
from ..panel.prepare import PreparedReference, trans_rates
from ..kernels import FBInputs, fb_full_batched, PaddedReads
from ..kernels.common import pad_to_multiple
from ..kernels.gibbs import GibbsInputs, run_gibbs_chains
from ..utils import print_message
from .selection import (
    consensus_read_labels,
    read_confidence,
    recast_haps,
    recast_nipt_haps,
    select_new_haps_from_topk,
)


@dataclass
class RegionContext:
    """Device-ready per-region constants shared across samples."""

    prep: PreparedReference
    trans: np.ndarray            # [2, nGrids-1]
    fb_inputs: Optional[FBInputs]
    thinned_grids: np.ndarray
    n_latent: int
    Ksub: int
    Knew: int
    n_seek_its: int
    n_burn_in_seek_its: int
    trans_all: Optional[np.ndarray] = None    # rare/common: all-SNP trans
    nGrids_all: int = 0
    boundaries: Optional[np.ndarray] = None   # block-Gibbs suffix starts
    smooth_cm: Optional[np.ndarray] = None    # block-defining smoothed rate
    # bp-smoothing operator for ON-THE-FLY boundary detection from the
    # live FB state (block_gibbs_boundary_detection == "gamma"); None =
    # static map-based boundaries
    smooth_w: Optional[np.ndarray] = None
    block_quantile: float = 0.95
    block_nb_cap: int = 32
    hla_capture: bool = False
    timers: Optional[object] = None           # SectionTimers (or None)
    mesh: Optional[object] = None             # jax Mesh (multi-chip)
    sharded_fb: Optional[object] = None       # dist.mesh.ShardedFB
    _rhb_dev_cache: Optional[object] = None
    _dh_bits_dev_cache: Optional[object] = None
    _smooth_w_dev_cache: Optional[object] = None
    _e_full_dev_cache: Optional[object] = None

    def rhb_dev(self):
        """Packed panel resident on device (uploaded once per region)."""
        if self._rhb_dev_cache is None:
            object.__setattr__(self, "_rhb_dev_cache",
                               jnp.asarray(self.prep.rhb_t))
        return self._rhb_dev_cache

    def e_full_dev(self):
        """{0,1} bf16 expansion of the whole packed panel (once per
        region; operand of the batched engine's eMatRead matmuls)."""
        if self._e_full_dev_cache is None:
            from ..kernels.emissions import expand_panel_bf16
            object.__setattr__(self, "_e_full_dev_cache",
                               expand_panel_bf16(self.rhb_dev()))
        return self._e_full_dev_cache

    def smooth_w_dev(self):
        """Banded smoothing operator device-resident (uploaded once per
        region instead of per Gibbs call)."""
        if self.smooth_w is None:
            return None
        if self._smooth_w_dev_cache is None:
            object.__setattr__(
                self, "_smooth_w_dev_cache",
                tuple(jnp.asarray(x) for x in self.smooth_w),
            )
        return self._smooth_w_dev_cache

    def dh_bits_dev(self):
        """Distinct-hap alleles [nMaxDH, S] uint8 on device (uploaded once;
        feeds the device symbol extraction of the mspbwt selection)."""
        if self._dh_bits_dev_cache is None:
            from ..utils import unpack_bits_32
            panel = self.prep.panel
            bits = unpack_bits_32(
                panel.distinctHapsB, panel.nGrids * 32
            )
            object.__setattr__(self, "_dh_bits_dev_cache",
                               jnp.asarray(bits))
        return self._dh_bits_dev_cache

    @classmethod
    def build(cls, prep: PreparedReference, cfg: ImputeConfig) -> "RegionContext":
        trans = trans_rates(prep.sigma)
        K = prep.K
        Ksub = min(cfg.Ksubset, K)
        Knew = min(cfg.Knew, Ksub)
        n_seek = cfg.n_seek_its
        n_burn = cfg.resolved_n_burn_in_seek_its()
        if cfg.override_default_params_for_small_ref_panel and K <= cfg.Ksubset:
            # small-panel override (reference: quilt.R:451-465)
            n_seek, n_burn, Ksub, Knew = 1, 0, K, K
        nGrids = prep.nGrids
        n_thin = max(1, round(cfg.heuristic_match_thin * nGrids))
        thinned = np.unique(
            np.linspace(0, nGrids - 1, n_thin).round().astype(np.int64)
        )
        fb_inputs = None
        hla_capture = False
        if not cfg.use_mspbwt or cfg.hla_run:
            fb_inputs = FBInputs.build(prep.panel, trans, thinned_grids=thinned)
            if cfg.hla_run:
                # capture full-panel gamma at the grid physically closest to
                # the gene centre (reference: quilt-hla.R:192-212,
                # functions.R:1261-1280)
                if cfg.gamma_physically_closest_to is not None:
                    snp = int(
                        np.abs(prep.pos - cfg.gamma_physically_closest_to)
                        .argmin()
                    )
                    fb_inputs.capture_grid = int(prep.grid[snp])
                else:
                    fb_inputs.capture_grid = prep.nGrids // 2
                hla_capture = True
        n_latent = 3 if cfg.method == "nipt" else 2
        trans_all = None
        nGrids_all = 0
        if cfg.impute_rare_common and prep.sigma_all is not None:
            trans_all = trans_rates(prep.sigma_all)
            nGrids_all = len(prep.L_grid_all)
        from ..panel.prepare import make_smoothed_rate, smoothing_band
        from ..oracle.block_gibbs import detect_boundaries
        smooth = make_smoothed_rate(
            prep.sigma, prep.L_grid, cfg.shuffle_bin_radius
        )
        boundaries = detect_boundaries(smooth, 0.9) if nGrids > 4 else None
        # "gamma" mode: boundaries come from the live FB jump rate inside
        # the kernel each block iteration (reference production behavior);
        # the bp-smoothing operator is the only per-region precompute
        smooth_w = None
        nb_cap = cfg.max_block_gibbs_boundaries
        if (cfg.block_gibbs_boundary_detection == "gamma" and nGrids > 4
                and cfg.max_block_gibbs_boundaries > 0):
            smooth_w = smoothing_band(
                prep.L_grid, cfg.shuffle_bin_radius
            )
            # the reference's detector is UNCAPPED (gibbs-nipt-block.cpp
            # greedy loop); auto-raise the on-the-fly slot count to the
            # static map's run estimate so the cap only ever bites on maps
            # hotter than the marginal recombination field suggests
            if smooth is not None and len(smooth) > 1:
                above = smooth >= np.quantile(
                    smooth, cfg.block_gibbs_quantile_prob
                )
                n_runs = int(
                    (above & ~np.concatenate([[False], above[:-1]])).sum()
                )
                est = 2 * n_runs           # cascade allowance per run
                raised = max(nb_cap, min(est, 128))
                if raised > nb_cap:
                    print_message(
                        f"Raising max_block_gibbs_boundaries "
                        f"{nb_cap} -> {raised} (static map suggests "
                        f"~{est} above-quantile boundaries)"
                    )
                    nb_cap = raised
        from ..utils.log import SectionTimers
        # multi-chip: build the mesh from mesh_data/mesh_panel and hold a
        # panel-sharded FB when the panel axis is split (SURVEY section 2.7)
        from ..dist.mesh import mesh_from_config
        mesh = mesh_from_config(cfg)
        sharded_fb = None
        if (mesh is not None and mesh.shape["panel"] > 1
                and fb_inputs is not None):
            from ..dist.mesh import ShardedFB
            print_message(
                f"Panel-sharded FB over mesh data={mesh.shape['data']} x "
                f"panel={mesh.shape['panel']}"
            )
            sharded_fb = ShardedFB(
                fb_inputs, mesh, K_top=max(8, cfg.K_top_matches),
                ref_error=prep.ref_error,
            )
        return cls(
            prep=prep, trans=trans, fb_inputs=fb_inputs, thinned_grids=thinned,
            n_latent=n_latent, Ksub=Ksub, Knew=Knew, n_seek_its=n_seek,
            n_burn_in_seek_its=n_burn, trans_all=trans_all,
            nGrids_all=nGrids_all, boundaries=boundaries, smooth_cm=smooth,
            smooth_w=smooth_w,
            block_quantile=cfg.block_gibbs_quantile_prob,
            block_nb_cap=nb_cap,
            hla_capture=hla_capture,
            timers=SectionTimers(cfg.print_extra_timing_information),
            mesh=mesh, sharded_fb=sharded_fb,
        )


@dataclass
class SampleResult:
    imputed: bool
    dosage: Optional[np.ndarray] = None        # [nSNPs] diploid dosage
    gp: Optional[np.ndarray] = None            # [3, nSNPs]
    phased_haps: Optional[np.ndarray] = None   # [n_latent, nSNPs] 0/1
    read_labels: Optional[np.ndarray] = None   # [R]
    allele_count: Optional[np.ndarray] = None  # [nSNPs, 2] (alt, total)
    # NIPT extras
    mat_gp: Optional[np.ndarray] = None
    fet_gp: Optional[np.ndarray] = None
    mat_dosage: Optional[np.ndarray] = None
    fet_dosage: Optional[np.ndarray] = None
    # HLA extras (hla_run): per-chain full-panel gamma at the gene grid
    hla_gammas: Optional[np.ndarray] = None    # [C, n_latent, K]
    hla_gamma_total: Optional[np.ndarray] = None   # [K]
    # diagnostics of the final Gibbs call (kernels.gibbs.PER_IT_COLS;
    # reference: per_it_likelihoods / H_class in RData_objects_to_save)
    per_it_likelihoods: Optional[np.ndarray] = None  # [n_its, C, 8]
    H_class: Optional[np.ndarray] = None             # [C, R] (NIPT)
    # per-seek-iteration chain-mean dosage (make_heuristic_plot /
    # record_interim_dosages)
    seek_dosages: Optional[np.ndarray] = None        # [n_seek_its, nSNPs]
    # per-seek-iteration per-chain read labels (record_read_label_usage)
    read_label_usage: Optional[np.ndarray] = None    # [n_seek_its, C, R]


def gls_from_labels(
    reads: SampleReads,
    H: np.ndarray,
    n_latent: int,
    nSNPs: int,
    minGLValue: float = 1e-10,
) -> np.ndarray:
    """Haploid GLs [n_latent, 2, nSNPs] from read labels (vectorized host
    equivalent of make_gl_from_u_bq, reference-single.R:19-42)."""
    probs = bq_to_probs(reads.bq)
    read_of_base = np.repeat(np.arange(reads.nReads), np.diff(reads.offsets))
    h_of_base = H[read_of_base]
    gl = np.ones((n_latent, 2, nSNPs), dtype=np.float64)
    nz = reads.bq != 0
    for h in range(n_latent):
        w = (h_of_base == h) & nz
        np.multiply.at(gl[h, 0], reads.u[w], probs[w, 0])
        np.multiply.at(gl[h, 1], reads.u[w], probs[w, 1])
    if minGLValue > 0:
        hi = gl.max(axis=1, keepdims=True)
        fix = (gl < minGLValue).any(axis=1, keepdims=True)
        scaled = np.maximum(gl / hi, minGLValue)
        gl = np.where(fix, scaled, gl)
    return gl


def emat_read_vs_dosages(
    reads: SampleReads, hap_dos: np.ndarray, max_diff: float = 1e10
) -> np.ndarray:
    """P(read | hap dosage vector) per latent hap, [n_latent, R] (host;
    for read confidence, reference functions.R:1615-1660)."""
    nl = hap_dos.shape[0]
    probs = bq_to_probs(reads.bq)
    read_of_base = np.repeat(np.arange(reads.nReads), np.diff(reads.offsets))
    e = hap_dos[:, reads.u]                          # [nl, nBases]
    term = e * probs[None, :, 1] + (1 - e) * probs[None, :, 0]
    logterm = np.log(np.maximum(term, 1e-300))
    out = np.zeros((nl, reads.nReads))
    for h in range(nl):
        np.add.at(out[h], read_of_base, logterm[h])
    return np.exp(out)


def _gather_topk_lists(tv, ti, thinned, n_latent, chain, K_top):
    """Per-chain ranked top-match lists [n_thin*n_latent, K_top] from the FB
    kernel's per-grid outputs (batch rows chain*n_latent + h)."""
    rows_i = []
    rows_v = []
    for h in range(n_latent):
        b = chain * n_latent + h
        rows_i.append(ti[thinned, b, :])
        rows_v.append(tv[thinned, b, :])
    return np.concatenate(rows_i, axis=0), np.concatenate(rows_v, axis=0)


def impute_one_sample(
    ctx: RegionContext,
    reads: SampleReads,
    cfg: ImputeConfig,
    seed: int,
    ff: float = 0.0,
    truth_haps: Optional[np.ndarray] = None,
    reads_all: Optional[SampleReads] = None,
) -> SampleResult:
    prep = ctx.prep
    nSNPs = prep.nSNPs
    nGrids = prep.nGrids
    K = prep.K
    nl = ctx.n_latent
    rng = np.random.default_rng(seed)

    if reads.nReads < cfg.minimum_number_of_sample_reads:
        return SampleResult(imputed=False)

    reads = reads.sorted_by_grid()
    C = cfg.nGibbsSamples
    n_its = cfg.small_ref_panel_gibbs_iterations + 1
    ginputs = GibbsInputs.build(reads, ctx.trans, nGrids)
    R = ginputs.R
    preads = PaddedReads.build(reads, ref_error=prep.ref_error)

    if nl == 2:
        label_prior = np.array([0.5, 0.5])
    else:
        label_prior = np.array([0.5, (1 - ff) / 2, ff / 2])

    # per-chain random haplotype subsets and read labels
    which_haps = np.stack(
        [np.sort(rng.choice(K, size=ctx.Ksub, replace=False)) for _ in range(C)]
    )
    H = np.zeros((C, R), dtype=np.int32)
    H[:, : reads.nReads] = rng.choice(
        nl, size=(C, reads.nReads), p=label_prior
    )
    max_diff = cfg.maxDifferenceBetweenReads

    hla_gammas = None
    diag = {}
    dosage_acc = np.zeros(nSNPs)
    gp_acc = np.zeros((3, nSNPs))
    fet_dosage_acc = np.zeros(nSNPs)
    fet_gp_acc = np.zeros((3, nSNPs))
    n_acc = 0
    hap_dos_final = np.zeros((C, nl, nSNPs))
    gcap_store = [None]

    # block-Gibbs schedule (reference: small_ref_panel_block_gibbs_iterations,
    # quilt.R default c(3,6,9))
    do_block_np = np.zeros(n_its, dtype=bool)
    for bit in cfg.small_ref_panel_block_gibbs_iterations:
        if 1 <= bit <= n_its:
            do_block_np[bit - 1] = True
    bnd = ctx.boundaries if ctx.boundaries is not None else np.zeros(0, np.int32)
    otf = ctx.smooth_w is not None
    nb_slots = ctx.block_nb_cap if otf else len(bnd)

    def run_chains(which_haps_b, H0_b, iterative, first_read_b, max_diff):
        """One Gibbs call (B chains), with underflow retry policy
        (reference: functions.R:2704-2714)."""
        B = which_haps_b.shape[0]
        rhb_sub = prep.rhb_t[which_haps_b]              # [B, Ksub, nGrids]
        Ksub = rhb_sub.shape[1]
        Kp = pad_to_multiple(Ksub, 128)
        if Kp != Ksub:
            pad = np.repeat(rhb_sub[:, :1, :], Kp - Ksub, axis=1)
            rhb_sub = np.concatenate([rhb_sub, pad], axis=1)
        # packed words go straight to the kernels (unpacked on the fly)
        bits = jnp.asarray(rhb_sub)
        uniforms = rng.random((n_its, B, R)).astype(np.float32)
        block_u = rng.random((n_its, nb_slots, 3, B)).astype(np.float32)
        # uniforms for resample_H_using_H_class at block iterations (NIPT
        # within-block move set; kernels/gibbs.py:nipt_block_within)
        resample_u = (
            rng.random((n_its, B, R)).astype(np.float32)
            if (nl == 3 and nb_slots) else None
        )
        for attempt in range(11):
            with ctx.timers.section("gibbs_sweep"):
                gp, gpF, hap_dos, Hn, ll, uf, Hcls = run_gibbs_chains(
                    bits=bits, preads=preads, inputs=ginputs,
                    uniforms=uniforms,
                    H0=H0_b, first_read=first_read_b, n_latent=nl, ff=ff,
                    n_burn_in=n_its - 1, iterative_init=iterative,
                    K_real=Ksub,
                    max_diff=max_diff, ref_error=prep.ref_error,
                    boundaries=None if otf else bnd,
                    block_u=block_u, do_block=do_block_np,
                    resample_u=resample_u,
                    smooth_w=ctx.smooth_w_dev(),
                    quantile_prob=ctx.block_quantile,
                )
            if not uf.any():
                break
            max_diff = max(1.0, max_diff / 10.0)
            print_message(
                f"Underflow; retrying with maxDifferenceBetweenReads={max_diff}"
            )
        # diagnostics of the most recent Gibbs call (per-iteration
        # likelihood matrix + NIPT H_class), exported on the SampleResult
        diag["per_it_ll"] = ll
        diag["H_class"] = Hcls if nl == 3 else None
        return gp, gpF, hap_dos, Hn, max_diff

    def run_fb_and_select(H_b, which_haps_b, accumulate):
        """Full-panel FB per (chain, latent hap); returns hap dosages and the
        re-selected subsets (QUILT1 heuristic path)."""
        B = H_b.shape[0]
        gls = np.ones((B * nl, 2, nSNPs), dtype=np.float32)
        for c in range(B):
            gl_c = gls_from_labels(
                reads, H_b[c, : reads.nReads], nl, nSNPs, cfg.minGLValue
            )
            gls[c * nl:(c + 1) * nl] = gl_c
        with ctx.timers.section("fb_full"):
            if ctx.sharded_fb is not None:
                res_fb = ctx.sharded_fb(gls)
            else:
                res_fb = fb_full_batched(
                    gls, ctx.fb_inputs, K_top=max(8, cfg.K_top_matches),
                    ref_error=prep.ref_error,
                )
        if ctx.hla_capture:
            dosage, log_like, tv, ti, gcap = res_fb
            gcap_store[0] = gcap.reshape(B, nl, -1)
        else:
            dosage, log_like, tv, ti = res_fb
        hap_dos = dosage.reshape(B, nl, nSNPs)
        new_sets = np.empty_like(which_haps_b)
        for c in range(B):
            n_keep = ctx.Ksub - ctx.Knew
            prev_sel = rng.choice(which_haps_b[c], size=n_keep, replace=False)
            li, lv = _gather_topk_lists(tv, ti, ctx.thinned_grids, nl, c,
                                        tv.shape[2])
            new = select_new_haps_from_topk(
                li, lv, ctx.Knew, K, prev_sel, rng, cfg.K_top_matches
            )
            new_sets[c] = np.sort(np.concatenate([prev_sel, new]))
        return hap_dos, new_sets

    # rare/common support (QUILT2 impute_rare_common;
    # reference: rare_common.R:109-470)
    rare_common = (
        cfg.impute_rare_common and reads_all is not None
        and prep.snp_is_common is not None
    )
    if rare_common:
        from .rare_common import (
            build_subset_bits_all, initial_all_snp_labels,
        )
        reads_all = reads_all.sorted_by_grid()
        nSNPs_all = len(prep.snp_is_common)
        nGrids_all = ctx.nGrids_all
        S_all = nGrids_all * 32
        ginputs_all = GibbsInputs.build(reads_all, ctx.trans_all, nGrids_all)
        preads_all = PaddedReads.build(reads_all, ref_error=prep.ref_error)
        dosage_all_acc = np.zeros(nSNPs_all)
        gp_all_acc = np.zeros((3, nSNPs_all))
        fet_dosage_all_acc = np.zeros(nSNPs_all)
        fet_gp_all_acc = np.zeros((3, nSNPs_all))
        n_all_acc = 0

    def run_all_snp_gibbs(which_haps_b, hap_dos_common, max_diff):
        """Final all-SNP Gibbs for a batch of chains (rare/common mode)."""
        B = which_haps_b.shape[0]
        Ksub = which_haps_b.shape[1]
        bits_np = build_subset_bits_all(
            prep.rhb_t, which_haps_b, prep.snp_is_common,
            prep.rare_per_hap_info, nGrids_all,
        )
        Kp = pad_to_multiple(Ksub, 128)
        if Kp != Ksub:
            pad = np.repeat(bits_np[:, :1, :], Kp - Ksub, axis=1)
            bits_np = np.concatenate([bits_np, pad], axis=1)
        H0_all = np.zeros((B, ginputs_all.R), dtype=np.int32)
        for c in range(B):
            H0_all[c, : reads_all.nReads] = initial_all_snp_labels(
                reads_all, hap_dos_common[c], prep.snp_is_common, nl, ff, rng
            )
        uniforms = rng.random((n_its, B, ginputs_all.R)).astype(np.float32)
        for attempt in range(11):
            gp_a, gpF_a, hd_a, Hn, ll, uf, Hcls = run_gibbs_chains(
                bits=bits_np, preads=preads_all, inputs=ginputs_all,
                uniforms=uniforms, H0=H0_all,
                first_read=np.zeros(B, dtype=np.int32), n_latent=nl, ff=ff,
                n_burn_in=n_its - 1, iterative_init=False, K_real=Ksub,
                max_diff=max_diff, ref_error=prep.ref_error,
            )
            if not uf.any():
                break
            max_diff = max(1.0, max_diff / 10.0)
        return (
            gp_a[:, :, :nSNPs_all], gpF_a[:, :, :nSNPs_all],
            hd_a[:, :, :nSNPs_all],
        )

    # ------------------------------------------------------------------
    # main chains
    # ------------------------------------------------------------------
    first_read = rng.integers(0, max(reads.nReads, 1), size=C).astype(np.int32)
    for i_it in range(1, ctx.n_seek_its + 1):
        iterative = i_it == 1
        gp_g, gpF_g, hap_dos_g, H, max_diff = run_chains(
            which_haps, H, iterative, first_read, max_diff
        )
        if cfg.make_heuristic_plot or cfg.record_interim_dosages:
            # per-seek-iteration dosage trace (reference: heuristic.R:40-176
            # and record_interim_dosages, functions.R:552,607,988)
            diag.setdefault("seek_dosages", []).append(
                (gp_g[:, 1, :nSNPs] + 2 * gp_g[:, 2, :nSNPs]).mean(axis=0)
            )
        if cfg.record_read_label_usage:
            # read labels after each seek iteration per chain (reference:
            # record_read_label_usage, functions.R:564,599,994)
            diag.setdefault("label_usage", []).append(
                H[:, : reads.nReads].copy()
            )
        if cfg.use_mspbwt:
            # QUILT2: hap dosages from the Gibbs run; selection via mspbwt
            from ..panel.mspbwt import select_new_haps_mspbwt
            hap_dos = hap_dos_g[:, :, :nSNPs]
            for c in range(C):
                n_keep = ctx.Ksub - ctx.Knew
                prev_sel = rng.choice(which_haps[c], size=n_keep, replace=False)
                new = select_new_haps_mspbwt(
                    prep.ms_indices, prep.panel, hap_dos[c], ctx.Knew, K,
                    prev_sel, rng, mspbwtL=cfg.mspbwtL, mspbwtM=cfg.mspbwtM,
                    heuristic_approach=cfg.heuristic_approach,
                )
                which_haps[c] = np.sort(np.concatenate([prev_sel, new]))
        else:
            hap_dos, which_haps = run_fb_and_select(H, which_haps, True)
        if ctx.hla_capture and gcap_store[0] is not None:
            hla_gammas = gcap_store[0]
        if i_it > ctx.n_burn_in_seek_its:
            h1, h2 = hap_dos[:, 0], hap_dos[:, 1]
            dosage_acc += (h1 + h2).sum(axis=0)
            gp_acc[0] += ((1 - h1) * (1 - h2)).sum(axis=0)
            gp_acc[1] += (h1 * (1 - h2) + (1 - h1) * h2).sum(axis=0)
            gp_acc[2] += (h1 * h2).sum(axis=0)
            if nl == 3:
                h3 = hap_dos[:, 2]
                fet_dosage_acc += (h1 + h3).sum(axis=0)
                fet_gp_acc[0] += ((1 - h1) * (1 - h3)).sum(axis=0)
                fet_gp_acc[1] += (h1 * (1 - h3) + (1 - h1) * h3).sum(axis=0)
                fet_gp_acc[2] += (h1 * h3).sum(axis=0)
            n_acc += C
        hap_dos_final = hap_dos

    if rare_common:
        gp_a, gpF_a, hd_a = run_all_snp_gibbs(
            which_haps, hap_dos_final, max_diff
        )
        h1a, h2a = hd_a[:, 0], hd_a[:, 1]
        dosage_all_acc += (h1a + h2a).sum(axis=0)
        gp_all_acc[0] += ((1 - h1a) * (1 - h2a)).sum(axis=0)
        gp_all_acc[1] += (h1a * (1 - h2a) + (1 - h1a) * h2a).sum(axis=0)
        gp_all_acc[2] += (h1a * h2a).sum(axis=0)
        if nl == 3:
            h3a = hd_a[:, 2]
            fet_dosage_all_acc += (h1a + h3a).sum(axis=0)
            fet_gp_all_acc[0] += ((1 - h1a) * (1 - h3a)).sum(axis=0)
            fet_gp_all_acc[1] += (h1a * (1 - h3a) + (1 - h1a) * h3a).sum(axis=0)
            fet_gp_all_acc[2] += (h1a * h3a).sum(axis=0)
        n_all_acc += C

    def _diag_kwargs():
        return dict(
            per_it_likelihoods=diag.get("per_it_ll"),
            seek_dosages=(
                np.stack(diag["seek_dosages"])
                if "seek_dosages" in diag else None
            ),
            read_label_usage=(
                np.stack(diag["label_usage"])
                if "label_usage" in diag else None
            ),
            H_class=diag.get("H_class"),
        )

    # ------------------------------------------------------------------
    # cross-chain consensus (diploid; NIPT folds 3->2 first, reference
    # functions.R:1788-1832)
    # ------------------------------------------------------------------
    labels_all = H[:, : reads.nReads].T.astype(np.int64)    # [R, C]
    conf_all = np.zeros_like(labels_all, dtype=bool)
    for c in range(C):
        em = emat_read_vs_dosages(reads, hap_dos_final[c])
        conf_all[:, c] = read_confidence(em)
    if nl == 3:
        labels2 = labels_all.copy()
        conf2 = conf_all & (labels_all != 2)
        labels2[labels_all == 2] = 1
        cons = consensus_read_labels(labels2, conf2)
        cons[labels_all[:, C - 1] == 2] = 2
    else:
        cons = consensus_read_labels(labels_all, conf_all)

    # ------------------------------------------------------------------
    # phasing pass (reference: i_gibbs_sample == nGibbsSamples+1)
    # ------------------------------------------------------------------
    # phasing chain replicated x C to reuse the main chains' compiled
    # kernel shapes (a second compile costs more than the redundant rows;
    # the sweep cost is nearly flat in batch size)
    H_p = np.zeros((C, R), dtype=np.int32)
    H_p[:, : reads.nReads] = cons[None, :]
    wh_p = np.repeat(which_haps[C - 1:C], C, axis=0).copy()
    for i_it in range(1, ctx.n_seek_its + 1):
        gp_p, gpF_p, hap_dos_p, H_p, max_diff = run_chains(
            wh_p, H_p, False, np.zeros(C, dtype=np.int32), max_diff
        )
        if cfg.use_mspbwt:
            from ..panel.mspbwt import select_new_haps_mspbwt
            hap_dos_ph = hap_dos_p[:, :, :nSNPs]
            n_keep = ctx.Ksub - ctx.Knew
            prev_sel = rng.choice(wh_p[0], size=n_keep, replace=False)
            new = select_new_haps_mspbwt(
                prep.ms_indices, prep.panel, hap_dos_ph[0], ctx.Knew, K,
                prev_sel, rng, mspbwtL=cfg.mspbwtL, mspbwtM=cfg.mspbwtM,
                heuristic_approach=cfg.heuristic_approach,
            )
            wh_p[:] = np.sort(np.concatenate([prev_sel, new]))[None, :]
        else:
            hap_dos_ph, wh_p = run_fb_and_select(H_p, wh_p, False)
    hap_dos_ph = hap_dos_ph[:1]

    if rare_common:
        gp_ph, gpF_ph, hd_ph = run_all_snp_gibbs(
            wh_p[:1], hap_dos_ph[:1, :, :nSNPs], max_diff
        )
        hap_dos_ph = hd_ph          # phased hap dosages over ALL SNPs
        gp_all = gp_all_acc / max(n_all_acc, 1)
        dosage_all = dosage_all_acc / max(n_all_acc, 1)
        if nl == 2:
            hd1, hd2 = recast_haps(hap_dos_ph[0, 0], hap_dos_ph[0, 1], gp_all)
            return SampleResult(
                imputed=True,
                dosage=dosage_all,
                gp=gp_all,
                phased_haps=np.stack([np.round(hd1), np.round(hd2)]),
                read_labels=cons,
                allele_count=sample_allele_count(
                    reads_all, nSNPs_all
                ),
                **_diag_kwargs(),
            )
        fet_gp_all = fet_gp_all_acc / max(n_all_acc, 1)
        fet_dosage_all = fet_dosage_all_acc / max(n_all_acc, 1)
        h1, h2, h3 = recast_nipt_haps(
            hap_dos_ph[0, 0], hap_dos_ph[0, 1], hap_dos_ph[0, 2],
            gp_all, fet_gp_all,
        )
        return SampleResult(
            imputed=True,
            dosage=dosage_all,
            gp=gp_all,
            phased_haps=np.stack([h1, h2, h3]),
            read_labels=cons,
            allele_count=sample_allele_count(reads_all, nSNPs_all),
            mat_gp=gp_all,
            fet_gp=fet_gp_all,
            mat_dosage=dosage_all,
            fet_dosage=fet_dosage_all,
            **_diag_kwargs(),
        )

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------
    gp = gp_acc / max(n_acc, 1)
    dosage = dosage_acc / max(n_acc, 1)
    if nl == 2:
        hd1, hd2 = recast_haps(
            hap_dos_ph[0, 0], hap_dos_ph[0, 1], gp
        )
        phased = np.stack([np.round(hd1), np.round(hd2)])
        result = SampleResult(
            imputed=True,
            dosage=dosage,
            gp=gp,
            phased_haps=phased,
            read_labels=cons,
            allele_count=sample_allele_count(reads, nSNPs),
            hla_gammas=hla_gammas,
            hla_gamma_total=(
                hla_gammas.sum(axis=(0, 1)) if hla_gammas is not None else None
            ),
            **_diag_kwargs(),
        )
    else:
        fet_gp = fet_gp_acc / max(n_acc, 1)
        fet_dosage = fet_dosage_acc / max(n_acc, 1)
        h1, h2, h3 = recast_nipt_haps(
            hap_dos_ph[0, 0], hap_dos_ph[0, 1], hap_dos_ph[0, 2], gp, fet_gp
        )
        result = SampleResult(
            imputed=True,
            dosage=dosage,
            gp=gp,
            phased_haps=np.stack([h1, h2, h3]),
            read_labels=cons,
            allele_count=sample_allele_count(reads, nSNPs),
            mat_gp=gp,
            fet_gp=fet_gp,
            mat_dosage=dosage,
            fet_dosage=fet_dosage,
            **_diag_kwargs(),
        )
    return result


def sample_allele_count(reads: SampleReads, nSNPs: int) -> np.ndarray:
    """Per-site expected (alt, total) allele counts from the pileup
    (reference: increment2N use at functions.R:1383-1401)."""
    probs = bq_to_probs(reads.bq)
    alt = np.zeros(nSNPs)
    ref = np.zeros(nSNPs)
    np.add.at(alt, reads.u, probs[:, 1])
    np.add.at(ref, reads.u, probs[:, 0])
    return np.stack([alt, ref + alt], axis=1)


def optimal_hap_dosages(
    ctx: RegionContext,
    reads: SampleReads,
    cfg: ImputeConfig,
    truth_haps_sample: np.ndarray,     # [nSNPs, 2] truth alleles (may have nan)
) -> np.ndarray:
    """Haploid dosages when read-label origin is known from truth — the
    "optimal haplotype dosages" added as the OHD FORMAT field under
    addOptimalHapsToVCF (reference: quilt.R:48, functions.R:280-281,1419).

    Reads are assigned to the truth haplotype that best explains them, then
    one full-panel FB pass per latent hap produces the dosages."""
    prep = ctx.prep
    nSNPs = prep.nSNPs
    reads = reads.sorted_by_grid()
    truth = np.nan_to_num(truth_haps_sample.T.astype(np.float64), nan=0.5)
    em = emat_read_vs_dosages(reads, truth)            # [2, R]
    H_opt = em.argmax(axis=0).astype(np.int32)
    gls = gls_from_labels(reads, H_opt, 2, nSNPs, cfg.minGLValue)
    fb_inputs = ctx.fb_inputs
    if fb_inputs is None:
        fb_inputs = FBInputs.build(
            prep.panel, ctx.trans, thinned_grids=ctx.thinned_grids
        )
    res = fb_full_batched(
        gls.astype(np.float32), fb_inputs,
        K_top=max(8, cfg.K_top_matches), ref_error=prep.ref_error,
    )
    return res[0]                                       # [2, nSNPs]
