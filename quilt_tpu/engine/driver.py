"""Multi-sample imputation driver: the QUILT() equivalent.

Mirrors the orchestration in QUILT/R/quilt.R:97-1074 — load prepared
reference, build transition rates, impute each sample, aggregate the
info-score / allele-frequency / HWE counts, and write the VCF — minus the
fork-based parallelism (samples batch onto the device instead).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import ImputeConfig
from ..io.reads import SampleReads
from ..panel.prepare import PreparedReference
from ..out.vcf_writer import (
    MISSING_DIPLOID_COL,
    MISSING_NIPT_COL,
    diploid_sample_column,
    hwe_from_counts,
    info_score,
    nipt_sample_column,
    write_quilt_vcf,
)
from ..out.metrics import calculate_pse, r2_simple
from ..utils import print_message
from .sample import RegionContext, SampleResult, impute_one_sample


@dataclass
class ImputeOutput:
    results: List[SampleResult]
    vcf_path: Optional[str]
    eaf: np.ndarray
    info: np.ndarray
    r2_per_sample: Optional[List[float]] = None
    # per-stage wall-time breakdown (print_extra_timing_information)
    timing: Optional[Dict] = None


def quilt_impute(
    prep: PreparedReference,
    samples: Sequence[SampleReads],
    sample_names: Sequence[str],
    cfg: ImputeConfig,
    output_filename: Optional[str] = None,
    ff_values: Optional[np.ndarray] = None,
    truth_gen: Optional[np.ndarray] = None,     # [nSNPs, N] truth genotypes
    truth_haps: Optional[np.ndarray] = None,    # [nSNPs, N, 2]
    region_name: str = "region",
) -> ImputeOutput:
    t0 = time.time()
    from ..utils import set_verbosity
    set_verbosity(cfg.verbose)
    from .validators import validate_impute_config, validate_region_consistency
    validate_impute_config(cfg)
    validate_region_consistency(prep, cfg)
    N = len(samples)
    # region setup (distinct-hap escape tables, device panel uploads,
    # mspbwt symbol caches) is per-region work the reference amortises by
    # loading one RData per job; cache it on the prepared reference so
    # repeated quilt_impute calls on one region pay it once. The key
    # covers every cfg field RegionContext.build consumes.
    ctx_key = (
        cfg.method, cfg.Ksubset, cfg.Knew, cfg.n_seek_its,
        cfg.resolved_n_burn_in_seek_its(), cfg.use_mspbwt, cfg.hla_run,
        cfg.gamma_physically_closest_to, cfg.impute_rare_common,
        cfg.heuristic_match_thin, cfg.shuffle_bin_radius,
        cfg.block_gibbs_boundary_detection, cfg.max_block_gibbs_boundaries,
        cfg.block_gibbs_quantile_prob, cfg.K_top_matches,
        cfg.override_default_params_for_small_ref_panel,
        cfg.mesh_data, cfg.mesh_panel,
    )
    cached = getattr(prep, "_region_ctx_cache", None)
    if cached is not None and cached[0] == ctx_key:
        ctx = cached[1]
        from ..utils.log import SectionTimers
        object.__setattr__(
            ctx, "timers", SectionTimers(cfg.print_extra_timing_information)
        )
    else:
        ctx = RegionContext.build(prep, cfg)
        try:
            prep._region_ctx_cache = (ctx_key, ctx)
        except AttributeError:
            pass
    method = cfg.method
    ff_values = np.asarray(
        ff_values if ff_values is not None else np.zeros(N)
    )
    rare_common = cfg.impute_rare_common and prep.snp_is_common is not None
    if rare_common:
        # samples hold ALL-SNP reads; the seek loop runs on common SNPs
        # (reference: quilt.R:664-684, functions.R:130-174)
        from .rare_common import restrict_reads_to_common
        nSNPs = len(prep.snp_is_common)
        out_pos = prep.pos_all
        out_ref, out_alt = prep.ref_allele_all, prep.alt_allele_all
        in_region = prep.in_region_all()
        samples_all = list(samples)
        samples = [
            restrict_reads_to_common(r, prep.snp_is_common, prep.grid)
            if r is not None else None
            for r in samples_all
        ]
    else:
        nSNPs = prep.nSNPs
        out_pos = prep.pos
        out_ref, out_alt = prep.ref_allele, prep.alt_allele
        in_region = prep.in_region()
        samples_all = [None] * N

    eij_sum = np.zeros(nSNPs)
    var_sum = np.zeros(nSNPs)
    af_sum = np.zeros(nSNPs)
    hwe_counts = np.zeros((nSNPs, 3), dtype=np.int64)
    allele_count = np.zeros((nSNPs, 2))
    results: List[Optional[SampleResult]] = []
    columns: List[Optional[List[str]]] = []
    r2s: List[float] = []
    n_imputed = 0

    # multi-process data parallelism (dist/hosts.py): each process
    # imputes its contiguous sample shard; aggregates reduce and columns
    # gather before the process-0 VCF write
    import jax as _jax
    nproc = _jax.process_count()
    multihost = nproc > 1
    if multihost:
        from ..dist.hosts import sample_shards
        pid = _jax.process_index()
        local_set = set(int(i) for i in sample_shards(N, nproc)[pid])
        print_message(
            f"Multi-host: process {pid}/{nproc} imputes "
            f"{len(local_set)}/{N} samples"
        )
    else:
        pid = 0
        local_set = set(range(N))

    # multi-sample device batching (production path): the Gibbs sweep cost
    # is nearly flat in batch size, so samples x chains share one kernel call
    needs_per_sample_diag = (
        cfg.make_heuristic_plot or cfg.record_read_label_usage
        or cfg.record_interim_dosages or cfg.output_read_label_prob
        or bool(cfg.RData_objects_to_save) or bool(cfg.output_RData_filename)
        or cfg.make_plots or cfg.plot_per_sample_likelihoods
    )
    use_batched = (
        cfg.sample_batch > 1
        and N > 1
        and not cfg.hla_run
        and not needs_per_sample_diag
        and method in ("diploid", "nipt")
    )
    precomputed: Dict[int, SampleResult] = {}
    if use_batched:
        from .batch import gibbs_chain_cap, impute_samples_batched
        # clamp the device batch (rows = samples x nGibbsSamples) so one
        # Gibbs sweep call fits its share of this device's memory
        from ..kernels.common import pad_to_multiple as _ptm
        from ..utils.device import device_bytes_limit
        nl_eff = 3 if method == "nipt" else 2
        R_max = max(
            [r.nReads for r in samples if r is not None] + [1]
        )
        cap_chains = gibbs_chain_cap(
            _ptm(max(cfg.Ksubset, 1), 128), nl_eff, G=prep.nGrids,
            R=_ptm(R_max, 64), bytes_limit=device_bytes_limit(),
        )
        group_cap = max(1, cap_chains // max(cfg.nGibbsSamples, 1))
        sample_batch = min(cfg.sample_batch, group_cap)
        if sample_batch < cfg.sample_batch:
            print_message(
                f"Clamping sample_batch {cfg.sample_batch} -> "
                f"{sample_batch} (Gibbs batch device-memory share at "
                f"Ksubset={cfg.Ksubset})"
            )
        # NIPT batches share one ff (the kernel's class tables are
        # ff-shaped); group sample indices by ff so per-sample fetal
        # fractions stay exact
        if method == "nipt":
            order: Dict[float, List[int]] = {}
            for i in sorted(local_set):
                order.setdefault(float(ff_values[i]), []).append(i)
            index_groups = [g for v in order.values() for g in
                            [v[j:j + sample_batch]
                             for j in range(0, len(v), sample_batch)]]
        else:
            local_sorted = sorted(local_set)
            index_groups = [
                local_sorted[s0:s0 + sample_batch]
                for s0 in range(0, len(local_sorted), sample_batch)
            ]
        for group in index_groups:
            if len(group) == 1 and rare_common:
                continue   # no batching win; per-sample path below
            print_message(
                f"Imputing samples {group[0] + 1}-{group[-1] + 1}/{N} "
                f"(batched)"
            )
            batch_res = impute_samples_batched(
                ctx, [samples[i] for i in group], cfg,
                seed=cfg.seed + group[0],
                ff_values=ff_values[group],
                reads_all_list=(
                    [samples_all[i] for i in group] if rare_common else None
                ),
            )
            for gi, i in enumerate(group):
                precomputed[i] = batch_res[gi]

    for i, reads in enumerate(samples):
        if i not in local_set:
            results.append(None)
            columns.append(None)
            continue
        if i in precomputed:
            res = precomputed[i]
        else:
            print_message(f"Imputing sample {i + 1}/{N}: {sample_names[i]}")
            res = impute_one_sample(
                ctx, reads, cfg, seed=cfg.seed + i, ff=ff_values[i],
                reads_all=samples_all[i],
            )
        results.append(res)
        if not res.imputed:
            print_message(
                f"Sample {sample_names[i]} has fewer than "
                f"{cfg.minimum_number_of_sample_reads} reads; output missing"
            )
            miss = MISSING_NIPT_COL if method == "nipt" else MISSING_DIPLOID_COL
            if cfg.addOptimalHapsToVCF and truth_haps is not None and method != "nipt":
                miss += ":.,."
            columns.append([miss] * nSNPs)
            continue
        n_imputed += 1
        gp = res.mat_gp if method == "nipt" else res.gp
        eij = np.round(gp[1] + 2 * gp[2], 3)
        fij = np.round(gp[1] + 4 * gp[2], 3)
        eij_sum += eij
        var_sum += fij - eij ** 2
        af_sum += eij / 2
        hwe_counts[np.arange(nSNPs), gp.argmax(axis=0)] += 1
        allele_count += res.allele_count
        if method == "nipt":
            with ctx.timers.section("vcf:columns"):
                columns.append(
                    nipt_sample_column(
                        res.mat_gp, res.fet_gp, res.mat_dosage,
                        res.fet_dosage, res.phased_haps,
                    )
                )
        else:
            ohd = None
            if (cfg.addOptimalHapsToVCF and truth_haps is not None
                    and not rare_common):
                # optimal haploid dosages given truth read labels
                # (reference: functions.R:280-281,1419; OHD FORMAT field)
                from .sample import optimal_hap_dosages
                ohd = optimal_hap_dosages(
                    ctx, samples[i], cfg, truth_haps[:, i]
                )
            with ctx.timers.section("vcf:columns"):
                columns.append(
                    diploid_sample_column(
                        res.gp, res.phased_haps, res.dosage,
                        output_gt_phased_genotypes=(
                            cfg.output_gt_phased_genotypes
                        ),
                        ohd=ohd,
                    )
                )
        if (cfg.make_plots or cfg.plot_per_sample_likelihoods) and cfg.outputdir:
            # plot_per_sample_likelihoods draws the same diagnostic panel,
            # which includes the per-iteration likelihood traces
            # (reference: plotting_functions.R:351-552)
            from ..out.plots import (
                plot_hclass, plot_read_label_flips, plot_sample_diagnostics,
            )
            plot_sample_diagnostics(
                cfg.outputdir, sample_names[i], region_name,
                pos=out_pos, dosage=res.dosage, gp=gp,
                af=prep.af_all if rare_common else prep.af,
                truth_gen=truth_gen[:, i] if truth_gen is not None else None,
                per_it_likelihoods=res.per_it_likelihoods,
            )
            # read-flip / H_class diagnostics (reference:
            # plotting_functions.R:553-734) when the data was recorded
            if res.read_label_usage is not None:
                plot_read_label_flips(
                    cfg.outputdir, sample_names[i], region_name,
                    res.read_label_usage,
                )
            if res.H_class is not None:
                plot_hclass(
                    cfg.outputdir, sample_names[i], region_name, res.H_class
                )
            if ctx.boundaries is not None and len(ctx.boundaries):
                # block-Gibbs diagnostics (reference:
                # plot_attempt_to_reblock_snps, gibbs-nipt-block.R:2006-2315)
                from ..out.plots import plot_block_gibbs
                plot_block_gibbs(
                    cfg.outputdir, sample_names[i], region_name,
                    L_grid=prep.L_grid, smooth_rate=ctx.smooth_cm,
                    boundaries=ctx.boundaries,
                    read_label_usage=res.read_label_usage,
                    read_grids=samples[i].wif0 if samples[i] is not None
                    else None,
                )
        if truth_gen is not None:
            r2 = r2_simple(truth_gen[:, i], res.dosage)
            r2s.append(r2)
            msg = f"  r2 vs truth: {r2:.4f}"
            # common/rare split, as the reference prints per seek iteration
            # (calculate_pse_and_r2_master, pse_and_r2.R:3-77)
            af_here = prep.af_all if rare_common else prep.af
            if af_here is not None:
                maf = np.minimum(af_here, 1 - af_here)
                com = maf >= 0.05
                if com.any() and (~com).any():
                    r2c = r2_simple(truth_gen[com, i], res.dosage[com])
                    r2r = r2_simple(truth_gen[~com, i], res.dosage[~com])
                    msg += f" (common {r2c:.4f}, rare {r2r:.4f})"
            if truth_haps is not None and res.phased_haps is not None:
                pse = calculate_pse(res.phased_haps[:2].T, truth_haps[:, i])
                msg += f", PSE: {pse['pse']:.4f} ({pse.get('phase_sites', 0)} het sites)"
            print_message(msg)

    if multihost:
        # cross-process reduction of the INFO/EAF/HWE accumulators + column gather,
        # so the merged VCF is bit-identical to a single-process run
        from ..dist.hosts import allgather_columns, reduce_sum_across_hosts
        red = reduce_sum_across_hosts({
            "eij_sum": eij_sum, "var_sum": var_sum, "af_sum": af_sum,
            "hwe_counts": hwe_counts, "allele_count": allele_count,
            "n_imputed": np.array(n_imputed, dtype=np.int64),
        })
        eij_sum, var_sum, af_sum = red["eij_sum"], red["var_sum"], red["af_sum"]
        hwe_counts, allele_count = red["hwe_counts"], red["allele_count"]
        n_imputed = int(red["n_imputed"])
        local_cols = {
            i: columns[i] for i in local_set if columns[i] is not None
        }
        columns = allgather_columns(local_cols, N)

    denom = max(n_imputed, 1)
    eaf = af_sum / denom
    info = info_score(eij_sum, var_sum, denom)
    hwe = hwe_from_counts(hwe_counts)

    if multihost and pid != 0:
        output_filename = None          # process 0 writes the merged VCF
    vcf_path = None
    if output_filename:
        vcf_path = output_filename
        _vcf_sec = ctx.timers.section("vcf:write")
        _vcf_sec.__enter__()
        write_quilt_vcf(
            vcf_path,
            chrom=prep.chrom,
            pos=out_pos,
            ref_allele=out_ref,
            alt_allele=out_alt,
            sample_names=sample_names,
            sample_columns=columns,
            eaf=eaf,
            info=info,
            hwe=hwe,
            allele_count=allele_count,
            in_region=in_region,
            method=method,
            output_gt_phased_genotypes=cfg.output_gt_phased_genotypes,
            with_ohd=cfg.addOptimalHapsToVCF and truth_haps is not None,
        )
        _vcf_sec.__exit__(None, None, None)
        print_message(f"Wrote {vcf_path}")
    if (cfg.make_heuristic_plot and truth_gen is not None and cfg.outputdir
            and not rare_common):
        # hap-selection strategy comparison (reference: make_heuristic_plot,
        # heuristic.R:40-176): rerun each sample under the other selection
        # strategy and plot dosage r2 vs truth per seek iteration
        from dataclasses import replace as dc_replace
        from ..out.plots import plot_heuristic_comparison

        # strategy panel mirroring the reference's 5 traces (QUILT1,
        # zilong A/B, mspbwt A/B): full-panel top-K plus the mspbwt
        # selection under both match-finding approaches. (The reference's
        # zilong A and B rows are captures of the same non-mspbwt selection
        # at two pipeline points, functions.R:752-778 — they collapse to
        # the QUILT1 trace here.)
        can_mspbwt = prep.ms_indices is not None
        cur = (f"mspbwt {cfg.heuristic_approach}" if cfg.use_mspbwt
               else "QUILT1 top-K")
        variants = {}
        if cfg.use_mspbwt:
            variants["QUILT1 top-K"] = dc_replace(
                cfg, use_mspbwt=False, make_plots=False)
        elif can_mspbwt:
            variants[f"mspbwt {cfg.heuristic_approach}"] = dc_replace(
                cfg, use_mspbwt=True, make_plots=False)
        if can_mspbwt:
            other = "B" if cfg.heuristic_approach == "A" else "A"
            variants[f"mspbwt {other}"] = dc_replace(
                cfg, use_mspbwt=True, heuristic_approach=other,
                make_plots=False)
        for i, res in enumerate(results):
            if res is None or not res.imputed or res.seek_dosages is None:
                continue
            traces = {
                cur: [r2_simple(truth_gen[:, i], d)
                      for d in res.seek_dosages],
            }
            if not cfg.use_mspbwt:
                # the reference's 5-row panel captures zilong A and B as
                # the current non-mspbwt selection at two pipeline points
                # (functions.R:752-778) — both rows duplicate that trace
                traces["zilong A (= current)"] = traces[cur]
                traces["zilong B (= current)"] = traces[cur]
            for label, vcfg in variants.items():
                res_alt = impute_one_sample(
                    ctx, samples[i], vcfg, seed=cfg.seed + i,
                    ff=ff_values[i], reads_all=samples_all[i],
                )
                if res_alt.imputed and res_alt.seek_dosages is not None:
                    traces[label] = [r2_simple(truth_gen[:, i], d)
                                     for d in res_alt.seek_dosages]
            plot_heuristic_comparison(
                cfg.outputdir, sample_names[i], region_name, traces
            )
    want_dump = (
        cfg.output_read_label_prob
        or cfg.RData_objects_to_save
        or cfg.output_RData_filename
        or cfg.record_read_label_usage
        or cfg.record_interim_dosages
    )
    if want_dump and (cfg.outputdir or cfg.output_RData_filename):
        # npz equivalent of the reference's output_RData_filename /
        # RData_objects_to_save dump (quilt.R:1029-1068): every requested
        # per-sample object saved under <object>_<sample>
        import os
        # default: everything available; RData_objects_to_save restricts
        exportable = (
            "read_labels", "per_it_likelihoods", "H_class", "dosage", "gp",
            "phased_haps", "seek_dosages", "read_label_usage", "hla_gammas",
        )
        wanted = exportable
        if cfg.RData_objects_to_save:
            unknown = [o for o in cfg.RData_objects_to_save
                       if o not in exportable]
            if unknown:
                print_message(
                    f"Warning: unknown RData_objects_to_save {unknown}; "
                    f"exportable: {list(exportable)}"
                )
            wanted = [o for o in cfg.RData_objects_to_save if o in exportable]
        dump = {}
        for i, res in enumerate(results):
            if res is None or not res.imputed:
                continue
            for obj in wanted:
                val = getattr(res, obj, None)
                if val is not None:
                    dump[f"{obj}_{sample_names[i]}"] = val
        out_npz = cfg.output_RData_filename
        if not out_npz:
            os.makedirs(os.path.join(cfg.outputdir, "RData"), exist_ok=True)
            out_npz = os.path.join(
                cfg.outputdir, "RData", f"quilt.output.{region_name}.npz"
            )
        np.savez_compressed(out_npz, **dump)
        print_message(f"Wrote output objects to {out_npz}")
    timing = None
    if ctx.timers is not None:
        ctx.timers.report()
        if getattr(ctx.timers, "enabled", False):
            timing = ctx.timers.as_dict()
    print_message(f"Done QUILT ({time.time() - t0:.1f}s)")
    return ImputeOutput(
        results=results, vcf_path=vcf_path, eaf=eaf, info=info,
        r2_per_sample=r2s if truth_gen is not None else None,
        timing=timing,
    )
