"""Multi-sample batched imputation.

The Gibbs sweep's device cost is nearly flat in the batch size (it is
dominated by sequential per-grid/per-read step latency), so imputing many
samples in one kernel call multiplies throughput: batch rows are
{sample x chain}, each row carrying its own reads (GibbsInputs/PaddedReads
build_batched). This replaces the reference's fork-per-sample parallelism
(QUILT/R/quilt.R:692) as the production scaling path on a chip.

Covers the diploid and NIPT paths of QUILT1 and QUILT2 (mspbwt and
rare/common included — the all-SNP final Gibbs runs batched too); HLA and
diagnostic-flag runs use the per-sample engine (engine/sample.py). NIPT
batches share one fetal fraction; the driver groups samples by ff.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import jax.numpy as jnp

import jax

from ..config import ImputeConfig
from ..io.reads import SampleReads
from ..kernels import PaddedReads, fb_full_batched
from ..kernels.common import pad_to_multiple
from ..kernels.emissions import (
    ReadWindowCache, gls_from_labels_device, gls_from_labels_windowed,
)
from ..kernels.gibbs import GibbsInputs, run_gibbs_chains

# shares of the device's memory limit (utils.device.device_bytes_limit)
# for the arrays that live through one batch
GIBBS_MEMORY_SHARE = 0.3   # one Gibbs sweep call
LEM_MEMORY_SHARE = 0.2     # the whole-panel read-emission cache


def gibbs_chain_cap(K_pad: int, nl: int, G: int, R: int,
                    bytes_limit: int) -> int:
    """Largest chain batch (rows = samples x chains) whose Gibbs sweep
    fits GIBBS_MEMORY_SHARE of `bytes_limit`. Per row: the lemg, beta and
    alphas [G, nl, K_pad] f32 planes, three copies each (loop carry, scan
    output, block-move result), and five [K_pad, R] f32 layouts of the
    read emissions."""
    per_row = 9 * G * nl * K_pad * 4 + 5 * K_pad * R * 4
    return max(1, int(bytes_limit * GIBBS_MEMORY_SHARE) // per_row)


def lem_cache_fits(n_samples: int, K: int, R_pad: int, S: int,
                   bytes_limit: int) -> bool:
    """Whether the per-batch whole-panel log eMatRead [n_samples * K,
    R_pad] f32 and the expanded bf16 panel [K, S] fit LEM_MEMORY_SHARE of
    `bytes_limit`; larger panels build emissions per call instead."""
    need = n_samples * K * R_pad * 4 + K * S * 2
    return need <= bytes_limit * LEM_MEMORY_SHARE


@jax.jit
def _gather_words(rhb_dev, which):
    """Device-side subset gather of PACKED panel words: only the
    [B, Ksub] index array crosses to the device, and the panel stays
    bit-packed all the way into the kernels (the emission builder and
    dosage pass unpack words on the fly — no [B, K, S] byte panel in
    device memory). Flat 1-D row indices keep the gather one-dimensional."""
    B, Kp = which.shape
    return jnp.take(
        rhb_dev, which.reshape(-1), axis=0
    ).reshape(B, Kp, rhb_dev.shape[1])


def _device_uniforms(key, shape):
    return jax.random.uniform(key, shape, dtype=jnp.float32)
from ..utils import print_message
from ..utils.device import device_bytes_limit
from .sample import (
    RegionContext,
    SampleResult,
    _gather_topk_lists,
    sample_allele_count,
)
from .selection import (
    consensus_read_labels,
    read_confidence_device,
    recast_haps,
    recast_nipt_haps,
    select_new_haps_device,
    select_new_haps_from_topk,
)


def impute_samples_batched(
    ctx: RegionContext,
    reads_list: Sequence[SampleReads],
    cfg: ImputeConfig,
    seed: int,
    ff_values: Optional[np.ndarray] = None,
    reads_all_list: Optional[Sequence[SampleReads]] = None,
) -> List[SampleResult]:
    """Whole-batch underflow retry wrapper (reference: the per-call /10
    retry of functions.R:2704-2714). The device seek loop defers the
    underflow check to one end-of-batch fetch, so that no iteration waits
    for the host; on underflow the whole batch reruns with the reduced
    maxDifferenceBetweenReads."""
    max_diff = cfg.maxDifferenceBetweenReads
    for attempt in range(11):
        results, uf_seen = _impute_samples_batched_once(
            ctx, reads_list, cfg, seed + attempt, max_diff,
            ff_values=ff_values, reads_all_list=reads_all_list,
        )
        if not uf_seen:
            return results
        max_diff = max(1.0, max_diff / 10.0)
        print_message(
            f"Underflow; rerunning batch with "
            f"maxDifferenceBetweenReads={max_diff}"
        )
    return results


def _impute_samples_batched_once(
    ctx: RegionContext,
    reads_list: Sequence[SampleReads],
    cfg: ImputeConfig,
    seed: int,
    max_diff_0: float,
    ff_values: Optional[np.ndarray] = None,
    reads_all_list: Optional[Sequence[SampleReads]] = None,
):
    prep = ctx.prep
    nSNPs, nGrids, K, nl = prep.nSNPs, prep.nGrids, prep.K, ctx.n_latent
    rng = np.random.default_rng(seed)
    # per-stage wall-time attribution (print_extra_timing_information):
    # sections drain the device queue at their boundary so async dispatch
    # time lands on the stage that issued it
    timers = ctx.timers
    timing = timers is not None and getattr(timers, "enabled", False)

    def _sec(name):
        if timing:
            return timers.section(name)
        import contextlib
        return contextlib.nullcontext()

    def _drain(x):
        if timing and x is not None:
            jax.block_until_ready(x)
        return x
    S = len(reads_list)
    C = cfg.nGibbsSamples
    B = S * C
    ff_values = ff_values if ff_values is not None else np.zeros(S)
    ff = float(ff_values[0])  # batched NIPT assumes shared ff per batch

    ok = [r.nReads >= cfg.minimum_number_of_sample_reads for r in reads_list]
    reads_sorted = [r.sorted_by_grid() for r in reads_list]

    _inputs_sec = _sec("inputs_build")
    _inputs_sec.__enter__()
    ginputs1 = GibbsInputs.build_batched(reads_sorted, ctx.trans, nGrids)
    ginputs = ginputs1.repeat_rows(C)
    R = ginputs.R
    preads1 = PaddedReads.build_batched(reads_sorted, ref_error=prep.ref_error)
    preads = PaddedReads(
        u_pad=np.repeat(preads1.u_pad, C, axis=0),
        lr=np.repeat(preads1.lr, C, axis=0),
        la=np.repeat(preads1.la, C, axis=0),
        mask=np.repeat(preads1.mask, C, axis=0),
        wif0=np.repeat(preads1.wif0, C, axis=0),
        nReads=preads1.nReads,
        J=preads1.J,
        lpr=np.repeat(preads1.lpr, C, axis=0),
        lpa=np.repeat(preads1.lpa, C, axis=0),
    )
    _inputs_sec.__exit__(None, None, None)
    n_its = cfg.small_ref_panel_gibbs_iterations + 1
    if nl == 2:
        label_prior = np.array([0.5, 0.5])
    else:
        label_prior = np.array([0.5, (1 - ff) / 2, ff / 2])

    which_haps = np.stack([
        np.sort(rng.choice(K, size=ctx.Ksub, replace=False)) for _ in range(B)
    ])                                                     # [B, Ksub]
    H = np.zeros((B, R), dtype=np.int32)
    for s in range(S):
        nr = reads_sorted[s].nReads
        for c in range(C):
            H[s * C + c, :nr] = rng.choice(nl, size=nr, p=label_prior)
    max_diff = max_diff_0
    first_read = np.array(
        [rng.integers(0, max(reads_sorted[b // C].nReads, 1))
         for b in range(B)], dtype=np.int32,
    )
    # on-device seek loop: hap subsets, read labels and the underflow flag
    # stay device-resident end to end (fb top-K selection runs on device);
    # the mesh-sharded FB and mspbwt paths keep host-side selection
    dev_sel = (
        not cfg.use_mspbwt and ctx.sharded_fb is None and ctx.mesh is None
    )
    uf_dev = jnp.zeros((), dtype=bool)
    sel_key = jax.random.PRNGKey(int(rng.integers(0, 2**31)))

    do_block_np = np.zeros(n_its, dtype=bool)
    for bit in cfg.small_ref_panel_block_gibbs_iterations:
        if 1 <= bit <= n_its:
            do_block_np[bit - 1] = True
    bnd = ctx.boundaries if ctx.boundaries is not None else np.zeros(0, np.int32)
    otf = ctx.smooth_w is not None
    nb_slots = ctx.block_nb_cap if otf else len(bnd)

    rhb_dev = ctx.rhb_dev()
    Kp_sub = pad_to_multiple(ctx.Ksub, 128)

    def run_chains(which_b, H0_b, iterative, first_b, ginputs_b, preads_b,
                   max_diff):
        """One 21-sweep Gibbs call. which_b is either a device [Bb, Ksub]
        array (dev_sel mode) or host numpy; H0_b may be device. No host
        round trips: the underflow flag is accumulated on device and
        checked once at the end of the batch."""
        nonlocal uf_dev
        Bb = np.shape(which_b)[0]
        Ksub_b = np.shape(which_b)[1]
        with _sec("gibbs:bits_gather"):
            if isinstance(which_b, jax.Array):
                which_p = which_b if Kp_sub == Ksub_b else jnp.concatenate(
                    [which_b]
                    + [which_b[:, :1]] * (Kp_sub - Ksub_b), axis=1
                )
            else:
                # pad hap-subset indices by repeating the first entry: pad
                # rows carry zero weight in all kernel sums
                which_p = jnp.asarray(np.concatenate(
                    [which_b] + [which_b[:, :1]] * (Kp_sub - Ksub_b), axis=1
                ) if Kp_sub != Ksub_b else which_b)
            bits = _drain(_gather_words(rhb_dev, which_p))
        with _sec("gibbs:rng"):
            key = jax.random.PRNGKey(int(rng.integers(0, 2**31)))
            k1, k2, k3 = jax.random.split(key, 3)
            uniforms = _device_uniforms(k1, (n_its, Bb, ginputs_b.R))
            block_u = _device_uniforms(k2, (n_its, max(nb_slots, 1), 3, Bb))
            block_u = block_u[:, :nb_slots]
            resample_u = (
                _device_uniforms(k3, (n_its, Bb, ginputs_b.R))
                if (nl == 3 and nb_slots) else None
            )
            _drain(uniforms)
        if ctx.mesh is not None:
            # chains are shared-nothing: shard the batch axis over the mesh
            # and let XLA partition the sweep (no collectives needed)
            from ..dist.mesh import shard_gibbs_batch
            sharded, uniforms, block_u, resample_u = shard_gibbs_batch(
                ctx.mesh, {"bits": bits, "H0": jnp.asarray(H0_b),
                           "first": jnp.asarray(first_b)},
                uniforms=uniforms, block_u=block_u, resample_u=resample_u,
            )
            bits, H0_b, first_b = (
                sharded["bits"], sharded["H0"], sharded["first"]
            )
        lem_pair = None
        if lem_full is not None and ctx.mesh is None and Bb == B:
            # subset emissions from the per-batch whole-panel cache: one
            # flat row gather + rescale instead of a gather-einsum build
            with _sec("gibbs:lem_subset"):
                flat_idx = sp_of_row[:, None] * K + which_p
                lem_pair = lem_subset(
                    lem_full, flat_idx, max_diff, ginputs_b.R
                )
        # device-resident outputs: the batched path consumes only the
        # read labels (and, under mspbwt, the hap dosages) host-side;
        # fetching gp/gpF/hap_dos every call would copy them for nothing
        with _sec("gibbs:sweep_kernel"):
            gp, gpF, hap_dos, Hn, ll, uf, Hcls = run_gibbs_chains(
                bits=bits, preads=preads_b, inputs=ginputs_b,
                lem_read=lem_pair,
                uniforms=uniforms, H0=H0_b, first_read=first_b,
                n_latent=nl,
                ff=ff, n_burn_in=n_its - 1, iterative_init=iterative,
                K_real=Ksub_b, max_diff=max_diff,
                ref_error=prep.ref_error,
                boundaries=None if otf else bnd,
                block_u=block_u, do_block=do_block_np,
                resample_u=resample_u,
                smooth_w=ctx.smooth_w_dev(),
                quantile_prob=ctx.block_quantile,
                return_arrays=False,
            )
            _drain(hap_dos)
        uf_dev = jnp.logical_or(uf_dev, jnp.asarray(uf).any())
        return gp, gpF, hap_dos, Hn, max_diff

    # mspbwt mode has no FBInputs; S_pad only feeds the FB path's GL build
    S_pad = ctx.fb_inputs.S if ctx.fb_inputs is not None else nGrids * 32
    # upload the PER-SAMPLE read tensors and replicate to chain rows ON
    # DEVICE: the chain-replicated [B, R, J] versions would be C x the
    # bytes to copy, for arrays only the consensus confidence pass consumes
    preads1_dev = {
        "u": jnp.asarray(preads1.u_pad), "pr": jnp.asarray(preads1.lpr),
        "pa": jnp.asarray(preads1.lpa),
    }
    preads_dev = {
        k: jnp.repeat(v, C, axis=0) for k, v in preads1_dev.items()
    }

    # per-batch window cache: reads are fixed across the seek loop, so the
    # windowed coefficient rows upload/build once and every GL call is a
    # couple of one-hot matmuls per read chunk
    gl_cache = ReadWindowCache(
        preads1.u_pad, preads1.lpr, preads1.lpa, preads1.mask, nGrids,
        lr=preads1.lr, la=preads1.la,
    )
    # whole-panel log eMatRead, built once per batch from the same window
    # cache (gated by its share of device memory; larger panels fall back
    # to the per-call subset build inside run_gibbs_chains)
    from ..kernels.emissions import lem_full_from_cache, lem_subset
    lem_full = None
    if lem_cache_fits(S, K, gl_cache.Rpad, nGrids * 32,
                      device_bytes_limit()):
        with _sec("emat:full_build"):
            dh, dl = gl_cache.diff
            lem_full = _drain(lem_full_from_cache(
                ctx.e_full_dev(), dh, dl, gl_cache.base, gl_cache.s0,
                gl_cache.Rc, gl_cache.Swin,
            ))
    sp_of_row = jnp.asarray(np.repeat(np.arange(S), C).astype(np.int32))

    def run_fb_and_select(H_b, which_b, row_to_sample, sel_key_it):
        Bb = np.shape(H_b)[0]
        with _sec("fb:gl_build"):
            if Bb == B:
                gls = _drain(gls_from_labels_windowed(
                    gl_cache, jnp.asarray(H_b), nl, C, S_pad,
                    minGLValue=cfg.minGLValue,
                ))
            else:
                pd = preads1_dev
                gls = _drain(gls_from_labels_device(
                    pd["u"], pd["pr"], pd["pa"], jnp.asarray(H_b), nl,
                    S_pad, minGLValue=cfg.minGLValue,
                ))
        if ctx.sharded_fb is not None:
            with _sec("fb:kernel"):
                res_fb = ctx.sharded_fb(np.asarray(gls))
                dosage = res_fb[0]
                tv, ti = res_fb[2], res_fb[3]
            thin_rows = ctx.thinned_grids
        else:
            # dosages and top-K lists stay DEVICE-resident: the selection
            # runs on device (select_new_haps_device), so nothing crosses
            # the host link inside the seek loop
            with _sec("fb:kernel"):
                res_fb = fb_full_batched(
                    gls, ctx.fb_inputs, K_top=max(8, cfg.K_top_matches),
                    ref_error=prep.ref_error, return_arrays=False,
                )
                dosage = _drain(res_fb[0])[:, :nSNPs]
            if dev_sel:
                hap_dos = dosage.reshape(Bb, nl, nSNPs)
                with _sec("fb:select"):
                    tg = jnp.asarray(ctx.thinned_grids)
                    new_sets = select_new_haps_device(
                        res_fb[2][tg], res_fb[3][tg], which_b, sel_key_it,
                        ctx.Ksub - ctx.Knew, ctx.Knew, K, nl,
                        cfg.K_top_matches,
                    )
                    _drain(new_sets)
                return hap_dos, new_sets
            with _sec("fb:topk_fetch"):
                # host selection (mesh / diagnostic paths): gather the
                # thinned rows ON DEVICE before fetching — the host link
                # is the bottleneck (~10x less traffic)
                tg = jnp.asarray(ctx.thinned_grids)
                tv, ti = np.asarray(res_fb[2][tg]), np.asarray(res_fb[3][tg])
            thin_rows = np.arange(len(ctx.thinned_grids))
        hap_dos = dosage.reshape(Bb, nl, nSNPs)
        with _sec("fb:select_host"):
            new_sets = np.empty_like(which_b)
            for b in range(Bb):
                n_keep = ctx.Ksub - ctx.Knew
                prev_sel = rng.choice(which_b[b], size=n_keep, replace=False)
                li, lv = _gather_topk_lists(
                    tv, ti, thin_rows, nl, b, tv.shape[2]
                )
                new = select_new_haps_from_topk(
                    li, lv, ctx.Knew, K, prev_sel, rng, cfg.K_top_matches
                )
                new_sets[b] = np.sort(np.concatenate([prev_sel, new]))
        return hap_dos, new_sets

    # rare/common (QUILT2 impute_rare_common): the final all-SNP Gibbs
    # runs for the whole {sample x chain} batch in one kernel call, same
    # restructuring as the common-SNP sweep (reference: rare_common.R:109-470
    # runs it per sample inside the fork loop)
    rare_common = (
        cfg.impute_rare_common and reads_all_list is not None
        and prep.snp_is_common is not None
    )
    if rare_common:
        from .rare_common import (
            build_subset_bits_all, initial_all_snp_labels,
        )
        reads_all_sorted = [r.sorted_by_grid() for r in reads_all_list]
        nSNPs_all = len(prep.snp_is_common)
        nGrids_all = ctx.nGrids_all
        ginputs_all1 = GibbsInputs.build_batched(
            reads_all_sorted, ctx.trans_all, nGrids_all
        )
        ginputs_all = ginputs_all1.repeat_rows(C)
        preads_all1 = PaddedReads.build_batched(
            reads_all_sorted, ref_error=prep.ref_error
        )
        preads_all = PaddedReads(
            u_pad=np.repeat(preads_all1.u_pad, C, axis=0),
            lr=np.repeat(preads_all1.lr, C, axis=0),
            la=np.repeat(preads_all1.la, C, axis=0),
            mask=np.repeat(preads_all1.mask, C, axis=0),
            wif0=np.repeat(preads_all1.wif0, C, axis=0),
            nReads=preads_all1.nReads,
            J=preads_all1.J,
            lpr=np.repeat(preads_all1.lpr, C, axis=0),
            lpa=np.repeat(preads_all1.lpa, C, axis=0),
        )
        dosage_all_acc = np.zeros((S, nSNPs_all))
        gp_all_acc = np.zeros((S, 3, nSNPs_all))
        fet_dosage_all_acc = np.zeros((S, nSNPs_all))
        fet_gp_all_acc = np.zeros((S, 3, nSNPs_all))
        n_all_acc = 0

    def run_all_snp_gibbs(which_b, hap_dos_common, max_diff):
        """Batched final all-SNP Gibbs (rare/common mode). `which_b` and
        `hap_dos_common` have B = S*C rows (phasing rows replicated x C so
        the compiled shapes are shared with the main call)."""
        with _sec("rare:bits_build"):
            bits_np = build_subset_bits_all(
                prep.rhb_t, which_b, prep.snp_is_common,
                prep.rare_per_hap_info, nGrids_all,
            )
        Ksub = which_b.shape[1]
        Kp = pad_to_multiple(Ksub, 128)
        if Kp != Ksub:
            pad = np.repeat(bits_np[:, :1, :], Kp - Ksub, axis=1)
            bits_np = np.concatenate([bits_np, pad], axis=1)
        H0_all = np.zeros((B, ginputs_all.R), dtype=np.int32)
        for b in range(B):
            ra = reads_all_sorted[b // C]
            H0_all[b, : ra.nReads] = initial_all_snp_labels(
                ra, hap_dos_common[b], prep.snp_is_common, nl, ff, rng
            )
        uniforms = rng.random((n_its, B, ginputs_all.R)).astype(np.float32)
        for attempt in range(11):
            with _sec("rare:sweep_kernel"):
                gp_a, gpF_a, hd_a, Hn, ll, uf, Hcls = run_gibbs_chains(
                    bits=bits_np, preads=preads_all, inputs=ginputs_all,
                    uniforms=uniforms, H0=H0_all,
                    first_read=np.zeros(B, dtype=np.int32), n_latent=nl,
                    ff=ff,
                    n_burn_in=n_its - 1, iterative_init=False, K_real=Ksub,
                    max_diff=max_diff, ref_error=prep.ref_error,
                )
            if not uf.any():
                break
            max_diff = max(1.0, max_diff / 10.0)
            print_message(
                f"Underflow in all-SNP Gibbs; retrying batch with "
                f"maxDifferenceBetweenReads={max_diff}"
            )
        return (
            gp_a[:, :, :nSNPs_all], gpF_a[:, :, :nSNPs_all],
            hd_a[:, :, :nSNPs_all],
        )

    dosage_acc = np.zeros((S, nSNPs))
    gp_acc = np.zeros((S, 3, nSNPs))
    fet_dosage_acc = np.zeros((S, nSNPs))
    fet_gp_acc = np.zeros((S, 3, nSNPs))
    n_acc = 0
    hap_dos_final = np.zeros((B, nl, nSNPs))
    row_to_sample = np.repeat(np.arange(S), C)

    if dev_sel:
        which_haps = jnp.asarray(which_haps.astype(np.int32))
    first_read = jnp.asarray(first_read)

    for i_it in range(1, ctx.n_seek_its + 1):
        iterative = i_it == 1
        gp_g, gpF_g, hap_dos_g, H, max_diff = run_chains(
            which_haps, H, iterative, first_read, ginputs, preads, max_diff
        )
        if cfg.use_mspbwt:
            from ..panel.mspbwt import (
                select_new_haps_mspbwt_batch, symbols_device,
            )
            with _sec("select:mspbwt"):
                # symbols extracted ON DEVICE: only [B, nl, nGrids] uint8
                # crosses the host link instead of the full dosage planes;
                # matching runs ONE vectorized insertion scan per index
                # for the whole batch
                z_all = np.asarray(symbols_device(
                    hap_dos_g[:, :, :nSNPs], ctx.dh_bits_dev(), nSNPs
                ))
                hap_dos = hap_dos_g[:, :, :nSNPs]
                n_keep = ctx.Ksub - ctx.Knew
                prev_list = [
                    rng.choice(which_haps[b], size=n_keep, replace=False)
                    for b in range(B)
                ]
                news = select_new_haps_mspbwt_batch(
                    prep.ms_indices, prep.panel, z_all, ctx.Knew, K,
                    prev_list, rng, mspbwtL=cfg.mspbwtL,
                    mspbwtM=cfg.mspbwtM,
                    heuristic_approach=cfg.heuristic_approach,
                )
                for b in range(B):
                    which_haps[b] = np.sort(
                        np.concatenate([prev_list[b], news[b]])
                    )
        else:
            hap_dos, which_haps = run_fb_and_select(
                H, which_haps, row_to_sample,
                jax.random.fold_in(sel_key, i_it),
            )
        if i_it > ctx.n_burn_in_seek_its:
            # device-side accumulation (reassignment keeps jnp arrays; an
            # in-place += on a numpy accumulator would fetch per iteration)
            with _sec("accumulate"):
                h1 = hap_dos[:, 0].reshape(S, C, nSNPs)
                h2 = hap_dos[:, 1].reshape(S, C, nSNPs)
                dosage_acc = dosage_acc + (h1 + h2).sum(axis=1)
                gp0 = gp_acc[:, 0] + ((1 - h1) * (1 - h2)).sum(axis=1)
                gp1 = gp_acc[:, 1] + (
                    h1 * (1 - h2) + (1 - h1) * h2
                ).sum(axis=1)
                gp2 = gp_acc[:, 2] + (h1 * h2).sum(axis=1)
                gp_acc = jnp.stack([gp0, gp1, gp2], axis=1)
                if nl == 3:
                    h3 = hap_dos[:, 2].reshape(S, C, nSNPs)
                    fet_dosage_acc = fet_dosage_acc + (h1 + h3).sum(axis=1)
                    f0 = fet_gp_acc[:, 0] + ((1 - h1) * (1 - h3)).sum(axis=1)
                    f1 = fet_gp_acc[:, 1] + (
                        h1 * (1 - h3) + (1 - h1) * h3
                    ).sum(axis=1)
                    f2 = fet_gp_acc[:, 2] + (h1 * h3).sum(axis=1)
                    fet_gp_acc = jnp.stack([f0, f1, f2], axis=1)
                _drain(gp_acc)
            n_acc += C
        hap_dos_final = hap_dos
    with _sec("final_fetch"):
        dosage_acc, gp_acc = np.asarray(dosage_acc), np.asarray(gp_acc)
        fet_dosage_acc = np.asarray(fet_dosage_acc)
        fet_gp_acc = np.asarray(fet_gp_acc)
        if rare_common:
            hap_dos_final = np.asarray(hap_dos_final)
            if isinstance(which_haps, jax.Array):
                which_haps = np.asarray(which_haps)

    if rare_common:
        gp_a, gpF_a, hd_a = run_all_snp_gibbs(
            which_haps, hap_dos_final[:, :, :nSNPs], max_diff
        )
        h1a = hd_a[:, 0].reshape(S, C, nSNPs_all)
        h2a = hd_a[:, 1].reshape(S, C, nSNPs_all)
        dosage_all_acc += (h1a + h2a).sum(axis=1)
        gp_all_acc[:, 0] += ((1 - h1a) * (1 - h2a)).sum(axis=1)
        gp_all_acc[:, 1] += (h1a * (1 - h2a) + (1 - h1a) * h2a).sum(axis=1)
        gp_all_acc[:, 2] += (h1a * h2a).sum(axis=1)
        if nl == 3:
            h3a = hd_a[:, 2].reshape(S, C, nSNPs_all)
            fet_dosage_all_acc += (h1a + h3a).sum(axis=1)
            fet_gp_all_acc[:, 0] += ((1 - h1a) * (1 - h3a)).sum(axis=1)
            fet_gp_all_acc[:, 1] += (
                h1a * (1 - h3a) + (1 - h1a) * h3a
            ).sum(axis=1)
            fet_gp_all_acc[:, 2] += (h1a * h3a).sum(axis=1)
        n_all_acc += C

    # per-sample consensus: read confidence computed on device from the
    # final per-chain hap dosages; one small [B, R] fetch feeds the host
    # flip-detection walk (inherently sequential, reference
    # functions.R:1680-1832)
    with _sec("consensus"):
        conf_dev = read_confidence_device(
            jnp.asarray(hap_dos_final) if not isinstance(
                hap_dos_final, jax.Array
            ) else hap_dos_final,
            preads_dev["u"], preads_dev["pr"], preads_dev["pa"], nl,
        )
        conf_np = np.asarray(conf_dev)
        H = np.asarray(H)
        cons_list = []
        for s in range(S):
            nr = reads_sorted[s].nReads
            labels_all = H[s * C:(s + 1) * C, :nr].T.astype(np.int64)
            conf_all = conf_np[s * C:(s + 1) * C, :nr].T
            if nl == 3:
                labels2 = labels_all.copy()
                conf2 = conf_all & (labels_all != 2)
                labels2[labels_all == 2] = 1
                cons = consensus_read_labels(labels2, conf2)
                cons[labels_all[:, C - 1] == 2] = 2
            else:
                cons = consensus_read_labels(labels_all, conf_all)
            cons_list.append(cons)

    # phasing pass: one chain per sample; rows are replicated x C so the
    # main chains' compiled kernel shapes are reused (no second compile)
    H_p = np.zeros((B, R), dtype=np.int32)
    for s in range(S):
        for c in range(C):
            H_p[s * C + c, : reads_sorted[s].nReads] = cons_list[s]
    rows_last = np.arange(S) * C + (C - 1)
    if isinstance(which_haps, jax.Array):
        wh_p = jnp.repeat(which_haps[jnp.asarray(rows_last)], C, axis=0)
    else:
        wh_p = np.repeat(which_haps[rows_last], C, axis=0).copy()
    first_zero = jnp.zeros(B, dtype=jnp.int32)
    for i_it in range(1, ctx.n_seek_its + 1):
        gp_p, gpF_p, hap_dos_p, H_p, max_diff = run_chains(
            wh_p, H_p, False, first_zero, ginputs, preads,
            max_diff,
        )
        if cfg.use_mspbwt:
            from ..panel.mspbwt import (
                select_new_haps_mspbwt_batch, symbols_device,
            )
            with _sec("select:mspbwt"):
                z_all = np.asarray(symbols_device(
                    hap_dos_p[:, :, :nSNPs], ctx.dh_bits_dev(), nSNPs
                ))
                n_keep = ctx.Ksub - ctx.Knew
                prev_list = [
                    rng.choice(wh_p[b], size=n_keep, replace=False)
                    for b in range(B)
                ]
                news = select_new_haps_mspbwt_batch(
                    prep.ms_indices, prep.panel, z_all, ctx.Knew, K,
                    prev_list, rng, mspbwtL=cfg.mspbwtL,
                    mspbwtM=cfg.mspbwtM,
                    heuristic_approach=cfg.heuristic_approach,
                )
                for b in range(B):
                    wh_p[b] = np.sort(
                        np.concatenate([prev_list[b], news[b]])
                    )
            hap_dos_ph = hap_dos_p[:, :, :nSNPs]
        else:
            hap_dos_ph, wh_p = run_fb_and_select(
                H_p, wh_p, row_to_sample,
                jax.random.fold_in(sel_key, 100 + i_it),
            )
    rows0 = np.arange(S) * C
    if rare_common:
        hap_dos_ph = np.asarray(hap_dos_ph)
        if isinstance(wh_p, jax.Array):
            wh_p = np.asarray(wh_p)
    else:
        # only row 0 of each sample feeds the outputs: fetch S rows, not B
        hap_dos_ph = np.asarray(jnp.asarray(hap_dos_ph)[jnp.asarray(rows0)])

    if rare_common:
        # final phased all-SNP Gibbs; rows are replicated x C, take row 0
        # per sample (reference: rare_common.R final call in the phasing
        # i_gibbs_sample)
        gp_ph, gpF_ph, hd_ph = run_all_snp_gibbs(
            wh_p, hap_dos_ph[:, :, :nSNPs], max_diff
        )
        hap_dos_ph = hd_ph[np.arange(S) * C]
        results: List[SampleResult] = []
        for s in range(S):
            if not ok[s]:
                results.append(SampleResult(imputed=False))
                continue
            gp_all = gp_all_acc[s] / max(n_all_acc, 1)
            dosage_all = dosage_all_acc[s] / max(n_all_acc, 1)
            acount = sample_allele_count(reads_all_sorted[s], nSNPs_all)
            if nl == 2:
                hd1, hd2 = recast_haps(
                    hap_dos_ph[s, 0], hap_dos_ph[s, 1], gp_all
                )
                results.append(SampleResult(
                    imputed=True, dosage=dosage_all, gp=gp_all,
                    phased_haps=np.stack([np.round(hd1), np.round(hd2)]),
                    read_labels=cons_list[s], allele_count=acount,
                ))
            else:
                fet_gp_all = fet_gp_all_acc[s] / max(n_all_acc, 1)
                fet_dosage_all = fet_dosage_all_acc[s] / max(n_all_acc, 1)
                h1, h2, h3 = recast_nipt_haps(
                    hap_dos_ph[s, 0], hap_dos_ph[s, 1], hap_dos_ph[s, 2],
                    gp_all, fet_gp_all,
                )
                results.append(SampleResult(
                    imputed=True, dosage=dosage_all, gp=gp_all,
                    phased_haps=np.stack([h1, h2, h3]),
                    read_labels=cons_list[s], allele_count=acount,
                    mat_gp=gp_all, fet_gp=fet_gp_all,
                    mat_dosage=dosage_all, fet_dosage=fet_dosage_all,
                ))
        return results, bool(np.asarray(uf_dev))

    results: List[SampleResult] = []
    for s in range(S):
        if not ok[s]:
            results.append(SampleResult(imputed=False))
            continue
        gp = gp_acc[s] / max(n_acc, 1)
        dosage = dosage_acc[s] / max(n_acc, 1)
        if nl == 2:
            hd1, hd2 = recast_haps(hap_dos_ph[s, 0], hap_dos_ph[s, 1], gp)
            results.append(SampleResult(
                imputed=True, dosage=dosage, gp=gp,
                phased_haps=np.stack([np.round(hd1), np.round(hd2)]),
                read_labels=cons_list[s],
                allele_count=sample_allele_count(reads_sorted[s], nSNPs),
            ))
        else:
            fet_gp = fet_gp_acc[s] / max(n_acc, 1)
            fet_dosage = fet_dosage_acc[s] / max(n_acc, 1)
            h1, h2, h3 = recast_nipt_haps(
                hap_dos_ph[s, 0], hap_dos_ph[s, 1], hap_dos_ph[s, 2],
                gp, fet_gp,
            )
            results.append(SampleResult(
                imputed=True, dosage=dosage, gp=gp,
                phased_haps=np.stack([h1, h2, h3]),
                read_labels=cons_list[s],
                allele_count=sample_allele_count(reads_sorted[s], nSNPs),
                mat_gp=gp, fet_gp=fet_gp, mat_dosage=dosage,
                fet_dosage=fet_dosage,
            ))
    return results, bool(np.asarray(uf_dev))
