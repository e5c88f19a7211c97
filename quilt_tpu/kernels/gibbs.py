"""Batched per-read Gibbs sampler over a small haplotype subset (device).

Functional equivalent of rcpp_forwardBackwardGibbsNIPT (reference:
QUILT/src/gibbs-nipt.cpp:2395-3318; per-grid sweep rcpp_gibbs_nipt_iterate
:1756-1960; in-grid read resampling sample_reads_in_grid :733-1341; read
probability evaluation rcpp_evaluate_read_probabilities :3320-3415),
redesigned for XLA:

- the grid axis is a lax.scan; within a grid a dynamic-trip fori_loop
  resamples that grid's reads sequentially (the sampler is order-dependent
  by construction);
- every per-read quantity is vectorized over the batch axis B (independent
  Gibbs chains, potentially of different samples) and the K lane axis;
- numerics are float32: per-read emission products (eMatGrid) are held in
  LOG space and exponentiated with per-grid max subtraction at point of use,
  and alpha is renormalized after every read update. This replaces the
  reference's fp64 magnitude guards (gibbs-nipt.R:808-836, eMatGrid_t
  bounding in copied-from-stitch.cpp:285-307). Candidate label
  probabilities are invariant to per-haplotype rescaling, so sampled chains
  follow the same law as the reference's.

Deviations from the reference (documented):
- n_gibbs_sample_its is fixed at 1 (the reference's default; QUILT's 7
  "Gibbs samples" are outer chains, which map to the batch axis here).
- The reference's read-category 2/3 CPU shortcuts are not distinguished;
  category-1 (uninformative) reads are skipped identically.
- H_class (NIPT read classes, kernels/nipt.py) is evaluated from the
  end-of-iteration alpha/beta state, batched, instead of mid-sweep.

Per-iteration likelihood matrix columns (add_to_per_it_likelihoods,
QUILT/R/gibbs-nipt.R:1441-1471; the s/i_samp/i_it bookkeeping columns are
host-side): see PER_IT_COLS.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

from ..io.reads import SampleReads
from . import nipt as nipt_tables
from .common import pad_to_multiple
from .emissions import PaddedReads, emat_read_from_bits

# every f32 contraction here feeds a probability: ask for full f32
# products (the GPU's default f32 matmul rounds operands to TF32)
_HI = jax.lax.Precision.HIGHEST

PER_IT_COLS = (
    "p_O1_given_H1_L", "p_O2_given_H2_L", "p_O3_given_H3_L",
    "p_O_given_H_L", "p_H_given_L", "p_H_given_O_L_up_to_C",
    "p_set_H_given_L", "relabel",
)


def _classify3(gain, lose_C, pC, h_cur, prior, rlc,
               cutoff=nipt_tables.CLASS_SUM_CUTOFF):
    """Batched NIPT read classification (see kernels/nipt.py docstring).
    gain [..., 3], lose_C [...], pC [..., 3], h_cur [...] int -> class
    [...] int32 in 0..7."""
    oh = jax.nn.one_hot(h_cur, 3, dtype=gain.dtype)
    stay = pC.prod(axis=-1)
    ws = []
    for n in range(3):
        e_n = jnp.zeros(3, dtype=gain.dtype).at[n].set(1.0)
        m_mask = (1.0 - oh) * (1.0 - e_n)
        pC_m = (pC * m_mask).sum(axis=-1)
        w_n = jnp.where(h_cur == n, stay, lose_C * gain[..., n] * pC_m)
        ws.append(w_n * prior[n])
    w = jnp.stack(ws, axis=-1)
    s = w.sum(axis=-1, keepdims=True)
    ok = jnp.isfinite(s[..., 0]) & (s[..., 0] > 0)
    x = w / jnp.where(s > 0, s, 1.0)
    y = jnp.abs(x[..., None, :] - rlc).sum(axis=-1)         # [..., 7]
    cls = jnp.argmin(y, axis=-1).astype(jnp.int32)
    ymin = jnp.min(y, axis=-1)
    return jnp.where(ok & (ymin < cutoff), cls + 1, 0)


def _perm_block_probs(cmat, ns, clp, perm_mask):
    """[..., 6] suffix-relabel choice probabilities from the FB junction
    cross terms cmat [..., 3, 3] (cmat[i,j] = sum_k alpha_i beta_j) and
    H_class counts ns [..., 8] (Rcpp_consider_block_relabelling,
    QUILT/src/gibbs-nipt-block.cpp:590-760, block_approach=6)."""
    logc = jnp.log(jnp.maximum(cmat, 1e-30))
    fb = jnp.stack(
        [
            sum(logc[..., i, int(nipt_tables.INVS[r, i])] for i in range(3))
            for r in range(6)
        ],
        axis=-1,
    )
    # reference pairing: ns[CLASS_PERM[r, c]] * clp[c] (see
    # nipt.perm_choice_probs_np; differs from the transposed pairing for
    # the two 3-cycle relabellings)
    ns_t = jnp.take(ns, jnp.asarray(nipt_tables.CLASS_PERM), axis=-1)
    ht = jnp.einsum("...rc,c->...r", ns_t, clp, precision=_HI)
    lw = fb + ht
    lw = lw - lw.max(axis=-1, keepdims=True)
    w = jnp.exp(jnp.clip(lw, -100.0, None)) * perm_mask
    return w / w.sum(axis=-1, keepdims=True)


_BOUNDARY_PASSES = 4   # cascade depth matched exactly vs the greedy loop


def _run_peaks(smoothed, avail):
    """Per-run maxima of contiguous available runs (leftmost on ties,
    matching the reference's stable descending sort). Returns
    (peak mask [Gm, B], run-start mask, run-end mask)."""
    Gm, B = smoothed.shape
    score = jnp.where(avail, smoothed, -jnp.inf)
    start = avail & jnp.concatenate(
        [jnp.ones((1, B), bool), ~avail[:-1]], axis=0
    )
    end = avail & jnp.concatenate(
        [~avail[1:], jnp.ones((1, B), bool)], axis=0
    )

    # segmented running max over contiguous runs (associative: a reset
    # flag re-anchors the max at run starts)
    def seg_op(a, b):
        (ma, sa), (mb, sb) = a, b
        return jnp.where(sb, mb, jnp.maximum(ma, mb)), sa | sb

    fwd_max, _ = jax.lax.associative_scan(seg_op, (score, start), axis=0)
    bwd_max, _ = jax.lax.associative_scan(
        seg_op, (score[::-1], end[::-1]), axis=0
    )
    run_max = jnp.maximum(fwd_max, bwd_max[::-1])
    prev_fwd = jnp.concatenate(
        [jnp.full((1, B), -jnp.inf), fwd_max[:-1]], axis=0
    )
    peak = avail & (score >= run_max) & (start | (prev_fwd < score))
    return peak, start, end


def _boundaries_from_rate(rate2, smooth_w, NB, quantile_prob):
    """Per-row block-Gibbs boundaries from the live FB jump rate.

    Mirrors Rcpp_define_blocked_snps_using_gamma_on_the_fly (reference:
    QUILT/src/gibbs-nipt-block.cpp:311-527): smooth the per-gap jump rate
    over physical distance (smooth_w = panel.prepare.smoothing_band, a
    BANDED operator — O(Gm*band) instead of a dense [Gm, Gm] matrix),
    threshold at min(1, sorted[int(n*q)]) (rcpp_simple_quantile, :81-85),
    then replicate the greedy descending-peak loop (:440-470) as
    vectorized passes: each pass keeps every remaining run's maximum; an
    interior maximum (d == 3 neighborhood fully available) consumes its
    whole run, a run-edge maximum consumes only its ±1 neighborhood so
    the run remainder feeds the next pass — the reference's cascade that
    emits several boundaries per edge-peaked run. DOCUMENTED DEVIATIONS:
    the cascade is truncated at _BOUNDARY_PASSES passes (the greedy is
    unbounded; oracle greedy_peak_boundaries is exact), and the count is
    capped at NB by smoothed rate (the engine auto-raises NB to the
    static-map run estimate; see RegionContext.build).

    rate2: [Gm, B] f32; smooth_w: (band [Gm, bw], idx0 [Gm]); returns
    [NB, B] int32 suffix-start grid indices, ascending per row, 0 = pad.
    """
    Gm, B = rate2.shape
    band, idx0 = smooth_w
    bw = band.shape[1]
    gidx = jnp.clip(
        idx0[:, None].astype(jnp.int32) + jnp.arange(bw)[None, :],
        0, Gm - 1,
    )                                                      # [Gm, bw]
    smoothed = (band[:, :, None] * rate2[gidx]).sum(axis=1)  # [Gm, B]
    v = min(int(Gm * quantile_prob), Gm - 1)
    thresh = jnp.minimum(1.0, jnp.sort(smoothed, axis=0)[v])   # [B]
    avail = smoothed > thresh[None, :]                     # [Gm, B]

    def shift_or(m):
        up = jnp.concatenate([m[1:], jnp.zeros((1, B), bool)], axis=0)
        dn = jnp.concatenate([jnp.zeros((1, B), bool), m[:-1]], axis=0)
        return m | up | dn

    all_peaks = jnp.zeros((Gm, B), bool)
    for _ in range(_BOUNDARY_PASSES):
        peak, start, end = _run_peaks(smoothed, avail)
        all_peaks = all_peaks | peak
        interior = peak & ~start & ~end
        # interior peak consumes its whole run: broadcast over the run
        def seg_or(a, b):
            (fa, sa), (fb, sb) = a, b
            return jnp.where(sb, fb, fa | fb), sa | sb

        fwd_f, _ = jax.lax.associative_scan(
            seg_or, (interior, start), axis=0
        )
        bwd_f, _ = jax.lax.associative_scan(
            seg_or, (interior[::-1], end[::-1]), axis=0
        )
        consumed_run = fwd_f | bwd_f[::-1]
        avail = avail & ~consumed_run & ~shift_or(peak)
    # top-NB peaks per row by smoothed rate; boundary = gap index + 1
    pscore = jnp.where(all_peaks, smoothed, -jnp.inf)
    vals, idx = jax.lax.top_k(pscore.T, min(NB, Gm))       # [B, NB]
    bnd = jnp.where(jnp.isfinite(vals), idx + 1, 0)
    if bnd.shape[1] < NB:
        bnd = jnp.pad(bnd, ((0, 0), (0, NB - bnd.shape[1])))
    return jnp.sort(bnd, axis=1).T.astype(jnp.int32)       # [NB, B]


def _compose_suffix_perms(cmat, ns_sfx, block_u, bnd_rb, clp, perm_mask):
    """Sample the NIPT 6-permutation suffix relabellings of all boundaries
    with ORIGINAL-state junction statistics, composing accepted moves.

    Exactly equivalent (same uniforms, same draws) to the sequential
    per-boundary loop that re-gathers junction terms from the mutated
    arrays: the current state at boundary j differs from the original only
    by the composed permutation sigma of boundaries < j, so the current
    junction matrix is the sigma-conjugated gather of the original one and
    the current class counts are the CLASS_PERM_INV[sigma] gather of the
    original counts (Rcpp_consider_block_relabelling acceptance,
    QUILT/src/gibbs-nipt-block.cpp:590-954, in suffix formulation).

    cmat: [NB, B, 3, 3] original-state junction cross terms at each
    boundary; ns_sfx: [NB, B, 8] original-class suffix counts;
    block_u: [NB, B]; bnd_rb: [NB, B] (0 = pad).
    Returns sig_seq [NB, B]: the composed permutation AFTER each boundary.
    """
    NB, B = bnd_rb.shape
    mul_t = jnp.asarray(nipt_tables.MUL)
    invs_t = jnp.asarray(nipt_tables.INVS)
    cpinv_t = jnp.asarray(nipt_tables.CLASS_PERM_INV)
    rows = jnp.arange(B)

    def step(sigma, j):
        iv = invs_t[sigma]                                 # [B, 3]
        cm = cmat[j]                                       # [B, 3, 3]
        cm_cur = cm[rows[:, None, None], iv[:, :, None], iv[:, None, :]]
        ns_cur = ns_sfx[j][rows[:, None], cpinv_t[sigma]]  # [B, 8]
        probs = _perm_block_probs(cm_cur, ns_cur, clp, perm_mask)
        chosen = _sample_idx(probs, block_u[j])
        sigma_new = jnp.where(
            bnd_rb[j] > 0, mul_t[chosen, sigma], sigma
        ).astype(jnp.int32)
        return sigma_new, sigma_new

    _, sig_seq = jax.lax.scan(
        step, jnp.zeros((B,), jnp.int32), jnp.arange(NB)
    )
    return sig_seq


def _perm_of_grid(sig_seq, bnd_rb, G):
    """[G, B] composed permutation index at each grid: the state after the
    last boundary SLOT <= g (identity before the first). Pad slots (0)
    sort before all valid boundaries and leave sigma unchanged, so they
    are counted like any other slot — sig_seq is indexed by slot."""
    NB, B = bnd_rb.shape
    gids = jnp.arange(G)
    leq = bnd_rb[None] <= gids[:, None, None]
    cnt = leq.sum(axis=1)                                  # [G, B]
    sel = jnp.take_along_axis(
        sig_seq, jnp.clip(cnt - 1, 0, NB - 1), axis=0
    )
    return jnp.where(cnt > 0, sel, 0)


def _pair_swap_parity(C, block_u, bnd_rb, G):
    """Diploid suffix pair-swap decisions for all boundaries at once.

    The keep/swap products w_keep = C[0,0]*C[1,1], w_swap = C[0,1]*C[1,0]
    are invariant under the pairwise plane swap, so every boundary's
    acceptance can be computed from the ORIGINAL state and the net effect
    per grid is the XOR-prefix of accepted swaps — identical draws to the
    sequential loop (same uniforms, u < p_swap convention; functional
    equivalent of Rcpp_shard_block_gibbs_resampler's pairwise checks,
    QUILT/src/gibbs-nipt-block.cpp:1975-2355).

    C: [NB, B, 2, 2]; block_u/bnd_rb: [NB, B]. Returns parity [G, B] bool.
    """
    w_keep = C[..., 0, 0] * C[..., 1, 1]
    w_swap = C[..., 0, 1] * C[..., 1, 0]
    tot = w_keep + w_swap
    ok = jnp.isfinite(tot) & (tot > 0)
    p_swap = jnp.where(ok, w_swap / jnp.where(tot > 0, tot, 1.0), 0.0)
    do_swap = (bnd_rb > 0) & ok & (block_u < p_swap)       # [NB, B]
    gids = jnp.arange(G)
    leq = (bnd_rb[None] > 0) & (bnd_rb[None] <= gids[:, None, None])
    return (leq & do_swap[None]).sum(axis=1) % 2 == 1      # [G, B]


def _entire_probs(rc, log_p):
    """[..., 6] entire-relabelling probabilities from label counts rc
    [..., 3] (get_weights_for_entire_relabelling, gibbs-nipt.R:1336-1352)."""
    lw = jnp.stack(
        [
            sum(rc[..., int(nipt_tables.INVS[r, i])] * log_p[i]
                for i in range(3))
            for r in range(6)
        ],
        axis=-1,
    )
    lw = lw - lw.max(axis=-1, keepdims=True)
    w = jnp.exp(jnp.clip(lw, -100.0, None))
    return w / w.sum(axis=-1, keepdims=True)


def _sample_idx(probs, u):
    """Inverse-CDF choice along the last axis; u [...] in [0,1)."""
    cum = jnp.cumsum(probs, axis=-1)
    return jnp.minimum(
        (cum <= u[..., None]).sum(axis=-1), probs.shape[-1] - 1
    ).astype(jnp.int32)


def _log_dmultinom(rc, p):
    """log multinomial pmf, batched over leading axes of rc [..., C]
    (calc_prob_of_set_of_reads, gibbs-nipt.R:1308-1312)."""
    n = rc.sum(axis=-1)
    logp = jnp.log(jnp.maximum(p, 1e-300))
    return (
        gammaln(n + 1.0) - gammaln(rc + 1.0).sum(axis=-1)
        + jnp.where(rc > 0, rc * logp, 0.0).sum(axis=-1)
    )


@dataclass
class GibbsInputs:
    """Static device inputs for the Gibbs sweep.

    Read structures are per batch row ([n_rows, ...]); rows of one sample
    batch can carry DIFFERENT samples' reads — the per-step cost of the
    sweep is nearly flat in the batch size, so batching samples x chains is
    the main throughput lever. `build` creates a single-row input
    (broadcast across chains); `build_batched` stacks several samples.
    """

    wif0: np.ndarray         # int32 [n_rows, R]
    read_start: np.ndarray   # int32 [n_rows, G]
    read_count: np.ndarray   # int32 [n_rows, G]
    read_mask: np.ndarray    # bool [n_rows, R]
    trans: np.ndarray        # f32 [G, 2] transition INTO grid g (row 0 = (1,0))
    G: int
    R: int

    @classmethod
    def build(
        cls, reads: SampleReads, trans: np.ndarray, nGrids: int,
        R_pad_to: int = 64,
    ) -> "GibbsInputs":
        return cls.build_batched([reads], trans, nGrids, R_pad_to=R_pad_to)

    @classmethod
    def build_batched(
        cls, reads_list, trans: np.ndarray, nGrids: int, R_pad_to: int = 64,
    ) -> "GibbsInputs":
        n = len(reads_list)
        Rp = pad_to_multiple(
            max(max(r.nReads for r in reads_list), 1), R_pad_to
        )
        wif0 = np.full((n, Rp), nGrids - 1, dtype=np.int32)
        mask = np.zeros((n, Rp), dtype=bool)
        read_start = np.zeros((n, nGrids), dtype=np.int32)
        read_count = np.zeros((n, nGrids), dtype=np.int32)
        for i, reads in enumerate(reads_list):
            w = reads.wif0.astype(np.int32)
            assert (np.diff(w) >= 0).all(), "reads must be sorted by grid"
            R = reads.nReads
            wif0[i, :R] = w
            mask[i, :R] = True
            read_start[i] = np.searchsorted(w, np.arange(nGrids), side="left")
            read_count[i] = (
                np.searchsorted(w, np.arange(nGrids), side="right")
                - read_start[i]
            )
        trans_full = np.zeros((nGrids, 2), dtype=np.float32)
        trans_full[0] = (1.0, 0.0)
        trans_full[1:] = np.asarray(trans, dtype=np.float32).T
        return cls(
            wif0=wif0, read_start=read_start, read_count=read_count,
            read_mask=mask, trans=trans_full, G=nGrids, R=Rp,
        )

    def repeat_rows(self, n_chains: int) -> "GibbsInputs":
        """Each sample row repeated n_chains times (chain batching)."""
        return GibbsInputs(
            wif0=np.repeat(self.wif0, n_chains, axis=0),
            read_start=np.repeat(self.read_start, n_chains, axis=0),
            read_count=np.repeat(self.read_count, n_chains, axis=0),
            read_mask=np.repeat(self.read_mask, n_chains, axis=0),
            trans=self.trans, G=self.G, R=self.R,
        )


def _build_log_emat_grid(log_em, H, wif0, read_mask, G, nl):
    """log eMatGrid [G, B, nl, K] from current labels (non-iterative init).

    Equivalent of rcpp_make_eMatGrid_t (copied-from-stitch.cpp:234-310).
    wif0/read_mask are per batch row [B, R].
    """
    B, K, R = log_em.shape
    rows = jnp.arange(B)

    def body(emg, r):
        g = wif0[:, r]                           # [B]
        h = H[:, r]
        em_r = log_em[:, :, r]
        onehot = jax.nn.one_hot(h, nl, dtype=em_r.dtype)
        add = onehot[:, :, None] * em_r[:, None, :]
        add = jnp.where(read_mask[:, r][:, None, None], add, 0.0)
        emg = emg.at[g, rows].add(add)
        return emg, None

    emg0 = jnp.zeros((G, B, nl, K), dtype=jnp.float32)
    emg, _ = jax.lax.scan(body, emg0, jnp.arange(R))
    return emg


def nipt_block_within(
    lemg,            # [G, B, 3, K] f32 log grid emissions
    beta,            # [G, B, 3, K]
    H,               # [R, B] int read labels
    Hc,              # [R, B] int read classes
    wif0,            # [B, R] central grid per read
    read_mask,       # [B, R] bool
    log_em_all,      # [B, K, R] log read emissions
    trans,           # [G, 2]
    boundaries,      # [NB] suffix-start boundaries (<=0 = pad)
    block_u_it,      # [NB, 3, B] uniforms for this iteration
    clp,             # [8] per-class log label probability
    perm_mask,       # [6] allowed-relabelling mask
    rlc,             # [7, 3] read-label-class probability rows
    K_real: int,
    resample_u_it=None,   # [B, R] uniforms for the H_class label resample
    rebuild_fn=None,      # (H [R, B]) -> lemg; default _build_log_emat_grid
):
    """WITHIN-block 6-permutation relabelling + read-label resample
    from H_class: the production NIPT move set of
    Rcpp_block_gibbs_resampler with block_approach=6 and
    resample_H_using_H_class=TRUE (gibbs-nipt-block.cpp:1636-1974;
    per-block decision Rcpp_consider_block_relabelling :590-954;
    oracle mirror oracle/block_gibbs.py:block_gibbs_within).

    One scan over grids carries the 6-relabelling forward bank
    (alphaStore) and per-block log-normalizer/class-count accumulators;
    at each block end the relabelling is sampled from the in-block
    forward x stale-beta junction plus the H_class count term, and the
    bank collapses to the accepted slice so the next block enters
    consistently. Afterwards labels/classes/emissions permute per
    block, labels optionally resample from H_class, and a full
    forward+backward re-run restores alpha/beta (reference
    :1900-1965)."""
    G, B, _, K = lemg.shape
    R = H.shape[0]
    NB = boundaries.shape[0]
    wif0_r = wif0.T
    km = (jnp.arange(K) < K_real).astype(jnp.float32)
    k_mask = jnp.arange(K) < K_real
    invs_t = jnp.asarray(nipt_tables.INVS)
    perms_t = jnp.asarray(nipt_tables.PERMS)
    clsperm_t = jnp.asarray(nipt_tables.CLASS_PERM)

    def emg_to_e(lemg_g):
        lm = jnp.where(k_mask[None, None, :], lemg_g, -jnp.inf)
        mx = lm.max(axis=2, keepdims=True)
        return jnp.exp(lm - mx) * km[None, None, :], mx[:, :, 0]

    # block topology from the suffix-start boundaries (pads -> G);
    # boundaries may be [NB] (shared) or [NB, B] (per row, as produced by
    # the on-the-fly gamma detection) — topology is held per row either way
    if boundaries.ndim == 1:
        bb = jnp.broadcast_to(
            jnp.where(boundaries > 0, boundaries, G)[:, None], (NB, B)
        )
    else:
        bb = jnp.where(boundaries > 0, boundaries, G)
    bb = jnp.sort(bb, axis=0)                                  # [NB, B]
    gidx = jnp.arange(G)
    block_of_g = (gidx[:, None, None] >= bb[None]).sum(axis=1)  # [G, B]
    is_end = jnp.concatenate(
        [
            ((gidx[:-1, None, None] + 1) == bb[None]).any(axis=1),
            jnp.ones((1, B), bool),
        ],
        axis=0,
    )                                                          # [G, B]
    # per-grid class-count contributions ns_g [G, B, 8]
    oh_c = jax.nn.one_hot(Hc, 8, dtype=jnp.float32)           # [R, B, 8]
    oh_c = oh_c * read_mask.T[:, :, None]
    oh_g = jax.nn.one_hot(wif0_r, G, dtype=jnp.float32)       # [R, B, G]
    ns_g = jnp.einsum("rbg,rbc->gbc", oh_g, oh_c, precision=_HI)
    # per-block uniforms: slot [j, 0] for j < NB, slot [NB-1, 1] for
    # the final (suffix) block
    u_blocks = jnp.concatenate(
        [block_u_it[:, 0], block_u_it[NB - 1:NB, 1]], axis=0
    )                                                          # [NB+1, B]

    def scan_step(carry, g):
        aS, lgS, ns_acc = carry       # [B,6,3,K], [B,6,3], [B,8]
        lemg_g = jax.lax.dynamic_index_in_dim(lemg, g, 0, False)
        beta_g = jax.lax.dynamic_index_in_dim(beta, g, 0, False)
        e_g, _ = emg_to_e(lemg_g)                              # [B,3,K]
        e_perm = e_g[:, invs_t]                                # [B,6,3,K]
        t = trans[g]
        is_first = (g == 0).astype(jnp.float32)
        a_raw = e_perm * (
            t[0] * aS + (t[1] + is_first) / K_real
        )
        s = a_raw.sum(axis=3, keepdims=True)
        s = jnp.maximum(s, 1e-30)
        aS = a_raw / s
        lgS = lgS + jnp.log(s[..., 0])
        ns_acc = ns_acc + ns_g[g]

        end_b = is_end[g]                                      # [B]

        def decide(args):
            aS, lgS, ns_acc = args
            junction = jnp.einsum(
                "brik,bik->bri", aS, beta_g * km[None, None, :],
                precision=_HI,
            )
            lw = jnp.log(jnp.maximum(junction, 1e-30)).sum(axis=2) \
                + lgS.sum(axis=2)                              # [B, 6]
            ns_t = jnp.take(ns_acc, clsperm_t, axis=-1)        # [B,6,8]
            lw = lw + jnp.einsum("brc,c->br", ns_t, clp, precision=_HI)
            lw = lw - lw.max(axis=1, keepdims=True)
            w = jnp.exp(jnp.clip(lw, -100.0, None)) * perm_mask
            w = w / w.sum(axis=1, keepdims=True)
            j = jnp.minimum(block_of_g[g], NB)                 # [B]
            u = jnp.take_along_axis(u_blocks, j[None, :], axis=0)[0]
            chosen = _sample_idx(w, u)                         # [B]
            aS_sel = jnp.take_along_axis(
                aS, chosen[:, None, None, None], axis=1
            )                                                  # [B,1,3,K]
            aS_new = jnp.broadcast_to(aS_sel, aS.shape)
            # per-row block ends: rows whose block does not end at this
            # grid keep their running bank/accumulators
            aS = jnp.where(end_b[:, None, None, None], aS_new, aS)
            lgS = jnp.where(end_b[:, None, None], 0.0, lgS)
            ns_acc = jnp.where(end_b[:, None], 0.0, ns_acc)
            return (aS, lgS, ns_acc, jnp.where(end_b, chosen, 0))

        def no_decide(args):
            aS, lgS, ns_acc = args
            return aS, lgS, ns_acc, jnp.zeros((B,), jnp.int32)

        aS, lgS, ns_acc, chosen = jax.lax.cond(
            end_b.any(), decide, no_decide, (aS, lgS, ns_acc)
        )
        return (aS, lgS, ns_acc), chosen

    aS0 = jnp.zeros((B, 6, 3, K), dtype=jnp.float32)
    carry0 = (aS0, jnp.zeros((B, 6, 3), jnp.float32),
              jnp.zeros((B, 8), jnp.float32))
    _, chosen_g = jax.lax.scan(scan_step, carry0, jnp.arange(G))
    # chosen decision of each grid's block = the choice emitted at the
    # block's END grid (per row)
    bnd_next = jnp.take_along_axis(
        bb, jnp.minimum(block_of_g, NB - 1), axis=0
    )                                                          # [G, B]
    ends_g = jnp.where(block_of_g < NB, bnd_next - 1, G - 1)
    perm_g = jnp.take_along_axis(chosen_g, ends_g, axis=0)     # [G, B]
    perm_r = jnp.take_along_axis(perm_g, jnp.clip(wif0_r, 0, G - 1),
                                 axis=0)                       # [R, B]
    H = perms_t[perm_r, jnp.clip(H, 0, 2)]
    Hc = clsperm_t[perm_r, Hc]
    inv_sel = invs_t[perm_g]                                   # [G,B,3]
    lemg = jnp.take_along_axis(lemg, inv_sel[:, :, :, None], axis=2)

    # resample H from H_class (rcpp_sample_H_using_H_class) and
    # rebuild the grid emissions from the read emissions
    if resample_u_it is not None:
        # class -> P(label) rows: classes 1..6 are make_rlc rows 0..5,
        # classes 0 and 7 the full prior row 6
        rlc_cls = rlc[jnp.array([6, 0, 1, 2, 3, 4, 5, 6])]     # [8, 3]
        cdf = jnp.cumsum(rlc_cls[Hc], axis=-1)                 # [R,B,3]
        H_new = jnp.clip(
            (resample_u_it.T[:, :, None] >= cdf).sum(axis=-1), 0, 2
        )
        H = jnp.where(read_mask.T, H_new, H).astype(jnp.int32)
        if rebuild_fn is not None:
            lemg = rebuild_fn(H)
        else:
            lemg = _build_log_emat_grid(
                log_em_all, H.T, wif0, read_mask, G, 3
            )

    # full forward + backward re-run under the accepted labels
    def fwd(carry, g):
        a = carry
        lemg_g = jax.lax.dynamic_index_in_dim(lemg, g, 0, False)
        e_g, _ = emg_to_e(lemg_g)
        t = trans[g]
        is_first = (g == 0).astype(jnp.float32)
        raw = e_g * (t[0] * a + (t[1] + is_first) / K_real)
        s = jnp.maximum(raw.sum(axis=2, keepdims=True), 1e-30)
        a = raw / s
        return a, a

    _, alphas = jax.lax.scan(
        fwd, jnp.zeros((B, 3, K), jnp.float32), jnp.arange(G)
    )

    def bwd(beta_next, g):
        gn = jnp.minimum(g + 1, G - 1)
        lemg_n = jax.lax.dynamic_index_in_dim(lemg, gn, 0, False)
        t = jax.lax.dynamic_index_in_dim(trans, gn, 0, False)
        e_n, _ = emg_to_e(lemg_n)
        etb = e_n * beta_next
        b_new = t[0] * etb + t[1] * etb.sum(
            axis=2, keepdims=True
        ) / K_real
        b_new = jnp.where(g == G - 1, jnp.ones_like(b_new), b_new)
        mx = jnp.max(b_new, axis=2, keepdims=True)
        b_new = b_new / jnp.where(mx > 0, mx, 1.0)
        return b_new, b_new

    _, betas_rev = jax.lax.scan(
        bwd, jnp.ones((B, 3, K), jnp.float32),
        jnp.arange(G - 1, -1, -1),
    )
    beta = betas_rev[::-1]
    return lemg, beta, alphas, H, Hc


def _apply_perm3(chosen, cond_g, cond_r, lemg, beta, alphas, H, Hc):
    """Apply per-row relabelling `chosen` [B] in 0..5 to the state planes
    [G, B, 3, K] (new_plane[i] = old_plane[INVS[chosen, i]]), the read
    labels (PERMS) and read classes (CLASS_PERM), where cond_g [G, B] /
    cond_r [R, B] hold."""
    rows = jnp.arange(chosen.shape[0])
    idx = jnp.asarray(nipt_tables.INVS)[chosen]              # [B, 3]
    cg = cond_g[:, :, None, None]
    out = []
    for arr in (lemg, beta, alphas):
        permuted = jnp.take_along_axis(arr, idx[None, :, :, None], axis=2)
        out.append(jnp.where(cg, permuted, arr))
    lemg, beta, alphas = out
    perm_rows = jnp.asarray(nipt_tables.PERMS)[chosen]       # [B, 3]
    H_new = perm_rows[rows[None, :], jnp.clip(H, 0, 2)]
    H = jnp.where(cond_r, H_new, H)
    cp_rows = jnp.asarray(nipt_tables.CLASS_PERM)[chosen]    # [B, 8]
    Hc_new = cp_rows[rows[None, :], Hc]
    Hc = jnp.where(cond_r, Hc_new, Hc)
    return lemg, beta, alphas, H, Hc


def _block_moves_pair(lemg, beta, alphas, H, boundaries, u, wif0_r):
    """Diploid suffix-swap escape moves at recombination-hot boundaries,
    one boundary after another. Functional equivalent of the pairwise
    shard checks (Rcpp_shard_block_gibbs_resampler,
    gibbs-nipt-block.cpp:1975-2355); see oracle/block_gibbs.py.

    State planes [G, B, nl, K]; H and wif0_r [R, B]; boundaries [NB]
    (<= 0 = pad); u [NB, B] uniforms."""
    G, nl = lemg.shape[0], lemg.shape[2]
    i, j2 = 0, 1

    def bound_body(j, st):
        lemg, beta, alphas, H = st
        b = boundaries[j]
        valid = b > 0
        bb = jnp.maximum(b, 1)
        sfx_g = (jnp.arange(G) >= bb)[:, None]              # [G, 1]
        sfx_r = wif0_r >= bb                                 # [R, B]
        alpha_b = alphas[bb - 1]                             # [B, nl, K]
        beta_b = beta[bb - 1]
        cii = (alpha_b[:, i] * beta_b[:, i]).sum(axis=1)
        cjj = (alpha_b[:, j2] * beta_b[:, j2]).sum(axis=1)
        cij = (alpha_b[:, i] * beta_b[:, j2]).sum(axis=1)
        cji = (alpha_b[:, j2] * beta_b[:, i]).sum(axis=1)
        w_keep = cii * cjj
        w_swap = cij * cji
        tot = w_keep + w_swap
        ok = jnp.isfinite(tot) & (tot > 0)
        p_swap = jnp.where(ok, w_swap / jnp.where(tot > 0, tot, 1.0), 0.0)
        do_swap = valid & ok & (u[j] < p_swap)               # [B]
        cg = (sfx_g & do_swap[None, :])[:, :, None]          # [G, B, 1]
        out = []
        for arr in (lemg, beta, alphas):
            ai = arr[:, :, i, :]
            aj = arr[:, :, j2, :]
            arr = arr.at[:, :, i, :].set(jnp.where(cg, aj, ai))
            arr = arr.at[:, :, j2, :].set(jnp.where(cg, ai, aj))
            out.append(arr)
        lemg, beta, alphas = out
        cond_r = sfx_r & do_swap[None, :]
        H = jnp.where(cond_r & (H == i), nl + 7,
                      jnp.where(cond_r & (H == j2), i, H))
        H = jnp.where(H == nl + 7, j2, H)
        return (lemg, beta, alphas, H)

    return jax.lax.fori_loop(
        0, boundaries.shape[0], bound_body, (lemg, beta, alphas, H)
    )


def _block_moves_nipt(lemg, beta, alphas, H, Hc, boundaries, u, wif0_r,
                      read_mask, K_real, clp, perm_mask):
    """NIPT 6-permutation suffix relabelling at recombination-hot
    boundaries, one boundary after another: FB junction cross terms x
    H_class count likelihood (functional equivalent of
    Rcpp_block_gibbs_resampler with block_approach=6,
    gibbs-nipt-block.cpp:590-954,1636-1974; suffix formulation rather
    than within-block, documented in SURVEY §7).

    read_mask [B, R]; other layouts as _block_moves_pair."""
    G, B, _, K = lemg.shape
    km = (jnp.arange(K) < K_real).astype(jnp.float32)

    def bound_body(j, st):
        lemg, beta, alphas, H, Hc = st
        b = boundaries[j]
        valid = b > 0
        bb = jnp.maximum(b, 1)
        sfx_g = (jnp.arange(G) >= bb)[:, None] & valid       # [G, 1]
        sfx_g = jnp.broadcast_to(sfx_g, (G, B))
        sfx_r = (wif0_r >= bb) & valid                       # [R, B]
        alpha_b = alphas[bb - 1]                             # [B, 3, K]
        beta_b = beta[bb - 1]
        cmat = jnp.einsum(
            "bik,bjk->bij", alpha_b, beta_b * km[None, None, :],
            precision=_HI,
        )
        mr = sfx_r & read_mask.T                             # [R, B]
        oh_c = jax.nn.one_hot(Hc, 8, dtype=jnp.float32)      # [R, B, 8]
        ns = (oh_c * mr[:, :, None]).sum(axis=0)             # [B, 8]
        probs = _perm_block_probs(cmat, ns, clp, perm_mask)
        chosen = _sample_idx(probs, u[j])                    # [B]
        return _apply_perm3(chosen, sfx_g, sfx_r, lemg, beta, alphas,
                            H, Hc)

    return jax.lax.fori_loop(
        0, boundaries.shape[0], bound_body, (lemg, beta, alphas, H, Hc)
    )


def _live_jump_rate(alphas, beta, lemg, trans, prior, K_real):
    """[G-1, B] per-gap posterior jump rate summed over latent haps from
    the live FB state [G, B, nl, K] — the rate2 of
    Rcpp_define_blocked_snps_using_gamma_on_the_fly (reference:
    QUILT/src/gibbs-nipt-block.cpp:348-365), in normalization-invariant
    form: P(jump at gap g | O) computed from the exact stay/jump
    decomposition of alpha(g+1) rather than assuming the scaled arrays
    sum to one."""
    nl, K = lemg.shape[2], lemg.shape[3]
    k_mask = jnp.arange(K) < K_real
    km = k_mask.astype(jnp.float32)
    lm = jnp.where(k_mask[None, None, None, :], lemg, -jnp.inf)
    mx = lm.max(axis=3, keepdims=True)
    e = jnp.exp(lemg - mx) * km[None, None, None, :]
    eb = e * beta                                        # [G, B, nl, K]
    n1 = (alphas[:-1] * eb[1:]).sum(axis=3)              # [G-1, B, nl]
    n2 = alphas[:-1].sum(axis=3) * eb[1:].sum(axis=3) / K_real
    t0 = trans[1:, 0][:, None, None]
    t1 = trans[1:, 1][:, None, None]
    denom = t0 * n1 + t1 * n2
    njf = jnp.where(denom > 0, t0 * n1 / jnp.maximum(denom, 1e-300), 1.0)
    r = 1.0 - njf                                        # [G-1, B, nl]
    if nl == 3:
        # hap3 contributes only when ff > 0 (reference :359-364)
        w3 = (prior[2] > 0).astype(jnp.float32)
        rate2 = r[..., 0] + r[..., 1] + w3 * r[..., 2]
    else:
        rate2 = r.sum(axis=2)
    # reference leaves the final gap at zero (loop bound nGrids-2)
    return rate2.at[-1].set(0.0)


def _block_moves_pair_otf(lemg, beta, alphas, H, bnd_rb, u, wif0_r):
    """Composed diploid suffix swaps at per-row boundaries bnd_rb [NB, B]:
    all acceptances from the original state (see _pair_swap_parity), one
    apply pass. Same draws as _block_moves_pair for shared boundaries."""
    G, nl = lemg.shape[0], lemg.shape[2]
    idxg = jnp.clip(bnd_rb - 1, 0, G - 1)                # [NB, B]
    a_sel = jnp.take_along_axis(alphas, idxg[:, :, None, None], axis=0)
    b_sel = jnp.take_along_axis(beta, idxg[:, :, None, None], axis=0)
    C = jnp.einsum("jbik,jblk->jbil", a_sel, b_sel, precision=_HI)
    parity_g = _pair_swap_parity(C[..., :2, :2], u, bnd_rb, G)  # [G, B]
    parity_r = jnp.take_along_axis(
        parity_g, jnp.clip(wif0_r, 0, G - 1), axis=0
    )                                                    # [R, B]
    p_i = parity_g.astype(jnp.int32)
    idx2 = jnp.stack([p_i, 1 - p_i], axis=2)             # [G, B, 2]
    if nl == 3:
        idx2 = jnp.concatenate(
            [idx2, jnp.full_like(p_i, 2)[:, :, None]], axis=2
        )
    lemg, beta, alphas = (
        jnp.take_along_axis(arr, idx2[:, :, :, None], axis=2)
        for arr in (lemg, beta, alphas)
    )
    H = jnp.where(parity_r & (H == 0), nl + 7,
                  jnp.where(parity_r & (H == 1), 0, H))
    H = jnp.where(H == nl + 7, 1, H)
    return (lemg, beta, alphas, H)


def _block_moves_nipt_otf(lemg, beta, alphas, H, Hc, bnd_rb, u, wif0_r,
                          read_mask, K_real, clp, perm_mask):
    """Composed NIPT 6-permutation suffix relabelling at per-row
    boundaries (see _compose_suffix_perms), one apply pass. Same draws as
    _block_moves_nipt for shared boundaries."""
    G, K = lemg.shape[0], lemg.shape[3]
    km = (jnp.arange(K) < K_real).astype(jnp.float32)
    idxg = jnp.clip(bnd_rb - 1, 0, G - 1)
    a_sel = jnp.take_along_axis(alphas, idxg[:, :, None, None], axis=0)
    b_sel = jnp.take_along_axis(beta, idxg[:, :, None, None], axis=0)
    cmat = jnp.einsum(
        "jbik,jblk->jbil", a_sel, b_sel * km[None, None, None, :],
        precision=_HI,
    )                                                    # [NB, B, 3, 3]
    oh_c = jax.nn.one_hot(Hc, 8, dtype=jnp.float32)      # [R, B, 8]
    oh_c = oh_c * read_mask.T[:, :, None]
    sfx_mask = wif0_r[None] >= jnp.maximum(bnd_rb, 1)[:, None, :]
    ns_sfx = (oh_c[None] * sfx_mask[..., None]).sum(axis=1)
    sig_seq = _compose_suffix_perms(cmat, ns_sfx, u, bnd_rb, clp, perm_mask)
    perm_g = _perm_of_grid(sig_seq, bnd_rb, G)           # [G, B]
    perm_r = jnp.take_along_axis(perm_g, jnp.clip(wif0_r, 0, G - 1), axis=0)
    inv_sel = jnp.asarray(nipt_tables.INVS)[perm_g]      # [G, B, 3]
    lemg, beta, alphas = (
        jnp.take_along_axis(arr, inv_sel[:, :, :, None], axis=2)
        for arr in (lemg, beta, alphas)
    )
    H = jnp.asarray(nipt_tables.PERMS)[perm_r, jnp.clip(H, 0, 2)]
    Hc = jnp.asarray(nipt_tables.CLASS_PERM)[perm_r, Hc]
    return (lemg, beta, alphas, H, Hc)


@partial(
    jax.jit,
    static_argnames=("nl", "iterative_init", "K_real", "W", "do_entire",
                     "block_within", "quantile_prob"),
)
def _gibbs_core(
    eMatRead: jnp.ndarray,     # [B, K, R] f32
    bits: jnp.ndarray,         # [B, K, S] uint8
    read_start: jnp.ndarray,   # [B, G]
    read_count: jnp.ndarray,   # [B, G]
    wif0: jnp.ndarray,         # [B, R]
    read_mask: jnp.ndarray,    # [B, R] bool
    trans: jnp.ndarray,        # [G, 2]
    prior: jnp.ndarray,        # [nl] f32
    uniforms: jnp.ndarray,     # [n_its, B, R]
    H0: jnp.ndarray,           # [B, R] int32
    first_read: jnp.ndarray,   # [B] int32
    boundaries: jnp.ndarray,   # [NB] int32 (block-Gibbs suffix starts; -1 pad)
    block_u: jnp.ndarray,      # [n_its, NB, 3, B] uniforms for block moves
    do_block: jnp.ndarray,     # [n_its] bool
    relabel_u: jnp.ndarray,    # [n_its, B] uniforms for entire relabelling
    rlc: jnp.ndarray,          # [7, 3] f32 read-class probability rows
    clp: jnp.ndarray,          # [8] f32 per-class log label probability
    perm_mask: jnp.ndarray,    # [6] f32 allowed-relabelling mask (ff==0)
    nl: int,
    iterative_init: bool,
    K_real: int,
    W: int,                    # max reads per grid (H_class scan width)
    do_entire: bool,
    ref_error: float = 0.001,
    resample_u: Optional[jnp.ndarray] = None,  # [n_its, B, R] for the
                                               # H_class label resample
    block_within: bool = True, # within-block moves (reference default) vs
                               # the shard suffix formulation
    smooth_w: Optional[jnp.ndarray] = None,    # [G-1, G-1] bp smoothing
                               # operator: enables ON-THE-FLY per-row
                               # boundary detection from the live FB state
                               # (Rcpp_define_blocked_snps_using_gamma_
                               # on_the_fly) instead of the static
                               # `boundaries`
    quantile_prob: float = 0.95,
):
    B, K, R = eMatRead.shape
    bits_packed = bits.dtype != jnp.uint8
    S = bits.shape[2] * (32 if bits_packed else 1)
    G = read_start.shape[1]
    n_its = uniforms.shape[0]
    eye_b = jnp.eye(nl, dtype=bool)
    rows = jnp.arange(B)

    k_mask = jnp.arange(K) < K_real
    km = k_mask.astype(jnp.float32)
    # R-leading layouts: each per-read gather in the sequential loop reads
    # one contiguous [B, K] slab of the leading axis
    em_r = jnp.moveaxis(eMatRead, 2, 0)                    # [R, B, K]
    lem_r = jnp.log(em_r)                                  # [R, B, K]
    log_em_all = jnp.moveaxis(lem_r, 0, 2)                 # [B, K, R] (init)
    u_r = jnp.moveaxis(uniforms, 2, 1)                     # [n_its, R, B]
    skip_r_all = (
        (eMatRead.max(axis=1) - eMatRead.min(axis=1) <= 1e-9) | ~read_mask
    ).T                                                    # [R, B]
    H_r0 = H0.T                                            # [R, B]
    wif0_r = wif0.T                                        # [R, B]

    if iterative_init:
        lemg = jnp.zeros((G, B, nl, K), dtype=jnp.float32)
    else:
        lemg = _build_log_emat_grid(log_em_all, H0, wif0, read_mask, G, nl)
    beta = jnp.ones((G, B, nl, K), dtype=jnp.float32)
    alphas = jnp.zeros((G, B, nl, K), dtype=jnp.float32)
    H = H_r0
    Hc0 = jnp.zeros((R, B), dtype=jnp.int32)
    underflow = jnp.zeros((B,), dtype=bool)
    per_it_ll = jnp.zeros((n_its, B, len(PER_IT_COLS)), dtype=jnp.float32)

    def emg_to_e(lemg_g):
        """exp(log eMatGrid) with per-(b,h) max subtraction; pads -> 0."""
        lm = jnp.where(k_mask[None, None, :], lemg_g, -jnp.inf)
        mx = lm.max(axis=2, keepdims=True)
        return jnp.exp(lm - mx) * km[None, None, :], mx[:, :, 0]

    NB = boundaries.shape[0]
    log_prior = jnp.log(prior)
    em_bRK = jnp.transpose(eMatRead, (0, 2, 1))            # [B, R, K]
    skip_T = skip_r_all.T                                   # [B, R]

    def compute_Hclass(alphas, beta, H, Hc):
        """Batched NIPT read classification from the end-of-iteration state
        (see kernels/nipt.py for semantics/deviation notes)."""
        H_T = H.T                                            # [B, R]
        aw = jnp.arange(W)

        def body(Hc_T, g):
            ab = alphas[g] * beta[g]                         # [B, nl, K]
            r_idx = read_start[:, g][:, None] + aw[None, :]  # [B, W]
            in_g = aw[None, :] < read_count[:, g][:, None]
            r_c = jnp.clip(r_idx, 0, R - 1)
            em_g = jnp.take_along_axis(em_bRK, r_c[:, :, None], axis=1)
            gain = jnp.einsum("bwk,bhk->bwh", em_g, ab, precision=_HI)
            lose = jnp.einsum("bwk,bhk->bwh", 1.0 / em_g, ab, precision=_HI)
            h_cur = jnp.take_along_axis(H_T, r_c, axis=1)    # [B, W]
            lose_C = jnp.take_along_axis(
                lose, h_cur[:, :, None], axis=2
            )[:, :, 0]
            pC = ab.sum(axis=2)[:, None, :]                  # [B, 1, 3]
            cls = _classify3(gain, lose_C, pC, h_cur, prior, rlc)
            live = in_g & ~jnp.take_along_axis(skip_T, r_c, axis=1)
            upd = jnp.where(
                live, cls, jnp.take_along_axis(Hc_T, r_c, axis=1)
            )
            return Hc_T.at[rows[:, None], r_c].set(upd), None

        Hc_T, _ = jax.lax.scan(body, Hc.T, jnp.arange(G))
        return Hc_T.T                                        # [R, B]

    def block_moves_nipt_within(it, lemg, beta, alphas, H, Hc):
        """Closure adapter for nipt_block_within (the production NIPT
        within-block move set); `alphas` is recomputed inside."""
        del alphas
        return nipt_block_within(
            lemg, beta, H, Hc, wif0, read_mask, log_em_all, trans,
            boundaries, block_u[it], clp, perm_mask, rlc, K_real,
            resample_u_it=(
                resample_u[it] if (resample_u is not None and W > 0)
                else None
            ),
        )

    use_otf = smooth_w is not None
    NBu = block_u.shape[1]

    def entire_move(it, lemg, beta, alphas, H, Hc):
        """Entire relabelling of all reads (functional equivalent of
        rcpp_consider_and_try_entire_relabelling, gibbs-nipt.cpp:1553-1577,
        enabled by do_block_resampling)."""
        mask_T = read_mask.T                                 # [R, B]
        oh = jax.nn.one_hot(jnp.clip(H, 0, 2), 3, dtype=jnp.float32)
        rc = (oh * mask_T[:, :, None]).sum(axis=0)           # [B, 3]
        probs = _entire_probs(rc, log_prior)
        chosen = _sample_idx(probs, relabel_u[it])           # [B]
        all_g = jnp.ones((G, B), dtype=bool)
        all_r = jnp.ones((R, B), dtype=bool)
        lemg, beta, alphas, H, Hc = _apply_perm3(
            chosen, all_g, all_r, lemg, beta, alphas, H, Hc
        )
        return lemg, beta, alphas, H, Hc, chosen + 1

    def one_iteration(it, state):
        lemg, beta, alphas, H, Hc, underflow, per_it_ll = state
        u_it = u_r[it]                                      # [R, B]

        def fwd_step(carry, g):
            alpha, H, uf = carry
            lemg_g = jax.lax.dynamic_index_in_dim(lemg, g, 0, keepdims=False)
            beta_g = jax.lax.dynamic_index_in_dim(beta, g, 0, keepdims=False)
            e_g, e_mx = emg_to_e(lemg_g)
            t = trans[g]
            is_first = (g == 0).astype(jnp.float32)
            a_raw = e_g * (t[0] * alpha + (t[1] + is_first) / K_real)
            s = a_raw.sum(axis=2, keepdims=True)
            uf = uf | (~jnp.isfinite(s[:, :, 0]) | (s[:, :, 0] <= 0)).any(
                axis=1
            )
            s = jnp.where(s > 0, s, 1.0)
            alpha_g = a_raw / s
            logc = jnp.log(s[:, :, 0]) + e_mx               # [B, nl]

            def read_body(i, rs):
                alpha_g, lemg_g, pC, H, logc, uf = rs
                r = read_start[:, g] + i                     # [B] per-row read
                in_grid = i < read_count[:, g]               # [B]
                em = em_r[r, rows]                           # [B, K]
                lem = lem_r[r, rows]
                emk = jnp.where(k_mask[None, :], em, 1.0)
                ab = alpha_g * beta_g                        # [B, nl, K]
                gain = (ab * emk[:, None, :]).sum(axis=2)
                lose = (ab / emk[:, None, :]).sum(axis=2)
                h_rC = H[r, rows]
                oh_C = jax.nn.one_hot(h_rC, nl, dtype=jnp.float32)
                skip_r = skip_r_all[r, rows] | ~in_grid
                if iterative_init:
                    doing_pass = (it == 0) & (r < first_read)
                    doing_init = ((it == 0) & (r >= first_read)) | (
                        (it == 1) & (r < first_read)
                    )
                else:
                    doing_pass = jnp.zeros((B,), dtype=bool)
                    doing_init = jnp.zeros((B,), dtype=bool)
                normal = ~doing_init
                u = u_it[r, rows]
                if nl == 2:
                    # specialized diploid math (halves the per-step op count)
                    # candidate 0 / candidate 1 per-hap factors:
                    # q_n[h]: n == h_rC -> pC; else gain at n, lose at h_rC
                    c0 = h_rC == 0
                    lose_C = jnp.where(c0, lose[:, 0], lose[:, 1])
                    w0 = jnp.where(
                        c0, pC[:, 0] * pC[:, 1], lose_C * gain[:, 0]
                    )
                    w1 = jnp.where(
                        c0, lose_C * gain[:, 1], pC[:, 0] * pC[:, 1]
                    )
                    w0i = jnp.where(doing_init, gain[:, 0] * pC[:, 1], w0)
                    w1i = jnp.where(doing_init, pC[:, 0] * gain[:, 1], w1)
                    wsum = w0i + w1i
                    bad = (~jnp.isfinite(wsum)) | (wsum <= 0)
                    uf = uf | (bad & ~skip_r)
                    p0 = jnp.where(bad, 0.5, w0i / jnp.where(wsum > 0, wsum, 1.0))
                    h_new = (u >= p0).astype(H.dtype)
                    active = (~skip_r) & (~doing_pass) & (~bad)
                    flip = active & ((h_new != h_rC) | doing_init)
                    n0 = h_new == 0
                    fac0 = jnp.where(n0[:, None], emk, 1.0) * jnp.where(
                        (c0 & normal)[:, None], 1.0 / emk, 1.0
                    )
                    fac1 = jnp.where((~n0)[:, None], emk, 1.0) * jnp.where(
                        ((~c0) & normal)[:, None], 1.0 / emk, 1.0
                    )
                    fw = flip[:, None]
                    fac = jnp.stack(
                        [jnp.where(fw, fac0, 1.0), jnp.where(fw, fac1, 1.0)],
                        axis=1,
                    )
                    alpha_g = alpha_g * fac
                    d0 = (n0.astype(jnp.float32)
                          - (c0 & normal).astype(jnp.float32))
                    d1 = ((~n0).astype(jnp.float32)
                          - ((~c0) & normal).astype(jnp.float32))
                    dlog = jnp.stack(
                        [d0[:, None] * lem, d1[:, None] * lem], axis=1
                    )
                    lemg_g = lemg_g + jnp.where(fw[:, :, None], dlog, 0.0)
                    H = H.at[r, rows].set(jnp.where(flip, h_new, h_rC))
                    # pC after the move (only applied where flip):
                    # gainer hap gets gain, the loser gets lose (normal) or
                    # keeps its base value (init adds without removing)
                    pc0_new = jnp.where(
                        n0, gain[:, 0], jnp.where(normal, lose_C, pC[:, 0])
                    )
                    pc1_new = jnp.where(
                        ~n0, gain[:, 1], jnp.where(normal, lose_C, pC[:, 1])
                    )
                    pC = jnp.where(
                        fw, jnp.stack([pc0_new, pc1_new], axis=1), pC
                    )
                else:
                    base = jnp.broadcast_to(pC[:, None, :], (B, nl, nl))
                    p_init = jnp.where(eye_b[None], gain[:, :, None], base)
                    lose_C = (lose * oh_C).sum(axis=1)
                    col_C = oh_C[:, None, :].astype(bool)
                    row_C = oh_C[:, :, None].astype(bool)
                    p_norm = jnp.where(eye_b[None], gain[:, :, None], base)
                    p_norm = jnp.where(
                        col_C & ~row_C, lose_C[:, None, None], p_norm
                    )
                    p_norm = jnp.where(row_C, pC[:, None, :], p_norm)
                    p_opts = jnp.where(
                        doing_init[:, None, None], p_init, p_norm
                    )
                    w = jnp.prod(p_opts, axis=2) * prior[None, :]
                    wsum = w.sum(axis=1, keepdims=True)
                    bad = (~jnp.isfinite(wsum[:, 0])) | (wsum[:, 0] <= 0)
                    uf = uf | (bad & ~skip_r)
                    probs = jnp.where(
                        bad[:, None], 1.0 / nl,
                        w / jnp.where(wsum > 0, wsum, 1.0),
                    )
                    cum = jnp.cumsum(probs, axis=1)
                    h_new = jnp.minimum(
                        (cum <= u[:, None]).sum(axis=1), nl - 1
                    ).astype(H.dtype)
                    active = (~skip_r) & (~doing_pass) & (~bad)
                    flip = active & ((h_new != h_rC) | doing_init)
                    oh_N = jax.nn.one_hot(h_new, nl, dtype=jnp.float32)
                    fac = jnp.where(oh_N[:, :, None] > 0, emk[:, None, :], 1.0)
                    fac = fac * jnp.where(
                        (oh_C[:, :, None] > 0) & normal[:, None, None],
                        1.0 / emk[:, None, :],
                        1.0,
                    )
                    fac = jnp.where(flip[:, None, None], fac, 1.0)
                    alpha_g = alpha_g * fac
                    dlog = oh_N[:, :, None] * lem[:, None, :] - (
                        oh_C[:, :, None] * lem[:, None, :]
                    ) * normal[:, None, None].astype(jnp.float32)
                    dlog = jnp.where(flip[:, None, None], dlog, 0.0)
                    lemg_g = lemg_g + dlog
                    H = H.at[r, rows].set(jnp.where(flip, h_new, h_rC))
                    pC_new = jnp.take_along_axis(
                        p_opts, h_new[:, None, None], axis=1
                    )[:, 0, :]
                    pC = jnp.where(flip[:, None], pC_new, pC)
                s = (alpha_g * km[None, None, :]).sum(axis=2, keepdims=True)
                s = jnp.where(s > 0, s, 1.0)
                alpha_g = alpha_g / s
                logc = logc + jnp.log(s[:, :, 0])
                pC = pC / s[:, :, 0]
                return (alpha_g, lemg_g, pC, H, logc, uf)

            pC0 = (alpha_g * beta_g).sum(axis=2)
            alpha_g, lemg_g, pC, H, logc, uf = jax.lax.fori_loop(
                0, read_count[:, g].max(), read_body,
                (alpha_g, lemg_g, pC0, H, logc, uf),
            )
            return (alpha_g, H, uf), (alpha_g, lemg_g, logc)

        (alpha_last, H, uf), (alphas, lemg, logcs) = jax.lax.scan(
            fwd_step,
            (jnp.zeros((B, nl, K), dtype=jnp.float32), H, underflow),
            jnp.arange(G),
        )
        underflow = uf

        def bwd_step(beta_next, g):
            gn = jnp.minimum(g + 1, G - 1)
            lemg_n = jax.lax.dynamic_index_in_dim(lemg, gn, 0, keepdims=False)
            t = jax.lax.dynamic_index_in_dim(trans, gn, 0, keepdims=False)
            e_n, _ = emg_to_e(lemg_n)
            etb = e_n * beta_next
            b_new = t[0] * etb + t[1] * etb.sum(axis=2, keepdims=True) / K_real
            b_new = jnp.where(g == G - 1, jnp.ones_like(b_new), b_new)
            mx = jnp.max(b_new, axis=2, keepdims=True)
            b_new = b_new / jnp.where(mx > 0, mx, 1.0)
            return b_new, b_new

        _, betas_rev = jax.lax.scan(
            bwd_step,
            jnp.ones((B, nl, K), dtype=jnp.float32),
            jnp.arange(G - 1, -1, -1),
        )
        beta = betas_rev[::-1]
        relabel = jnp.ones((B,), dtype=jnp.int32)
        if nl == 3 and W > 0:
            # H_class from the end-of-iteration state, whenever it feeds the
            # block moves or the final outputs
            need_hc = do_block[it] | (it == n_its - 1) | bool(do_entire)
            Hc = jax.lax.cond(
                need_hc,
                lambda a: compute_Hclass(a[0], a[1], a[2], a[3]),
                lambda a: a[3],
                (alphas, beta, H, Hc),
            )
        if use_otf and NBu > 0:
            # on-the-fly boundaries from the live FB state, per batch row
            if nl == 3:
                def blocked3(args):
                    lemg, beta, alphas, H, Hc = args
                    rate2 = _live_jump_rate(
                        alphas, beta, lemg, trans, prior, K_real
                    )
                    bnd_rb = _boundaries_from_rate(
                        rate2, smooth_w, NBu, quantile_prob
                    )
                    if block_within:
                        return nipt_block_within(
                            lemg, beta, H, Hc, wif0, read_mask, log_em_all,
                            trans, bnd_rb, block_u[it], clp, perm_mask,
                            rlc, K_real,
                            resample_u_it=(
                                resample_u[it]
                                if (resample_u is not None and W > 0)
                                else None
                            ),
                        )
                    return _block_moves_nipt_otf(
                        lemg, beta, alphas, H, Hc, bnd_rb,
                        block_u[it, :, 0], wif0_r, read_mask, K_real, clp,
                        perm_mask,
                    )

                lemg, beta, alphas, H, Hc = jax.lax.cond(
                    do_block[it], blocked3, lambda args: args,
                    (lemg, beta, alphas, H, Hc),
                )
            else:
                def blocked2(args):
                    lemg, beta, alphas, H = args
                    rate2 = _live_jump_rate(
                        alphas, beta, lemg, trans, prior, K_real
                    )
                    bnd_rb = _boundaries_from_rate(
                        rate2, smooth_w, NBu, quantile_prob
                    )
                    return _block_moves_pair_otf(
                        lemg, beta, alphas, H, bnd_rb, block_u[it, :, 0],
                        wif0_r,
                    )

                lemg, beta, alphas, H = jax.lax.cond(
                    do_block[it], blocked2, lambda args: args,
                    (lemg, beta, alphas, H),
                )
        elif NB > 0:
            if nl == 3:
                if block_within:
                    nipt_move = lambda args: block_moves_nipt_within(  # noqa: E731
                        it, *args
                    )
                else:
                    nipt_move = lambda args: _block_moves_nipt(  # noqa: E731
                        *args, boundaries, block_u[it, :, 0], wif0_r,
                        read_mask, K_real, clp, perm_mask,
                    )
                lemg, beta, alphas, H, Hc = jax.lax.cond(
                    do_block[it], nipt_move, lambda args: args,
                    (lemg, beta, alphas, H, Hc),
                )
            else:
                lemg, beta, alphas, H = jax.lax.cond(
                    do_block[it],
                    lambda args: _block_moves_pair(
                        *args, boundaries, block_u[it, :, 0], wif0_r
                    ),
                    lambda args: args,
                    (lemg, beta, alphas, H),
                )
        if do_entire and nl == 3:
            lemg, beta, alphas, H, Hc, relabel = entire_move(
                it, lemg, beta, alphas, H, Hc
            )
        p_O_h = logcs.sum(axis=0)                           # [B, nl]
        p_O = p_O_h.sum(axis=1)
        logprior = jnp.log(prior)[H] * read_mask.T
        p_H = logprior.sum(axis=0)
        mask_T = read_mask.T
        oh_l = jax.nn.one_hot(
            jnp.clip(H, 0, nl - 1), nl, dtype=jnp.float32
        )
        rc = (oh_l * mask_T[:, :, None]).sum(axis=0)        # [B, nl]
        p_set = _log_dmultinom(rc, prior)
        p_O3 = p_O_h[:, 2] if nl == 3 else jnp.zeros_like(p_O)
        row = jnp.stack(
            [
                p_O_h[:, 0], p_O_h[:, 1], p_O3, p_O, p_H, p_O + p_H,
                p_set, relabel.astype(jnp.float32),
            ],
            axis=1,
        )
        per_it_ll = per_it_ll.at[it].set(row)
        return (lemg, beta, alphas, H, Hc, underflow, per_it_ll)

    state = (lemg, beta, alphas, H, Hc0, underflow, per_it_ll)
    state = jax.lax.fori_loop(0, n_its, one_iteration, state)
    lemg, beta, alphas, H, Hc, underflow, per_it_ll = state
    H = H.T                                                 # back to [B, R]
    H_class = Hc.T                                          # [B, R]

    # genProbs / hapProbs from the final iteration's gammas
    # (rcpp_calculate_gn_genProbs_and_hapProbs, gibbs-nipt.cpp)
    def dos_step(_, g):
        gam = alphas[g] * beta[g] * km[None, None, :]
        gam = gam / jnp.maximum(gam.sum(axis=2, keepdims=True), 1e-30)
        if bits_packed:
            w_g = jax.lax.dynamic_slice(bits, (0, 0, g), (B, K, 1))
            sh32 = jnp.arange(32, dtype=w_g.dtype)
            bits_g = (w_g >> sh32[None, None, :]) & 1
        else:
            bits_g = jax.lax.dynamic_slice(
                bits, (0, 0, g * 32), (B, K, 32)
            )
        e_g = bits_g.astype(jnp.float32) * (1.0 - 2.0 * ref_error) + ref_error
        hd = jnp.einsum("bhk,bks->bhs", gam, e_g, precision=_HI)
        return None, hd

    _, hd = jax.lax.scan(dos_step, None, jnp.arange(G))     # [G, B, nl, 32]
    hap_dos = hd.transpose(1, 2, 0, 3).reshape(B, nl, S)
    gp = jnp.stack(
        [
            (1 - hap_dos[:, 0]) * (1 - hap_dos[:, 1]),
            hap_dos[:, 0] * (1 - hap_dos[:, 1])
            + (1 - hap_dos[:, 0]) * hap_dos[:, 1],
            hap_dos[:, 0] * hap_dos[:, 1],
        ],
        axis=1,
    )
    if nl == 3:
        gpF = jnp.stack(
            [
                (1 - hap_dos[:, 0]) * (1 - hap_dos[:, 2]),
                hap_dos[:, 0] * (1 - hap_dos[:, 2])
                + (1 - hap_dos[:, 0]) * hap_dos[:, 2],
                hap_dos[:, 0] * hap_dos[:, 2],
            ],
            axis=1,
        )
    else:
        gpF = gp
    return gp, gpF, hap_dos, H, per_it_ll, underflow, H_class


def run_gibbs_chains(
    bits: np.ndarray,            # [B, K, S] uint8 subset alleles (K padded ok)
    preads: PaddedReads,
    inputs: GibbsInputs,
    uniforms: np.ndarray,        # [n_its, B, R]
    H0: np.ndarray,              # [B, R]
    first_read: np.ndarray,      # [B]
    n_latent: int,
    ff: float,
    n_burn_in: int,
    iterative_init: bool,
    K_real: int,
    max_diff: float = 1e10,
    ref_error: float = 0.001,
    eMatRead: Optional[jnp.ndarray] = None,
    boundaries: Optional[np.ndarray] = None,
    block_u: Optional[np.ndarray] = None,
    do_block: Optional[np.ndarray] = None,
    relabel_u: Optional[np.ndarray] = None,
    do_entire: bool = False,
    resample_u: Optional[np.ndarray] = None,
    block_within: bool = True,
    smooth_w: Optional[np.ndarray] = None,
    quantile_prob: float = 0.95,
    return_arrays: bool = True,
    lem_read=None,
):
    """Run B independent Gibbs chains; returns numpy outputs
    (gp, gpF, hap_dos, H, per_it_ll, underflow, H_class).

    genProbs/hapProbs cover the padded SNP axis S; slice to nSNPs outside.
    Pad rows of `bits` (beyond K_real) must duplicate a real haplotype so
    the per-read emission rescale is unaffected; they carry zero weight in
    all sums.

    lem_read: optional (lem [B, K, R'] f32, skip [B, R']) pair of
    rescaled, floored log read emissions (the batched engine's per-batch
    whole-panel cache, emissions.lem_subset); it replaces the per-call
    emission build from `bits`. block_within selects the reference's
    within-block NIPT moves (default) or the suffix formulation.
    """
    # the H_class label resample is gated on ff > 0 in the oracle and the
    # reference (block_gibbs_within: resample_H and ff > 0.0); at ff == 0
    # classes 0/7 would draw from a (0.5, 0.5, 0) prior instead
    if ff <= 0.0:
        resample_u = None

    if n_latent == 2:
        prior = np.array([0.5, 0.5], dtype=np.float32)
    else:
        prior = np.array([0.5, (1 - ff) / 2, ff / 2], dtype=np.float32)
    if eMatRead is None and lem_read is not None:
        # lem >= -log(max_diff), so exp(lem) is eMatRead with its floor
        eMatRead = jnp.exp(lem_read[0])
        R = inputs.R
        if eMatRead.shape[2] < R:
            eMatRead = jnp.pad(
                eMatRead,
                ((0, 0), (0, 0), (0, R - eMatRead.shape[2])),
                constant_values=1.0,
            )
        eMatRead = eMatRead[:, :, :R]
    if eMatRead is None:
        eMatRead = emat_read_from_bits(
            jnp.asarray(bits),
            jnp.asarray(preads.u_pad),
            jnp.asarray(preads.lr),
            jnp.asarray(preads.la),
            max_diff,
        )
        R = inputs.R
        if eMatRead.shape[2] < R:
            eMatRead = jnp.pad(
                eMatRead,
                ((0, 0), (0, 0), (0, R - eMatRead.shape[2])),
                constant_values=1.0,
            )
    n_its = uniforms.shape[0]
    B = bits.shape[0]
    if boundaries is None or len(boundaries) == 0:
        boundaries = np.zeros(0, dtype=np.int32)
        if smooth_w is None:
            block_u = None          # no static boundaries, no on-the-fly
    if block_u is None:
        block_u = np.zeros((n_its, 0, 3, B), dtype=np.float32)
        do_block = np.zeros(n_its, dtype=bool)
    if do_block is None:
        do_block = np.zeros(n_its, dtype=bool)
    # read structures are [n_rows, ...]; broadcast a single shared row to B
    rs_np, rc_np, w_np, m_np = (
        inputs.read_start, inputs.read_count, inputs.wif0, inputs.read_mask,
    )
    if rs_np.shape[0] == 1 and B > 1:
        rs_np = np.broadcast_to(rs_np, (B, rs_np.shape[1]))
        rc_np = np.broadcast_to(rc_np, (B, rc_np.shape[1]))
        w_np = np.broadcast_to(w_np, (B, w_np.shape[1]))
        m_np = np.broadcast_to(m_np, (B, m_np.shape[1]))
    if relabel_u is None:
        relabel_u = np.zeros((n_its, B), dtype=np.float32)
    if n_latent == 3:
        rlc = nipt_tables.make_rlc(ff).astype(np.float32)
        clp = nipt_tables.class_log_p(ff).astype(np.float32)
        perm_mask = np.ones(6, dtype=np.float32)
        if ff <= 0.0:
            perm_mask[[1, 3, 4, 5]] = 0.0
        W = int(rc_np.max()) if rc_np.size else 0
    else:
        rlc = np.zeros((7, 3), dtype=np.float32)
        clp = np.zeros(8, dtype=np.float32)
        perm_mask = np.ones(6, dtype=np.float32)
        W = 0
    gp, gpF, hap_dos, H, ll, uf, H_class = _gibbs_core(
        eMatRead,
        jnp.asarray(bits),
        jnp.asarray(rs_np),
        jnp.asarray(rc_np),
        jnp.asarray(w_np),
        jnp.asarray(m_np),
        jnp.asarray(inputs.trans),
        jnp.asarray(prior),
        jnp.asarray(uniforms, dtype=np.float32),
        jnp.asarray(H0, dtype=np.int32),
        jnp.asarray(first_read, dtype=np.int32),
        jnp.asarray(boundaries, dtype=np.int32),
        jnp.asarray(block_u, dtype=np.float32),
        jnp.asarray(do_block),
        jnp.asarray(relabel_u, dtype=np.float32),
        jnp.asarray(rlc),
        jnp.asarray(clp),
        jnp.asarray(perm_mask),
        nl=n_latent,
        iterative_init=iterative_init,
        K_real=K_real,
        W=W,
        do_entire=bool(do_entire),
        ref_error=ref_error,
        resample_u=(
            jnp.asarray(resample_u, dtype=np.float32)
            if resample_u is not None else None
        ),
        block_within=bool(block_within),
        smooth_w=(tuple(jnp.asarray(x) for x in smooth_w)
                  if smooth_w is not None else None),
        quantile_prob=float(quantile_prob),
    )
    if not return_arrays:
        return gp, gpF, hap_dos, H, ll, uf, H_class
    return (
        np.asarray(gp),
        np.asarray(gpF),
        np.asarray(hap_dos),
        np.asarray(H),
        np.asarray(ll),
        np.asarray(uf),
        np.asarray(H_class),
    )
