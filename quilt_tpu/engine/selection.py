"""Haplotype re-selection between seek iterations.

Implements everything_select_good_haps (reference:
QUILT/R/functions.R:2262-2310): merge the per-latent-hap, per-thinned-grid
top-match lists breadth-first (all rank-1 matches, then rank-2, ...) into
Knew fresh haplotypes, excluding the retained previously-selected set.

Two implementations: the host reference (select_new_haps_from_topk, used
by the per-sample engine and as the oracle) and a batched device version
(select_new_haps_device) that keeps the whole seek loop on-device, so the
batched engine never waits for the host to fetch top-K lists or read
labels between iterations.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def select_new_haps_from_topk(
    top_idx: np.ndarray,        # [n_lists, K_top] hap indices, rank order
    top_vals: np.ndarray,       # [n_lists, K_top] gamma values
    Knew: int,
    K: int,
    previously_selected: np.ndarray,
    rng: np.random.Generator,
    K_top_matches: int = 5,
) -> np.ndarray:
    """Pick Knew haplotypes from ranked top-match lists."""
    prev = set(previously_selected.tolist())
    keep: List[int] = []
    kept = set()
    depth_max = min(K_top_matches, top_idx.shape[1])
    for depth in range(depth_max):
        new = np.unique(top_idx[:, depth])
        new = [h for h in new.tolist() if h not in prev and h not in kept]
        room = Knew - len(keep)
        if len(new) < room:
            keep.extend(new)
            kept.update(new)
        else:
            chosen = rng.choice(len(new), size=room, replace=False)
            keep.extend(np.asarray(new)[chosen].tolist())
            kept.update(keep)
            break
    if len(keep) < Knew:
        # exhausted ranked lists: take everything seen, then random fill
        allm = np.unique(top_idx)
        extra = [h for h in allm.tolist() if h not in prev and h not in kept]
        room = Knew - len(keep)
        keep.extend(extra[:room])
        kept.update(keep)
    if len(keep) < Knew:
        pool = np.setdiff1d(
            np.arange(K), np.asarray(sorted(kept | prev), dtype=np.int64)
        )
        fill = rng.choice(pool, size=Knew - len(keep), replace=False)
        keep.extend(fill.tolist())
    return np.asarray(keep[:Knew], dtype=np.int64)


def select_new_haps_device(
    tv,                         # [nThin, B*nl, K_top] thinned top-match vals
    ti,                         # [nThin, B*nl, K_top] hap indices
    which,                      # [B, Ksub] current subsets (device, i32)
    key,                        # jax PRNG key
    n_keep: int,
    Knew: int,
    K: int,
    nl: int,
    K_top_matches: int,
):
    """Batched on-device everything_select_good_haps.

    Same selection semantics as select_new_haps_from_topk, vectorized over
    the chain batch with a key-based formulation: every panel hap gets a
    priority key — ranked candidates get (depth + intra-depth noise),
    depths past K_top_matches are demoted behind all primary depths
    (the reference's 'exhausted ranked lists' fallback), untouched haps get
    a large random key (the random pool fill), retained haps +inf — and
    the Knew smallest keys win. Scatter-min performs the first-occurrence
    dedup. The intra-depth random order replaces the reference's random
    subset at the boundary depth (equivalent in distribution).

    Returns the new sorted subsets [B, Ksub] (device)."""
    import jax
    import jax.numpy as jnp

    nThin, BN, K_top = tv.shape
    B = BN // nl
    Ksub = which.shape[1]
    k1, k2, k3 = jax.random.split(key, 3)
    # retained previously-selected rows: random n_keep of the current set
    perm_keys = jax.random.uniform(k1, (B, Ksub))
    order = jnp.argsort(perm_keys, axis=1)[:, :n_keep]
    prev = jnp.take_along_axis(which, order, axis=1)          # [B, n_keep]

    # candidate lists -> [B, n_lists, K_top]
    ti_b = ti.reshape(nThin, B, nl, K_top).transpose(1, 2, 0, 3).reshape(
        B, nl * nThin, K_top
    )
    tv_b = tv.reshape(nThin, B, nl, K_top).transpose(1, 2, 0, 3).reshape(
        B, nl * nThin, K_top
    )
    depth = jnp.arange(K_top, dtype=jnp.float32)[None, None, :]
    demote = jnp.where(depth < K_top_matches, 0.0, 1e4)
    noise = jax.random.uniform(k2, ti_b.shape)
    cand_key = depth + demote + noise
    cand_key = jnp.where(tv_b > 0, cand_key, jnp.inf)
    cand = jnp.clip(ti_b, 0, K - 1).reshape(B, -1)
    cand_key = cand_key.reshape(B, -1)

    pool = 1e6 + jax.random.uniform(k3, (B, K))               # random fill
    bidx = jnp.arange(B)[:, None]
    keymat = pool.at[
        jnp.broadcast_to(bidx, cand.shape), cand
    ].min(cand_key)
    keymat = keymat.at[
        jnp.broadcast_to(bidx, prev.shape), prev
    ].set(jnp.inf)
    _, new = jax.lax.top_k(-keymat, Knew)                     # [B, Knew]
    return jnp.sort(
        jnp.concatenate([prev, new.astype(which.dtype)], axis=1), axis=1
    )


def read_confidence_device(
    hap_dos,                    # [B, nl, S] final per-chain hap dosages
    u_pad,                      # [B, R, J] device i32
    lpr,                        # [B, R, J] device f32 (log pR; 0 at pads)
    lpa,                        # [B, R, J] device f32
    nl: int,
    minrp: float = 0.95,
):
    """Batched device read confidence (reference:
    assess_ability_of_reads_to_be_confident, functions.R:1615-1660, via
    the P(read | hap dosage) products of emat_read_vs_dosages)."""
    import jax.numpy as jnp

    B, R, J = u_pad.shape
    u_flat = u_pad.reshape(B, 1, R * J)
    e = jnp.take_along_axis(hap_dos, u_flat, axis=2).reshape(B, nl, R, J)
    pR = jnp.exp(lpr)[:, None]
    pA = jnp.exp(lpa)[:, None]
    term = e * pA + (1.0 - e) * pR
    logp = jnp.log(jnp.maximum(term, 1e-30)).sum(axis=3)      # [B, nl, R]
    em = jnp.exp(logp - logp.max(axis=1, keepdims=True))
    p = em / jnp.maximum(em.sum(axis=1, keepdims=True), 1e-30)
    return p.max(axis=1) > minrp                              # [B, R]


def consensus_read_labels(
    labels_all: np.ndarray,     # [R, C] final labels per chain (0/1)
    conf_all: np.ndarray,       # [R, C] read-confidence per chain
    verbose: bool = False,
) -> np.ndarray:
    """Cross-chain read-label consensus via confident-read flip detection.

    Port of determine_best_read_label_so_far (reference:
    QUILT/R/functions.R:1680-1784): align chains at confident reads; where a
    minority of chains flips relative to the canonical chain, flip their
    suffix back; where a majority flips, flip the canonical chain's suffix.
    Labels are 0/1 here (reference uses 1/2).
    """
    R, C = labels_all.shape
    can_hap = C - 1
    out = labels_all[:, can_hap].astype(np.int64).copy()
    both_conf = conf_all.all(axis=1)
    idx = np.flatnonzero(both_conf)
    if len(idx) < 10:
        return out
    a = labels_all[idx].astype(np.int64)
    can = a[:, can_hap].copy()
    d = a - can[:, None]
    rows_change = np.flatnonzero(np.diff(np.abs(d).sum(axis=1)) != 0)
    if len(rows_change) == 0:
        return out
    labels_work = labels_all.astype(np.int64).copy()
    starts = np.concatenate([[0], rows_change + 1])
    flip_cols_per_seg = []
    for i in range(1, len(starts)):
        s = starts[i]
        cur = d[s]
        changed = np.flatnonzero(cur != 0)
        w = slice(s, len(idx))
        if len(changed) == 0:
            flip_cols_per_seg.append((s, []))
            continue
        if len(changed) <= C / 2:
            # trust canonical: revert changed chains' suffixes
            for c1 in changed:
                reverted = 1 - (d[w, c1] + can[w])
                d[w, c1] = reverted - can[w]
            flip_cols_per_seg.append((s, changed.tolist()))
        else:
            changed = np.flatnonzero(cur == 0)
            for c1 in changed:
                reverted = 1 - (d[w, c1] + can[w])
                d[w, c1] = reverted - can[w]
            reverted_all = d[w] + can[w, None]
            can[w] = 1 - can[w]
            d[w] = reverted_all - can[w, None]
            flip_cols_per_seg.append((s, changed.tolist()))
    # apply flips to the full label matrix from each segment start onwards
    for s, cols in flip_cols_per_seg:
        if not cols:
            continue
        full_start = idx[s]
        for c1 in cols:
            labels_work[full_start:, c1] = 1 - labels_work[full_start:, c1]
    return labels_work[:, can_hap]


def read_confidence(
    em_vs_haps: np.ndarray,     # [n_latent, R] P(read | final hap dosages)
    minrp: float = 0.95,
) -> np.ndarray:
    """Which reads confidently belong to one haplotype (reference:
    assess_ability_of_reads_to_be_confident, functions.R:1615-1660)."""
    if em_vs_haps.shape[0] == 2:
        p1, p2 = em_vs_haps
        with np.errstate(invalid="ignore", divide="ignore"):
            mp = p1 / (p1 + p2)
        mp = np.where(np.isfinite(mp), mp, 0.5)
        mp = np.where(mp < 0.5, 1 - mp, mp)
        return mp > minrp
    d = em_vs_haps.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = em_vs_haps / d
    mp = np.nanmax(np.where(np.isfinite(p), p, 1 / 3), axis=0)
    return mp > minrp


def recast_haps(
    hd1: np.ndarray, hd2: np.ndarray, gp: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Force phased haplotype dosages to agree with the genotype posterior
    argmax (reference: recast_haps, functions.R:3180-3209). gp is [3, nSNPs].
    """
    hd1 = hd1.copy()
    hd2 = hd2.copy()
    gt1 = np.round(hd1) + np.round(hd2)
    gt3 = gp.argmax(axis=0)
    ch = gt3 != gt1
    w0 = ch & (gt3 == 0)
    hd1[w0] = 0.0
    hd2[w0] = 0.0
    w2 = ch & (gt3 == 2)
    hd1[w2] = 1.0
    hd2[w2] = 1.0
    w1 = ch & (gt3 == 1)
    gtr = hd1[w1] > hd2[w1]
    hd1w = np.where(gtr, 1.0, 0.0)
    hd2w = np.where(gtr, 0.0, 1.0)
    hd1[w1] = hd1w
    hd2[w1] = hd2w
    return hd1, hd2


def recast_nipt_haps(
    hap1: np.ndarray,
    hap2: np.ndarray,
    hap3: np.ndarray,
    mat_gp: np.ndarray,
    fet_gp: np.ndarray,
):
    """NIPT variant: make the 3 phased haplotypes agree with maternal and
    fetal genotype posteriors (reference: recast_nipt_haps,
    functions.R:3214-3288)."""
    hap1, hap2, hap3 = hap1.copy(), hap2.copy(), hap3.copy()
    gtM = mat_gp.argmax(axis=0)
    gtF = fet_gp.argmax(axis=0)
    conv = [
        (0, 0, 0, 0, 0),
        (0, 1, 0, 0, 1),
        (0, 2, 0, 0, 1),
        (1, 0, 0, 1, 0),
        (1, 2, 1, 0, 1),
        (2, 0, 1, 1, 0),
        (2, 1, 1, 1, 0),
        (2, 2, 1, 1, 1),
    ]
    for m, f, h1, h2, h3 in conv:
        w = (gtM == m) & (gtF == f)
        hap1[w] = h1
        hap2[w] = h2
        hap3[w] = h3
    w1 = (gtM == 1) & (gtF == 1)
    r1 = np.round(hap1[w1])
    r2 = np.round(hap2[w1])
    r3 = np.round(hap3[w1])
    case_a = (r1 == 1) & (r2 == 0) & (r3 == 0)
    case_b = (r1 == 0) & (r2 == 1) & (r3 == 1)
    other = ~case_a & ~case_b
    h1n = np.where(case_a, 1, np.where(case_b, 0, r1))
    h2n = np.where(case_a, 0, np.where(case_b, 1, r2))
    h3n = np.where(case_a, 0, np.where(case_b, 1, 1 - h1n))
    h3n = np.where(other, 1 - h1n, h3n)
    hap1[w1] = h1n
    hap2[w1] = h2n
    hap3[w1] = h3n
    return np.round(hap1), np.round(hap2), np.round(hap3)
