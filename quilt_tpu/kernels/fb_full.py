"""Batched full-panel haploid forward-backward (the QUILT1 hot kernel).

Functional equivalent of Rcpp_haploid_dosage_versus_refs (reference:
QUILT/src/reference-single.cpp:2189-2413, forward v3 at :878-1151, fused
backward + dosage + streaming top-K at :1152-2188), redesigned for XLA:

- per-grid emissions for all K haplotypes are materialized BEFORE the scans
  with one gather from the per-grid distinct-haplotype log-emission
  table (built once per call from the sample's GLs), plus an exact scatter
  correction for escape entries (hapMatcher == 0) — replacing the
  reference's per-element binary search (reference-single.cpp:2326-2331) —
  and exponentiated after subtracting each (grid, row)'s panel-wide max,
  so no grid underflows float32 (_fb_emissions);
- the grid axis is then a lax.scan whose steps are purely elementwise over
  [B, K] (no gathers/matmuls inside the scan), so each step is bound by
  device-memory bandwidth; K is shardable over a mesh axis
  (quilt_tpu/dist);
- per-SNP dosages reduce through the distinctHapsIE table as chunked
  matmuls over the stored gammas (gather-as-matmul with a bf16 one-hot,
  whose 0/1 entries are exact);
- rows are split into chunks sized from the device's memory limit
  (fb_row_chunk), since E, alphas and gammas are [G, rows, K] each;
- top-K matching haplotypes are extracted at thinned grids with lax.top_k
  (replacing the streaming insertion sort, reference-single.cpp:129-266);
- numerics: float32 with per-grid renormalization (the reference's lazy
  fp64 normalization, reference-single.cpp:521-537, does not survive fp32).

Batch axis B = {samples x chains x latent haps}.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..panel.prepare import CompressedPanel
from ..utils.device import device_bytes_limit
from .common import pad_to_multiple
from .emissions import log_emat_dh_from_gl


@dataclass
class FBInputs:
    """Static (per-region) device inputs for fb_full, built once."""

    dh: np.ndarray            # int32 [nGrids, K_pad] hapMatcher.T (0=escape)
    ie: np.ndarray            # f32 [nMaxDH+1, S] inflated dosages (row 0 = 0)
    dh_bits: np.ndarray       # uint8 [nMaxDH, S] distinct hap alleles
    esc_grid: np.ndarray      # int32 [nnz] escape grid (flat COO)
    esc_k: np.ndarray         # int32 [nnz]
    esc_word: np.ndarray      # uint32 [nnz]
    esc_bits: np.ndarray      # uint8 [nnz, 32]
    trans: np.ndarray         # f32 [nGrids, 2]; row g = (stay, jump) INTO g
    thin_flag: np.ndarray     # int32 [nGrids]; slot index at thinned grids else -1
    K: int
    K_pad: int
    nGrids: int
    S: int
    nSNPs: int
    nMaxDH: int
    nnz: int
    _dev: Optional[dict] = None    # cached device-resident arrays

    capture_grid: int = -1       # grid whose gamma to capture (hla_run)

    def device(self) -> dict:
        """Upload the static arrays once; reused across FB calls."""
        if self._dev is None:
            cap = np.zeros(self.nGrids, dtype=np.float32)
            if self.capture_grid >= 0:
                cap[self.capture_grid] = 1.0
            self._dev = {
                k: jnp.asarray(getattr(self, k))
                for k in ("dh", "ie", "dh_bits", "esc_grid", "esc_k",
                          "esc_bits", "trans", "thin_flag")
            }
            self._dev["capture_flag"] = jnp.asarray(cap)
        return self._dev

    @classmethod
    def build(
        cls,
        panel: CompressedPanel,
        trans: np.ndarray,
        thinned_grids: Optional[np.ndarray] = None,
    ) -> "FBInputs":
        from ..utils import unpack_bits_32, unpack_words

        K, nGrids = panel.K, panel.nGrids
        K_pad = pad_to_multiple(K, 128)
        # grid axis padded to the scan-chunk multiple with NEUTRAL grids
        # (emission 1 for real haps, stay=1/jump=0): the recursion is a
        # no-op through them, amortizing per-step scan overhead
        Gp = pad_to_multiple(nGrids, GRID_CHUNK)
        S = Gp * 32
        dh = np.zeros((Gp, K_pad), dtype=np.int32)
        dh[:nGrids, :K] = panel.hapMatcher.astype(np.int32).T
        dh[nGrids:, :K] = 1                               # neutral: slot 1
        ie = np.zeros((panel.nMaxDH + 1, S), dtype=np.float32)
        ie[1:, :panel.nSNPs] = panel.distinctHapsIE[:, :panel.nSNPs]
        dh_bits = np.zeros((panel.nMaxDH, S), dtype=np.uint8)
        dh_bits[:, :panel.nSNPs] = unpack_bits_32(
            panel.distinctHapsB, panel.nSNPs
        )
        esc_bits = unpack_words(panel.esc_word)           # [nnz, 32]
        trans_full = np.zeros((Gp, 2), dtype=np.float32)
        trans_full[0] = (1.0, 1.0)    # g=0: alpha carry 0 => prior jump/K
        trans_full[1:nGrids] = np.asarray(trans, dtype=np.float32).T
        trans_full[nGrids:] = (1.0, 0.0)
        thin_flag = np.full(Gp, -1, dtype=np.int32)
        if thinned_grids is not None:
            for i, g in enumerate(thinned_grids):
                thin_flag[int(g)] = i
        # the escape COO must be sorted by (grid, k) with unique entries:
        # the emission scatter and the dosage segment_sum promise XLA both
        esc_key = panel.esc_grid.astype(np.int64) * K + panel.esc_k
        if np.any(np.diff(esc_key) <= 0):
            raise ValueError("escape COO is not sorted by (grid, k)")
        return cls(
            dh=dh, ie=ie, dh_bits=dh_bits,
            esc_grid=panel.esc_grid.astype(np.int32),
            esc_k=panel.esc_k.astype(np.int32),
            esc_word=panel.esc_word.astype(np.uint32),
            esc_bits=esc_bits,
            trans=trans_full, thin_flag=thin_flag,
            K=K, K_pad=K_pad, nGrids=Gp, S=S, nSNPs=panel.nSNPs,
            nMaxDH=panel.nMaxDH, nnz=len(panel.esc_k),
        )


ESC_CHUNK = 65536
# grids unrolled per scan step: 8 beat 16 and 32 by 10-16 % on an H100
# (700 W) at the diploid quick-start FB call (K=5,120, 448 rows, 512 grids)
GRID_CHUNK = 8
# [G, rows, K_pad] f32 arrays live at the peak of one FB call: E, alphas,
# gammas, the reversed backward-scan output and two scan/scatter transients
FB_ROW_ARRAYS = 6
FB_MEMORY_SHARE = 0.4   # of the device's memory limit, for one FB call
# most rows per FB call: on an H100 (700 W) XLA took over 7 minutes to
# compile one reduction fusion of the call at 224 rows (K=5,120, 512
# grids), and the call ran 6.7x slower per cell than at 28 rows
FB_MAX_ROWS = 28


def _pad_nnz(x, n_pad, value=0):
    return jnp.pad(x, [(0, n_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1),
                   constant_values=value)


def _escape_log_emissions_flat(gl, esc_grid, esc_bits, ref_error):
    """Exact log emissions of flat escape entries: [B, nnz] (chunked over
    nnz to bound the [B, chunk, 32] transient)."""
    B = gl.shape[0]
    G = gl.shape[2] // 32
    nnz = esc_grid.shape[0]
    gl_g = gl.reshape(B, 2, G, 32)
    e_all = esc_bits.astype(jnp.float32) * (1.0 - 2.0 * ref_error) + ref_error
    n_chunks = (nnz + ESC_CHUNK - 1) // ESC_CHUNK
    npad = n_chunks * ESC_CHUNK
    eg = _pad_nnz(esc_grid, npad)
    eb = _pad_nnz(e_all, npad)

    def chunk(_, c):
        g_c = jax.lax.dynamic_slice(eg, (c * ESC_CHUNK,), (ESC_CHUNK,))
        e_c = jax.lax.dynamic_slice(
            eb, (c * ESC_CHUNK, 0), (ESC_CHUNK, 32)
        )
        dR = gl_g[:, 0, g_c, :]
        dA = gl_g[:, 1, g_c, :]
        term = dR * (1.0 - e_c[None]) + dA * e_c[None]
        return None, jnp.log(jnp.maximum(term, 1e-30)).sum(axis=-1)

    _, out = jax.lax.scan(chunk, None, jnp.arange(n_chunks))
    return jnp.moveaxis(out, 0, 1).reshape(B, npad)[:, :nnz]


def _fb_emissions(gl, dh, dh_bits, esc_grid, esc_k, esc_bits, ref_error,
                  K_pad, nMaxDH, nnz, esc_valid, kmax):
    """Emissions E [G, B, K_pad] of every (grid, hap), scaled so that the
    largest over the whole panel is 1 at each (grid, row), and the log of
    that scale, shift [G, B]. A grid whose every haplotype disagrees with
    the GLs can have all emissions below float32's range; scaling in log
    space keeps it finite. The normalized recursion is invariant to the
    scale and the log-likelihood adds it back. Pad haps get 0.

    Table haps gather their log emission from the distinct-hap table
    (an exact gather), escape haps take their exact COO log emission."""
    log_tab = jnp.moveaxis(
        log_emat_dh_from_gl(gl, dh_bits, ref_error), 0, 1
    )                                                      # [G, B, D+1]
    logE = jnp.take_along_axis(log_tab, dh[:, None, :], axis=2)  # [G, B, K]
    present = (dh > 0).astype(jnp.int32)                   # [G, K_pad]
    if nnz > 0:
        valid = (jnp.ones((nnz,), jnp.float32) if esc_valid is None
                 else esc_valid)
        log_esc = _escape_log_emissions_flat(gl, esc_grid, esc_bits,
                                             ref_error)
        # .add == .set here: escape slots hold slot 0's placeholder 0,
        # and invalid (padded) entries add 0. The COO from compress_panel
        # is sorted by (grid, k) with unique entries (checked in
        # FBInputs.build), so the scatter may say so. The sharded path
        # pads with duplicate indices, so it must not claim uniqueness.
        sorted_unique = esc_valid is None
        logE = logE.at[esc_grid, :, esc_k].add(
            (log_esc * valid[None, :]).T, unique_indices=sorted_unique,
            indices_are_sorted=sorted_unique,
        )
        present = present.at[esc_grid, esc_k].max(
            (valid > 0).astype(jnp.int32)
        )
    # pad haps: neither in the table nor escapes
    logE = jnp.where(present[:, None, :] > 0, logE, -jnp.inf)
    shift = kmax(logE.max(axis=2))                         # [G, B]
    return jnp.exp(logE - shift[:, :, None]), shift


def _dosage_from_gammas(
    gammas, dh, ie, esc_grid, esc_k, esc_bits, K_pad, nMaxDH, nnz,
    ref_error, grid_chunk, ksum, esc_valid, B, S, G,
):
    """Per-SNP dosages from stored gammas via chunked matmuls
    through the distinct-hap table + exact escape corrections (shared
    by the per-grid and segment-fused FB bodies)."""
    D1 = nMaxDH + 1
    # ---- dosage: chunked matmuls through the distinct-hap table
    ie_g = ie.reshape(D1, G, 32)
    n_chunks = (G + grid_chunk - 1) // grid_chunk
    Gp = n_chunks * grid_chunk
    if Gp != G:
        gammas_p = jnp.pad(gammas, ((0, Gp - G), (0, 0), (0, 0)))
        dh_p = jnp.pad(dh, ((0, Gp - G), (0, 0)))
        ie_p = jnp.pad(ie_g, ((0, 0), (0, Gp - G), (0, 0)))
    else:
        gammas_p, dh_p, ie_p = gammas, dh, ie_g

    def dos_chunk(_, c):
        g0 = c * grid_chunk
        gam = jax.lax.dynamic_slice(
            gammas_p, (g0, 0, 0), (grid_chunk, B, K_pad)
        )
        dh_c = jax.lax.dynamic_slice(dh_p, (g0, 0), (grid_chunk, K_pad))
        onehot = jax.nn.one_hot(dh_c, D1, dtype=jnp.bfloat16)   # [CG, K, D+1]
        # bf16 operands, f32 accumulation: the one-hot's 0/1 entries are
        # exact, so each term is exactly the bf16-rounded gamma
        matched = ksum(jnp.einsum(
            "gbk,gkd->gbd", gam.astype(jnp.bfloat16), onehot,
            preferred_element_type=jnp.float32,
        ))
        ie_c = jax.lax.dynamic_slice(ie_p, (0, g0, 0), (D1, grid_chunk, 32))
        dos = jnp.einsum(
            "gbd,dgs->gbs", matched, ie_c, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return None, dos

    _, dos_chunks = jax.lax.scan(dos_chunk, None, jnp.arange(n_chunks))
    dosage = (
        dos_chunks.reshape(Gp, B, 32)[:G].transpose(1, 0, 2).reshape(B, S)
    )
    if nnz > 0:
        # exact escape dosage: gamma of escape haps x their inflated alleles,
        # chunked over nnz and scatter-added per grid
        e_inf_all = esc_bits.astype(jnp.float32) * (1.0 - 2.0 * ref_error) + ref_error
        n_chunks = (nnz + ESC_CHUNK - 1) // ESC_CHUNK
        npad = n_chunks * ESC_CHUNK
        eg = _pad_nnz(esc_grid, npad)
        ek = _pad_nnz(esc_k, npad)
        ei = _pad_nnz(e_inf_all, npad)
        valid_nnz = (esc_valid if esc_valid is not None
                     else jnp.ones((nnz,), jnp.float32))
        valid = _pad_nnz(valid_nnz, npad)
        # per-grid reduction via sorted segment_sum (chunked to bound the
        # [chunk, B, 32] transient); the sharded path's padded COO is not
        # sorted, so it does not claim to be
        dos_esc0 = jnp.zeros((G, B * 32), dtype=jnp.float32)

        def chunk(dg, c):
            g_c = jax.lax.dynamic_slice(eg, (c * ESC_CHUNK,), (ESC_CHUNK,))
            k_c = jax.lax.dynamic_slice(ek, (c * ESC_CHUNK,), (ESC_CHUNK,))
            e_c = jax.lax.dynamic_slice(ei, (c * ESC_CHUNK, 0), (ESC_CHUNK, 32))
            v_c = jax.lax.dynamic_slice(valid, (c * ESC_CHUNK,), (ESC_CHUNK,))
            gam_esc = gammas[g_c, :, k_c] * v_c[:, None]       # [chunk, B]
            contrib = gam_esc[:, :, None] * e_c[:, None, :]    # [chunk, B, 32]
            return dg + jax.ops.segment_sum(
                contrib.reshape(ESC_CHUNK, B * 32), g_c, num_segments=G,
                indices_are_sorted=esc_valid is None,
            ), None

        dos_esc, _ = jax.lax.scan(chunk, dos_esc0, jnp.arange(n_chunks))
        dos_esc = dos_esc.reshape(G, B, 32)
        dos_g = jnp.moveaxis(dosage.reshape(B, G, 32), 0, 1) + ksum(dos_esc)
        dosage = jnp.moveaxis(dos_g, 0, 1).reshape(B, S)
    return dosage


def _fb_core_impl(
    gl: jnp.ndarray,          # [B, 2, S] f32 (pad SNPs = 1)
    dh: jnp.ndarray,          # [G, K_pad] int32
    ie: jnp.ndarray,          # [D+1, S]
    dh_bits: jnp.ndarray,     # [D, S] uint8
    esc_grid: jnp.ndarray,    # [nnz]
    esc_k: jnp.ndarray,       # [nnz]
    esc_bits: jnp.ndarray,    # [nnz, 32]
    trans: jnp.ndarray,       # [G, 2]
    thin_flag: jnp.ndarray,   # [G]
    capture_flag: jnp.ndarray,  # [G] f32; 1 at grids whose gamma is captured
    K: int,
    K_pad: int,
    nMaxDH: int,
    nnz: int,
    K_top: int,
    ref_error: float,
    grid_chunk: int = 64,
    axis_name=None,
    esc_valid: jnp.ndarray = None,   # f32 [nnz] 1/0 mask (sharded padding)
):
    """Kernel body. With axis_name set (running under shard_map with the K
    axis sharded over that mesh axis), every K-reduction becomes a psum /
    pmax over the axis, making the sharded result the exact algorithm —
    the multi-device decomposition of SURVEY section 2.7 (K over NVLink)."""

    def _ksum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    def _kmax(x):
        return jax.lax.pmax(x, axis_name) if axis_name else x

    B, _, S = gl.shape
    G = S // 32
    CG = GRID_CHUNK
    NSC = G // CG
    # ---- emissions for every (grid, hap), max-scaled per (grid, row)
    E, shift = _fb_emissions(
        gl, dh, dh_bits, esc_grid, esc_k, esc_bits, ref_error, K_pad,
        nMaxDH, nnz, esc_valid, _kmax,
    )

    # ---- forward: scan over grid chunks, inner steps unrolled
    E_c = E.reshape(NSC, CG, B, K_pad)
    trans_c = trans.reshape(NSC, CG, 2)

    def fwd_chunk(alpha, xs):
        e_ch, t_ch = xs
        outs = []
        logs = []
        for i in range(CG):
            a_raw = (t_ch[i, 0] * alpha + t_ch[i, 1] / K) * e_ch[i]
            ssum = _ksum(a_raw.sum(axis=1, keepdims=True))
            alpha = a_raw / ssum
            outs.append(alpha)
            logs.append(jnp.log(ssum[:, 0]))
        return alpha, (jnp.stack(outs), jnp.stack(logs))

    alpha0 = jnp.zeros((B, K_pad), dtype=jnp.float32)
    _, (alphas_c, log_s) = jax.lax.scan(fwd_chunk, alpha0, (E_c, trans_c))
    alphas = alphas_c.reshape(G, B, K_pad)
    log_like = log_s.reshape(G, B).sum(axis=0) + shift.sum(axis=0)

    # ---- backward: chunked reverse scan; beta + normalized gamma + top-K
    thin_c = thin_flag.reshape(NSC, CG)

    cap_c = capture_flag.reshape(NSC, CG)

    def bwd_chunk(carry, c):
        beta, e_next, t_next, gcap = carry    # state at grid (c+1)*CG
        ci = NSC - 1 - c
        e_ch = E_c[ci]
        t_ch = trans_c[ci]
        a_ch = alphas_c[ci]
        th_ch = thin_c[ci]
        cp_ch = cap_c[ci]
        gammas = []
        tvs = []
        tis = []
        for i in range(CG - 1, -1, -1):
            is_last_grid = (ci == NSC - 1) & (i == CG - 1)
            etb = e_next * beta
            b_new = t_next[0] * etb + t_next[1] * _ksum(etb.sum(
                axis=1, keepdims=True
            )) / K
            beta = jnp.where(is_last_grid, jnp.ones_like(beta), b_new)
            beta = beta / jnp.maximum(
                _kmax(beta.max(axis=1, keepdims=True)), 1e-30
            )
            gamma = a_ch[i] * beta
            gamma = gamma / _ksum(gamma.sum(axis=1, keepdims=True))
            gammas.append(gamma)
            tf = th_ch[i]

            def do_topk(_):
                # sharded: local top-K with global indices; the caller
                # merges the gathered per-shard lists by value
                v, ix = jax.lax.top_k(gamma[:, :K] if axis_name is None
                                      else gamma, K_top)
                ix = ix.astype(jnp.int32)
                if axis_name is not None:
                    ix = ix + jax.lax.axis_index(axis_name) * K_pad
                return v, ix

            def no_topk(_):
                return (
                    jnp.zeros((B, K_top), dtype=gamma.dtype),
                    jnp.zeros((B, K_top), dtype=jnp.int32),
                )

            tv, ti = jax.lax.cond(tf >= 0, do_topk, no_topk, None)
            tvs.append(tv)
            tis.append(ti)
            gcap = gcap + gamma * cp_ch[i]
            e_next = e_ch[i]
            t_next = t_ch[i]
        gammas.reverse()
        tvs.reverse()
        tis.reverse()
        return (beta, e_next, t_next, gcap), (
            jnp.stack(gammas), jnp.stack(tvs), jnp.stack(tis)
        )

    carry0 = (
        jnp.ones((B, K_pad), dtype=jnp.float32),
        E_c[NSC - 1, CG - 1],
        trans_c[NSC - 1, CG - 1],
        jnp.zeros((B, K_pad), dtype=jnp.float32),
    )
    (_, _, _, gamma_cap), (gammas_rc, tv_rc, ti_rc) = jax.lax.scan(
        bwd_chunk, carry0, jnp.arange(NSC)
    )
    gammas = gammas_rc[::-1].reshape(G, B, K_pad)
    top_vals = tv_rc[::-1].reshape(G, B, K_top)
    top_idx = ti_rc[::-1].reshape(G, B, K_top)

    dosage = _dosage_from_gammas(
        gammas, dh, ie, esc_grid, esc_k, esc_bits, K_pad, nMaxDH, nnz,
        ref_error, grid_chunk, _ksum, esc_valid, B, S, G,
    )
    return dosage, log_like, top_vals, top_idx, gamma_cap


_fb_core = partial(
    jax.jit,
    static_argnames=("K", "K_pad", "nMaxDH", "nnz", "K_top", "ref_error",
                     "grid_chunk"),
)(_fb_core_impl)


SEG_LEN = 8    # grids per collective in the segment-fused sharded FB


def _fb_core_segmented(
    gl, dh, ie, dh_bits, esc_grid, esc_k, esc_bits, trans, thin_flag,
    capture_flag, K, K_pad, nMaxDH, nnz, K_top, ref_error,
    grid_chunk: int = 64, axis_name=None, esc_valid=None,
    seg_len: int = SEG_LEN,
):
    """Segment-fused panel-sharded FB (SURVEY section 7, hard part 4).

    _fb_core_impl under shard_map pays 4 collectives PER GRID (forward
    normalizer psum; backward jump-mass psum + pmax; gamma normalizer
    psum). Within a segment of L grids the Li & Stephens step is affine
    with a DIAGONAL propagator plus a rank-1 jump inflow
    (reference-single.cpp:441-580: alpha' = e*(t0*alpha + t1*mass/K)), so
    the cross-shard coupling over a whole segment reduces to L scalar
    masses per batch row satisfying a lower-triangular system whose
    coefficients are segment-local reductions: the elementwise cumulative
    products S_i = prod(t0_j e_j) give
        A_i = S_i*(a_0 + sum_{l<=i} c_l M_{l-1} / S_{l-1}),
        M_i = h_i + sum_l c_l M_{l-1} P_{l-1,i},
    with h_i = sum_k S_i a_0, P_{l,i} = sum_k S_i/S_l, c_l = t1_l/(K t0_l).
    One psum of the [L(L+3)/2]-vector (h + lower-tri P) replaces L
    per-grid psums; the backward recursion mirrors it with
    emission-weighted pair sums. Per-grid emissions are pre-scaled by
    their GLOBAL max (one [G, B] pmax per call) so the in-segment
    products stay in f32 range; zero columns (pad haps, underflowed
    emissions) are handled by clamped denominators.

    Exact same outputs as _fb_core_impl (within f32 tolerance); per-grid
    collectives drop from 4 to ~3/L."""
    ksum = (lambda x: jax.lax.psum(x, axis_name)) if axis_name else (
        lambda x: x
    )
    kmax = (lambda x: jax.lax.pmax(x, axis_name)) if axis_name else (
        lambda x: x
    )
    B, _, S = gl.shape
    G = S // 32
    L = seg_len
    NSC = G // L
    assert NSC * L == G, "grid axis must be a multiple of seg_len"
    TINY = 1e-30

    # ---- emissions, max-scaled per (grid, row) by one global pmax ----
    Eh, shift = _fb_emissions(
        gl, dh, dh_bits, esc_grid, esc_k, esc_bits, ref_error, K_pad,
        nMaxDH, nnz, esc_valid, kmax,
    )
    Eh_c = Eh.reshape(NSC, L, B, K_pad)
    trans_c = trans.reshape(NSC, L, 2)
    log_mu_seg = shift.reshape(NSC, L, B).sum(axis=1)      # [NSC, B]

    # ---- forward: one psum per segment ----
    def fwd_seg(a0, xs):
        e_ch, t_ch = xs                 # [L, B, K], [L, 2]
        t0s, t1s = t_ch[:, 0], t_ch[:, 1]
        # direct suffix products R[(l, i)] = prod_{j=l..i} t0_j e_j
        # (the math ratio S_{i+1}/S_l): division-free, so weak columns
        # underflow harmlessly to 0 instead of overflowing 1/S terms
        T = [t0s[i] * e_ch[i] for i in range(L)]
        R = {}
        for l in range(L):
            U = T[l]
            R[(l, l)] = U
            for i in range(l + 1, L):
                U = U * T[i]
                R[(l, i)] = U
        # local reductions: h_i = sum_k R[(0,i)] a0, P[(l,i)] = sum_k R
        flat = jnp.stack(
            [(R[(0, i)] * a0).sum(axis=1) for i in range(L)]
            + [R[(l, i)].sum(axis=1) for l in range(L)
               for i in range(l, L)]
        )
        flat = ksum(flat)
        h = flat[:L]
        P = {}
        off = L
        for l in range(L):
            for i in range(l, L):
                P[(l, i)] = flat[off]
                off += 1
        # lower-triangular mass solve; M[0] = 1 (a0 enters normalized; at
        # the very first grid trans row (1,1) injects the 1/K prior)
        c_l = [t1s[i] / (K * jnp.maximum(t0s[i], TINY)) for i in range(L)]
        M = [jnp.ones((B,), jnp.float32)]
        for i in range(L):
            acc = h[i]
            for l in range(i + 1):
                acc = acc + c_l[l] * M[l] * P[(l, i)]
            M.append(acc)
        # reconstruction by direct inflow accumulation
        outs = []
        ll = jnp.log(jnp.maximum(M[L], TINY))
        for i in range(L):
            A_i = R[(0, i)] * a0
            for l in range(i + 1):
                A_i = A_i + (c_l[l] * M[l])[:, None] * R[(l, i)]
            outs.append(A_i / jnp.maximum(M[i + 1], TINY)[:, None])
        return outs[-1], (jnp.stack(outs), ll)

    alpha0 = jnp.zeros((B, K_pad), dtype=jnp.float32)
    _, (alphas_c, ll_seg) = jax.lax.scan(fwd_seg, alpha0, (Eh_c, trans_c))
    log_like = (ll_seg + log_mu_seg).sum(axis=0)

    # ---- backward: mirrored segment solve ----
    thin_c = thin_flag.reshape(NSC, L)
    cap_c = capture_flag.reshape(NSC, L)

    def bwd_seg(carry, c):
        beta_R, e_R, t_R, gcap = carry  # state right of this segment
        ci = NSC - 1 - c
        e_ch = Eh_c[ci]
        t_ch = trans_c[ci]
        a_ch = alphas_c[ci]
        # recursion: B_j = T_j*B_{j+1} + cb_j*N_{j+1}, with propagator
        # T_j = t0_{j+1} e_{j+1}, inflow cb_j = t1_{j+1}/K and mass
        # N_j = sum_k e_j B_j (N_L = sum_k e_R beta_R at the boundary);
        # step j = L-1 uses the NEXT segment's first grid (e_R, t_R)
        nxt_e = [e_ch[j + 1] for j in range(L - 1)] + [e_R]
        nxt_t = [t_ch[j + 1] for j in range(L - 1)] + [t_R]
        cb = [nxt_t[j][1] / K for j in range(L)]
        # direct products Rb[(j, l)] = prod_{m=j..l} T_m = Sb_j / Sb_{l+1}
        T = [nxt_t[j][0] * nxt_e[j] for j in range(L)]
        Rb = {}
        for j in range(L - 1, -1, -1):
            U = T[j]
            Rb[(j, j)] = U
            for l in range(j + 1, L):
                U = Rb[(j, l - 1)] * T[l]
                Rb[(j, l)] = U
        # local reductions: boundary mass NR, q_j = sum_k e_j Sb_j beta_R
        # (Sb_j = Rb[(j, L-1)]), Qr_{j,l} = sum_k e_j Sb_j/Sb_l
        NR_loc = (e_R * beta_R).sum(axis=1)
        q_loc = [
            (e_ch[j] * Rb[(j, L - 1)] * beta_R).sum(axis=1)
            for j in range(L)
        ]
        Qr_loc = {}
        for j in range(L):
            for l in range(j, L):
                w = e_ch[j] if l == j else e_ch[j] * Rb[(j, l - 1)]
                Qr_loc[(j, l)] = w.sum(axis=1)
        flat = jnp.stack(
            q_loc + [NR_loc]
            + [Qr_loc[(j, l)] for j in range(L) for l in range(j, L)]
        )
        flat = ksum(flat)
        q = flat[:L]
        Qr = {}
        off = L + 1
        for j in range(L):
            for l in range(j, L):
                Qr[(j, l)] = flat[off]
                off += 1
        # descending mass solve: N_j = q_j + sum_{l>=j} cb_l N_{l+1} Qr_{j,l}
        N = [None] * (L + 1)
        N[L] = flat[L]
        for j in range(L - 1, -1, -1):
            acc = q[j]
            for l in range(j, L):
                acc = acc + cb[l] * N[l + 1] * Qr[(j, l)]
            N[j] = acc
        # reconstruction by direct inflow accumulation:
        # B_j = Sb_j beta_R + cb_j N_{j+1} + sum_{l>j} cb_l N_{l+1} Rb[(j,l-1)]
        Bs = [None] * L
        for j in range(L - 1, -1, -1):
            B_j = Rb[(j, L - 1)] * beta_R + (cb[j] * N[j + 1])[:, None]
            for l in range(j + 1, L):
                B_j = B_j + (cb[l] * N[l + 1])[:, None] * Rb[(j, l - 1)]
            Bs[j] = B_j
        # gamma + top-K + capture; one psum for the L normalizers + the
        # carry normalizer
        gn_loc = jnp.stack(
            [(a_ch[j] * Bs[j]).sum(axis=1) for j in range(L)]
            + [Bs[0].sum(axis=1)]
        )
        gn = ksum(gn_loc)
        gammas = []
        tvs = []
        tis = []
        for j in range(L):
            gamma = a_ch[j] * Bs[j] / jnp.maximum(gn[j], TINY)[:, None]
            gammas.append(gamma)
            tf = thin_c[ci, j]

            def do_topk(_):
                v, ix = jax.lax.top_k(
                    gamma[:, :K] if axis_name is None else gamma, K_top
                )
                ix = ix.astype(jnp.int32)
                if axis_name is not None:
                    ix = ix + jax.lax.axis_index(axis_name) * K_pad
                return v, ix

            def no_topk(_):
                return (
                    jnp.zeros((B, K_top), dtype=gamma.dtype),
                    jnp.zeros((B, K_top), dtype=jnp.int32),
                )

            tv, ti = jax.lax.cond(tf >= 0, do_topk, no_topk, None)
            tvs.append(tv)
            tis.append(ti)
            gcap = gcap + gamma * cap_c[ci, j]
        # carry: beta at the segment's left edge, normalized by its
        # global sum (mass normalization, psum-batched above)
        beta_L = Bs[0] / jnp.maximum(gn[L], TINY)[:, None]
        return (beta_L, e_ch[0], t_ch[0], gcap), (
            jnp.stack(gammas), jnp.stack(tvs), jnp.stack(tis)
        )

    carry0 = (
        jnp.ones((B, K_pad), dtype=jnp.float32),
        jnp.ones((B, K_pad), dtype=jnp.float32),   # e right of last grid
        jnp.asarray([1.0, 0.0], dtype=jnp.float32),
        jnp.zeros((B, K_pad), dtype=jnp.float32),
    )
    (_, _, _, gamma_cap), (gammas_rc, tv_rc, ti_rc) = jax.lax.scan(
        bwd_seg, carry0, jnp.arange(NSC)
    )
    gammas = gammas_rc[::-1].reshape(G, B, K_pad)
    top_vals = tv_rc[::-1].reshape(G, B, K_top)
    top_idx = ti_rc[::-1].reshape(G, B, K_top)

    # ---- dosage (identical to _fb_core_impl) ----
    dosage = _dosage_from_gammas(
        gammas, dh, ie, esc_grid, esc_k, esc_bits, K_pad, nMaxDH, nnz,
        ref_error, grid_chunk, ksum, esc_valid, B, S, G,
    )
    return dosage, log_like, top_vals, top_idx, gamma_cap


def fb_row_chunk(B: int, G: int, K_pad: int, bytes_limit: int) -> int:
    """Rows per FB call: at most FB_MAX_ROWS, with the [G, rows, K_pad]
    f32 arrays of one call (FB_ROW_ARRAYS of them) within FB_MEMORY_SHARE
    of the device's memory limit; the fewest calls that fit split B
    evenly (so the last call carries few pad rows). Rows are
    independent, so a chunked call is exact."""
    per_row = FB_ROW_ARRAYS * G * K_pad * 4
    cap = int(bytes_limit * FB_MEMORY_SHARE) // per_row
    cap = max(1, min(B, FB_MAX_ROWS, cap))
    n_calls = -(-B // cap)
    return -(-B // n_calls)


def fb_full_batched(
    gl: np.ndarray,                  # [B, 2, nSNPs] float
    inputs: FBInputs,
    K_top: int = 16,
    ref_error: float = 0.001,
    return_arrays: bool = True,
):
    """Run the batched FB; returns (dosage [B, nSNPs], log_like [B],
    top_vals [nGrids, B, K_top], top_idx [nGrids, B, K_top]).

    top_* rows are only meaningful at grids with thin_flag >= 0.
    """
    B = gl.shape[0]
    S = inputs.S
    if isinstance(gl, jnp.ndarray) and gl.shape[2] == S:
        gl_pad = gl          # already padded, device-resident
    else:
        gl_pad = np.ones((B, 2, S), dtype=np.float32)
        gl_pad[:, :, : gl.shape[2]] = np.asarray(gl)
    gl_pad = jnp.asarray(gl_pad)
    chunk = fb_row_chunk(B, inputs.nGrids, inputs.K_pad, device_bytes_limit())
    n_chunks = -(-B // chunk)
    if n_chunks > 1:
        # pad rows carry neutral GLs (all ones); their outputs are dropped.
        # Every chunk has one shape, so one compiled program serves all.
        gl_pad = jnp.pad(
            gl_pad, ((0, n_chunks * chunk - B), (0, 0), (0, 0)),
            constant_values=1.0,
        )
    dev = inputs.device()
    parts = [
        _fb_core(
            gl_pad[c * chunk:(c + 1) * chunk],
            dev["dh"],
            dev["ie"],
            dev["dh_bits"],
            dev["esc_grid"],
            dev["esc_k"],
            dev["esc_bits"],
            dev["trans"],
            dev["thin_flag"],
            dev["capture_flag"],
            K=inputs.K,
            K_pad=inputs.K_pad,
            nMaxDH=inputs.nMaxDH,
            nnz=inputs.nnz,
            K_top=K_top,
            ref_error=ref_error,
        )
        for c in range(n_chunks)
    ]
    if n_chunks == 1:
        dosage, log_like, tv, ti, gamma_cap = parts[0]
    else:
        cat = lambda i, ax: jnp.concatenate(  # noqa: E731
            [p[i] for p in parts], axis=ax
        )
        dosage, log_like, gamma_cap = cat(0, 0)[:B], cat(1, 0)[:B], \
            cat(4, 0)[:B]
        tv, ti = cat(2, 1)[:, :B], cat(3, 1)[:, :B]
    if return_arrays:
        out = (
            np.asarray(dosage)[:, : inputs.nSNPs],
            np.asarray(log_like),
            np.asarray(tv),
            np.asarray(ti),
        )
        if inputs.capture_grid >= 0:
            return out + (np.asarray(gamma_cap)[:, : inputs.K],)
        return out
    return dosage, log_like, tv, ti, gamma_cap
