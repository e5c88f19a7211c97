"""Device emission kernels.

- emat_read_from_bits: P(read | hap) over a panel subset, batched over chains.
  Functional equivalent of rcpp_make_eMatRead_t (reference:
  QUILT/src/copied-from-stitch.cpp:115-233) and the compressed-object variant
  (QUILT/src/gibbs-small.cpp:116-274), recast as a dense masked
  gather-and-reduce in log space so it vectorizes over {chain, hap, read}.
- log_emat_dh_from_gl: per-grid log emission of each distinct haplotype vs
  haploid GLs (reference: Rcpp_build_eMatDH,
  QUILT/src/reference-single.cpp:272-329), computed for a batch of GL
  vectors at once.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io.reads import SampleReads, bq_to_probs


@dataclass
class PaddedReads:
    """Dense padded read tensors for the device kernels.

    u_pad[r, j] is the SNP index of base j of read r (0 for pads);
    lr/la are log-emission factors for hap-allele 0 / 1:
      lr = log(pR*(1-ref_error) + pA*ref_error)
      la = log(pA*(1-ref_error) + pR*ref_error)
    so log P(base | allele a) = lr + a*(la-lr). Pads have lr = la = 0.
    """

    u_pad: np.ndarray       # int32 [R, J]
    lr: np.ndarray          # float32 [R, J]
    la: np.ndarray          # float32 [R, J]
    mask: np.ndarray        # bool [R, J]
    wif0: np.ndarray        # int32 [R]
    nReads: int
    J: int
    lpr: np.ndarray = None  # float32 [R, J] log pR (raw, for GL building)
    lpa: np.ndarray = None  # float32 [R, J] log pA

    @classmethod
    def build_batched(
        cls, reads_list, ref_error: float = 0.001, Jmax: int = 10000,
        R_pad_to: int = 64,
    ) -> "PaddedReads":
        """Stack several samples' reads into [B, R, J] tensors (rows align
        with GibbsInputs.build_batched)."""
        from .common import pad_to_multiple

        built = [cls.build(r, ref_error, Jmax) for r in reads_list]
        R = pad_to_multiple(max(b.nReads for b in built), R_pad_to)
        J = max(b.J for b in built)
        n = len(built)
        u = np.zeros((n, R, J), dtype=np.int32)
        lr = np.zeros((n, R, J), dtype=np.float32)
        la = np.zeros((n, R, J), dtype=np.float32)
        lpr = np.zeros((n, R, J), dtype=np.float32)
        lpa = np.zeros((n, R, J), dtype=np.float32)
        mask = np.zeros((n, R, J), dtype=bool)
        wif0 = np.zeros((n, R), dtype=np.int32)
        for i, b in enumerate(built):
            u[i, : b.nReads, : b.J] = b.u_pad
            lr[i, : b.nReads, : b.J] = b.lr
            la[i, : b.nReads, : b.J] = b.la
            lpr[i, : b.nReads, : b.J] = b.lpr
            lpa[i, : b.nReads, : b.J] = b.lpa
            mask[i, : b.nReads, : b.J] = b.mask
            wif0[i, : b.nReads] = b.wif0
        return cls(u_pad=u, lr=lr, la=la, mask=mask, wif0=wif0,
                   nReads=R, J=J, lpr=lpr, lpa=lpa)

    @classmethod
    def build(
        cls, reads: SampleReads, ref_error: float = 0.001, Jmax: int = 10000
    ) -> "PaddedReads":
        nReads = reads.nReads
        lens = np.minimum(np.diff(reads.offsets), Jmax + 1).astype(np.int64)
        J = max(int(lens.max()) if nReads else 1, 1)
        u_pad = np.zeros((nReads, J), dtype=np.int32)
        lr = np.zeros((nReads, J), dtype=np.float32)
        la = np.zeros((nReads, J), dtype=np.float32)
        lpr = np.zeros((nReads, J), dtype=np.float32)
        lpa = np.zeros((nReads, J), dtype=np.float32)
        mask = np.zeros((nReads, J), dtype=bool)
        probs = bq_to_probs(reads.bq)
        t_ref = probs[:, 0] * (1 - ref_error) + probs[:, 1] * ref_error
        t_alt = probs[:, 1] * (1 - ref_error) + probs[:, 0] * ref_error
        log_tr = np.log(t_ref)
        log_ta = np.log(t_alt)
        log_pr = np.log(np.maximum(probs[:, 0], 1e-30))
        log_pa = np.log(np.maximum(probs[:, 1], 1e-30))
        # bases with bq == 0 are skipped in GL building (reference:
        # impute_using_everything, functions.R:2018-2020)
        zero = reads.bq == 0
        log_pr = np.where(zero, 0.0, log_pr)
        log_pa = np.where(zero, 0.0, log_pa)
        for r in range(nReads):
            s = reads.offsets[r]
            n = lens[r]
            u_pad[r, :n] = reads.u[s:s + n]
            lr[r, :n] = log_tr[s:s + n]
            la[r, :n] = log_ta[s:s + n]
            lpr[r, :n] = log_pr[s:s + n]
            lpa[r, :n] = log_pa[s:s + n]
            mask[r, :n] = True
        return cls(
            u_pad=u_pad, lr=lr, la=la, mask=mask,
            wif0=reads.wif0.astype(np.int32), nReads=nReads, J=J,
            lpr=lpr, lpa=lpa,
        )


@functools.partial(
    jax.jit, static_argnames=("read_chunk", "R_out")
)
def emat_read_from_bits(
    bits: jnp.ndarray,          # [B, K, S] uint8 subset panel alleles
    u_pad: jnp.ndarray,         # [R, J] or [B, R, J] int32
    lr: jnp.ndarray,            # same leading shape as u_pad, f32
    la: jnp.ndarray,
    max_diff: float,
    read_chunk: int = 512,
    R_out: int = 0,
) -> jnp.ndarray:
    """eMatRead [B, K, R] float32.

    log e[b,k,r] = sum_j lr[r,j] + bits[b,k,u[r,j]]*(la-lr)[r,j]; per read the
    column is rescaled to max 1 and floored at 1/max_diff (the reference's
    rescale_eMatRead_t + maxDifferenceBetweenReads clamp,
    copied-from-stitch.cpp:190-226). With 3D inputs, each batch row carries
    its own reads (multi-sample batching).

    Jitted (the eager lax.scan re-traced per call, dominating the Gibbs
    call's dispatch overhead); R_out > R right-pads the read axis with 1.0
    inside the jit so callers avoid a separate eager pad.

    `bits` dtype selects the layout: uint8 = unpacked alleles [B, K, S];
    int32/uint32 = PACKED words [B, K, S/32] (bit b of word g = allele of
    SNP 32g+b) — 32x less gather traffic and no unpacked panel in device
    memory.
    """
    B, K, S = bits.shape
    packed = bits.dtype != jnp.uint8
    per_row = u_pad.ndim == 3
    R, J = u_pad.shape[-2], u_pad.shape[-1]
    base = lr.sum(axis=-1)                     # [R] or [B, R]
    diff = (la - lr)                           # [..., R, J], 0 at pads

    n_chunks = (R + read_chunk - 1) // read_chunk
    Rpad = n_chunks * read_chunk
    if Rpad != R:
        padw = [(0, 0)] * (u_pad.ndim - 2) + [(0, Rpad - R), (0, 0)]
        u_pad = jnp.pad(u_pad, padw)
        diff = jnp.pad(diff, padw)
        base = jnp.pad(base, padw[:-1])

    def _alleles(u_c):
        """Gather [B, K, Rc, J] alleles for SNP indices u_c [(B,) Rc, J].
        The index keeps its size-1 K dim — take_along_axis broadcasts it
        (an explicit broadcast_to forces a far slower gather lowering)."""
        flat = u_c.reshape((B, 1, -1) if per_row else (1, 1, -1))
        if packed:
            w = jnp.take_along_axis(bits, flat >> 5, axis=2)
            a = (w >> (flat & 31).astype(w.dtype)) & 1
        else:
            a = jnp.take_along_axis(bits, flat, axis=2)
        if not per_row and a.shape[0] == 1 and B > 1:
            a = jnp.broadcast_to(a, (B, K, a.shape[2]))
        return a.reshape(B, K, read_chunk, J)

    if per_row:
        def chunk_fn(carry, idx):
            u_c = jax.lax.dynamic_slice(
                u_pad, (0, idx, 0), (B, read_chunk, J)
            )
            d_c = jax.lax.dynamic_slice(
                diff, (0, idx, 0), (B, read_chunk, J)
            )
            b_c = jax.lax.dynamic_slice(base, (0, idx), (B, read_chunk))
            a = _alleles(u_c)
            logs = b_c[:, None, :] + jnp.einsum(
                "bkrj,brj->bkr", a.astype(jnp.float32),
                d_c.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST,
            )
            return carry, logs
    else:
        def chunk_fn(carry, idx):
            u_c = jax.lax.dynamic_slice(u_pad, (idx, 0), (read_chunk, J))
            d_c = jax.lax.dynamic_slice(diff, (idx, 0), (read_chunk, J))
            b_c = jax.lax.dynamic_slice(base, (idx,), (read_chunk,))
            a = _alleles(u_c)
            logs = b_c[None, None, :] + jnp.einsum(
                "bkrj,rj->bkr", a.astype(jnp.float32),
                d_c.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST,
            )
            return carry, logs

    _, logs = jax.lax.scan(
        chunk_fn, None, jnp.arange(n_chunks) * read_chunk
    )
    logs = jnp.moveaxis(logs, 0, 2).reshape(B, K, Rpad)[:, :, :R]
    logs = logs - logs.max(axis=1, keepdims=True)
    em = jnp.exp(logs)
    em = jnp.maximum(em, 1.0 / max_diff).astype(jnp.float32)
    if R_out and R_out > R:
        em = jnp.pad(
            em, ((0, 0), (0, 0), (0, R_out - R)), constant_values=1.0
        )
    return em


def lem_window_meta(u_pad: np.ndarray, mask: np.ndarray, G: int,
                    Rc: int = 256):
    """Host-side window metadata for the windowed matmuls: per Rc-chunk of
    (grid-sorted) read slots, the covering word window. Returns
    (s0 [n_rc] int32, Wwin int)."""
    if u_pad.ndim == 2:
        u_pad, mask = u_pad[None], mask[None]
    B, R, J = u_pad.shape
    n_rc = (R + Rc - 1) // Rc
    Rpad = n_rc * Rc
    if Rpad != R:
        pad = [(0, 0), (0, Rpad - R), (0, 0)]
        u_pad = np.pad(u_pad, pad)
        mask = np.pad(mask, pad)
    w = (u_pad >> 5).reshape(B, n_rc, Rc, J)
    m = mask.reshape(B, n_rc, Rc, J)
    lo = np.where(m, w, np.iinfo(np.int32).max).min(axis=(0, 2, 3))
    hi = np.where(m, w, -1).max(axis=(0, 2, 3))
    lo = np.where(lo > hi, 0, lo)                   # empty chunk
    hi = np.maximum(hi, lo)
    Wwin = int((hi - lo + 1).max())
    Wwin = min(-(-Wwin // 4) * 4, max(G, 1))        # lane-align Swin
    s0 = np.minimum(lo, max(G - Wwin, 0)).astype(np.int32)
    return s0, Wwin


class ReadWindowCache:
    """Per-batch device cache for windowed read-coefficient matmuls.

    Reads are fixed across a batch's whole seek loop, so the dense
    windowed coefficient rows (the scatter of per-base log-prob terms
    into each Rc-chunk's SNP window) are built once per batch and reused
    by every GL-building call. Rows are per SAMPLE (chains share reads).
    Split bf16 hi/lo pairs carry the f32 coefficients through bf16
    matmuls (hi + lo keeps 16 of f32's 24 mantissa bits); the other
    operand is a {0,1} one-hot or panel, which bf16 holds exactly."""

    def __init__(self, u_pad: np.ndarray, lpr: np.ndarray, lpa: np.ndarray,
                 mask: np.ndarray, G: int, Rc: int = 128,
                 lr: Optional[np.ndarray] = None,
                 la: Optional[np.ndarray] = None):
        s0, Wwin = lem_window_meta(u_pad, mask, G, Rc)
        self.Rc, self.Wwin, self.G = Rc, Wwin, G
        self.Swin = Wwin * 32
        self.n_rc = len(s0)
        self.s0 = jnp.asarray(s0)
        Bu, R, J = u_pad.shape
        self.Bu, self.R = Bu, R
        Rpad = self.n_rc * Rc
        if Rpad != R:
            pad = [(0, 0), (0, Rpad - R), (0, 0)]
            u_pad = np.pad(u_pad, pad)
            lpr = np.pad(lpr, pad)
            lpa = np.pad(lpa, pad)
            mask = np.pad(mask, pad)
            if lr is not None:
                lr = np.pad(lr, pad)
                la = np.pad(la, pad)
        self.Rpad = Rpad
        s0_of_r = np.repeat(s0, Rc)
        u_loc = np.clip(
            u_pad - (s0_of_r * 32)[None, :, None], 0, self.Swin - 1
        )
        self.pr = self._scatter(u_loc, np.where(mask, lpr, 0.0), Bu)
        self.pa = self._scatter(u_loc, np.where(mask, lpa, 0.0), Bu)
        # eMatRead coefficients (ref_error-adjusted log terms): the
        # difference rides the windowed matmul against the expanded panel
        self.diff = None
        self.base = None
        if lr is not None:
            self.diff = self._scatter(
                u_loc, np.where(mask, la - lr, 0.0), Bu
            )
            self.base = jnp.asarray(
                np.where(mask, lr, 0.0).sum(axis=-1).astype(np.float32)
            )                                               # [Bu, Rpad]

    def _scatter(self, u_loc, vals, Bu):
        """Dense [Bu, Rpad, Swin] rows from per-base (SNP slot, value)
        pairs. Slots repeat (pad bases clip to window slot 0, and a read
        may cover a SNP twice), so the scatter promises neither sorted nor
        unique indices: repeated slots must add."""
        D = jnp.zeros((Bu, self.Rpad, self.Swin), jnp.float32)
        bidx = np.arange(Bu)[:, None, None]
        ridx = np.arange(self.Rpad)[None, :, None]
        D = D.at[
            np.broadcast_to(bidx, u_loc.shape),
            np.broadcast_to(ridx, u_loc.shape),
            u_loc,
        ].add(jnp.asarray(vals))
        Dh = D.astype(jnp.bfloat16)
        Dl = (D - Dh.astype(jnp.float32)).astype(jnp.bfloat16)
        return Dh, Dl


@functools.partial(
    jax.jit,
    static_argnames=("n_latent", "C", "S", "Rc", "Swin", "minGLValue"),
)
def _gls_windowed_impl(
    prH, prL, paH, paL, s0, H, n_latent, C, S, Rc, Swin, minGLValue,
):
    Sn, Rpad, _ = prH.shape
    n_rc = s0.shape[0]
    B = Sn * C
    Hp = H if H.shape[1] == Rpad else jnp.pad(
        H, [(0, 0), (0, Rpad - H.shape[1])]
    )

    def chunk_fn(acc, c):
        r0 = c * Rc
        H_c = jax.lax.dynamic_slice(Hp, (0, r0), (B, Rc))
        oh = jax.nn.one_hot(H_c, n_latent, dtype=jnp.bfloat16)
        lhs = jnp.transpose(
            oh.reshape(Sn, C, Rc, n_latent), (0, 1, 3, 2)
        ).reshape(Sn, C * n_latent, Rc)
        dn = (((2,), (1,)), ((0,), (0,)))
        out = []
        for Dh, Dl in ((prH, prL), (paH, paL)):
            Dh_c = jax.lax.dynamic_slice(Dh, (0, r0, 0), (Sn, Rc, Swin))
            Dl_c = jax.lax.dynamic_slice(Dl, (0, r0, 0), (Sn, Rc, Swin))
            out.append(
                jax.lax.dot_general(lhs, Dh_c, dn,
                                    preferred_element_type=jnp.float32)
                + jax.lax.dot_general(lhs, Dl_c, dn,
                                      preferred_element_type=jnp.float32)
            )
        M = jnp.stack(out, axis=2)            # [Sn, C*nl, 2, Swin]
        off = s0[c] * 32
        cur = jax.lax.dynamic_slice(
            acc, (0, 0, 0, off), (Sn, C * n_latent, 2, Swin)
        )
        acc = jax.lax.dynamic_update_slice(acc, cur + M, (0, 0, 0, off))
        return acc, None

    logg0 = jnp.zeros((Sn, C * n_latent, 2, S), jnp.float32)
    logg, _ = jax.lax.scan(chunk_fn, logg0, jnp.arange(n_rc))
    gl = jnp.exp(logg.reshape(B, n_latent, 2, S))
    hi = gl.max(axis=2, keepdims=True)
    fix = (gl < minGLValue).any(axis=2, keepdims=True)
    scaled = jnp.maximum(gl / jnp.maximum(hi, 1e-30), minGLValue)
    gl = jnp.where(fix, scaled, gl)
    return gl.reshape(B * n_latent, 2, S)


@jax.jit
def expand_panel_bf16(rhb_dev: jnp.ndarray) -> jnp.ndarray:
    """[K, G] packed words -> [K, G*32] {0,1} bf16 panel (once per region;
    feeds the per-batch eMatRead matmuls)."""
    K = rhb_dev.shape[0]
    w = rhb_dev.astype(jnp.uint32)[:, None, :]             # [K, 1, G]
    sh = jax.lax.broadcasted_iota(jnp.uint32, (1, 32, 1), 1)
    e = (jax.lax.shift_right_logical(w, sh) & jnp.uint32(1))  # [K, 32, G]
    return jnp.transpose(e, (0, 2, 1)).reshape(K, -1).astype(jnp.bfloat16)


@functools.partial(jax.jit, static_argnames=("Rc", "Swin"))
def lem_full_from_cache(E_full, diff_h, diff_l, base, s0, Rc, Swin):
    """Whole-panel log eMatRead [Bu*K_panel, Rpad] f32, built once per
    batch (reads are fixed across the seek loop): per read chunk,
    D_chunk @ E_window^T as bf16 hi/lo matmuls with f32 accumulation
    (exact up to the hi/lo split: E is {0,1}). Layout is (sample, hap)-major rows
    so per-call subset selection is a flat row gather."""
    K_panel = E_full.shape[0]
    Bu, Rpad, _ = diff_h.shape
    n_rc = s0.shape[0]

    def cf(_, c):
        win = jax.lax.dynamic_slice(
            E_full, (0, s0[c] * 32), (K_panel, Swin)
        )
        Dh = jax.lax.dynamic_slice(diff_h, (0, c * Rc, 0), (Bu, Rc, Swin))
        Dl = jax.lax.dynamic_slice(diff_l, (0, c * Rc, 0), (Bu, Rc, Swin))
        dn = (((2,), (1,)), ((), ()))
        logs = (
            jax.lax.dot_general(Dh, win, dn,
                                preferred_element_type=jnp.float32)
            + jax.lax.dot_general(Dl, win, dn,
                                  preferred_element_type=jnp.float32)
        )                                       # [Bu, Rc, K_panel]
        return None, logs

    _, logs = jax.lax.scan(cf, None, jnp.arange(n_rc))
    logs = jnp.moveaxis(logs, 0, 1).reshape(Bu, Rpad, K_panel)
    logs = logs + base[:, :, None]
    return jnp.transpose(logs, (0, 2, 1)).reshape(Bu * K_panel, Rpad)


@functools.partial(jax.jit, static_argnames=("R_out",))
def lem_subset(lem_full, flat_idx, max_diff, R_out):
    """Per-call subset selection from the batch lem_full: flat row gather
    (rows = sample*K_panel + hap), then the per-read rescale to max 0 and
    the 1/maxDifferenceBetweenReads floor (reference rescale + clamp,
    copied-from-stitch.cpp:190-226). Returns (lem [B, Ksub, R_out] f32,
    skip [B, R_out] bool)."""
    B, Kp = flat_idx.shape
    sub = jnp.take(lem_full, flat_idx.reshape(-1), axis=0).reshape(
        B, Kp, -1
    )
    if sub.shape[2] > R_out:
        sub = sub[:, :, :R_out]
    elif sub.shape[2] < R_out:
        sub = jnp.pad(sub, ((0, 0), (0, 0), (0, R_out - sub.shape[2])))
    mx = sub.max(axis=1, keepdims=True)
    mn = sub.min(axis=1, keepdims=True)
    lem = jnp.maximum(sub - mx, -jnp.log(max_diff))
    skip = (mx - mn)[:, 0] <= 1e-9
    return lem, skip


def gls_from_labels_windowed(
    cache: ReadWindowCache,
    H,                       # [B, R] device i32, rows = sample*C + chain
    n_latent: int,
    C: int,
    S: int,
    minGLValue: float = 1e-10,
):
    """Windowed matmul GL builder (same math as gls_from_labels_device /
    reference reference-single.R:19-43): log gl[b,h,a,s] accumulates
    lp_a of the bases of reads assigned to latent hap h, computed as
    one-hot(H) @ D_a per read chunk instead of a scatter — ~20x faster
    at production batch shapes."""
    prH, prL = cache.pr
    paH, paL = cache.pa
    return _gls_windowed_impl(
        prH, prL, paH, paL, cache.s0, H, n_latent, C,
        S, cache.Rc, cache.Swin, minGLValue,
    )


def log_emat_dh_from_gl(
    gl: jnp.ndarray,            # [B, 2, S] haploid GLs, S = nGrids*32
    dh_bits: jnp.ndarray,       # [D, S] uint8 distinct-hap alleles
    ref_error: float,
) -> jnp.ndarray:
    """log eMatDH [B, nGrids, D+1] with slot 0 = 0 (escape placeholder).

    Emission per grid = prod over its 32 SNPs of dR*(1-e) + dA*e with
    e in {ref_error, 1-ref_error}, returned as its log (a grid's product
    can fall below float32's range; the caller rescales before exp).
    """
    B, _, S = gl.shape
    D = dh_bits.shape[0]
    G = S // 32
    e = jnp.where(dh_bits == 1, 1.0 - ref_error, ref_error)[None]     # [1,D,S]
    term = gl[:, 0][:, None, :] * (1.0 - e) + gl[:, 1][:, None, :] * e  # [B,D,S]
    logterm = jnp.log(jnp.maximum(term, 1e-30))
    logsum = logterm.reshape(B, D, G, 32).sum(axis=-1)                # [B,D,G]
    logsum = jnp.moveaxis(logsum, 1, 2)                                # [B,G,D]
    zeros = jnp.zeros((B, G, 1), dtype=logsum.dtype)
    return jnp.concatenate([zeros, logsum], axis=-1)                   # [B,G,D+1]


def emissions_for_words(
    words: jnp.ndarray,         # [..., ] uint32 packed 32-SNP hap words
    gl32: jnp.ndarray,          # [..., 2, 32] GL slice of the word's grid
    ref_error: float,
) -> jnp.ndarray:
    """Exact emission of packed escape words vs their grid's GLs.

    Device equivalent of the reference's special-symbol escape recomputation
    (QUILT/src/reference-single.cpp:2326-2331).
    """
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((words[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.float32)
    e = bits * (1.0 - 2.0 * ref_error) + ref_error
    term = gl32[..., 0, :] * (1.0 - e) + gl32[..., 1, :] * e
    return jnp.exp(jnp.log(jnp.maximum(term, 1e-30)).sum(axis=-1))


@functools.partial(
    jax.jit, static_argnames=("n_latent", "S", "minGLValue", "chunk")
)
def gls_from_labels_device(
    u_pad: jnp.ndarray,      # [B, R, J]
    lpr: jnp.ndarray,
    lpa: jnp.ndarray,
    H: jnp.ndarray,          # [B, R]
    n_latent: int,
    S: int,
    minGLValue: float = 1e-10,
    chunk: int = 256,
) -> jnp.ndarray:
    """Chunked-scan implementation of the device GL builder (jitted; the
    eager lax.scan re-traced per call)."""
    B, R, J = u_pad.shape
    n_chunks = (R + chunk - 1) // chunk
    Rp = n_chunks * chunk
    if Rp != R:
        pad = [(0, 0), (0, Rp - R), (0, 0)]
        u_pad = jnp.pad(u_pad, pad)
        lpr = jnp.pad(lpr, pad)
        lpa = jnp.pad(lpa, pad)
        H = jnp.pad(H, [(0, 0), (0, Rp - R)])
    oh = jax.nn.one_hot(H, n_latent, dtype=jnp.float32)       # [B, Rp, nl]
    bidx = jnp.arange(B)[:, None, None]

    def body(logg, c):
        sl = lambda x: jax.lax.dynamic_slice(
            x, (0, c * chunk) + (0,) * (x.ndim - 2),
            (B, chunk) + x.shape[2:],
        )
        u_c = sl(u_pad)                                       # [B, C, J]
        pr_c = sl(lpr)
        pa_c = sl(lpa)
        oh_c = sl(oh)                                         # [B, C, nl]
        wpr = oh_c[:, :, :, None] * pr_c[:, :, None, :]       # [B, C, nl, J]
        wpa = oh_c[:, :, :, None] * pa_c[:, :, None, :]
        u_b = jnp.broadcast_to(u_c[:, :, None, :], wpr.shape)
        logg = logg.at[bidx[..., None], jnp.arange(n_latent)[None, None, :, None], 0, u_b].add(wpr)
        logg = logg.at[bidx[..., None], jnp.arange(n_latent)[None, None, :, None], 1, u_b].add(wpa)
        return logg, None

    logg0 = jnp.zeros((B, n_latent, 2, S), dtype=jnp.float32)
    logg, _ = jax.lax.scan(body, logg0, jnp.arange(n_chunks))
    gl = jnp.exp(logg)
    hi = gl.max(axis=2, keepdims=True)
    fix = (gl < minGLValue).any(axis=2, keepdims=True)
    scaled = jnp.maximum(gl / jnp.maximum(hi, 1e-30), minGLValue)
    gl = jnp.where(fix, scaled, gl)
    return gl.reshape(B * n_latent, 2, S)
