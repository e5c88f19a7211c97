import numpy as np
import jax.numpy as jnp
import pytest

from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.panel import assign_positions_to_grid, trans_rates
from quilt_tpu.oracle import gibbs_sample_one_chain
from quilt_tpu.oracle.emissions import make_emat_read
from quilt_tpu.kernels import PaddedReads, emat_read_from_bits
from quilt_tpu.kernels.gibbs import GibbsInputs, run_gibbs_chains


def setup(rng, K=48, nSNPs=256, coverage=3.0, read_len=800, phred=28):
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, sim = simulate_sample_reads(
        rng, truth, pos, grid, coverage=coverage, read_length_bp=read_len,
        phred=phred,
    )
    sigma = np.full(nGrids - 1, 0.985)
    trans = trans_rates(sigma)
    return haps, pos, grid, nGrids, truth, reads, sim, trans


def pad_bits(haps, nGrids):
    S = nGrids * 32
    K = haps.shape[0]
    bits = np.zeros((K, S), dtype=np.uint8)
    bits[:, : haps.shape[1]] = haps
    return bits


def test_emat_read_kernel_matches_oracle(rng):
    haps, pos, grid, nGrids, truth, reads, sim, trans = setup(rng)
    oracle_em = make_emat_read(reads, haps, 0.001, 1e10)
    preads = PaddedReads.build(reads, ref_error=0.001)
    bits = pad_bits(haps, nGrids)[None]
    em = np.asarray(
        emat_read_from_bits(
            jnp.asarray(bits),
            jnp.asarray(preads.u_pad),
            jnp.asarray(preads.lr),
            jnp.asarray(preads.la),
            1e10,
        )
    )[0]
    np.testing.assert_allclose(em, oracle_em, rtol=2e-4, atol=2e-6)


def test_gibbs_kernel_matches_oracle(rng):
    haps, pos, grid, nGrids, truth, reads, sim, trans = setup(rng)
    n_its = 9
    uniforms = rng.random((n_its, reads.nReads))
    H_init = rng.integers(0, 2, reads.nReads)
    oracle = gibbs_sample_one_chain(
        reads=reads, hap_alleles=haps, grid=grid, trans=trans, n_latent=2,
        ff=0.0, uniforms=uniforms, H_init=H_init, nGrids=nGrids,
        iterative_init=True, first_read_init=0,
        n_burn_in_its=n_its - 1, n_sample_its=1,
    )
    inputs = GibbsInputs.build(reads, trans, nGrids)
    R = inputs.R
    u_pad = np.zeros((n_its, 1, R), dtype=np.float32)
    u_pad[:, 0, : reads.nReads] = uniforms
    H0 = np.zeros((1, R), dtype=np.int32)
    H0[0, : reads.nReads] = H_init
    preads = PaddedReads.build(reads, ref_error=0.001)
    bits = pad_bits(haps, nGrids)[None]
    gp, gpF, hap_dos, H, ll, uf, Hcls = run_gibbs_chains(
        bits=bits, preads=preads, inputs=inputs, uniforms=u_pad, H0=H0,
        first_read=np.zeros(1, dtype=np.int32), n_latent=2, ff=0.0,
        n_burn_in=n_its - 1, iterative_init=True, K_real=haps.shape[0],
    )
    assert not uf[0]
    # informative reads must agree exactly; reads whose emissions are all
    # ~1 are resampled ~uniformly in fp64 but skipped in fp32 — exclude them
    em_o = oracle.eMatRead
    informative = em_o.min(axis=0) < 0.5
    agree = (H[0, : reads.nReads] == oracle.H)[informative].mean()
    assert agree > 0.99, f"informative label agreement {agree}"
    dos_k = gp[0, 1, : len(pos)] + 2 * gp[0, 2, : len(pos)]
    dos_o = oracle.genProbs[1] + 2 * oracle.genProbs[2]
    r2 = np.corrcoef(dos_k, dos_o)[0, 1] ** 2
    assert r2 > 0.999, f"dosage r2 vs oracle {r2}"
    # accuracy vs truth
    truth_g = truth.sum(axis=0)
    r2t = np.corrcoef(dos_k, truth_g)[0, 1] ** 2
    assert r2t > 0.85, f"dosage r2 vs truth {r2t}"


def test_gibbs_kernel_batched_chains(rng):
    haps, pos, grid, nGrids, truth, reads, sim, trans = setup(rng, K=40)
    n_its = 6
    B = 3
    inputs = GibbsInputs.build(reads, trans, nGrids)
    R = inputs.R
    uniforms = rng.random((n_its, B, R)).astype(np.float32)
    H0 = rng.integers(0, 2, (B, R)).astype(np.int32)
    preads = PaddedReads.build(reads)
    bits = np.broadcast_to(
        pad_bits(haps, nGrids)[None], (B, haps.shape[0], nGrids * 32)
    ).copy()
    gp, gpF, hap_dos, H, ll, uf, Hcls = run_gibbs_chains(
        bits=bits, preads=preads, inputs=inputs, uniforms=uniforms, H0=H0,
        first_read=np.zeros(B, dtype=np.int32), n_latent=2, ff=0.0,
        n_burn_in=n_its - 1, iterative_init=True, K_real=haps.shape[0],
    )
    assert gp.shape == (B, 3, nGrids * 32)
    assert not uf.any()
    truth_g = truth.sum(axis=0)
    for b in range(B):
        dos = gp[b, 1, : len(pos)] + 2 * gp[b, 2, : len(pos)]
        r2 = np.corrcoef(dos, truth_g)[0, 1] ** 2
        assert r2 > 0.8, f"chain {b}: r2 {r2}"
    # chains with different uniforms should not be identical
    assert not np.array_equal(H[0], H[1])


def test_gibbs_kernel_matches_oracle_nipt(rng):
    """Triploid (NIPT) kernel vs oracle equivalence."""
    K, nSNPs = 40, 256
    ff = 0.25
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    truth = simulate_truth_mosaic(rng, haps, n_latent=3)
    reads, sim = simulate_sample_reads(
        rng, truth, pos, grid, coverage=4.0, read_length_bp=800, phred=28,
        ff=ff,
    )
    sigma = np.full(nGrids - 1, 0.985)
    trans = trans_rates(sigma)
    n_its = 7
    uniforms = rng.random((n_its, reads.nReads))
    H_init = rng.choice(3, size=reads.nReads,
                        p=[0.5, (1 - ff) / 2, ff / 2]).astype(np.int64)
    oracle = gibbs_sample_one_chain(
        reads=reads, hap_alleles=haps, grid=grid, trans=trans, n_latent=3,
        ff=ff, uniforms=uniforms, H_init=H_init, nGrids=nGrids,
        iterative_init=True, first_read_init=0,
        n_burn_in_its=n_its - 1, n_sample_its=1,
    )
    inputs = GibbsInputs.build(reads, trans, nGrids)
    R = inputs.R
    u_pad = np.zeros((n_its, 1, R), dtype=np.float32)
    u_pad[:, 0, : reads.nReads] = uniforms
    H0 = np.zeros((1, R), dtype=np.int32)
    H0[0, : reads.nReads] = H_init
    preads = PaddedReads.build(reads, ref_error=0.001)
    bits = pad_bits(haps, nGrids)[None]
    gp, gpF, hap_dos, H, ll, uf, Hcls = run_gibbs_chains(
        bits=bits, preads=preads, inputs=inputs, uniforms=u_pad, H0=H0,
        first_read=np.zeros(1, dtype=np.int32), n_latent=3, ff=ff,
        n_burn_in=n_its - 1, iterative_init=True, K_real=K,
    )
    assert not uf[0]
    em_o = oracle.eMatRead
    informative = em_o.min(axis=0) < 0.5
    agree = (H[0, : reads.nReads] == oracle.H)[informative].mean()
    assert agree > 0.95, f"NIPT informative label agreement {agree}"
    # maternal genProbs
    dos_k = gp[0, 1, :nSNPs] + 2 * gp[0, 2, :nSNPs]
    dos_o = oracle.genProbs[1] + 2 * oracle.genProbs[2]
    r2 = np.corrcoef(dos_k, dos_o)[0, 1] ** 2
    assert r2 > 0.99, f"NIPT maternal dosage r2 vs oracle {r2}"
    # fetal genProbs
    dosF_k = gpF[0, 1, :nSNPs] + 2 * gpF[0, 2, :nSNPs]
    dosF_o = oracle.genProbsF[1] + 2 * oracle.genProbsF[2]
    r2f = np.corrcoef(dosF_k, dosF_o)[0, 1] ** 2
    assert r2f > 0.98, f"NIPT fetal dosage r2 vs oracle {r2f}"


def test_gibbs_packed_bits_equals_unpacked(rng):
    """run_gibbs_chains with PACKED panel words (int32/uint32 bits, the
    production layout) equals the unpacked uint8 path."""
    from quilt_tpu.io import simulate_panel, simulate_sample_reads
    from quilt_tpu.io.simulate import simulate_truth_mosaic
    from quilt_tpu.panel import assign_positions_to_grid, trans_rates
    from quilt_tpu.utils import pack_bits_32, unpack_bits_32
    from quilt_tpu.kernels.gibbs import GibbsInputs, run_gibbs_chains

    K, nSNPs = 64, 256
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    rhb_t = pack_bits_32(haps)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(
        rng, truth, pos, grid, coverage=1.5, read_length_bp=300
    )
    reads = reads.sorted_by_grid()
    trans = trans_rates(np.full(nGrids - 1, 0.98))
    gin = GibbsInputs.build(reads, trans, nGrids)
    pr = PaddedReads.build(reads, ref_error=0.001)
    C, n_its = 2, 6
    bits_u8 = np.broadcast_to(
        unpack_bits_32(rhb_t, nGrids * 32)[None], (C, K, nGrids * 32)
    )
    bits_pk = np.broadcast_to(rhb_t[None], (C, K, nGrids))
    uniforms = rng.random((n_its, C, gin.R)).astype(np.float32)
    H0 = rng.choice(2, size=(C, gin.R)).astype(np.int32)
    first = np.zeros(C, dtype=np.int32)
    outs = []
    for bits in (bits_u8, bits_pk):
        outs.append(run_gibbs_chains(
            bits=np.ascontiguousarray(bits), preads=pr, inputs=gin,
            uniforms=uniforms, H0=H0, first_read=first, n_latent=2,
            ff=0.0, n_burn_in=n_its - 1, iterative_init=False, K_real=K,
        ))
    for a, b, name in zip(outs[0], outs[1],
                          ("gp", "gpF", "hd", "H", "ll", "uf", "Hc")):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6,
            err_msg=name,
        )


def _variant_world(nl, ff, with_block, B, seed):
    """Small sweep inputs with optional static block boundaries."""
    rng = np.random.default_rng(seed)
    K, nSNPs = 24, 128
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    truth = simulate_truth_mosaic(rng, haps, n_latent=nl)
    reads, _ = simulate_sample_reads(
        rng, truth, pos, grid, coverage=3.0, read_length_bp=600, phred=25,
        ff=ff,
    )
    reads = reads.sorted_by_grid()
    trans = trans_rates(np.full(nGrids - 1, 0.985))
    n_its = 6
    inputs = GibbsInputs.build(reads, trans, nGrids)
    R = inputs.R
    p = [0.5, 0.5] if nl == 2 else [0.5, (1 - ff) / 2, ff / 2]
    kw = dict(
        preads=PaddedReads.build(reads, ref_error=0.001), inputs=inputs,
        uniforms=rng.random((n_its, B, R)).astype(np.float32),
        H0=rng.choice(nl, size=(B, R), p=p).astype(np.int32),
        first_read=rng.integers(0, reads.nReads, B).astype(np.int32),
        n_latent=nl, ff=ff, n_burn_in=n_its - 1, K_real=K,
    )
    if with_block:
        kw["boundaries"] = np.array(
            [nGrids // 3, 2 * nGrids // 3], dtype=np.int32
        )
        kw["block_u"] = rng.random((n_its, 2, 3, B)).astype(np.float32)
        db = np.zeros(n_its, bool)
        db[[2, 4]] = True
        kw["do_block"] = db
        if nl == 3:
            kw["resample_u"] = rng.random((n_its, B, R)).astype(np.float32)
    bits = np.broadcast_to(pad_bits(haps, nGrids)[None],
                           (B, K, nGrids * 32)).copy()
    return bits, reads, kw


@pytest.mark.parametrize("variant", ["packed_bits", "lem_read"])
@pytest.mark.parametrize(
    "nl,ff,with_block,iterative",
    [
        (2, 0.0, False, True),
        (2, 0.0, True, True),
        (2, 0.0, False, False),
        (3, 0.2, True, True),
    ],
)
def test_gibbs_input_variant_matches_default(nl, ff, with_block, iterative,
                                             variant):
    """The production inputs reach the same sweep as the default uint8
    panel: packed panel words (exact), and the batched engine's
    whole-panel emission cache fed through lem_read= (bf16 hi/lo matmul
    emissions, so labels agree to rounding ties)."""
    import jax.numpy as jnp
    from quilt_tpu.kernels.emissions import (
        ReadWindowCache, expand_panel_bf16, lem_full_from_cache, lem_subset,
    )
    from quilt_tpu.utils import pack_bits_32

    B = 2
    bits, reads, kw = _variant_world(nl, ff, with_block, B, seed=11 + nl)
    kw["iterative_init"] = iterative
    ref = run_gibbs_chains(bits=bits, **kw)
    words = pack_bits_32(bits[0])
    bits_p = np.broadcast_to(words[None], (B,) + words.shape).copy()
    if variant == "packed_bits":
        got = run_gibbs_chains(bits=bits_p, **kw)
        for a, b, name in zip(ref, got, ("gp", "gpF", "hd", "H", "ll",
                                         "uf", "Hc")):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6,
                err_msg=name,
            )
        return
    pr = kw["preads"]
    wc = ReadWindowCache(
        pr.u_pad[None], pr.lpr[None], pr.lpa[None], pr.mask[None],
        kw["inputs"].G, lr=pr.lr[None], la=pr.la[None], Rc=64,
    )
    dh, dl = wc.diff
    lem_full = lem_full_from_cache(
        expand_panel_bf16(jnp.asarray(words)), dh, dl, wc.base, wc.s0,
        wc.Rc, wc.Swin,
    )
    K = kw["K_real"]
    flat_idx = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None], (B, K))
    lem_pair = lem_subset(lem_full, flat_idx, 1e10, kw["inputs"].R)
    got = run_gibbs_chains(bits=bits_p, lem_read=lem_pair, **kw)
    nr = reads.nReads
    assert not got[5].any()
    assert (ref[3][:, :nr] == got[3][:, :nr]).mean() > 0.99
    nS = 128
    d_ref = ref[0][:, 1, :nS] + 2 * ref[0][:, 2, :nS]
    d_got = got[0][:, 1, :nS] + 2 * got[0][:, 2, :nS]
    np.testing.assert_allclose(d_got, d_ref, atol=2e-2)


def test_gibbs_dense_coverage_matches_oracle(rng):
    """Grids holding more than 64 reads (dense coverage) sweep their reads
    in order exactly as the oracle does."""
    haps, pos, grid, nGrids, truth, reads, sim, trans = setup(
        rng, K=24, nSNPs=96, coverage=40.0, read_len=600, phred=25,
    )
    reads = reads.sorted_by_grid()
    inputs = GibbsInputs.build(reads, trans, nGrids)
    assert int(inputs.read_count.max()) > 64, "fixture must be dense"
    n_its = 3
    uniforms = rng.random((n_its, reads.nReads))
    H_init = rng.integers(0, 2, reads.nReads)
    oracle = gibbs_sample_one_chain(
        reads=reads, hap_alleles=haps, grid=grid, trans=trans, n_latent=2,
        ff=0.0, uniforms=uniforms, H_init=H_init, nGrids=nGrids,
        iterative_init=True, first_read_init=0,
        n_burn_in_its=n_its - 1, n_sample_its=1,
    )
    R = inputs.R
    u_pad = np.zeros((n_its, 1, R), dtype=np.float32)
    u_pad[:, 0, : reads.nReads] = uniforms
    H0 = np.zeros((1, R), dtype=np.int32)
    H0[0, : reads.nReads] = H_init
    gp, _, _, H, _, uf, _ = run_gibbs_chains(
        bits=pad_bits(haps, nGrids)[None],
        preads=PaddedReads.build(reads, ref_error=0.001), inputs=inputs,
        uniforms=u_pad, H0=H0, first_read=np.zeros(1, dtype=np.int32),
        n_latent=2, ff=0.0, n_burn_in=n_its - 1, iterative_init=True,
        K_real=haps.shape[0],
    )
    assert not uf[0]
    informative = oracle.eMatRead.min(axis=0) < 0.5
    agree = (H[0, : reads.nReads] == oracle.H)[informative].mean()
    assert agree > 0.98, f"informative label agreement {agree}"
    dos_k = gp[0, 1, : len(pos)] + 2 * gp[0, 2, : len(pos)]
    dos_o = oracle.genProbs[1] + 2 * oracle.genProbs[2]
    assert np.corrcoef(dos_k, dos_o)[0, 1] ** 2 > 0.99
