"""Gibbs-sweep timing at the quick-start workload shape.

    python tools/bench_gibbs.py [--chains 7,56,224] [--reps 3]

One sample's reads (1x, 600 bp, phred 25) over 16,384 SNPs (512 grids),
Ksubset=600 (padded to 640), emissions from the engine's per-batch cache
(engine/batch.py). Per chain-batch size it times the full 21-sweep call
(seconds per call, median of timed calls ended by jax.block_until_ready)
and a 2-sweep call, which together split fixed per-call cost from
per-sweep cost. Prints the device and one JSON line per row.
"""
import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from quilt_tpu.io import simulate_sample_reads
    from quilt_tpu.io.simulate import fast_packed_panel, simulate_truth_mosaic
    from quilt_tpu.kernels import PaddedReads
    from quilt_tpu.kernels.common import pad_to_multiple
    from quilt_tpu.kernels.emissions import (
        ReadWindowCache, expand_panel_bf16, lem_full_from_cache, lem_subset,
    )
    from quilt_tpu.kernels.gibbs import GibbsInputs, run_gibbs_chains
    from quilt_tpu.panel.prepare import assign_positions_to_grid, trans_rates
    from quilt_tpu.utils import unpack_bits_32
    from quilt_tpu.utils.device import describe_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", default="7,56,224")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps(describe_device()), flush=True)

    rng = np.random.default_rng(0)
    K_panel, nSNPs, Ksub = 5120, 16384, 600
    rhb = fast_packed_panel(rng, K_panel, nSNPs // 32)
    haps = unpack_bits_32(rhb[:1024], nSNPs)
    pos = np.arange(1, nSNPs + 1, dtype=np.int64) * 60
    grid, _, nGrids = assign_positions_to_grid(pos)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(
        rng, truth, pos, grid, coverage=1.0, read_length_bp=600, phred=25
    )
    reads = reads.sorted_by_grid()
    ginputs = GibbsInputs.build(reads, trans_rates(np.full(nGrids - 1, 0.99)),
                                nGrids)
    preads = PaddedReads.build(reads, ref_error=0.001)
    Kp = pad_to_multiple(Ksub, 128)
    which = np.sort(rng.choice(K_panel, Ksub, replace=False))
    which_p = np.concatenate([which, np.repeat(which[:1], Kp - Ksub)])
    bits1 = jnp.asarray(rhb[which_p])
    wcache = ReadWindowCache(
        preads.u_pad[None], preads.lpr[None], preads.lpa[None],
        preads.mask[None], nGrids, lr=preads.lr[None], la=preads.la[None],
    )
    dh, dl = wcache.diff
    lem_full = lem_full_from_cache(
        expand_panel_bf16(jnp.asarray(rhb)), dh, dl, wcache.base, wcache.s0,
        wcache.Rc, wcache.Swin,
    )
    which_dev = jnp.asarray(which_p.astype(np.int32))

    def seconds_per_call(C, n_its):
        bits = jnp.broadcast_to(bits1[None], (C, Kp, nGrids))
        kw = dict(
            bits=bits, preads=preads, inputs=ginputs,
            uniforms=jnp.asarray(
                rng.random((n_its, C, ginputs.R)).astype(np.float32)),
            H0=jnp.asarray(rng.choice(2, size=(C, ginputs.R))
                           .astype(np.int32)),
            first_read=rng.integers(0, reads.nReads, C).astype(np.int32),
            n_latent=2, ff=0.0, n_burn_in=n_its - 1, iterative_init=True,
            K_real=Ksub, return_arrays=False,
            lem_read=lem_subset(
                lem_full, jnp.broadcast_to(which_dev[None], (C, Kp)), 1e10,
                ginputs.R,
            ),
        )
        jax.block_until_ready(run_gibbs_chains(**kw))      # compile
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run_gibbs_chains(**kw))
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    for C in [int(x) for x in args.chains.split(",")]:
        d21 = seconds_per_call(C, 21)
        d2 = seconds_per_call(C, 2)
        print(json.dumps({
            "chains": C, "nReads": reads.nReads, "Ksubset": Ksub,
            "nGrids": nGrids,
            "max_reads_per_grid": int(ginputs.read_count.max()),
            "seconds_per_21_sweep_call": d21,
            "seconds_per_2_sweep_call": d2,
            "marginal_seconds_per_sweep": (d21 - d2) / 19.0,
            "read_resamples_per_s": 21 * C * reads.nReads / d21,
        }), flush=True)


if __name__ == "__main__":
    main()
