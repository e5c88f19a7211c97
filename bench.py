"""Full-panel forward-backward (FB) throughput on one GPU.

    python bench.py                        # the two FB shapes below
    python bench.py --grid-chunks 8,16,32  # also time GRID_CHUNK choices

Shapes (inputs device-resident, as across the engine's seek loop):
- K=5,120 haplotypes x 2,048 grids (65,536 SNPs), B=28 rows;
- K=98,304 x 512 grids, B=16 rows (the biobank panel);
- with --grid-chunks, the diploid quick-start FB call: K=5,120 x 512
  grids, B=448 rows (32 samples x 7 chains x 2 haplotypes).

Per shape it prints seconds per call (median of timed calls, each ended by
jax.block_until_ready), cell updates/s (2*B*K*G: one forward and one
backward K-state update per grid and row), and the share of the card's
device-memory bandwidth implied by the call's minimal traffic: E written
once and read twice, alphas and gammas each written and read once
(7 [G, B, K_pad] f32 passes), plus the panel index read twice. Ends with
one JSON line. The peak table is keyed by device_kind; an unknown device
is an error.
"""
import argparse
import json
import statistics
import time

import numpy as np

from quilt_tpu.io.simulate import fast_packed_panel

# device memory bandwidth in bytes/s (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def fb_world(rng, K, G, B):
    import jax.numpy as jnp
    from quilt_tpu.kernels import FBInputs
    from quilt_tpu.panel import compress_panel, trans_rates

    panel = compress_panel(fast_packed_panel(rng, K, G), G * 32, nMaxDH=255)
    inputs = FBInputs.build(panel, trans_rates(np.full(G - 1, 0.99)),
                            thinned_grids=np.arange(0, G, 10))
    gl = jnp.asarray(rng.uniform(0.05, 1.0, (B, 2, G * 32)).astype(np.float32))
    return inputs, gl


def time_fb(inputs, gl, reps):
    import jax
    from quilt_tpu.kernels import fb_full_batched

    t0 = time.perf_counter()
    jax.block_until_ready(fb_full_batched(gl, inputs, K_top=8,
                                          return_arrays=False))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fb_full_batched(gl, inputs, K_top=8, return_arrays=False)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    dosage = np.asarray(out[0])
    assert np.isfinite(dosage).all()
    assert dosage.min() > -0.02 and dosage.max() < 1.02   # bf16 rounding
    return first, statistics.median(times)


def row(name, K, G, B, K_pad, first, dt, peak):
    cells = 2.0 * B * K * G
    nbytes = 7 * G * B * K_pad * 4 + 2 * G * K_pad * 4
    return {
        "shape": name, "K": K, "G": G, "B": B,
        "first_call_s": first, "seconds_per_call": dt,
        "cells_per_s": cells / dt,
        "model_bytes_per_call": nbytes,
        "bandwidth_share": nbytes / dt / peak,
    }


def main():
    import jax
    import quilt_tpu.kernels.fb_full as fbm
    from quilt_tpu.utils.device import describe_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid-chunks", default="",
                    help="comma-separated GRID_CHUNK values to time at "
                         "the diploid quick-start FB shape")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = describe_device()
    print(json.dumps(dev), flush=True)
    if dev["kind"] not in PEAK_BYTES_PER_S:
        raise SystemExit(f"no peak bandwidth for {dev['kind']!r}")
    peak = PEAK_BYTES_PER_S[dev["kind"]]
    rng = np.random.default_rng(0)
    rows = []
    shapes = [("K5120_G2048_B28", 5120, 2048, 28),
              ("K98304_G512_B16", 98304, 512, 16)]
    for name, K, G, B in shapes:
        inputs, gl = fb_world(rng, K, G, B)
        first, dt = time_fb(inputs, gl, args.reps)
        rows.append(row(name, K, G, B, inputs.K_pad, first, dt, peak))
        print(json.dumps(rows[-1]), flush=True)
    default_chunk = fbm.GRID_CHUNK
    for cg in [int(x) for x in args.grid_chunks.split(",") if x]:
        fbm.GRID_CHUNK = cg
        jax.clear_caches()
        inputs, gl = fb_world(np.random.default_rng(1), 5120, 512, 448)
        first, dt = time_fb(inputs, gl, args.reps)
        rows.append(row(f"K5120_G512_B448_gridchunk{cg}", 5120, 512, 448,
                        inputs.K_pad, first, dt, peak))
        print(json.dumps(rows[-1]), flush=True)
    fbm.GRID_CHUNK = default_chunk
    print(json.dumps({"device": dev, "fb": rows}))


if __name__ == "__main__":
    main()
