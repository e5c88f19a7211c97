"""Multi-device execution: device mesh and the panel-sharded full-panel FB.

The reference's only concurrency is fork-per-sample (QUILT/R/quilt.R:692);
the device equivalents are two mesh axes over GPUs that NVLink joins all
to all, so the mesh shape follows the algorithm alone:

- `data` mesh axis: independent samples/chains batch-parallel
  (embarrassingly parallel, no collectives);
- `panel` mesh axis: the K reference-haplotype axis of the full-panel FB
  sharded across cards. The Li & Stephens recursion needs global sums
  over K (jump mass, normalizers); the segment-fused body
  (`_fb_core_segmented`) batches them into one psum per SEG_LEN grids,
  which XLA hands to NCCL. Dosage partials (through the distinct-hap
  table) and escape corrections psum once; top-K candidates merge via
  all_gather of per-shard top-K followed by a host value-sort.

The sharded kernel is EXACT up to summation order: every K-reduction of
the single-device body is lifted to a psum/pmax (kernels/fb_full.py),
including the escape-COO correction and thinned-grid top-K gating
(SURVEY.md section 2.7).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels.fb_full import FBInputs, _fb_core_impl, _fb_core_segmented


def make_mesh(n_data: int, n_panel: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_data * n_panel, (
        f"need {n_data * n_panel} devices, have {devices.size}"
    )
    devices = devices.flatten()[: n_data * n_panel].reshape(n_data, n_panel)
    return Mesh(devices, ("data", "panel"))


def mesh_from_config(cfg) -> Optional[Mesh]:
    """Build the engine mesh from ImputeConfig.mesh_data/mesh_panel; None
    when the config asks for a single device."""
    n_data = max(int(getattr(cfg, "mesh_data", 1) or 1), 1)
    n_panel = max(int(getattr(cfg, "mesh_panel", 1) or 1), 1)
    if n_data * n_panel <= 1:
        return None
    n_dev = len(jax.devices())
    if n_data * n_panel > n_dev:
        raise ValueError(
            f"mesh_data x mesh_panel = {n_data}x{n_panel} needs "
            f"{n_data * n_panel} devices; only {n_dev} available"
        )
    return make_mesh(n_data, n_panel)


class ShardedFB:
    """Per-region state for the panel-sharded FB: the per-shard panel
    arrays are computed once and kept device-resident across calls (the
    sharded analogue of FBInputs.device())."""

    def __init__(self, inputs: FBInputs, mesh: Mesh, K_top: int = 8,
                 ref_error: float = 0.001):
        self.inputs = inputs
        self.mesh = mesh
        self.K_top = K_top
        self.ref_error = ref_error
        n_panel = mesh.shape["panel"]
        self.n_panel = n_panel
        self.n_data = mesh.shape["data"]
        K_pad = inputs.K_pad
        # per-shard K, multiple of 128
        K_shard = ((K_pad + n_panel - 1) // n_panel + 127) // 128 * 128
        self.K_shard = K_shard
        G = inputs.nGrids
        # split dh columns over shards: [n_panel, G, K_shard]
        dh_sh = np.zeros((n_panel, G, K_shard), dtype=np.int32)
        flat = np.zeros((G, n_panel * K_shard), dtype=np.int32)
        flat[:, :K_pad] = inputs.dh
        for s in range(n_panel):
            dh_sh[s] = flat[:, s * K_shard:(s + 1) * K_shard]
        # split escape COO by owning shard, pad to common nnz
        esc_k = inputs.esc_k
        owner = esc_k // K_shard if len(esc_k) else np.zeros(0, np.int64)
        nnz_max = int(np.bincount(owner, minlength=n_panel).max()) \
            if len(esc_k) else 0
        nnz_max = max(nnz_max, 1)
        eg = np.zeros((n_panel, nnz_max), dtype=np.int32)
        ek = np.zeros((n_panel, nnz_max), dtype=np.int32)
        eb = np.zeros((n_panel, nnz_max, 32), dtype=np.uint8)
        ev = np.zeros((n_panel, nnz_max), dtype=np.float32)
        for s in range(n_panel):
            w = np.flatnonzero(owner == s)
            eg[s, : len(w)] = inputs.esc_grid[w]
            ek[s, : len(w)] = esc_k[w] - s * K_shard
            eb[s, : len(w)] = inputs.esc_bits[w]
            ev[s, : len(w)] = 1.0
        self.nnz_max = nnz_max

        put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
        self.capture = inputs.capture_grid >= 0
        if True:
            self._dev = dict(
                dh=put(dh_sh, P("panel", None, None)),
                ie=put(inputs.ie, P()),
                dh_bits=put(inputs.dh_bits, P()),
                eg=put(eg, P("panel", None)),
                ek=put(ek, P("panel", None)),
                eb=put(eb, P("panel", None, None)),
                ev=put(ev, P("panel", None)),
                trans=put(inputs.trans.astype(np.float32), P()),
                thin=put(inputs.thin_flag, P()),
                cap=put(self._cap_flags(G), P()),
            )

        inp = inputs
        K_top_ = K_top
        ref_error_ = ref_error
        import os
        # default body: segment-fused collectives (one psum per SEG_LEN
        # grids instead of 4 per grid — SURVEY section 7 hard part 4);
        # QUILT_SHARDED_FB=pergrid restores the per-grid-psum body
        seg = os.environ.get("QUILT_SHARDED_FB", "segmented") != "pergrid"
        core = _fb_core_segmented if seg else _fb_core_impl

        @partial(
            jax.shard_map,
            mesh=mesh,
            check_vma=False,
            in_specs=(
                P("data", None, None),           # gl
                P("panel", None, None),          # dh [n_panel, G, K_shard]
                P(), P(),                        # ie, dh_bits
                P("panel", None),                # eg
                P("panel", None),                # ek
                P("panel", None, None),          # eb
                P("panel", None),                # ev
                P(), P(), P(),                   # trans, thin, cap
            ),
            out_specs=(
                P("data", None),                 # dosage
                P("data",),                      # log_like
                P(None, "data", ("panel",)),     # tv gathered over panel
                P(None, "data", ("panel",)),     # ti
                P("data", "panel"),              # gamma capture (K shards)
            ),
        )
        def run(gl_l, dh_l, ie_l, bits_l, eg_l, ek_l, eb_l, ev_l,
                trans_l, thin_l, cap_l):
            dosage, log_like, tv, ti, gcap = core(
                gl_l, dh_l[0], ie_l, bits_l,
                eg_l[0], ek_l[0], eb_l[0], trans_l, thin_l, cap_l,
                K=inp.K, K_pad=self.K_shard, nMaxDH=inp.nMaxDH,
                nnz=self.nnz_max, K_top=K_top_, ref_error=ref_error_,
                axis_name="panel", esc_valid=ev_l[0],
            )
            return dosage, log_like, tv, ti, gcap

        self._run = jax.jit(run)

    def _cap_flags(self, G):
        """Per-grid capture flags (gamma capture at the gene-center grid
        for HLA runs; reference gamma hook functions.R:1261-1280)."""
        cap = np.zeros(G, np.float32)
        if self.inputs.capture_grid >= 0:
            cap[self.inputs.capture_grid] = 1.0
        return cap

    def __call__(self, gl: np.ndarray):
        """gl [B, 2, nSNPs or S]. Returns (dosage [B, nSNPs], log_like [B],
        tv [G, B, K_top*n_panel], ti) with per-grid lists merged by value
        (rank order preserved across shards)."""
        inputs = self.inputs
        B = gl.shape[0]
        # pad the batch to a multiple of the data axis
        Bp = ((B + self.n_data - 1) // self.n_data) * self.n_data
        gl_pad = np.ones((Bp, 2, inputs.S), dtype=np.float32)
        gl_pad[:B, :, : gl.shape[2]] = np.asarray(gl)
        d = self._dev
        dosage, log_like, tv, ti, gcap = self._run(
            jax.device_put(
                gl_pad, NamedSharding(self.mesh, P("data", None, None))
            ),
            d["dh"], d["ie"], d["dh_bits"], d["eg"], d["ek"], d["eb"],
            d["ev"], d["trans"], d["thin"], d["cap"],
        )
        tv = np.asarray(tv)[:, :B]
        ti = np.asarray(ti)[:, :B]
        # merge per-shard top-K lists into global rank order by value
        order = np.argsort(-tv, axis=2, kind="stable")
        tv = np.take_along_axis(tv, order, axis=2)
        ti = np.take_along_axis(ti, order, axis=2)
        # zero-gamma slots can be shard pad columns (index >= K): remap to
        # hap 0 so downstream selection never sees an invalid index
        ti = np.where(tv > 0, ti, 0)
        out = (
            np.asarray(dosage)[:B, : inputs.nSNPs],
            np.asarray(log_like)[:B],
            tv,
            ti,
        )
        if self.capture:
            # gathered K shards: global columns [0, K_pad) are the
            # original panel order (constructor flat layout)
            out = out + (np.asarray(gcap)[:B, : inputs.K],)
        return out


def fb_full_sharded(
    gl: np.ndarray,
    inputs: FBInputs,
    mesh: Mesh,
    K_top: int = 8,
    ref_error: float = 0.001,
):
    """One-shot wrapper (tests / dryrun); the engine holds a ShardedFB."""
    return ShardedFB(inputs, mesh, K_top=K_top, ref_error=ref_error)(gl)


def shard_gibbs_batch(mesh: Mesh, batch_axis0: dict, uniforms=None,
                      block_u=None, resample_u=None):
    """Place Gibbs-sweep arrays with the chain/batch axis sharded over the
    mesh. The sweep is embarrassingly parallel over chains (shared-nothing,
    the device analogue of the reference's fork-per-sample, quilt.R:692), so
    XLA partitions it without collectives once the inputs are sharded.

    batch_axis0: name -> array with the batch on axis 0.
    uniforms: [n_its, B, R] (batch on axis 1). block_u: [n_its, nb, 3, B].
    Falls back to the 'data' axis alone, or to no sharding, when the batch
    doesn't divide the axis size. Returns (dict, uniforms, block_u).
    """
    B = next(iter(batch_axis0.values())).shape[0]
    n_total = mesh.devices.size
    n_data = mesh.shape["data"]
    if B % n_total == 0:
        axes = ("data", "panel")
    elif B % n_data == 0:
        axes = ("data",)
    else:
        return batch_axis0, uniforms, block_u, resample_u
    spec0 = lambda nd: NamedSharding(
        mesh, P(axes, *([None] * (nd - 1)))
    )
    out = {
        k: jax.device_put(v, spec0(v.ndim)) for k, v in batch_axis0.items()
    }
    if uniforms is not None:
        uniforms = jax.device_put(
            uniforms, NamedSharding(mesh, P(None, axes, None))
        )
    if block_u is not None:
        block_u = jax.device_put(
            block_u, NamedSharding(mesh, P(None, None, None, axes))
        )
    if resample_u is not None:
        resample_u = jax.device_put(
            resample_u, NamedSharding(mesh, P(None, axes, None))
        )
    return out, uniforms, block_u, resample_u
